"""MANO-parameter source for the Pretrain step: ``random_param_source``,
copied from dsf_tpu/data/synth_params.py (numpy only; the port imports
nothing of dsf_tpu).  It generates plausible random parameters for smoke
tests and profiles on machines without the hands20 parameter files; the
reader of those files (``ModelParaDataset`` there) is not ported yet.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def random_param_source(batch_size: int, cube_size=(250, 250, 250),
                        seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Random-but-plausible 62-D parameter batches (scale ~1, trans 0,
    the synth factory places depth itself)."""
    rng = np.random.RandomState(seed)
    cube = np.tile(np.asarray(cube_size, np.float32), (batch_size, 1))
    while True:
        para = np.concatenate([
            rng.uniform(-np.pi, np.pi, (batch_size, 3)),
            rng.randn(batch_size, 45) * 0.5,
            rng.randn(batch_size, 10) * 0.5,
            np.ones((batch_size, 1)),
            np.zeros((batch_size, 3)),
        ], axis=-1).astype(np.float32)
        yield para, cube
