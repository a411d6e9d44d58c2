"""MANO-parameter sources for the synth half of every step, copied from
dsf_tpu/data/synth_params.py (numpy only; the port imports nothing of
dsf_tpu).

``ModelParaDataset`` reads the hands20-style parameter text files the
reference trains from (ref: hands_modelPara_loader,
render_loader.py:2120-2156; file layout read_modelPara_simple,
render_loader.py:1334-1342).  ``random_param_source`` generates plausible
random parameters for machines without those files.
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np


class ModelParaDataset:
    """62-D parameter rows: [glb3 | pose45 | shape10 | scale1 | trans3]."""

    def __init__(self, data_rt: str, dataset_name: str = "hands",
                 file_name: str = "posePara_lm_collosion",
                 cube_size=(250, 250, 250)):
        d = os.path.join(data_rt, file_name)
        load = lambda suffix, cols: np.loadtxt(
            os.path.join(d, f"{dataset_name}-{suffix}.txt")).reshape(-1, cols)
        theta = load("pose", 45)
        quat = load("glb", 3)
        scale = load("scale", 1)
        trans = load("trans", 3)
        shape = load("shape", 10)
        self.params = np.concatenate(
            [quat, theta, shape, scale, trans], axis=-1).astype(np.float32)
        self.cube_size = np.asarray(cube_size, np.float32)

    def __len__(self):
        return len(self.params)

    def __getitem__(self, i):
        return self.params[i], self.cube_size

    def iterator(self, batch_size: int, seed: int = 0,
                 shuffle: bool = True) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.RandomState(seed)
        n = len(self.params)
        while True:
            idx = rng.permutation(n) if shuffle else np.arange(n)
            for s in range(0, n - batch_size + 1, batch_size):
                sel = idx[s:s + batch_size]
                cube = np.tile(self.cube_size, (batch_size, 1))
                yield self.params[sel], cube


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
