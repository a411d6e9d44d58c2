"""Exported predict programs: write and load one bucket's artifact
(counterpart of dsf_tpu/serving.py:39-52, ``load_exported``).

``serving.InferenceEngine.export`` writes a ``torch.export`` program of
one bucket's predict body, with its weights, as one ``.pt2`` file; it
holds the serving path's kernels as the custom ops of
``kernels/custom_ops`` (``dsf::raster_skip`` or ``dsf::raster_binned``,
``dsf::encode``, ``dsf::decode``).  Beside the program the file carries
``dsf_export.json``: the bucket, the crop size, the device (its type and
its name) it was exported on and the compute dtype.

Loading needs the op registry, and so this module imports it and
nothing of the model code (``models``, ``render``, ``mano``,
``training``): no checkpoint, no MANO asset, no ``Config``.  An artifact
exported on the card loads on the card, one exported on the CPU with
``device="cpu"``; any other pairing raises before the program is read.
The JAX package's artifact needs nothing of ``dsf_tpu`` to load; this
one needs the port's op registry (ROADMAP, recorded differences).

Example::

    call = load_exported("predict_b8.pt2")        # cuda by default
    out = call(img, center, M, cube)              # the exported bucket
    out["joint_xyz_mm"]                           # (8, J_dataset, 3)
"""

from __future__ import annotations

import json
import zipfile
from typing import Callable, Dict

import numpy as np
import torch

from dsf_tpu_torch.device import exact_float32, resolve_device
from dsf_tpu_torch.kernels import custom_ops  # noqa: F401 (registers dsf::)

META = "dsf_export.json"


def save(ep, path: str, **meta) -> None:
    """Write the exported program ``ep`` and its ``meta`` to ``path``."""
    torch.export.save(ep, path, extra_files={META: json.dumps(meta)})


def read_meta(path: str) -> Dict:
    """The artifact's ``dsf_export.json``, read without loading the
    program or its weights."""
    with zipfile.ZipFile(path) as z:
        names = [n for n in z.namelist() if n.rsplit("/", 1)[-1] == META]
        if len(names) != 1:
            raise ValueError(f"{path}: not an artifact of "
                             f"InferenceEngine.export (no {META})")
        return json.loads(z.read(names[0]).decode("utf-8"))


def load_exported(path: str, device=None) -> Callable:
    """Load an artifact written by ``InferenceEngine.export``.  Returns
    ``call(img, center, M, cube) -> dict`` of tensors on ``device`` at the
    exported bucket (img (b, 1, S, S), center (b, 3), M (b, 3, 3), cube
    (b, 3); numpy arrays or tensors; any other shape raises).

    ``device`` is ``cuda`` when None, and raises without CUDA; it must be
    of the type the artifact was exported on.  ``call`` runs under
    ``device.exact_float32``: the flags it sets are no part of a graph,
    and without it the card would run the convolutions in TF32."""
    dev = resolve_device(device)
    meta = read_meta(path)
    if meta["device"] != dev.type:
        raise ValueError(f"{path} was exported on {meta['device']}; it "
                         f"cannot run on {dev} (export it there)")
    ep = torch.export.load(path)
    if str(dev) != meta["device_name"]:
        # exported on another card of the machine
        from torch.export.passes import move_to_device_pass
        ep = move_to_device_pass(ep, dev)
    prog = ep.module()
    b, S = meta["bucket"], meta["input_size"]
    shapes = ((b, 1, S, S), (b, 3), (b, 3, 3), (b, 3))

    def call(img, center, M, cube) -> Dict[str, torch.Tensor]:
        args = []
        for name, x, shape in zip(("img", "center", "M", "cube"),
                                  (img, center, M, cube), shapes):
            x = (x if isinstance(x, torch.Tensor)
                 else torch.from_numpy(np.array(x, np.float32)))
            if tuple(x.shape) != shape:
                raise ValueError(f"{name}: the artifact takes {shape} (bucket "
                                 f"{b}), got {tuple(x.shape)}")
            args.append(x.to(dev, torch.float32))
        with torch.inference_mode(), exact_float32():
            return prog(*args)

    call.meta = meta
    return call
