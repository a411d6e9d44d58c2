"""Hand-object voxel intersection volume (counterpart of
dsf_tpu/tools/intersect.py; ref: util/intersect.py —
which is import-broken in the reference: load_obj is called at module
level before its definition, :12 vs :15).  Same obman-style metric on
our dependency-free ray-parity containment test, with a thread-pool
driver replacing the joblib one."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from dsf_tpu_torch.tools.eval_coll import voxel_contains


def load_obj(path):
    """Minimal OBJ reader (v/f lines only)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:4]]
                faces.append(idx)
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def intersect_vox(hand_mesh, obj_mesh, pitch=0.5):
    """Intersection volume of two closed meshes: sample a voxel grid
    over the AABB overlap, count voxels inside both
    (ref: intersect_vox, util/intersect.py)."""
    hv, hf = hand_mesh
    ov, of = obj_mesh
    lo = np.maximum(hv.min(0), ov.min(0))
    hi = np.minimum(hv.max(0), ov.max(0))
    if (hi <= lo).any():
        return 0.0
    axes = [np.arange(l + pitch / 2, h, pitch) for l, h in zip(lo, hi)]
    if any(len(a) == 0 for a in axes):
        return 0.0
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    inside = voxel_contains(grid, hv, hf) & voxel_contains(grid, ov, of)
    return float(inside.sum()) * pitch ** 3


def get_all_volumes(pairs, pitch=0.5, workers=8):
    """Parallel driver over (hand_mesh, obj_mesh) pairs
    (ref: get_all_volumes, util/intersect.py:124, joblib -> threads)."""
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(lambda p: intersect_vox(p[0], p[1], pitch), pairs))
