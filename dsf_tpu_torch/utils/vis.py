"""Visualization utilities (counterpart of dsf_tpu/utils/vis.py): so far
only the mesh export the test loop writes.  The pose overlays and
colormaps are not ported yet (ROADMAP Queue 1)."""

from __future__ import annotations

import numpy as np


def save_obj(path, verts, faces) -> None:
    """Dump a mesh as .obj (ref: debug_mesh, vis_tool.py:721)."""
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]:.4f} {v[1]:.4f} {v[2]:.4f}\n")
        for tri in np.asarray(faces).astype(int) + 1:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")
