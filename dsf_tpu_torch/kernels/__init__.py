"""The port's CUDA kernels: build (``build``) and launch counts.

``LAUNCHES`` holds one plain integer per kernel.  Each wrapper in
``ops/*_kernel.py`` increments its own entry where it launches its kernel
and nowhere else; a run shows that a path went through the kernels by
zeroing the counts before and reading them after.
"""

from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {"raster_skip": 0, "raster_moments": 0,
                            "codec_encode": 0, "codec_encode_bwd": 0,
                            "codec_decode": 0, "codec_decode_bwd": 0,
                            "point_mesh_argmin": 0, "tail_conv": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
