"""ctypes bindings of the loader's host library, ``csrc/host_data.cpp``
(counterpart of dsf_tpu/data/native.py and native/dsf_host.cpp, plus the
PNG unfilter and OpenCV's nearest warps).

The library is compiled with the host C++ compiler at first use
(``kernels.build.host_library``).  There is no fallback: if it does not
build, the loader raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from dsf_tpu_torch.kernels import build

_LIB = None


def load() -> ctypes.CDLL:
    """The typed library, built on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = build.host_library()
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i, f = ctypes.c_int, ctypes.c_float
    for name in ("batch_crop_normalize", "batch_crop_raw"):
        getattr(lib, name).argtypes = [f32p, i, i, i, f32p, f32p, f32p, i,
                                       f32p, f32p, i]
    lib.batch_finish_aug.argtypes = [f32p, i, i, u8p, f32p, f64p, f32p, f32p,
                                     f64p, i]
    lib.nyu_unpack.argtypes = [u8p, i, i, f32p]
    lib.png_nyu_depth.argtypes = [u8p, i, i, i, f32p]
    lib.png_nyu_depth.restype = i
    lib.png_gray.argtypes = [u8p, i, i, i, f32p]
    lib.png_gray.restype = i
    lib.rotation_matrix_2d.argtypes = [f, f, ctypes.c_double, ctypes.c_double,
                                       f64p]
    lib.warp_affine_nearest.argtypes = [f32p, i, i, f64p, i, i, f, f32p]
    lib.warp_perspective_nearest.argtypes = [f32p, i, i, f64p, i, i, f, f32p]
    lib.warp_perspective_nearest.restype = i
    for name in ("batch_crop_normalize", "batch_crop_raw", "batch_finish_aug",
                 "nyu_unpack", "rotation_matrix_2d", "warp_affine_nearest"):
        getattr(lib, name).restype = None
    _LIB = lib
    return lib


def _f32(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32)


def batch_crop_normalize(depths, coms, cubes, paras, dsize, nthreads=4):
    """Crop and normalize B full frames: (B, H, W) -> ((B, dsize, dsize),
    (B, 3, 3) crop matrices), float32."""
    depths = _f32(depths)
    B, H, W = depths.shape
    imgs = np.empty((B, dsize, dsize), np.float32)
    Ms = np.empty((B, 3, 3), np.float32)
    load().batch_crop_normalize(depths, B, H, W, _f32(coms), _f32(cubes),
                                _f32(paras), dsize, imgs, Ms, nthreads)
    return imgs, Ms


def batch_crop_raw(depths, coms, cubes, paras, dsize, nthreads=4):
    """``batch_crop_normalize`` without the normalization (the augmented
    path warps the raw-depth crop first)."""
    depths = _f32(depths)
    B, H, W = depths.shape
    imgs = np.empty((B, dsize, dsize), np.float32)
    Ms = np.empty((B, 3, 3), np.float32)
    load().batch_crop_raw(depths, B, H, W, _f32(coms), _f32(cubes),
                          _f32(paras), dsize, imgs, Ms, nthreads)
    return imgs, Ms


def batch_finish_aug(imgs, flags, floors, zwins, premaxes, com_zs, cube_zs,
                     nthreads=4):
    """In place over a (B, S, S) float32 stack: the post-warp floor and
    z-window thresholds, then the depth normalization."""
    if imgs.dtype != np.float32 or not imgs.flags.c_contiguous:
        raise ValueError("imgs: need a C-contiguous float32 stack")
    load().batch_finish_aug(
        imgs, imgs.shape[0], imgs.shape[1] * imgs.shape[2],
        np.ascontiguousarray(flags, np.uint8), _f32(floors),
        np.ascontiguousarray(zwins, np.float64), _f32(premaxes), _f32(com_zs),
        np.ascontiguousarray(cube_zs, np.float64), nthreads)
    return imgs


def nyu_unpack(bgr) -> np.ndarray:
    """(H, W, 3) BGR bytes -> (H, W) float32 depth B + G * 256."""
    bgr = np.ascontiguousarray(bgr, np.uint8)
    H, W = bgr.shape[:2]
    out = np.empty((H, W), np.float32)
    load().nyu_unpack(bgr, H, W, out)
    return out


def png_nyu_depth(raw: bytes, H: int, W: int, channels: int) -> np.ndarray:
    """The inflated IDAT bytes of an 8-bit RGB or RGBA PNG -> (H, W)
    float32 depth G * 256 + B, every PNG row filter undone."""
    buf = np.frombuffer(raw, np.uint8)
    if buf.size != H * (1 + W * channels):
        raise ValueError(f"PNG data holds {buf.size} bytes, not "
                         f"{H} rows of 1 + {W} x {channels}")
    out = np.empty((H, W), np.float32)
    bad = load().png_nyu_depth(np.ascontiguousarray(buf), H, W, channels, out)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has an unknown filter type")
    return out


def png_gray(raw: bytes, H: int, W: int, bytes_per_sample: int
             ) -> np.ndarray:
    """The inflated IDAT bytes of a single-band PNG of 8 (1 byte a sample)
    or 16 bits (2, big-endian) -> (H, W) float32 samples, every PNG row
    filter undone."""
    if bytes_per_sample not in (1, 2):
        raise ValueError(f"bytes per sample {bytes_per_sample}: 1 or 2")
    buf = np.frombuffer(raw, np.uint8)
    if buf.size != H * (1 + W * bytes_per_sample):
        raise ValueError(f"PNG data holds {buf.size} bytes, not "
                         f"{H} rows of 1 + {W} x {bytes_per_sample}")
    out = np.empty((H, W), np.float32)
    bad = load().png_gray(np.ascontiguousarray(buf), H, W, bytes_per_sample,
                          out)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has an unknown filter type")
    return out


def rotation_matrix_2d(center, angle, scale=1.0) -> np.ndarray:
    """cv2.getRotationMatrix2D: (2, 3) float64."""
    out = np.empty(6, np.float64)
    load().rotation_matrix_2d(float(center[0]), float(center[1]),
                              float(angle), float(scale), out)
    return out.reshape(2, 3)


def warp_affine_nearest(src, M, dsize, border=0.0) -> np.ndarray:
    """cv2.warpAffine(src, M, dsize, INTER_NEAREST, BORDER_CONSTANT,
    border) for a (H, W) float32 image; ``dsize`` is (W, H)."""
    src = _f32(src)
    dW, dH = dsize
    out = np.empty((dH, dW), np.float32)
    load().warp_affine_nearest(src, src.shape[0], src.shape[1],
                               np.ascontiguousarray(M, np.float64).reshape(6),
                               dH, dW, float(border), out)
    return out


def warp_perspective_nearest(src, M, dsize, border=0.0) -> np.ndarray:
    """cv2.warpPerspective(src, M, dsize, INTER_NEAREST, BORDER_CONSTANT,
    border) for a (H, W) float32 image; ``dsize`` is (W, H)."""
    src = _f32(src)
    dW, dH = dsize
    out = np.empty((dH, dW), np.float32)
    if load().warp_perspective_nearest(
            src, src.shape[0], src.shape[1],
            np.ascontiguousarray(M, np.float64).reshape(9), dH, dW,
            float(border), out):
        raise ValueError("warp_perspective_nearest: singular matrix")
    return out
