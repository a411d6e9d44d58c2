#!/usr/bin/env python3
"""Time the K1 and K6 raster kernels of dsf_tpu_torch at other block
shapes on one NVIDIA GPU.

    python3 scripts/raster_shapes_gpu.py     # from the root of the repository

Both kernels are templates on their block shape
(``csrc/raster_skip.cu:raster_skip_kernel<TX, TY>``, a TX x TY pixel tile;
``csrc/raster_dense.cu:raster_dense_kernel<NT, S>``, NT threads over NT * S
consecutive samples), and the port's library builds one shape of each.
This script compiles the two sources once more with every shape below
instantiated (one ``nvcc -shared`` each, the library's flags), runs each
shape on chip_smoke.py's scenes -- B=32 posed hands' crops at 64x64 and
128x128 for K1, 32 NYU frames of 640x480 for K6, then the same frames with
every hand moved out of view -- holds its zbuf and ids bitwise against
``rasterize.raster_scan`` and prints its mean device time
(``chip_smoke.time_ms``) beside the card's name and power limit.  The
face set-up and the tables are the library's own.  Exits non-zero without
a GPU or on a mismatch.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES_K1 = ((16, 16), (16, 8), (8, 16), (8, 8), (4, 16), (32, 2))
SHAPES_K6 = ((256, 1), (128, 1), (64, 1), (64, 2), (128, 2), (64, 4),
             (32, 2))
BATCH = 32


def build_variants(tmp):
    """The two sources with every shape instantiated, as two libraries."""
    from dsf_tpu_torch.kernels import build
    csrc = build.CSRC
    k1 = "".join(
        f'extern "C" int k1_{tx}x{ty}(const float* r, const float* b, '
        f'const float* c, const float* p, float* z, int32_t* i, int B, '
        f'int F, int H, int W, void* s) {{ return launch_raster_skip<{tx}, '
        f'{ty}>(r, b, c, p, z, i, B, F, H, W, s); }}\n'
        for tx, ty in SHAPES_K1)
    k6 = "".join(
        f'extern "C" int k6_{nt}x{s}(const float* r, const float* b, '
        f'const float* c, const float* p, float* z, int32_t* i, int B, '
        f'int F, int P, void* st) {{ return launch_raster_dense<{nt}, {s}>'
        f'(r, b, c, p, z, i, B, F, P, st); }}\n'
        for nt, s in SHAPES_K6)
    libs = {}
    procs = {}
    for name, src, body in (("k1", "raster_skip.cu", k1),
                            ("k6", "raster_dense.cu", k6)):
        path = os.path.join(tmp, name + ".cu")
        with open(path, "w") as f:
            f.write(f'#include "{os.path.join(csrc, src)}"\n{body}')
        out = os.path.join(tmp, name + ".so")
        procs[name] = (out, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (out, proc) in procs.items():
        msg = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} shapes:\n{msg}")
        libs[name] = ctypes.CDLL(out)
    return libs


def entry(lib, name, n_int):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * n_int + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main():
    import torch
    if not torch.cuda.is_available():
        print("raster_shapes_gpu: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.device import exact_float32
    from dsf_tpu_torch.mano import model as mano, synthetic
    from dsf_tpu_torch.ops import raster_kernel as rk
    from dsf_tpu_torch.ops import rasterize as ras
    from dsf_tpu_torch.render import renderer as rnd

    print(f"device: {cs.nvidia_smi_line()}", flush=True)
    bad = 0
    with tempfile.TemporaryDirectory() as tmp, exact_float32(), \
            torch.inference_mode():
        libs = build_variants(tmp)
        path = os.path.join(tmp, "mano_synthetic.npz")
        synthetic.save_synthetic_mano(path)
        renderer = rnd.Renderer.create(mano.load_model(path, device="cuda"),
                                       "nyu", demo.PARAS, (640, 480),
                                       (cs.INPUT_SIZE, cs.INPUT_SIZE))
        rng = np.random.RandomState(cs.SEED)
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

        def run(fn, tables, rays, z, i, *shape):
            return fn(*[t.data_ptr() for t in tables], rays.data_ptr(),
                      z.data_ptr(), i.data_ptr(), BATCH,
                      tables[0].shape[1], *shape, stream())

        def hold(label, fn, tables, rays, zp, ip, shape, iters):
            nonlocal bad
            z, i = torch.empty_like(zp), torch.empty_like(ip)
            if run(fn, tables, rays, z, i, *shape) != 0:
                raise RuntimeError(f"{label}: launch failed")
            torch.cuda.synchronize()
            same = torch.equal(z, zp) and torch.equal(i, ip)
            bad += not same
            ms = cs.time_ms(lambda: run(fn, tables, rays, z, i, *shape),
                            iters)
            print(f"{label}: bitwise {same}, {ms:.4f} ms", flush=True)

        for stride in (2, 1):
            proj, rays, faces, H, W = cs.raster_scene(renderer, BATCH, stride,
                                                      rng)
            tables = rk.face_setup_cuda(proj, faces.to(torch.int32))
            zp, ip = ras.raster_scan(proj, rays, faces)
            for tx, ty in SHAPES_K1:
                hold(f"K1 B={BATCH} {H}x{W}, {tx}x{ty} pixel tiles",
                     entry(libs["k1"], f"k1_{tx}x{ty}", 4), tables, rays, zp,
                     ip, (H, W), 50)

        Wf, Hf = renderer.img_size
        params = torch.from_numpy(cs.prerender_params(BATCH, rng)).cuda()
        verts, _ = mano.get_mano_vertices(renderer.mano,
                                          *mano.split_params(params))
        proj = ras.project_verts(verts, demo.PARAS)
        rays = ras.full_frame_pixel_rays((Wf, Hf), "cuda").expand(
            BATCH, -1, -1).contiguous()
        faces = renderer.mano.faces
        away = proj.clone()
        away[..., 0] += 5000.0
        for scene, pj in (("NYU frames", proj), ("frames without a hand", away)):
            tables = rk.face_setup_cuda(pj, faces.to(torch.int32),
                                        "raster_dense")
            zp, ip = ras.raster_scan(pj, rays, faces)
            for nt, s in SHAPES_K6:
                hold(f"K6 {BATCH} {scene} {Wf}x{Hf}, {nt} threads x {s} "
                     f"samples", entry(libs["k6"], f"k6_{nt}x{s}", 3),
                     tables, rays, zp, ip, (Wf * Hf,), 20)
    print(f"device: {cs.nvidia_smi_line()}; {bad} shapes disagreed")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
