#!/usr/bin/env python3
"""Time the K1, K6 and K10 raster kernels of dsf_tpu_torch at other block
shapes on one NVIDIA GPU, and with ``--parent DIR`` against an earlier
tree's.

    python3 scripts/raster_shapes_gpu.py [--parent DIR]   # from the repo root

The three are templates on their block shape
(``csrc/raster_skip.cu:raster_skip_kernel<TX, TY>``, a TX x TY pixel
tile; ``csrc/raster_dense.cu:raster_dense_kernel<NT, S>``, NT threads
over NT * S consecutive samples; ``csrc/raster_binned.cu:
raster_binned_kernel<TX, TY>``, a TX x TY block inside a 16x16 tile),
and the port's library builds one shape of each.  This script compiles
the three sources once more with every shape below instantiated (one
``nvcc -shared`` each, the library's flags, all at once), runs each on
chip_smoke.py's scenes -- B=32 posed hands' crops at 64x64 and 128x128
for K1 and K10 (K10 also on the 64x64 crops with the hands shrunk 5x,
whose tiles overflow, and with its overflow flag forced at both sizes),
32 NYU frames of 640x480 for K6, then the same frames with every hand
moved out of view -- holds its zbuf and ids bitwise against
``rasterize.raster_scan`` (K1, K6) or ``raster_binned_plain`` over
``binned_tables`` (K10) and prints its mean device time
(``chip_smoke.time_ms``) beside the card's name and power limit.  The
face set-up and the tables are the library's own.

With ``--parent DIR`` (an unpacked tree from before this K10, in a
git-ignored directory such as runs/) it also builds that tree's
``csrc/raster_skip.cu``, ``raster_dense.cu`` and ``raster_binned.cu`` as
they are and times each route against the library's in turns (parent,
library, library, parent): K1 and K6 as their set-up and raster, K10 as
the parent's PyTorch tables (its own ``ops/rasterize.py``'s ``face_rows``
and ``binned_tables``, loaded from DIR) and its kernel against the
library's set-up and raster, and both dense branches.  The parent's
answers are held against this tree's plain versions too.  Exits non-zero
without a GPU or on a mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES_K1 = ((16, 16), (16, 8), (8, 16), (8, 8), (4, 16), (32, 2))
SHAPES_K6 = ((256, 1), (128, 1), (64, 1), (64, 2), (128, 2), (64, 4),
             (32, 2))
SHAPES_K10 = ((4, 16), (8, 16), (16, 16), (16, 8), (8, 8), (16, 4), (4, 8),
              (2, 16))
BATCH = 32


def build_variants(tmp, parent):
    """The three sources with every shape instantiated, and the parent's
    three sources as they are, as libraries."""
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
    k10 = "".join(
        f'extern "C" int k10_{tx}x{ty}(const float* r, const float* b, '
        f'const float* c, const float* vb, const float* t, const float* p, '
        f'const int32_t* o, float* z, int32_t* i, int B, int F, int H, '
        f'int W, int sb, int sp, void* s) {{ return launch_raster_binned<'
        f'{tx}, {ty}>(r, b, c, vb, t, p, o, z, i, B, F, H, W, sb, sp, s); '
        f'}}\n' for tx, ty in SHAPES_K10)
    jobs = {}
    for name, src, body in (("k1", "raster_skip.cu", k1),
                            ("k6", "raster_dense.cu", k6),
                            ("k10", "raster_binned.cu", k10)):
        path = os.path.join(tmp, name + ".cu")
        with open(path, "w") as f:
            f.write(f'#include "{os.path.join(csrc, src)}"\n{body}')
        jobs[name] = (path, os.path.join(tmp, name + ".so"))
    if parent:
        for name in ("raster_skip", "raster_dense", "raster_binned"):
            jobs["parent_" + name] = (
                os.path.join(parent, "dsf_tpu_torch", "csrc", name + ".cu"),
                os.path.join(tmp, "parent_" + name + ".so"))
    procs = {n: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n, (src, out) in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        msg = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{msg}")
        libs[name] = ctypes.CDLL(jobs[name][1])
    return libs


def entry(lib, name, n_ptr, n_int):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def candidates(kind, shapes, unit):
    """(entry name, label) of every shape."""
    return [(f"{kind}_{a}x{b}", f"{a}x{b} {unit}") for a, b in shapes]


def parent_rasterize(parent):
    """The parent tree's ops/rasterize.py as a module of its own (its
    ``face_rows`` and ``binned_tables`` are plain PyTorch)."""
    spec = importlib.util.spec_from_file_location(
        "parent_rasterize",
        os.path.join(parent, "dsf_tpu_torch", "ops", "rasterize.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an unpacked earlier tree to time "
                    "against")
    args = ap.parse_args()
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
        libs = build_variants(tmp, args.parent)
        path = os.path.join(tmp, "mano_synthetic.npz")
        synthetic.save_synthetic_mano(path)
        renderer = rnd.Renderer.create(mano.load_model(path, device="cuda"),
                                       "nyu", demo.PARAS, (640, 480),
                                       (cs.INPUT_SIZE, cs.INPUT_SIZE))
        rng = np.random.RandomState(cs.SEED)
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

        def hold(label, run, zp, ip, iters):
            """``run(z, i)`` fills z and i; held bitwise against (zp, ip)
            and timed."""
            nonlocal bad
            z, i = torch.empty_like(zp), torch.empty_like(ip)
            if run(z, i) != 0:
                raise RuntimeError(f"{label}: launch failed")
            torch.cuda.synchronize()
            same = torch.equal(z, zp) and torch.equal(i, ip)
            bad += not same
            ms = cs.time_ms(lambda: run(z, i), iters)
            print(f"{label}: bitwise {same}, {ms:.4f} ms", flush=True)

        def turns(label, parent_fn, lib_fn, iters):
            """Parent, library, library, parent, in one call."""
            ts = [cs.time_ms(fn, iters)
                  for fn in (parent_fn, lib_fn, lib_fn, parent_fn)]
            print(f"{label} parent, library, library, parent: "
                  + ", ".join(f"{t:.4f}" for t in ts) + " ms; parent mean "
                  f"{(ts[0] + ts[3]) / 2:.4f}, library mean "
                  f"{(ts[1] + ts[2]) / 2:.4f}", flush=True)

        if args.parent:
            pras = parent_rasterize(args.parent)
            p_setup = {n: entry(libs["parent_" + n], f"dsf_{n}_setup", 5, 3)
                       for n in ("raster_skip", "raster_dense")}
            p_skip = entry(libs["parent_raster_skip"], "dsf_raster_skip", 6,
                           4)
            p_dense = entry(libs["parent_raster_dense"], "dsf_raster_dense",
                            6, 3)
            p_binned = entry(libs["parent_raster_binned"],
                             "dsf_raster_binned", 7, 5)

            def parent_tables(lib, proj, f32):
                B, V, F = proj.shape[0], proj.shape[1], f32.shape[0]
                t = (torch.empty((B, F, 16), device="cuda"),
                     torch.empty((B, F, 4), device="cuda"),
                     torch.empty((B, -(-F // rk.CHUNK), 4), device="cuda"))
                err = p_setup[lib](proj.data_ptr(), f32.data_ptr(),
                                   *[x.data_ptr() for x in t], B, V, F,
                                   stream())
                if err:
                    raise RuntimeError(f"parent {lib} set-up: error {err}")
                return t

            def parent_raster(fn, tables, pix, z, i, *shape):
                err = fn(*[t.data_ptr() for t in tables], pix.data_ptr(),
                         z.data_ptr(), i.data_ptr(), BATCH,
                         tables[0].shape[1], *shape, stream())
                if err:
                    raise RuntimeError(f"parent raster: error {err}")

        def k10_scenes():
            for stride in (2, 1):
                proj, rays, faces, H, W = cs.raster_scene(renderer, BATCH,
                                                          stride, rng)
                yield f"{H}x{W}", proj, rays, faces, (H, W)
                if stride == 2:
                    small = proj.clone()
                    mid = small[..., :2].mean(1, keepdim=True)
                    small[..., :2] = mid + (small[..., :2] - mid) * 0.2
                    yield f"{H}x{W} shrunk 5x", small, rays, faces, (H, W)

        for scene, proj, rays, faces, hw in k10_scenes():
            H, W = hw
            f32 = faces.to(torch.int32)
            # K1 on the hands' crops (not the shrunk ones: chip_smoke's)
            zs, i_s = ras.raster_scan(proj, rays, faces)
            if "shrunk" not in scene:
                tables = rk.face_setup_cuda(proj, f32)
                for name, what in candidates("k1", SHAPES_K1, "pixel tiles"):
                    fn = entry(libs["k1"], name, 6, 4)
                    hold(f"K1 B={BATCH} {scene}, {what}",
                         lambda z, i, fn=fn: fn(
                             *[t.data_ptr() for t in tables], rays.data_ptr(),
                             z.data_ptr(), i.data_ptr(), BATCH,
                             tables[0].shape[1], H, W, stream()),
                         zs, i_s, 50)
            # K10 on its own lists, and with the overflow flag forced
            t = rk.binned_setup_cuda(proj, faces, rays, hw)
            rows = ras.face_rows(proj, faces)
            lists, counts, overflow = ras.binned_tables(proj, rays, faces,
                                                        hw, rows)
            zb, ib = ras.raster_binned_plain(rows, rays, hw, lists, counts,
                                             overflow)
            forced = torch.ones_like(t.overflow)
            print(f"K10 B={BATCH} {scene}: overflow {int(overflow)}, faces "
                  f"per tile max {int(counts.max())}", flush=True)
            sb, sp = rays.stride(0), rays.stride(1)
            for name, shape in candidates("k10", SHAPES_K10, "blocks"):
                fn = entry(libs["k10"], name, 9, 6)
                for flag, want, what in ((t.overflow, (zb, ib), "lists"),
                                         (forced, (zs, i_s), "dense")):
                    hold(f"K10 B={BATCH} {scene}, {what}, {shape}",
                         lambda z, i, fn=fn, flag=flag: fn(
                             t.rows.data_ptr(), t.boxes.data_ptr(),
                             t.cbox.data_ptr(), t.vbox.data_ptr(),
                             t.tbox.data_ptr(),
                             rays.data_ptr(), flag.data_ptr(), z.data_ptr(),
                             i.data_ptr(), BATCH, t.rows.shape[1], H, W, sb,
                             sp, stream()), *want, 50)
            lib_route = lambda: rk.raster_binned_cuda(  # noqa: E731
                proj, faces, rays, hw)
            setup_ms = cs.time_ms(
                lambda: rk.binned_setup_cuda(proj, faces, rays, hw), 50)
            print(f"K10 B={BATCH} {scene}: library set-up {setup_ms:.4f} ms, "
                  f"route {cs.time_ms(lib_route, 50):.4f} ms", flush=True)
            if not args.parent:
                continue
            # the parent's K10 route: its PyTorch tables and its kernel
            z, i = torch.empty_like(zb), torch.empty_like(ib)

            def parent_route(flag=None):
                prow = pras.face_rows(proj, faces)
                pl, pc, po = pras.binned_tables(proj, rays, faces, hw, prow)
                err = p_binned(prow.data_ptr(), rays.data_ptr(),
                               pl.data_ptr(), pc.data_ptr(),
                               (po if flag is None else flag).data_ptr(),
                               z.data_ptr(), i.data_ptr(), BATCH,
                               prow.shape[1], H, W, pl.shape[-1], stream())
                if err:
                    raise RuntimeError(f"parent K10: error {err}")
            parent_route()
            torch.cuda.synchronize()
            same = torch.equal(z, zb) and torch.equal(i, ib)
            print(f"K10 parent route B={BATCH} {scene}: bitwise this tree's "
                  f"plain version {same}", flush=True)
            turns(f"K10 route B={BATCH} {scene}", parent_route, lib_route,
                  50)
            prow = pras.face_rows(proj, faces)
            pl, pc, _ = pras.binned_tables(proj, rays, faces, hw, prow)

            def parent_kernel(flag):
                err = p_binned(prow.data_ptr(), rays.data_ptr(),
                               pl.data_ptr(), pc.data_ptr(), flag.data_ptr(),
                               z.data_ptr(), i.data_ptr(), BATCH,
                               prow.shape[1], H, W, pl.shape[-1], stream())
                if err:
                    raise RuntimeError(f"parent K10: error {err}")
            turns(f"K10 dense branch B={BATCH} {scene}",
                  lambda: parent_kernel(forced),
                  lambda: rk.raster_binned_launch(
                      t.rows, t.boxes, t.cbox, t.vbox, t.tbox, rays, forced,
                      hw), 50)
            if "shrunk" in scene:
                continue
            # the parent's K1 route, its set-up and raster
            zk, ik = torch.empty_like(zs), torch.empty_like(i_s)

            def parent_k1():
                parent_raster(p_skip, parent_tables("raster_skip", proj, f32),
                              rays, zk, ik, H, W)
            parent_k1()
            torch.cuda.synchronize()
            print(f"K1 parent route B={BATCH} {scene}: bitwise this tree's "
                  f"raster_scan {torch.equal(zk, zs) and torch.equal(ik, i_s)}",
                  flush=True)
            turns(f"K1 route B={BATCH} {scene}", parent_k1,
                  lambda: rk.raster_skip_cuda(proj, f32, rays, hw), 50)

        Wf, Hf = renderer.img_size
        params = torch.from_numpy(cs.prerender_params(BATCH, rng)).cuda()
        verts, _ = mano.get_mano_vertices(renderer.mano,
                                          *mano.split_params(params))
        proj = ras.project_verts(verts, demo.PARAS)
        rays = ras.full_frame_pixel_rays((Wf, Hf), "cuda").expand(
            BATCH, -1, -1).contiguous()
        faces = renderer.mano.faces
        f32 = faces.to(torch.int32)
        away = proj.clone()
        away[..., 0] += 5000.0
        for scene, pj in (("NYU frames", proj), ("frames without a hand", away)):
            tables = rk.face_setup_cuda(pj, f32, "raster_dense")
            zp, ip = ras.raster_scan(pj, rays, faces)
            for name, what in candidates("k6", SHAPES_K6, "threads x samples"):
                fn = entry(libs["k6"], name, 6, 3)
                hold(f"K6 {BATCH} {scene} {Wf}x{Hf}, {what}",
                     lambda z, i, fn=fn: fn(
                         *[t.data_ptr() for t in tables], rays.data_ptr(),
                         z.data_ptr(), i.data_ptr(), BATCH,
                         tables[0].shape[1], Wf * Hf, stream()),
                     zp, ip, 20)
            if args.parent:
                zd, i_d = torch.empty_like(zp), torch.empty_like(ip)

                def parent_k6():
                    parent_raster(p_dense,
                                  parent_tables("raster_dense", pj, f32),
                                  rays, zd, i_d, Wf * Hf)
                parent_k6()
                torch.cuda.synchronize()
                print(f"K6 parent route {BATCH} {scene}: bitwise this "
                      f"tree's raster_scan "
                      f"{torch.equal(zd, zp) and torch.equal(i_d, ip)}",
                      flush=True)
                turns(f"K6 route {BATCH} {scene}", parent_k6,
                      lambda: rk.raster_dense_cuda(pj, f32, rays), 20)
    print(f"device: {cs.nvidia_smi_line()}; {bad} shapes disagreed")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
