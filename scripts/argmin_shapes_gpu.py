#!/usr/bin/env python3
"""Time the K3, K8 and K7 argmin kernels of dsf_tpu_torch at other block
shapes on one NVIDIA GPU.

    python3 scripts/argmin_shapes_gpu.py     # from the root of the repository

Both kernels instantiate one body (``csrc/argmin_body.cuh:argmin_kernel<
Form, THREADS, R, GROUPS>``: GROUPS groups of THREADS threads a block, each
group walking a segment of the tile's face list, R points a thread, so a
tile holds THREADS x R points of one part), and the port's libraries build
one shape of each.  This script compiles the two sources once more with every
shape below instantiated (one ``nvcc -shared`` each, the library's flags),
builds the set-up's tables for each shape's tile with the library's set-up
kernel, and runs each shape on chip_smoke.py's ICP scene (the FinetuneStage
step's 128 clouds x 2048 points x 1554 faces).  Each shape is held against
the plain dense argmin by the exact distance of its winning faces (1e-5
relative + 1e-6), with (1e10, 0) -- K8: (1e10, perm[0]) -- where no face is
admissible, and K3's results also bitwise against the library's own K3 (the
same arithmetic in the same face order).  It prints each shape's mean device
time (``chip_smoke.time_ms``) and the pair slots it evaluates beside the
card's name and power limit, and the opcodes of the library's K3 inner
loop (``cuobjdump -sass``: the innermost loop that loads a face row).

K7 has its own body (``argmin_body.cuh:argmin_v2_kernel<THREADS, R, GROUPS,
SELECT>``) over its own tables (``v2_setup_cuda``: tiles of 128 points in
the caller's order, so THREADS x R = 128); SELECT computes every pair a
warp does not skip and selects its admissibility in, else a branch per
pair.  Each K7 shape, with either, is held as K3's against the plain dense
argmin (the caller's face ids; (1e10, the first face in the part order)
where no face is admissible) and bitwise against the library's K7, and
printed with its time, its pair slots (``chip_smoke.v2_slots``) and the
opcodes of the library's K7 inner loop.  Exits non-zero without a GPU or
on a mismatch.
"""

from __future__ import annotations

import collections
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (threads a group, points a thread, groups a block)
SHAPES = ((128, 2, 1), (128, 1, 1), (64, 2, 4), (64, 2, 2), (64, 2, 8),
          (128, 2, 2), (128, 2, 4), (64, 4, 4), (32, 4, 4), (32, 2, 8),
          (64, 1, 4), (64, 3, 4))
# K7: (threads a group, points a thread, groups a block), 128 points a tile
V2_SHAPES = ((128, 1, 1), (128, 1, 2), (128, 1, 4), (64, 2, 1), (64, 2, 2),
             (64, 2, 4), (64, 2, 8), (32, 4, 2), (32, 4, 4), (32, 4, 8))
BATCH = 64                  # chip_smoke.py's scene: 2 x BATCH clouds


def build_variants(tmp):
    """The two sources with every shape instantiated, as two libraries."""
    from dsf_tpu_torch.kernels import build
    args = ("const float* pt, const float* rw, const int32_t* ls, "
            "const int32_t* ln, const int32_t* co, const int32_t* fp, "
            "const int32_t* pm, const int32_t* tl, const int32_t* tc, "
            "float* dm, int32_t* im, int N, int P, int T, int mT, void* s")
    call = "(pt, rw, ls, ln, co, fp, pm, tl, tc, dm, im, N, P, T, mT, s)"
    libs, procs = {}, {}
    for name, src, form in (("k3", "point_mesh.cu", "Form27"),
                            ("k8", "point_mesh_culled.cu", "Form16")):
        body = "".join(
            f'extern "C" int {name}_{t}x{r}x{g}({args}) {{ return '
            f'dsf_argmin::launch_argmin<dsf_argmin::{form}, {t}, {r}, {g}>'
            f'{call}; }}\n' for t, r, g in SHAPES)
        path = os.path.join(tmp, name + ".cu")
        with open(path, "w") as f:
            f.write(f'#include "{os.path.join(build.CSRC, src)}"\n{body}')
        out = os.path.join(tmp, name + ".so")
        procs[name] = (out, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    v2_args = ("const float* pt, const float* rw, const int32_t* wd, "
               "const int32_t* pa, const int32_t* sk, const int32_t* fp, "
               "float* dm, int32_t* im, int N, int P, int T, void* s")
    body = "".join(
        f'extern "C" int k7_{t}x{r}x{g}_{int(sel)}({v2_args}) {{ return '
        f'dsf_argmin::launch_argmin_v2<{t}, {r}, {g}, '
        f'{"true" if sel else "false"}>(pt, rw, wd, pa, sk, fp, dm, im, N, '
        f'P, T, s); }}\n' for t, r, g in V2_SHAPES for sel in (True, False))
    path = os.path.join(tmp, "k7.cu")
    with open(path, "w") as f:
        f.write(f'#include "{os.path.join(build.CSRC, "point_mesh_v2.cu")}"'
                f'\n{body}')
    out = os.path.join(tmp, "k7.so")
    procs["k7"] = (out, subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (out, proc) in procs.items():
        msg = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} shapes:\n{msg}")
        libs[name] = ctypes.CDLL(out)
    return libs


def inner_loop_opcodes(so_path, kernel):
    """The opcode counts of an argmin body's per-face loop in the library
    ``so_path``: of the loops (backward branches) of the kernel whose name
    holds every string of ``kernel`` and whose body loads a whole 28-float
    row (7 LDS.128), the shortest."""
    from dsf_tpu_torch.kernels import build
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so_path], capture_output=True,
                          text=True, check=True).stdout
    funcs = sass.split("Function : ")
    body = next(f for f in funcs
                if all(k in f.split("\n")[0] for k in kernel))
    ops = []
    for line in body.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z0-9_.]+)(.*)", line)
        if m:
            ops.append((int(m.group(1), 16), m.group(2), m.group(3)))
    best = None
    for off, op, rest in ops:
        target = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") \
            else None
        if target is None or int(target.group(1), 16) >= off:
            continue
        loop = [o for a, o, _ in ops if int(target.group(1), 16) <= a <= off]
        if sum(o == "LDS.128" for o in loop) >= 7 and (
                best is None or len(loop) < len(best)):
            best = loop
    return collections.Counter(o.split(".")[0] for o in best or [])


def entry(lib, name):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main():
    import torch
    if not torch.cuda.is_available():
        print("argmin_shapes_gpu: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.device import exact_float32
    from dsf_tpu_torch.mano import model as mano, synthetic
    from dsf_tpu_torch.ops import point_mesh as pm
    from dsf_tpu_torch.ops import point_mesh_kernel as pk
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
        sc = cs.icp_scene(renderer, BATCH, np.random.RandomState(cs.SEED))
        pts, tris, table, part = sc["pts"], sc["tris"], sc["table"], sc["part"]
        N, P, T = sc["N"], sc["P"], sc["T"]
        dp, _ = pm.argmin_faces_plain(pts, tris, table, part)
        none = dp >= 1e10
        ref3 = pk.argmin_faces_cuda(pts, tris, table, part)
        perm0 = int(pm.face_part_perm(table)[0])
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

        def run(fn, tb, d, i):
            ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
            return fn(pts.data_ptr(), tb.rows.data_ptr(), tb.lists.data_ptr(),
                      tb.lens.data_ptr(), tb.choff.data_ptr(), ptr(tb.fperm),
                      tb.perm.data_ptr(), tb.tiles.data_ptr(),
                      tb.tcount.data_ptr(), d.data_ptr(), i.data_ptr(), N, P,
                      T, tb.tiles.shape[1], stream())

        for name, culled in (("k3", False), ("k8", True)):
            for t, r, g in SHAPES:
                tb = pk.argmin_setup_cuda(pts, tris, table, part,
                                          culled=culled, tile=t * r)
                fn = entry(libs[name], f"{name}_{t}x{r}x{g}")
                d = torch.empty_like(dp)
                i = torch.empty((N, P), dtype=torch.int32, device=pts.device)
                if run(fn, tb, d, i) != 0:
                    raise RuntimeError(f"{name} {t}x{r}x{g}: launch failed")
                torch.cuda.synchronize()
                win = torch.gather(tris, 1, i.long()[..., None, None]
                                   .expand(N, P, 3, 3))
                dw = pm.point_tri_sqdist(pts, win)
                held = bool(((dw - dp).abs() <= 1e-5 * dp.abs() + 1e-6)
                            [~none].all())
                held &= bool((d[none] >= 1e10).all()) and bool(
                    (i[none] == (perm0 if culled else 0)).all())
                same = "" if culled else (
                    f", bitwise the library's K3: "
                    f"{torch.equal(d, ref3[0]) and torch.equal(i, ref3[1])}")
                bad += not held
                slots, real = cs.argmin_slots(tb, r)
                ms = cs.time_ms(lambda: run(fn, tb, d, i), 20)
                print(f"{'K3' if name == 'k3' else 'K8'} {N} clouds x {P} "
                      f"points x {T} faces, {g} groups of {t} threads x {r} "
                      f"points: held "
                      f"{held}{same}; pair slots {slots} (padding "
                      f"{1 - real / slots:.4f}, admissible pairs "
                      f"{sc['pairs']}), {ms:.4f} ms", flush=True)
        ref7 = pk.argmin_faces_v2_cuda(pts, tris, table, part)
        tb7 = pk.v2_setup_cuda(pts, tris, table, part)
        fperm0 = int(tb7.fperm[0])
        for (t, r, g), sel in ((shape, sel) for shape in V2_SHAPES
                               for sel in (True, False)):
            fn = getattr(libs["k7"], f"k7_{t}x{r}x{g}_{int(sel)}")
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            d = torch.empty_like(dp)
            i = torch.empty((N, P), dtype=torch.int32, device=pts.device)

            def run7():
                return fn(pts.data_ptr(), tb7.rows.data_ptr(),
                          tb7.words.data_ptr(), tb7.parts.data_ptr(),
                          tb7.skip.data_ptr(), tb7.fperm.data_ptr(),
                          d.data_ptr(), i.data_ptr(), N, P, T, stream())
            if run7() != 0:
                raise RuntimeError(f"k7 {t}x{r}x{g}: launch failed")
            torch.cuda.synchronize()
            win = torch.gather(tris, 1, i.long()[..., None, None]
                               .expand(N, P, 3, 3))
            dw = pm.point_tri_sqdist(pts, win)
            held = bool(((dw - dp).abs() <= 1e-5 * dp.abs() + 1e-6)
                        [~none].all())
            held &= bool((d[none] >= 1e10).all()) and bool(
                (i[none] == fperm0).all())
            bad += not held
            same = torch.equal(d, ref7[0]) and torch.equal(i, ref7[1])
            slots, real = cs.v2_slots(tb7, r)
            ms = cs.time_ms(run7, 20)
            print(f"K7 {N} clouds x {P} points x {T} faces, {g} groups "
                  f"of {t} threads x {r} points, "
                  f"{'select' if sel else 'branch'}: held {held}, "
                  f"bitwise the library's K7: {same}; pair slots {slots} "
                  f"(the run blocks' pairs {real}, admissible pairs "
                  f"{sc['pairs']}), {ms:.4f} ms", flush=True)
    from dsf_tpu_torch.kernels import build
    ops = inner_loop_opcodes(build._lib_path("point_mesh"),
                             ("argmin_kernel", "Form27"))
    print(f"K3 inner loop (the library's {pk.THREADS} threads x "
          f"{pk.POINTS_PER_THREAD} points a face): {sum(ops.values())} "
          f"instructions, {dict(ops.most_common())}", flush=True)
    ops = inner_loop_opcodes(build._lib_path("point_mesh_v2"),
                             ("argmin_v2_kernel",))
    print(f"K7 inner loop (the library's {pk.V2_THREADS} threads x "
          f"{pk.V2_POINTS_PER_THREAD} points a face): {sum(ops.values())} "
          f"instructions, {dict(ops.most_common())}", flush=True)
    print(f"device: {cs.nvidia_smi_line()}; {bad} shapes disagreed")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
