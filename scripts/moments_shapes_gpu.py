#!/usr/bin/env python3
"""Time K2, the raster-backward moments of dsf_tpu_torch, at other layouts
and designs on one NVIDIA GPU.

    python3 scripts/moments_shapes_gpu.py [--parent DIR]   # from the repo root

The library's design (a) is a template in ``csrc/moments.cu``
(``dsf_moments::launch<WARPS, U>``, the split CTAs of an image a cluster)
and the library builds one layout of it.  ``moments_shapes_gpu.cu``
beside this script includes that source and adds design (b), face-major
(a range kernel, then one warp a face adding its rows in pixel order);
this script instantiates every layout below, compiles it once (one
``nvcc -shared``, the library's flags) and runs each on:

* the shapes ``chip_smoke.py`` times: B=32 rendered hands at 64x64 and
  128x128 (K1's ids, a random cotangent);
* the shapes the FinetuneStage step really hands K2: one step at full
  width (B=32, 128x128, the stand-in generator) with the wrapper
  recording its inputs (B, P, T and the covered share are printed);
* one face covering every pixel of B=32 images of 128x128, and random
  ids (some out of range) at B=4, P=4096 (edge cases, not in the sums).

Layouts: (a) WARPS 4 or 8 a CTA, U rounds of 32 units loaded before they
are added, with or without the next step's loads issued before the
current step's adds, split 1, 2, 4 or 8 CTAs an image, 16-byte or 4-byte
loads;
(b) 4 or 8 warps a block.  Each is held against float64 (the worst
|error| / sum |rows| of a face, 2e-5 at most, printed beside the 1.35e-07
the direct port reached), run twice (bitwise), and (b) also bitwise
against ``face_moments_plain`` on the CPU.  The library's own layout is
held bitwise against its instantiation here.  Yardsticks: ``index_add_``
of the same rows (``chip_smoke.py``'s), and with ``--parent DIR`` (an
unpacked earlier tree) that tree's K2, timed in turns with the library's
(parent, library, library, parent).  Times are ``chip_smoke.time_ms``
means, warm (the same inputs) and cold (``time_cold_ms``).  Prints the
card's name and power limit; exits non-zero without a GPU or on a
mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# design (a): (warps a CTA, rounds a step, the next step's loads issued
# before the current step's adds)
A_SHAPES = ((4, 1, 0), (4, 1, 1), (4, 2, 1), (8, 1, 0), (8, 1, 1),
            (8, 2, 0), (8, 2, 1), (8, 4, 0))
SPLITS = (1, 2, 4, 8)
B_WARPS = (4, 8)
LIB = (8, 1, 1, 2)          # csrc kWarps, kRounds, kPrefetch, kSplit
SMOKE_B = 32
WHOLE_S = 128


def build_variants(tmp, parent):
    from dsf_tpu_torch.kernels import build
    aa = ("const int* i, const float* u, float* o, int B, int P, int T, "
          "int split, int vec, void* s")
    ba = ("const int* i, const float* u, float* o, unsigned* r, int B, "
          "int P, int T, void* s")
    body = "".join(
        f'extern "C" int a_{w}_{u}_{pf}({aa}) {{ return '
        f'dsf_moments::candidate<{w}, {u}, {"true" if pf else "false"}>(i, u, '
        f'o, B, P, T, split, vec, s); }}\n' for w, u, pf in A_SHAPES)
    body += "".join(
        f'extern "C" int b_{w}({ba}) {{ return '
        f'dsf_moments::range_candidate<{w}>(i, u, o, r, B, P, T, s); }}\n'
        for w in B_WARPS)
    path = os.path.join(tmp, "k2.cu")
    cand = os.path.join(ROOT, "scripts", "moments_shapes_gpu.cu")
    with open(path, "w") as f:
        f.write(f'#include "{cand}"\n{body}')
    jobs = {"k2": (path, os.path.join(tmp, "k2.so"))}
    if parent:
        jobs["parent"] = (os.path.join(parent, "dsf_tpu_torch", "csrc",
                                       "moments.cu"),
                          os.path.join(tmp, "parent.so"))
    procs = {n: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
         src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n, (src, out) in jobs.items()}
    libs, msgs = {}, {}
    for n, proc in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}:\n{text}")
        libs[n], msgs[n] = ctypes.CDLL(jobs[n][1]), text
    return libs, msgs


def typed(fn, n_ptr, n_int):
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def smoke_case(renderer, stride, rng):
    """``chip_smoke.check_moments``'s inputs: K1's ids of B=32 posed
    hands, the rows the raster backward builds from a random cotangent."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from dsf_tpu_torch.ops import raster_kernel
    proj, rays, faces, H, W = cs.raster_scene(renderer, SMOKE_B, stride, rng)
    _, idx = raster_kernel.raster_skip_cuda(proj, faces.to(torch.int32), rays,
                                            (H, W))
    g = torch.from_numpy(rng.randn(SMOKE_B, H * W).astype(np.float32)).cuda()
    gm = g * (idx >= 0).float()
    upd = torch.stack([gm, gm * rays[..., 0], gm * rays[..., 1]],
                      -1).contiguous()
    return idx.contiguous(), upd, int(faces.shape[0])


def step_cases(mano_path):
    """K2's inputs in one FinetuneStage step at full width (the wrapper's
    arguments, cloned)."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.data.synth_params import random_param_source
    from dsf_tpu_torch.ops import moments_kernel
    from dsf_tpu_torch.training.trainer import Trainer

    tr = Trainer(cs.train_config(mano_path, 2, cs.SEED), mano_path,
                 device="cuda")
    state = tr.init_state()
    src = random_param_source(cs.TRAIN_BATCH, seed=cs.SEED + 5)
    rng = np.random.RandomState(cs.SEED + 6)
    batch = dict(zip(("model_para", "cube_synth"), next(src)),
                 **demo.real_batch(tr.renderer, cs.TRAIN_BATCH, rng))
    seen = []
    kernel = moments_kernel.face_moments_cuda

    def recording(idx, upd, T):
        seen.append((idx.clone(), upd.clone(), T))
        return kernel(idx, upd, T)

    moments_kernel.face_moments_cuda = recording
    try:
        tr.train_step_fn("FinetuneStage")(
            state, tr.draw(cs.TRAIN_BATCH, "FinetuneStage"), batch)
        torch.cuda.synchronize()
    finally:
        moments_kernel.face_moments_cuda = kernel
    del tr, state
    return seen


def main():
    import numpy as np
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an unpacked earlier tree to time "
                    "against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("moments_shapes_gpu: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.device import exact_float32
    from dsf_tpu_torch.mano import model as mano, synthetic
    from dsf_tpu_torch.ops import moments_kernel
    from dsf_tpu_torch.render import renderer as rnd

    print(f"device: {cs.nvidia_smi_line()}", flush=True)
    bad = 0
    rng = np.random.RandomState(cs.SEED)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp, exact_float32():
        libs, msgs = build_variants(tmp, args.parent)
        for n, text in msgs.items():
            entry = ""
            for line in text.splitlines():
                if "Compiling entry" in line:
                    entry = line.split("'")[1]
                elif "registers" in line or "spill" in line:
                    print(f"  ptxas {n} {entry}: "
                          f"{line.split(':', 1)[-1].strip()}", flush=True)
        lib = libs["k2"]
        afn = {s: typed(getattr(lib, f"a_{s[0]}_{s[1]}_{s[2]}"), 3, 5)
               for s in A_SHAPES}
        bfn = {w: typed(getattr(lib, f"b_{w}"), 4, 3) for w in B_WARPS}

        path = os.path.join(tmp, "mano_synthetic.npz")
        synthetic.save_synthetic_mano(path)
        renderer = rnd.Renderer.create(mano.load_model(path, device="cuda"),
                                       "nyu", demo.PARAS, (640, 480),
                                       (cs.INPUT_SIZE, cs.INPUT_SIZE))
        cases = {}
        with torch.inference_mode():
            cases["smoke 64^2"] = smoke_case(renderer, 2, rng)
            cases["smoke 128^2"] = smoke_case(renderer, 1, rng)
        for i, c in enumerate(step_cases(path)):
            B, P = c[0].shape
            cases[f"step {i}: B={B} {int(round(P ** 0.5))}^2"] = c
        T = cases["smoke 64^2"][2]
        whole = torch.zeros((SMOKE_B, WHOLE_S ** 2), dtype=torch.int32,
                            device=dev)
        cases["one face, whole image"] = (
            whole, torch.from_numpy(rng.randn(SMOKE_B, WHOLE_S ** 2, 3)
                                    .astype(np.float32)).to(dev), T)
        cases["random ids"] = (
            torch.from_numpy(rng.randint(-1, T + 3, (4, 4096))
                             .astype(np.int32)).to(dev),
            torch.from_numpy(rng.randn(4, 4096, 3).astype(np.float32))
            .to(dev), T)
        main_cases = [k for k in cases if k.startswith(("smoke", "step"))]

        rows = {}
        with torch.inference_mode():
            for name, (idx, upd, T) in cases.items():
                B, P = idx.shape
                hits = int(((idx >= 0) & (idx < T)).sum())
                ref = moments_kernel.face_moments_plain(idx, upd.double(), T)
                absum = moments_kernel.face_moments_plain(
                    idx, upd.abs().double(), T)
                cpu = moments_kernel.face_moments_plain(idx.cpu(), upd.cpu(),
                                                        T)
                # chip_smoke.check_moments's call: the rows of pixels
                # without a face (zero there) go to their image's face 0
                valid = (idx >= 0) & (idx < T)
                flat = (torch.where(valid, idx.long(), 0)
                        + torch.arange(B, device=dev)[:, None] * T
                        ).reshape(-1)
                frows = (upd * valid[..., None]).reshape(-1, 3)
                lib_ms = cs.time_ms(lambda: torch.zeros(
                    (B * T, 3), device=dev).index_add_(0, flat, frows), 50)
                copies = cs.copies_past_l2((idx, upd))
                print(f"{name}: B={B} P={P} T={T}, covered pixels {hits} "
                      f"({hits / (B * P):.3f}); index_add_ {lib_ms:.4f} ms; "
                      f"cold copies {len(copies)}", flush=True)
                lib_out = moments_kernel.face_moments_cuda(idx, upd, T)
                cands = [("a",) + s + (sp, v) for s in A_SHAPES
                         for sp in SPLITS for v in (1, 0)]
                cands += [("b", w) for w in B_WARPS]
                for cand in cands:
                    out = torch.empty((B, T, 3), device=dev)
                    if cand[0] == "a":
                        _, w, u, pf, sp, v = cand
                        fn = afn[(w, u, pf)]

                        def run(i, r, *_):
                            err = fn(i.data_ptr(), r.data_ptr(),
                                     out.data_ptr(), B, P, T, sp, v, stream)
                            if err:
                                raise RuntimeError(f"{cand}: error {err}")
                        label = (f"(a) {w} warps, {u} rounds a step"
                                 f"{', prefetched' if pf else ''}, split "
                                 f"{sp}, {'16' if v else '4'}-byte loads")
                    else:
                        fn = bfn[cand[1]]
                        scratch = torch.empty(B * T * 2, dtype=torch.int32,
                                              device=dev)

                        def run(i, r, *_):
                            err = fn(i.data_ptr(), r.data_ptr(),
                                     out.data_ptr(), scratch.data_ptr(), B,
                                     P, T, stream)
                            if err:
                                raise RuntimeError(f"{cand}: error {err}")
                        label = f"(b) {cand[1]} warps a block"
                    run(idx, upd)
                    first = out.clone()
                    run(idx, upd)
                    torch.cuda.synchronize()
                    worst = float(((out.double() - ref).abs()
                                   / (absum + 1e-30)).max())
                    repeat = torch.equal(first, out)
                    exact = torch.equal(out.cpu(), cpu)
                    held = worst <= 2e-5 and repeat and (
                        cand[0] == "a" or exact)
                    same = ""
                    if cand == ("a",) + LIB + (1,):
                        same = (", bitwise the library's: "
                                f"{torch.equal(out, lib_out)}")
                        bad += not torch.equal(out, lib_out)
                    bad += not held
                    warm = cs.time_ms(lambda: run(idx, upd), 50)
                    cold = cs.time_cold_ms(run, copies, 50)
                    rows.setdefault(cand, {})[name] = (warm, cold)
                    print(f"K2 {name} {label}: held {held}, worst / "
                          f"sum|rows| {worst:.3g}, two runs bitwise {repeat},"
                          f" bitwise the CPU plain {exact}{same}; warm "
                          f"{warm:.4f} ms, cold {cold:.4f} ms", flush=True)

                if args.parent:
                    pf = typed(libs["parent"].dsf_raster_moments, 3, 3)
                    pout = torch.empty((B, T, 3), device=dev)

                    def parent(i, r, *_):
                        pf(i.data_ptr(), r.data_ptr(), pout.data_ptr(), B, P,
                           T, stream)

                    def library(i, r, *_):
                        moments_kernel.face_moments_cuda(i, r, T)

                    times = [(cs.time_ms(lambda: fn(idx, upd), 50),
                              cs.time_cold_ms(fn, copies, 50))
                             for fn in (parent, library, library, parent)]
                    print(f"K2 {name} parent, library, library, parent: warm "
                          f"{', '.join(f'{w:.4f}' for w, _ in times)} ms; "
                          f"cold {', '.join(f'{c:.4f}' for _, c in times)} "
                          "ms", flush=True)
                del copies

    print("fastest layouts, summed warm ms over " + "; ".join(main_cases)
          + ":")
    sums = sorted((sum(v[k][0] for k in main_cases), c)
                  for c, v in rows.items() if all(k in v for k in main_cases))
    for t, c in sums[:8]:
        print(f"  {c}: {t:.4f} ms ("
              + ", ".join(f"{rows[c][k][0]:.4f}" for k in main_cases) + ")",
              flush=True)
    for name in cases:
        best = sorted((v[name][0], c) for c, v in rows.items() if name in v)
        print(f"  {name}: " + "; ".join(f"{c} {t:.4f}" for t, c in best[:3]),
              flush=True)
    print(f"device: {cs.nvidia_smi_line()}; {bad} layouts disagreed")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
