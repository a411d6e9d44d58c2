#!/usr/bin/env python3
"""Time K4, the offset-codec decode of dsf_tpu_torch (forward and VJP),
and K5 bwd, the encode VJP, at other layouts on one NVIDIA GPU, and K5
fwd, the encode, beside PyTorch writing the same bytes.

    python3 scripts/codec_shapes_gpu.py [--parent DIR] [--encode-only]
    # from the repo root

All three are templates in ``csrc/codec.cu`` (namespaces dsf_decode and
dsf_encode) and the port's library builds one layout of each.  ``codec_shapes_gpu.cu``
beside this script includes that source and adds the candidates the
library does not run; this script instantiates every layout below in it,
compiles it once (one ``nvcc -shared``, the library's flags) and runs
each at J=21, S=64 and B = 1 (a serving request), 32 (the training batch)
and 64 (the FinetuneStage step's decode of 2B with gradients), from
seeded random fields:

* forward ``fwd_candidate<THREADS, U, TWO>``: THREADS a CTA, U units of 4
  pixels loaded before they are added, each (image, joint) row split over
  1, 2, 4 or 8 CTAs merged in a thread-block cluster (the library's
  ``fwd_launch``) or by a second kernel (TWO; split 1: no cluster, no
  merge); with 16-byte loads and with every pixel loaded alone (4-byte
  loads);
* VJP ``bwd_candidate<PT, JL, JU, STAGE>``: PT units (4 pixels, or single
  pixels with 4-byte loads) a block, JL joint lanes a unit, JU joints'
  loads issued before their use; STAGE stages each joint's 6 constants in
  shared memory behind a barrier, else each thread reads them with its
  loads (JU 1 without STAGE is the library's ``bwd_launch``);
* encode VJP ``dsf_encode::bwd_candidate<..., KIND>``: the library's
  block lanes (PT units x JL joint lanes of JPT joints a CTA, d depth
  summed in shared memory), the same with each thread's next unit copied
  into shared memory by cp.async, or warp lanes (JL joint lanes inside a
  warp, WARPS a CTA, d depth summed by shuffles), the split 4, 8 or 16 CTAs of an image merged in a cluster
  (16: a non-portable size), 16- or 4-byte loads; held against autograd of
  ``joint2offset_plain`` (1e-4 of each gradient's largest entry) and run
  twice (bitwise); yardstick ``g.sum()`` (``--encode-only`` times these
  alone).

Beside them, as yardsticks of what the card gives for the same bytes,
one PyTorch call each: ``x.sum()`` reads the field, ``dx.copy_(x)`` reads
and writes it.  K5 fwd (the library's ``dsf_codec_encode``, one layout,
held against ``joint2offset_plain`` within 1e-5) is timed, in every mode,
beside ``out.fill_(0)`` and ``out.zero_()`` of its output's bytes (the
field it writes; its inputs are 1/84 of that), warm and cold.

Each layout is held against the plain versions
(``offset_codec.decode_fwd_plain``: y within 1e-5, m exactly, Z within
1e-5 relative; ``decode_bwd_plain``: 1e-4 of each gradient's largest
entry) before it is timed, and the library's own layout bitwise against
its instantiation here.  Times are ``chip_smoke.time_ms`` means with the
inputs warm in L2 (the same inputs every call; 44 MB at B=32 nearly fits
the 50 MB L2, 88 MB at B=64 does not) and cold (``time_cold_ms``: each
call reads the next of enough copies to pass twice the L2).  With
``--parent DIR`` (an unpacked tree from before the one-launch encode VJP)
it also builds that tree's ``csrc/codec.cu`` and times its encode VJP
against the library's, in turns (parent, library, library, parent).  Prints the
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
# forward: (threads a CTA, units a step); the library's is csrc
# kFwdThreads, kFwdU, with the cluster merge where a row is split
FWD_SHAPES = ((128, 1), (128, 2), (128, 4), (256, 1), (256, 2), (64, 2))
SPLITS = (1, 2, 4, 8)
# VJP: (units a block, joint lanes, joints unrolled, staged); the
# library's is csrc kBwdPT, kBwdJL with 1 joint unrolled, not staged
BWD_SHAPES = ((32, 7, 1, False), (32, 7, 1, True), (64, 7, 1, False),
              (64, 4, 2, True), (64, 4, 2, False), (32, 7, 3, False),
              (128, 1, 3, False), (64, 3, 1, False), (64, 3, 2, False))
LIB_FWD = (128, 2)
LIB_BWD = (32, 7, 1, False)
# the encode VJP (K5 bwd): (units a CTA, joint lanes, joints a lane, 1)
# for the library's block-lane kernel, the same with 2 for its cp.async
# variant, (joint lanes, joints a lane, warps a CTA, 0) for the warp-lane
# kernel; the library's is csrc kEncPT, kEncJL, kEncJPT at
# codec_kernel.encode_bwd_split(B) CTAs an image
ENC_SHAPES = ((32, 7, 3, 1), (64, 7, 3, 1), (64, 3, 7, 1), (32, 7, 3, 2),
              (64, 7, 3, 2), (32, 3, 7, 2), (4, 6, 4, 0), (8, 3, 8, 0))
ENC_SPLITS = (2, 4, 8, 16)
LIB_ENC = (32, 7, 3, 1)
BATCHES = (1, 32, 64)
J, S, K, SCALE = 21, 64, 0.8, 30.0


def build_variants(tmp, parent):
    """The candidates' source with every layout instantiated; the
    parent's source as it is."""
    from dsf_tpu_torch.kernels import build
    fa = ("const float* x, const float* d, float* y, float* st, float* pa, "
          "int B, int J, int S, int split, int vec, float k, float sc, "
          "void* s")
    ba = ("const float* x, const float* d, const float* g, const float* y, "
          "const float* st, float* dx, float* dd, int B, int J, int S, "
          "int vec, float k, float sc, void* s")
    cpp = {True: "true", False: "false"}
    body = "".join(
        f'extern "C" int fwd_{"_".join(map(str, f))}_{int(two)}({fa}) {{ '
        f'return dsf_decode::fwd_candidate<{", ".join(map(str, f))}, '
        f'{cpp[two]}>(x, d, y, st, pa, B, J, S, split, vec, k, sc, s); }}\n'
        for f in FWD_SHAPES for two in (True, False))
    body += "".join(
        f'extern "C" int bwd_{"_".join(map(str, b[:3]))}_{int(b[3])}({ba}) '
        f'{{ return dsf_decode::bwd_candidate<{", ".join(map(str, b[:3]))}, '
        f'{cpp[b[3]]}>(x, d, g, y, st, dx, dd, B, J, S, vec, k, sc, s); }}\n'
        for b in BWD_SHAPES)
    ea = ("const float* j, const float* d, const float* g, float* dj, "
          "float* dd, int B, int J, int S, int split, int vec, float k, "
          "void* s")
    body += "".join(
        f'extern "C" int enc_{"_".join(map(str, e[:3]))}_{int(e[3])}({ea}) '
        f'{{ return dsf_encode::bwd_candidate<{", ".join(map(str, e))}>('
        f'j, d, g, dj, dd, B, J, S, split, vec, k, s); }}\n'
        for e in ENC_SHAPES)
    path = os.path.join(tmp, "k4.cu")
    cand = os.path.join(ROOT, "scripts", "codec_shapes_gpu.cu")
    with open(path, "w") as f:
        f.write(f'#include "{cand}"\n{body}')
    jobs = {"k4": (path, os.path.join(tmp, "k4.so"))}
    if parent:
        jobs["parent"] = (os.path.join(parent, "dsf_tpu_torch", "csrc",
                                       "codec.cu"),
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


def typed(fn, n_ptr, n_int, n_float):
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_float] * n_float + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def inputs(B, rng, dev):
    """A seeded field (the CPU tests' recipe): units ~ N(0, 0.3), heat in
    [-0.5, 1), depth in [-1, 1.05) (about 2.4% background), cotangent
    N(0, 1)."""
    import numpy as np
    import torch
    off = rng.randn(B, 4 * J, S, S).astype(np.float32) * 0.3
    off[:, 3 * J:] = rng.uniform(-0.5, 1.0, (B, J, S, S))
    dep = rng.uniform(-1, 1.05, (B, 1, S, S)).astype(np.float32)
    g = rng.randn(B, J, 3).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (off, dep, g)]


def encode_fwd_vs_fill(B, depth, rng, rows):
    """K5 fwd at B images against PyTorch writing its output's bytes,
    warm and cold L2 (``rows``: the summary's, keyed ("k5fwd", what))."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from dsf_tpu_torch.kernels import build
    from dsf_tpu_torch.ops import codec_kernel
    from dsf_tpu_torch.ops import offset_codec as oc
    joint = torch.from_numpy(rng.uniform(-1, 1, (B, J, 3)).astype(
        np.float32)).to(depth.device)
    out = codec_kernel.encode_cuda(joint, depth, K)
    err = float((out - oc.joint2offset_plain(joint, depth, K)).abs().max())
    fn = typed(build.library("codec").dsf_codec_encode, 3, 3, 1)
    stream = torch.cuda.current_stream().cuda_stream

    def run(j, d, o):
        if fn(j.data_ptr(), d.data_ptr(), o.data_ptr(), B, J, S, K, stream):
            raise RuntimeError("K5 fwd: launch failed")
    copies = cs.copies_past_l2((joint, depth, out))
    times = {}
    for what, call in (("K5 fwd", run),
                       ("out.fill_(0)", lambda j, d, o: o.fill_(0.0)),
                       ("out.zero_()", lambda j, d, o: o.zero_())):
        times[what] = (cs.time_ms(lambda: call(joint, depth, out), 50),
                       cs.time_cold_ms(call, copies, 50))
        rows.setdefault(("k5fwd", what), {})[B] = times[what]
    ratio = [k / f for k, f in zip(times["K5 fwd"], times["out.fill_(0)"])]
    print(f"K5 fwd B={B}: max_abs_err against joint2offset_plain {err:.3g}; "
          + "; ".join(f"{k} warm {w:.4f} ms, cold {c:.4f} ms"
                      for k, (w, c) in times.items())
          + f"; K5 fwd / fill_ warm {ratio[0]:.3f}, cold {ratio[1]:.3f}",
          flush=True)
    return int(not err <= 1e-5)


def encode_layouts(B, field, depth, rng, enc, parent, rows):
    """K5 bwd: every layout of ``enc`` at split 2, 4, 8, 16 with 16- and
    4-byte loads, on joints drawn in the crop, the depth and a cotangent
    the field's shape; held against autograd of ``joint2offset_plain``
    (1e-4 of each gradient's largest entry), the library's layout bitwise
    against its instantiation; beside ``g.sum()`` over the same bytes and,
    with ``parent``, the parent tree's encode VJP in turns.  Returns the
    number of layouts that disagreed."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from dsf_tpu_torch.ops import codec_kernel
    from dsf_tpu_torch.ops import offset_codec as oc

    dev, stream = field.device, torch.cuda.current_stream().cuda_stream
    S = depth.shape[-1]
    joints = torch.from_numpy(rng.uniform(-1, 1, (B, J, 3))
                              .astype(np.float32)).to(dev)
    g = field
    with torch.inference_mode(False), torch.enable_grad():
        jr = joints.clone().requires_grad_(True)
        dr = depth.clone().requires_grad_(True)
        refs = torch.autograd.grad(oc.joint2offset_plain(jr, dr, K),
                                   (jr, dr), g.clone())
    lib_out = codec_kernel.encode_bwd_cuda(joints, depth, g, K)
    copies = cs.copies_past_l2((joints, depth, g))
    gsum = cs.time_ms(lambda: g.sum(), 50)
    print(f"B={B} encode VJP yardstick (warm): g.sum() {gsum:.4f} ms",
          flush=True)
    bad = 0
    for e, fn in enc.items():
        for split in ENC_SPLITS:
            for vec in (1, 0):
                dj = torch.empty((B, J, 3), device=dev)
                dd = torch.empty_like(depth)

                def run(j, d, gg):
                    err = fn(j.data_ptr(), d.data_ptr(), gg.data_ptr(),
                             dj.data_ptr(), dd.data_ptr(), B, J, S, split,
                             vec, K, stream)
                    if err:
                        raise RuntimeError(f"enc {e} {split}: error {err}")
                run(joints, depth, g)
                first = (dj.clone(), dd.clone())
                run(joints, depth, g)
                torch.cuda.synchronize()
                rel = max(float((a - r).abs().max() / r.abs().max())
                          for a, r in zip((dj, dd), refs))
                repeat = torch.equal(first[0], dj) and torch.equal(first[1],
                                                                   dd)
                held = rel <= 1e-4 and repeat
                same = ""
                if (e == LIB_ENC and vec
                        and split == codec_kernel.encode_bwd_split(B)):
                    lib_same = (torch.equal(dj, lib_out[0])
                                and torch.equal(dd, lib_out[1]))
                    same = f", bitwise the library's: {lib_same}"
                    bad += not lib_same
                bad += not held
                warm = cs.time_ms(lambda: run(joints, depth, g), 50)
                cold = cs.time_cold_ms(run, copies, 50)
                key = ("enc",) + e + (split, "16 B" if vec else "4 B")
                rows.setdefault(key, {})[B] = (warm, cold)
                shape = (f"warp lanes: {e[0]} joint lanes of {e[1]}, "
                         f"{e[2]} warps a CTA" if e[3] == 0 else
                         f"block lanes{' (cp.async)' if e[3] == 2 else ''}:"
                         f" {e[0]} units a CTA, {e[1]} joint lanes of {e[2]}")
                print(f"K5 bwd B={B} {shape}, split {split}, {key[-1]} "
                      f"loads: held "
                      f"{held}{same}, max rel err {rel:.3g}, two runs "
                      f"bitwise {repeat}; warm {warm:.4f} ms, cold "
                      f"{cold:.4f} ms", flush=True)
    if parent is not None:
        # the encode VJP before this design: two kernels and a scratch of
        # B * ceil(S^2 / 256) * 3J floats
        pb = typed(parent.dsf_codec_encode_bwd, 6, 3, 1)
        pdj, pdd = torch.empty((B, J, 3), device=dev), torch.empty_like(depth)
        part = torch.empty(B * -(-(S * S) // 256) * 3 * J, device=dev)

        def parent_run(j, d, gg):
            pb(j.data_ptr(), d.data_ptr(), gg.data_ptr(), pdj.data_ptr(),
               pdd.data_ptr(), part.data_ptr(), B, J, S, K, stream)

        def lib_run(j, d, gg):
            codec_kernel.encode_bwd_cuda(j, d, gg, K)

        times = [(cs.time_ms(lambda: fn(joints, depth, g), 50),
                  cs.time_cold_ms(fn, copies, 50))
                 for fn in (parent_run, lib_run, lib_run, parent_run)]
        print(f"K5 bwd B={B} parent, library, library, parent: warm "
              f"{', '.join(f'{w:.4f}' for w, _ in times)} ms; cold "
              f"{', '.join(f'{c:.4f}' for _, c in times)} ms", flush=True)
    return bad


def main():
    import numpy as np
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an unpacked earlier tree to time "
                    "against")
    ap.add_argument("--encode-only", action="store_true",
                    help="time the encode VJP's layouts only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("codec_shapes_gpu: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from dsf_tpu_torch.ops import codec_kernel
    from dsf_tpu_torch.ops import offset_codec as oc

    print(f"device: {cs.nvidia_smi_line()}", flush=True)
    bad = 0
    rng = np.random.RandomState(cs.SEED)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        libs, msgs = build_variants(tmp, args.parent)
        for n, text in msgs.items():
            entry = ""
            for line in text.splitlines():
                if "Compiling entry" in line:
                    entry = line.split("'")[1]
                elif "registers" in line or "spill" in line:
                    print(f"  ptxas {n} {entry}: "
                          f"{line.split(':', 1)[-1].strip()}", flush=True)
        lib = libs["k4"]
        fwd = {f + (two,): typed(
            getattr(lib, f"fwd_{'_'.join(map(str, f))}_{int(two)}"), 5, 5, 2)
            for f in FWD_SHAPES for two in (True, False)}
        bwd = {b: typed(getattr(lib, f"bwd_{'_'.join(map(str, b[:3]))}_"
                                     f"{int(b[3])}"), 7, 4, 2)
               for b in BWD_SHAPES}
        enc = {e: typed(getattr(lib, f"enc_{'_'.join(map(str, e[:3]))}_"
                                     f"{int(e[3])}"), 5, 5, 1)
               for e in ENC_SHAPES}
        if args.encode_only:
            fwd, bwd = {}, {}
        rows = {}
        for B in BATCHES:
            x, d, g = inputs(B, rng, dev)
            y_ref, st_ref = oc.decode_fwd_plain(x, d, K, SCALE)
            dx_ref, dd_ref = oc.decode_bwd_plain(x, d, g, y_ref, st_ref, K,
                                                 SCALE)
            lib_y, lib_st = codec_kernel.decode_cuda(x, d, K, SCALE)
            lib_dx, lib_dd = codec_kernel.decode_bwd_cuda(x, d, g, lib_y,
                                                          lib_st, K, SCALE)
            copies = cs.copies_past_l2((x, d, g, lib_y, lib_st))
            rule = codec_kernel.decode_split(B, J)
            print(f"B={B}: the library's split rule gives {rule}; cold "
                  f"copies {len(copies)}", flush=True)

            sink = torch.empty_like(x)
            lib_ms = {"x.sum()": cs.time_ms(lambda: x.sum(), 50),
                      "dx.copy_(x)": cs.time_ms(lambda: sink.copy_(x), 50)}
            del sink
            print(f"B={B} yardsticks (warm): " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in lib_ms.items()), flush=True)
            for (t, u, two), fn in fwd.items():
                for split in SPLITS[1:] if two else SPLITS:
                    for vec in (1, 0):
                        y = torch.empty_like(y_ref)
                        st = torch.empty_like(st_ref)
                        part = torch.empty(B * J * split * 5, device=dev)

                        def run(x, d, *_):
                            err = fn(x.data_ptr(), d.data_ptr(), y.data_ptr(),
                                     st.data_ptr(), part.data_ptr(), B, J, S,
                                     split, vec, K, SCALE, stream)
                            if err:
                                raise RuntimeError(f"fwd {t} {u} {two} "
                                                   f"{split}: error {err}")
                        run(x, d)
                        torch.cuda.synchronize()
                        err = float((y - y_ref).abs().max())
                        held = (err <= 1e-5 and torch.equal(st[..., 0],
                                                            st_ref[..., 0])
                                and bool(((st[..., 1] - st_ref[..., 1]).abs()
                                          <= 1e-5 * st_ref[..., 1]).all()))
                        same = ""
                        if (t, u) == LIB_FWD and not two \
                                and split == rule and vec:
                            same = (", bitwise the library's: "
                                    f"{torch.equal(y, lib_y) and torch.equal(st, lib_st)}")
                        bad += not held
                        warm = cs.time_ms(lambda: run(x, d), 50)
                        cold = cs.time_cold_ms(run, copies, 50)
                        merge = ("2 kernels" if two else
                                 "cluster" if split > 1 else "none")
                        key = ("fwd", t, u, merge, split,
                               "16 B" if vec else "4 B")
                        rows.setdefault(key, {})[B] = (warm, cold)
                        print(f"K4 fwd B={B} {t} threads, {u} units a step, "
                              f"split {split}, merge {merge}, {key[5]} loads: "
                              f"held "
                              f"{held}{same}, max_abs_err {err:.3g}; warm "
                              f"{warm:.4f} ms, cold {cold:.4f} ms", flush=True)

            for (pt, jl, ju, sg), fn in bwd.items():
                for vec in (1, 0):
                    dx = torch.empty_like(dx_ref)
                    dd = torch.empty_like(dd_ref)

                    def run(x, d, g, y, st):
                        err = fn(x.data_ptr(), d.data_ptr(), g.data_ptr(),
                                 y.data_ptr(), st.data_ptr(), dx.data_ptr(),
                                 dd.data_ptr(), B, J, S, vec, K, SCALE,
                                 stream)
                        if err:
                            raise RuntimeError(f"bwd {pt} {jl} {ju} {sg}: "
                                               f"error {err}")
                    run(x, d, g, y_ref, st_ref)
                    torch.cuda.synchronize()
                    rel = max(float((a - r).abs().max() / r.abs().max())
                              for a, r in ((dx, dx_ref), (dd, dd_ref)))
                    held = rel <= 1e-4
                    same = ""
                    if (pt, jl, ju, sg) == LIB_BWD and vec:
                        run(x, d, g, lib_y, lib_st)
                        torch.cuda.synchronize()
                        same = (", bitwise the library's: "
                                f"{torch.equal(dx, lib_dx) and torch.equal(dd, lib_dd)}")
                    bad += not held
                    warm = cs.time_ms(lambda: run(x, d, g, y_ref, st_ref), 50)
                    cold = cs.time_cold_ms(run, copies, 50)
                    key = ("bwd", pt, jl, ju, "staged" if sg else "direct",
                           "16 B" if vec else "4 B")
                    rows.setdefault(key, {})[B] = (warm, cold)
                    print(f"K4 bwd B={B} {pt} units a block, {jl} joint "
                          f"lanes, {ju} joints unrolled, constants {key[4]}, "
                          f"{key[5]} loads: held "
                          f"{held}{same}, max rel err {rel:.3g}; warm "
                          f"{warm:.4f} ms, cold {cold:.4f} ms", flush=True)

            bad += encode_fwd_vs_fill(B, d, rng, rows)
            bad += encode_layouts(B, x, d, rng, enc, libs.get("parent"),
                                  rows)
            del copies

    print("fastest layouts (cold L2, ms at B = " + ", ".join(map(str, BATCHES))
          + "):")
    for kind in ("fwd", "bwd", "enc"):
        for B in BATCHES:
            if kind == "enc":
                print(f"  K5 fwd B={B}, warm / cold: " + ", ".join(
                    f"{k[1]} {v[B][0]:.4f} / {v[B][1]:.4f}"
                    for k, v in rows.items() if k[0] == "k5fwd"), flush=True)
            cands = [(v[B][1], k) for k, v in rows.items()
                     if k[0] == kind and B in v]
            for t, k in sorted(cands)[:3]:
                print(f"  {kind} B={B}: {k[1:]} {t:.4f} ms", flush=True)
    print(f"device: {cs.nvidia_smi_line()}; {bad} layouts disagreed")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
