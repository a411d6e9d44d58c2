#!/usr/bin/env python3
"""Time the K9 tail-conv kernel of dsf_tpu_torch at other block shapes on
one NVIDIA GPU.

    python3 scripts/tail_shapes_gpu.py     # from the root of the repository

The kernel is one template (``csrc/tail_conv.cu:tail_conv_kernel<RT, CT,
TX, TY, G, BULK>``: RT x CT outputs a thread, TX x TY threads a group, a
band of TY x RT rows and TX x CT columns a block, G groups splitting the
channels; BULK stages a channel's band with one cp.async.bulk, else with
4-byte cp.async), and the port's library builds one shape.  This script
compiles the source once more with every shape below instantiated (one
``nvcc -shared``, the library's flags) and runs each, with each copy
route, on the generator's head shape (B=32, C=64, 134^2 in, 128^2 out)
from seeded random data.  Each shape is held against the plain version
(cuDNN's float32 convolution, TF32 off, and tanh) within 1e-6 of each
output's sum of product magnitudes, and bitwise against the library's K9
where its sum order is the library's (the same channel split).  It prints
each shape's mean device time (``chip_smoke.time_ms``, CUDA events) beside
the card's name and power limit, and the opcodes of the library's
per-channel loop (``cuobjdump -sass``: the innermost loop of the
tail-conv kernel).  Exits non-zero without a GPU or on a mismatch.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (rows, columns a thread, threads across, threads down, channel groups)
SHAPES = ((8, 4, 32, 2, 4), (8, 4, 32, 1, 4), (8, 4, 32, 2, 2),
          (8, 4, 32, 2, 8), (8, 4, 32, 4, 2), (4, 4, 32, 2, 4),
          (4, 4, 32, 4, 4), (4, 8, 16, 4, 4), (6, 4, 32, 2, 4))
LIBRARY = (8, 4, 32, 2, 4)      # csrc/tail_conv.cu's kRT, kCT, kTX, kTY, kG
SHAPE = (32, 64, 134, 134)      # the generator's head input


def build_variants(tmp):
    """The source with every shape and both copy routes instantiated."""
    from dsf_tpu_torch.kernels import build
    args = ("const float* x, const float* w, const float* b, float* o, "
            "int B, int C, int H, int W, void* s")
    body = "".join(
        f'extern "C" int k9_{rt}x{ct}_{tx}x{ty}x{g}_{int(bulk)}({args}) '
        f'{{ return dsf_tail::launch<{rt}, {ct}, {tx}, {ty}, {g}, '
        f'{"true" if bulk else "false"}>(x, w, b, o, B, C, H, W, '
        f'static_cast<cudaStream_t>(s)); }}\n'
        for rt, ct, tx, ty, g in SHAPES for bulk in (True, False))
    path = os.path.join(tmp, "k9.cu")
    with open(path, "w") as f:
        f.write(f'#include "{os.path.join(build.CSRC, "tail_conv.cu")}"\n'
                f'{body}')
    out = os.path.join(tmp, "k9.so")
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas",
                          "-v", "-o", out, path], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for the K9 shapes:\n{res.stderr}")
    return ctypes.CDLL(out), res.stderr


def inner_loop_opcodes(so_path):
    """The opcode counts of the per-channel loop of the library's K9: the
    shortest loop (a backward branch) of its kernel that holds more than
    100 FFMA."""
    import collections
    import re
    from dsf_tpu_torch.kernels import build
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so_path], capture_output=True,
                          text=True, check=True).stdout
    ops = []
    for func in sass.split("Function : ")[1:]:
        if "tail_conv_kernel" not in func.split("\n")[0] \
                or "Lb1E" not in func.split("\n")[0]:
            continue
        for line in func.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z0-9_.]+)(.*)", line)
            if m:
                ops.append((int(m.group(1), 16), m.group(2), m.group(3)))
        break
    best = None
    for off, op, rest in ops:
        target = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") \
            else None
        if target is None or int(target.group(1), 16) >= off:
            continue
        loop = [o for a, o, _ in ops if int(target.group(1), 16) <= a <= off]
        if sum(o.startswith("FFMA") for o in loop) > 100 and (
                best is None or len(loop) < len(best)):
            best = loop
    return collections.Counter(o.split(".")[0] for o in best or [])


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("tail_shapes_gpu: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from dsf_tpu_torch.device import exact_float32
    from dsf_tpu_torch.kernels import build
    from dsf_tpu_torch.ops import tapsum, tapsum_kernel

    print(f"device: {cs.nvidia_smi_line()}", flush=True)
    bad = 0
    rng = np.random.RandomState(cs.SEED)
    dev = torch.device("cuda")
    B, C, Hp, Wp = SHAPE
    x = torch.from_numpy(rng.randn(*SHAPE).astype(np.float32)).to(dev)
    w = torch.from_numpy((0.02 * rng.randn(1, C, 7, 7)).astype(np.float32)
                         ).to(dev)
    b = torch.from_numpy(rng.randn(1).astype(np.float32) * 0.1).to(dev)
    with tempfile.TemporaryDirectory() as tmp, exact_float32(), \
            torch.inference_mode():
        lib, ptxas = build_variants(tmp)
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
        ref = tapsum.tail_conv_tanh_plain(x, w, b)
        absum = torch.nn.functional.conv2d(x.double().abs(), w.double().abs())
        own = tapsum_kernel.tail_conv_cuda(x, w, b)
        lib_ms = cs.time_ms(lambda: tapsum_kernel.tail_conv_cuda(x, w, b), 50)
        stream = torch.cuda.current_stream().cuda_stream
        for rt, ct, tx, ty, g in SHAPES:
            for bulk in (True, False):
                fn = getattr(lib, f"k9_{rt}x{ct}_{tx}x{ty}x{g}_{int(bulk)}")
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int
                out = torch.empty_like(ref)

                def run():
                    return fn(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                              out.data_ptr(), B, C, Hp - 6, Wp - 6, stream)
                err = run()
                if err != 0:
                    raise RuntimeError(f"K9 {rt}x{ct} {tx}x{ty}x{g} bulk "
                                       f"{bulk}: launch failed ({err})")
                torch.cuda.synchronize()
                held = bool(((out - ref).abs() <= 1e-6 * absum).all())
                same = ""
                if g == LIBRARY[4]:
                    same = f", bitwise the library's: {torch.equal(out, own)}"
                bad += not held
                ms = cs.time_ms(run, 50)
                print(f"K9 {SHAPE} -> {tuple(ref.shape)}: {rt} x {ct} outputs "
                      f"a thread, {tx} x {ty} threads a group, {g} groups, "
                      f"{'cp.async.bulk' if bulk else 'cp.async 4 B'}: held "
                      f"{held}{same}, max_abs_err "
                      f"{float((out - ref).abs().max()):.3g}; {ms:.4f} ms",
                      flush=True)
    ops = inner_loop_opcodes(build._lib_path("tail_conv"))
    print(f"K9 library ({'x'.join(map(str, LIBRARY))}) {lib_ms:.4f} ms; its "
          f"per-channel loop: {sum(ops.values())} instructions, "
          f"{dict(ops.most_common())}", flush=True)
    print(f"device: {cs.nvidia_smi_line()}; {bad} shapes disagreed")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
