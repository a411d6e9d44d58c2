#!/usr/bin/env python3
"""Read a ``transfer_G_A.npz`` (the CycleGAN pipeline's export, from
either package) with both packages on the CPU and compare the generators'
outputs on a seeded batch of 128^2 inputs in [-1, 1]:

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 scripts/transfer_npz_check.py PATH

``dsf_tpu``'s ``pipelines.load_variables_npz`` + ``ResnetGenerator.apply``
against ``dsf_tpu_torch``'s ``load_transfer_net``, each against the
port's generator in float64; prints the largest differences.
"""

import sys

import numpy as np


def main(path):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from dsf_tpu.models.cyclegan import ResnetGenerator
    from dsf_tpu.training.pipelines import load_variables_npz
    from dsf_tpu_torch.training.trainer import load_transfer_net

    v = load_variables_npz(path)
    x = np.random.RandomState(0).uniform(-1, 1, (2, 1, 128, 128))
    x = x.astype(np.float32)
    y_jax = np.asarray(ResnetGenerator().apply(v, jnp.asarray(x)))
    gen = load_transfer_net(path, "cpu")
    with torch.no_grad():
        y = gen(torch.from_numpy(x)).numpy()
        y64 = gen.double()(torch.from_numpy(x).double()).numpy()
    print(f"{path}: output {y.shape}, range [{y.min():.4g}, {y.max():.4g}]; "
          f"max abs JAX vs port {np.abs(y_jax - y).max():.3g}, port vs "
          f"float64 {np.abs(y - y64).max():.3g}, JAX vs float64 "
          f"{np.abs(y_jax - y64).max():.3g}")


if __name__ == "__main__":
    main(sys.argv[1])
