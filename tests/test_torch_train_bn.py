"""Port parity for train-mode BatchNorm: the port's ``batch_norm`` against
Flax nn.BatchNorm (output, gradients, running statistics), and its
state-dict names and eval mode against nn.BatchNorm2d.  The file imports
only what the serving slice already had, so the running-variance test
also runs, and fails, against nn.BatchNorm2d's unbiased EMA."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import flax.linen as nn

from dsf_tpu_torch.models.layers import batch_norm

torch.set_num_threads(2)


def _flax_bn(x, gy, scale, bias, mean, var):
    """Flax nn.BatchNorm(momentum=0.9, eps=1e-5) in train mode on NCHW
    data: output, d x, d scale, d bias, and the updated running mean/var."""
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    to_nhwc = lambda a: np.transpose(a, (0, 2, 3, 1))

    def f(xh, params):
        y, mut = bn.apply({"params": params,
                           "batch_stats": {"mean": mean, "var": var}},
                          xh, mutable=["batch_stats"])
        return jnp.sum(y * to_nhwc(gy)), (y, mut["batch_stats"])

    (_, (y, st)), (gx, gp) = jax.value_and_grad(f, argnums=(0, 1),
                                                has_aux=True)(
        to_nhwc(x), {"scale": scale, "bias": bias})
    back = lambda a: np.transpose(np.asarray(a), (0, 3, 1, 2))
    return (back(y), back(gx), np.asarray(gp["scale"]), np.asarray(gp["bias"]),
            np.asarray(st["mean"]), np.asarray(st["var"]))


@pytest.mark.parametrize("shape", [(2, 8, 16, 16), (4, 5, 3, 3)])
def test_train_mode_batchnorm_matches_flax(shape):
    """The port's BatchNorm in train mode: output and gradients to float32
    rounding (1e-5 of their scale: each side reduces N*H*W values in its
    own order), and the running statistics after one update to 1e-6
    relative.  Flax feeds the EMA the biased batch variance; torch's own
    nn.BatchNorm2d feeds it the unbiased one, which this test tells apart
    (a factor N*H*W/(N*H*W-1): 1.0020 and 1.0278 at these shapes)."""
    rng = np.random.RandomState(sum(shape))
    C = shape[1]
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    gy = rng.randn(*shape).astype(np.float32)
    scale = rng.uniform(0.8, 1.2, C).astype(np.float32)
    bias = rng.randn(C).astype(np.float32)
    mean0 = (rng.randn(C) * 0.1).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, C).astype(np.float32)
    y_r, gx_r, gs_r, gb_r, m_r, v_r = _flax_bn(x, gy, scale, bias, mean0, var0)

    m = batch_norm(C)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(mean0))
        m.running_var.copy_(torch.from_numpy(var0))
    m.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    y = m(xt)
    (y * torch.from_numpy(gy)).sum().backward()
    np.testing.assert_allclose(m.running_mean.numpy(), m_r, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(m.running_var.numpy(), v_r, rtol=1e-6, atol=1e-7)
    for got, ref in ((y.detach().numpy(), y_r), (xt.grad.numpy(), gx_r),
                     (m.weight.grad.numpy(), gs_r), (m.bias.grad.numpy(), gb_r)):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_batchnorm_keeps_state_dict_names_and_eval_mode():
    from dsf_tpu_torch.models.layers import BatchNorm2d
    m = batch_norm(4)
    assert isinstance(m, torch.nn.BatchNorm2d) and isinstance(m, BatchNorm2d)
    assert set(m.state_dict()) == {"weight", "bias", "running_mean",
                                   "running_var", "num_batches_tracked"}
    ref = torch.nn.BatchNorm2d(4)
    x = torch.randn(2, 4, 3, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for t in (m, ref):
            t.running_mean.fill_(0.3)
            t.running_var.fill_(2.0)
    m.eval()
    ref.eval()
    assert torch.equal(m(x), ref(x))
