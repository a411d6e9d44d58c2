"""Port parity for the stacked-hourglass ``PoseNet``
(dsf_tpu_torch.models.hourglass) and its weight carriers
(``weights.pose_net_state_dict_from_jax``, ``pose_net_from_reference``,
``random_pose_net_state_dict``) against the JAX package's ``PoseNet``
with ``convert_pose_net``, on the CPU.

Shapes: two stacks, 21 joints, a narrow ``inp_dim`` of 16, 64^2 input,
B=4 (the 4-level hourglass's bottom is 1x1, so its train-mode BatchNorm
sees B values a channel; at B=2 those statistics are ill-conditioned).
The JAX package's forward runs eagerly, once in train and once in eval
mode, for both carriers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsf_tpu.models import torch_import as TI
from dsf_tpu.models.hourglass import PoseNet as JPoseNet
from dsf_tpu_torch.models import weights as W
from dsf_tpu_torch.models.hourglass import PoseNet

torch.set_num_threads(2)

NSTACK, J, DIM, S, B = 2, 21, 16, 64, 4


@pytest.fixture(scope="module")
def ref():
    sd = W.random_pose_net_state_dict(np.random.RandomState(0), NSTACK, J,
                                      DIM)
    variables = jax.tree_util.tree_map(
        np.asarray, TI.convert_pose_net(sd, nstack=NSTACK))
    x = np.random.RandomState(1).rand(B, 1, S, S).astype(np.float32)
    net = JPoseNet(nstack=NSTACK, joint_num=J, inp_dim=DIM)
    (preds, hg), mut = net.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
    eval_preds, eval_hg = net.apply(variables, jnp.asarray(x), train=False)
    after = W.pose_net_state_dict_from_jax(
        {"params": variables["params"], "batch_stats": mut["batch_stats"]})
    return dict(sd=sd, variables=variables, x=x,
                train=[np.asarray(p) for p in preds] + [np.asarray(hg)],
                eval=[np.asarray(p) for p in eval_preds] + [np.asarray(eval_hg)],
                stats={k: v.numpy() for k, v in after.items()
                       if "running" in k})


def _carried(ref, carrier):
    sd = (W.pose_net_state_dict_from_jax(ref["variables"])
          if carrier == "jax" else W.pose_net_from_reference(ref["sd"]))
    net = PoseNet(**W.pose_net_dims(sd))
    W.load_into(net, sd)
    return net, sd


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("carrier", ["jax", "reference"])
def test_pose_net_matches_jax(ref, carrier):
    """Through either carrier the port's net has the JAX net's shape
    (two stacks of (B, 5J, S/4, S/4) and the last hourglass), and its
    outputs lie within 1e-4 relative L2 of JAX's in train mode (batch
    statistics; measured 8.5e-6) and 1e-5 in eval mode (running ones;
    measured 6.8e-7); the running statistics after the train-mode
    forward within 2e-4 of each tensor's largest entry (measured
    5.0e-5: the bottom's four values a channel), each moved."""
    net, sd = _carried(ref, carrier)
    x = torch.from_numpy(ref["x"])
    net.train()
    preds, hg = net(x)
    got = [p.detach().numpy() for p in preds] + [hg.detach().numpy()]
    assert [g.shape for g in got] == [r.shape for r in ref["train"]]
    assert got[0].shape == (B, 5 * J, S // 4, S // 4)
    for g, r in zip(got, ref["train"]):
        assert _rel(g, r) <= 1e-4
    after = net.state_dict()
    for k, r in ref["stats"].items():
        assert not np.array_equal(r, sd[k].numpy()), k
        np.testing.assert_allclose(after[k].numpy(), r, rtol=0,
                                   atol=2e-4 * np.abs(r).max(), err_msg=k)
    fresh, _ = _carried(ref, carrier)
    fresh.eval()
    with torch.no_grad():
        preds, hg = fresh(x)
    for g, r in zip([p.numpy() for p in preds] + [hg.numpy()], ref["eval"]):
        assert _rel(g, r) <= 1e-5


def test_carriers_agree_and_drop_unused_skips(ref):
    """Both carriers give one state dict, key for key and bitwise; the
    reference layout's skip convs survive only where a Residual changes
    its channels (pre.1 64 -> 128, pre.3 128 -> 256, pre.4 256 -> 16),
    and ``pose_net_dims`` reads the net's shape from either."""
    a = W.pose_net_state_dict_from_jax(ref["variables"])
    b = W.pose_net_from_reference(ref["sd"])
    assert sorted(a) == sorted(b)
    for k in a:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(a[k], b[k]), k
    skips = sorted({k.rsplit(".skip_layer.", 1)[0] for k in a
                    if ".skip_layer." in k})
    assert skips == ["pre.1", "pre.3", "pre.4"]
    assert sum(".skip_layer." in k for k in ref["sd"]) > 2 * len(skips)
    dims = dict(nstack=NSTACK, joint_num=J, inp_dim=DIM, in_ch=1)
    assert W.pose_net_dims(a) == W.pose_net_dims(ref["sd"]) == dims
    assert sorted(PoseNet(**dims).state_dict()) == sorted(a)
