"""Port parity at the deep trunks: ``ManoOCRStage`` at depths 50, 101 and
152 (Bottleneck blocks) against the JAX package's, on the CPU.

The JAX package converts ResNet-18 weights alone
(``torch_import.convert_mano_ocr_stage``), and a jitted Flax ``init`` at
these depths takes tens of seconds.  So the JAX variables come from
``jax.eval_shape`` of ``init`` (the tree's paths and shapes), each leaf
drawn from numpy by its name as ``random_reference_state_dict`` draws the
port's layout: He-scaled convolutions, 1e-3 heads, a visible hand in the
``mano_regress`` bias, and every Bottleneck's ``bn3`` scale damped by the
square root of the trunk's block count.  The port's net takes them through
``state_dict_from_jax``.  Each JAX function is jitted once.

Tolerances are the depth-18 tests': the eval forward as
test_torch_backbone.py (stage 1 1e-5 relative, stage 2 1e-4), the
train-mode forward and the Pretrain step as test_torch_train_step.py
(heads 2e-3, trunks 0.15 relative L2; running statistics 5e-5 / 2e-4 of
each tensor's largest entry), bfloat16 as test_torch_bf16_model.py (the
port's distance from float64 within 1.5x JAX's + 1e-3).
"""

import hashlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dsf_tpu.mano import model as JM, synthetic as JS
from dsf_tpu.models.backbone import ManoOCRStage as JManoOCRStage
from dsf_tpu.render import renderer as JR
from dsf_tpu_torch.mano import model as TM
from dsf_tpu_torch.models.backbone import ManoOCRStage
from dsf_tpu_torch.models.resnet import RESNET_SPECS, Bottleneck
from dsf_tpu_torch.models.weights import (random_reference_state_dict,
                                          reference_depth,
                                          state_dict_from_jax)
from dsf_tpu_torch.render import renderer as TR
from torch_parity import float64_renderer, jax_deep_variables

torch.set_num_threads(2)

PARAS = (588.03, 587.07, 320.0, 240.0)
S, B = 64, 2
DEPTHS = (50, 101, 152)
HEADS = ("mano_regress", "finals_s2")
# the ResNet-18 draw of random_reference_state_dict(RandomState(0)) with two
# and with one stage: the tests at depth 18 rest on it
R18_SHA256 = {
    True: "aa6af8768490083af018acffb6706397341031764373f7915dd406d50a5d9de9",
    False: "b6364b25642a3ef5e7b89cdf859abca8599d7210f1da97b38687e4925351230d"}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mano") / "syn.npz")
    JS.save_synthetic_mano(path)
    jr = JR.Renderer.create(JM.load_model(path), "nyu", PARAS, (640, 480),
                            (S, S))
    tr = TR.Renderer.create(TM.load_model(path, device="cpu"), "nyu", PARAS,
                            (640, 480), (S, S))
    rng = np.random.RandomState(1)
    img = rng.uniform(-1, 1, (2 * B, 1, S, S)).astype(np.float32)
    img[:, :, :8] = 1.0                                  # some background
    center = np.array([[10.0, -5.0, 700.0], [-20.0, 15.0, 800.0]] * 2,
                      np.float32)
    cube = np.full((2 * B, 3), 250.0, np.float32)
    return dict(path=path, jr=jr, tr=tr, img=img, center=center, cube=cube,
                variables={})


def _variables(env, depth):
    if depth not in env["variables"]:
        env["variables"][depth] = jax_deep_variables(depth, env["jr"], S)
    return env["variables"][depth]


def _net(sd, depth, **kw):
    net = ManoOCRStage(joint_num=21, depth=depth, **kw)
    net.load_state_dict(sd)                             # strict
    return net


def _rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _sha(sd):
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(np.ascontiguousarray(sd[k]).tobytes())
    return h.hexdigest()


# ------------------------------------------------------------ structure

@pytest.mark.parametrize("depth", DEPTHS)
def test_carried_state_dict_loads_strictly(env, depth):
    """The state dict carried from JAX's tree has every key and shape of
    the port's net and no other (a strict load), and so has the seeded
    draw at depth 50 (at 152 it loads strictly below);
    ``reference_depth`` reads the depth back from the keys.  The Bottleneck's rule for a downsample is JAX's:
    ``layer1_s2.0`` takes 256 = 64 * 4 channels and has none, while
    ``layer1.0`` (64 in) has one."""
    sd = state_dict_from_jax(_variables(env, depth))
    net = _net(sd, depth)
    own = net.state_dict()
    assert sorted(sd) == sorted(own)
    for k, v in own.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    assert reference_depth(sd) == depth
    if depth == 50:     # the seeded draw at 152: test_seeded_draw_keeps_...
        seeded = random_reference_state_dict(np.random.RandomState(0),
                                             depth=depth)
        assert sorted(seeded) == sorted(own)
        for k, v in own.items():
            assert tuple(seeded[k].shape) == tuple(v.shape), k
        assert reference_depth(seeded) == depth
    assert "layer1_s2.0.downsample.0.weight" not in own
    assert "layer1.0.downsample.0.weight" in own
    assert own["mano_regress.2.weight"].shape == (62, 2048)
    assert own["deconv_layer4_s2.0.weight"].shape == (2048, 256, 4, 4)
    assert isinstance(net.layer3_s2[0], Bottleneck)
    assert len(net.layer3) == RESNET_SPECS[depth][1][2]


def test_seeded_draw_keeps_the_hand_at_152(env):
    """``random_reference_state_dict`` at depth 152 (the card's seeded
    weights): in eval and in train mode both stages' MANO parameters stay
    O(1), the cam scale near its bias of 1, and the stage-1 hand covers
    more than 2% of the stage-2 render."""
    sd = random_reference_state_dict(np.random.RandomState(0), depth=152)
    net = _net({k: torch.as_tensor(v) for k, v in sd.items()}, 152)
    args = [torch.from_numpy(env[k][:B]) for k in ("img", "center", "cube")]
    for train in (False, True):
        net.train(train)
        with torch.no_grad():
            out = net(args[0], env["tr"], *args[1:])
            mano_img, _, _, _ = TR.render_params(env["tr"], out[0][1],
                                                 *args[1:], img_stride=2)
        for _, mp in out:
            assert mp.abs().max() < 3.0, (train, mp.abs().max())
            assert (mp[:, 58] - 1.0).abs().max() < 0.2, train
        assert (mano_img < 0.99).float().mean() > 0.02, train


@pytest.mark.parametrize("refine", [True, False])
def test_resnet18_draw_is_unchanged(refine):
    """The seeded draw at depth 18 is what it was before the deep trunks:
    the same draws in the same order."""
    sd = random_reference_state_dict(np.random.RandomState(0), refine=refine)
    assert _sha(sd) == R18_SHA256[refine]
    assert reference_depth(sd) == 18


# ------------------------------------------------------------ eval forward

@pytest.mark.parametrize("depth", DEPTHS)
def test_eval_forward_matches_jax(env, depth):
    """Both stages of the eval forward at 64^2, B=2: stage 1 within 1e-5
    relative, stage 2 within 1e-4.  The damped draw keeps both stages'
    MANO parameters O(1) and the stage-1 hand in the re-render (> 2% of
    its pixels), at 152 layers too."""
    v = _variables(env, depth)
    net = _net(state_dict_from_jax(v), depth).eval()
    img, center, cube = (env[k][:B] for k in ("img", "center", "cube"))
    jnet = JManoOCRStage(joint_num=21, depth=depth, refine=True)
    jr = env["jr"]
    ref = jax.jit(lambda v, i, c, q: jnet.apply(v, i, jr, c, q, train=False))(
        v, jnp.asarray(img), jnp.asarray(center), jnp.asarray(cube))
    with torch.inference_mode():
        got = net(torch.from_numpy(img), env["tr"], torch.from_numpy(center),
                  torch.from_numpy(cube))
        mano_img, _, _, _ = TR.render_params(
            env["tr"], got[0][1], torch.from_numpy(center),
            torch.from_numpy(cube), img_stride=2)
    for stage, tol in enumerate((1e-5, 1e-4)):
        for g, r in zip(got[stage], ref[stage]):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=tol,
                                       atol=tol / 10)
        mp = got[stage][1].numpy()
        assert np.abs(mp).max() < 3.0, (stage, np.abs(mp).max())
        np.testing.assert_allclose(mp[:, 58], 1.0, atol=0.2)
    assert (mano_img < 0.99).float().mean() > 0.02


# ------------------------------------------------------------ train mode

@pytest.fixture(scope="module")
def train_mode(env):
    """The one-stage depth-50 net in train mode, with ``bn_groups`` 1 and 2
    (4 crops of 64^2 as two stacked batches), both packages: outputs,
    running statistics after the forward and the gradients of the sum of
    squares of every output."""
    depth = 50
    v = _variables(env, depth)
    v1 = {"params": {k: v["params"][k] for k in ("trunk", "heads")},
          "batch_stats": {k: v["batch_stats"][k] for k in ("trunk", "heads")}}
    sd = state_dict_from_jax(v1)
    img = env["img"]
    out = {}
    for groups in (1, 2):
        x = img[:B] if groups == 1 else img
        jnet = JManoOCRStage(joint_num=21, depth=depth, refine=False,
                             bn_groups=groups)

        def loss(params, x):
            o, mut = jnet.apply({"params": params,
                                 "batch_stats": v1["batch_stats"]}, x,
                                train=True, mutable=["batch_stats"])
            return sum(jnp.sum(t ** 2) for t in o[0]), (o, mut)

        (_, (jo, jmut)), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            v1["params"], jnp.asarray(x))
        net = _net(sd, depth, refine=False).train()
        got = net(torch.from_numpy(x), bn_groups=groups)
        sum(t.pow(2).sum() for t in got[0]).backward()
        jsd_g = state_dict_from_jax({"params": jg,
                                     "batch_stats": v1["batch_stats"]})
        jsd_s = state_dict_from_jax({"params": v1["params"],
                                     "batch_stats": jmut["batch_stats"]})
        out[groups] = dict(
            out=[(g.detach().numpy(), np.asarray(r))
                 for g, r in zip(got[0], jo[0])],
            grads={n: (p.grad.numpy(), jsd_g[n].numpy())
                   for n, p in net.named_parameters()},
            stats={n: (b.numpy(), jsd_s[n].numpy())
                   for n, b in net.named_buffers() if "running" in n},
            before=sd)
    return out


@pytest.mark.parametrize("groups", [1, 2])
def test_train_forward_and_gradient_match_jax(train_mode, groups):
    """Train mode at depth 50: outputs within 1e-4 relative L2 (batch
    statistics normalize every layer, so the sides differ by float32
    rounding), the running statistics within 5e-5 of each tensor's
    largest entry, each gradient within 2e-3 relative L2 in the MANO head
    and 0.15 elsewhere (the step tests' bounds)."""
    r = train_mode[groups]
    for g, j in r["out"]:
        assert g.shape == j.shape and np.isfinite(g).all()
        assert _rel(g, j) <= 1e-4, _rel(g, j)
    assert len(r["stats"]) == 2 * 56       # BatchNorms of one stage at depth 50
    for n, (g, j) in r["stats"].items():
        assert not np.array_equal(j, r["before"][n].numpy()), n
        np.testing.assert_allclose(g, j, rtol=0, atol=5e-5 * np.abs(j).max(),
                                   err_msg=n)
    worst = {}
    for n, (g, j) in r["grads"].items():
        assert np.isfinite(g).all() and np.abs(j).max() > 0, n
        worst[n] = _rel(g, j)
        assert worst[n] <= (2e-3 if n.startswith(HEADS) else 0.15), (
            n, worst[n])
    print(f"groups {groups}: worst gradient {max(worst.values()):.2e}")


# ------------------------------------------------------------ bfloat16

def _f(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(
        jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("stage", [0, 1])
def test_bf16_forward_within_jax_distance_of_float64(env, stage):
    """The depth-50 eval forward in bfloat16, both packages, each against
    the port's float64 forward on the same weights (the witness): per
    stage, the offset field's and the MANO parameters' relative L2
    distance, the port's within 1.5x JAX's + 1e-3 and JAX's below 5%
    (test_torch_bf16_model.py's rule at depth 18)."""
    if "bf16" not in env:
        v = _variables(env, 50)
        sd = state_dict_from_jax(v)
        net = _net(sd, 50, dtype=torch.bfloat16).eval()
        net64 = _net(sd, 50).double().eval()
        img, center, cube = (env[k][:B] for k in ("img", "center", "cube"))
        jr = env["jr"]
        jnet = JManoOCRStage(joint_num=21, depth=50, refine=True,
                             dtype=jnp.bfloat16)
        ref = jax.jit(lambda v, i, c, q: jnet.apply(v, i, jr, c, q,
                                                    train=False))(
            v, jnp.asarray(img), jnp.asarray(center), jnp.asarray(cube))
        args = [torch.from_numpy(x) for x in (img, center, cube)]
        with torch.inference_mode():
            got = net(args[0], env["tr"], args[1], args[2])
            exact = net64(*[a.double() for a in args[:1]],
                          float64_renderer(env["tr"]),
                          *[a.double() for a in args[1:]])
        env["bf16"] = (got, ref, exact)
    got, ref, exact = env["bf16"]
    for k in range(2):
        assert got[stage][k].dtype == torch.bfloat16
        e = exact[stage][k].numpy()
        d_port = _rel(_f(got[stage][k]), e)
        d_jax = _rel(_f(ref[stage][k]), e)
        print(f"stage {stage + 1} output {k}: port {d_port:.2e}, "
              f"JAX {d_jax:.2e}")
        assert d_jax < 0.05, (k, d_jax)
        assert d_port <= 1.5 * d_jax + 1e-3, (k, d_port, d_jax)
