"""The port's multi-GPU layer on the CPU, in worlds of two gloo ranks
(tests/torch_parallel_workers.py): each rank holds different rows, and
every result is held against the port's own world-1 run and, where the
JAX package has the same function, against JAX on the 8-device CPU mesh
of tests/conftest.py.

* BatchNorm's global statistics (``BatchNorm2d.sync``): a conv+BN stack,
  one group and two, float32 and bfloat16: outputs, input and parameter
  gradients, running statistics;
* the M2P term's global joint count (``phases._masked_select_sl1``) with
  masked joints that fall unevenly between the ranks;
* the guarded optimizer under data parallelism and ``n_fsdp=2``: a NaN
  gradient on one rank rejects on both, the updates and the whole state
  are world 1's;
* ``Trainer.evaluate``'s sums, ``shard_dataset_indices`` against JAX's
  (its multi-host stripes, ``jax.process_count`` patched as
  tests/test_distributed.py does), the loader's stripes (augmentation
  draws and the padded eval tail included), the engine on two devices,
  and the kernel wrappers' device guard.
"""

import os
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from dsf_tpu.models import layers as JL
from dsf_tpu.parallel import distributed as JD
from dsf_tpu.parallel import mesh as JM
from dsf_tpu_torch.config import Config
from dsf_tpu_torch.data import aug_batch
from dsf_tpu_torch.data.datasets import BaseDataset
from dsf_tpu_torch.kernels import build
from dsf_tpu_torch.mano.synthetic import save_synthetic_mano
from dsf_tpu_torch.models.weights import random_reference_state_dict
from dsf_tpu_torch.parallel import distributed as TD
from dsf_tpu_torch.parallel.mesh import Mesh, check_layout
from dsf_tpu_torch.serving import InferenceEngine

torch.set_num_threads(2)

BN_CASES = [(1, "float32"), (2, "float32"), (1, "bfloat16"),
            (2, "bfloat16")]
ROWS, HW = 8, 10          # rows of each group, crop side


def _bn_case(groups, dtype, seed=0):
    rng = np.random.RandomState(seed)
    n = groups * ROWS
    f = lambda *s: rng.randn(*s).astype(np.float32)
    # each group its own offset and scale, so per-group statistics differ
    x = np.concatenate([f(ROWS, 1, HW, HW) * (1 + g) + 2 * g
                        for g in range(groups)])
    return dict(groups=groups, dtype=dtype, x=x, r=f(n, 16, HW, HW),
                w=[f(8, 1, 3, 3) * 0.5, f(16, 8, 3, 3) * 0.2],
                scale=[1 + 0.1 * f(8), 1 + 0.1 * f(16)],
                bias=[0.1 * f(8), 0.1 * f(16)])


def _sl1_case(seed=1):
    rng = np.random.RandomState(seed)
    a = rng.randn(6, 21, 3).astype(np.float32) * 0.02
    b = rng.randn(6, 21, 3).astype(np.float32) * 0.02
    mask = np.zeros((6, 21), bool)
    mask[0, :7] = mask[1, 3:5] = True          # rank 0: 9 joints
    mask[4, 20] = True                         # rank 1: 1 joint
    return dict(a=a, b=b, mask=mask)


def _guard_case(n_fsdp, seed=2):
    rng = np.random.RandomState(seed)
    shapes = [(5, 3), (8,)]                    # 23 elements: a padded shard
    g = lambda: [[rng.randn(*s).astype(np.float32) for s in shapes]
                 for _ in range(2)]
    nan = g()
    nan[0][1][3] = np.nan                      # rank 0 only
    return dict(n_fsdp=n_fsdp, w=[rng.randn(*s).astype(np.float32)
                                  for s in shapes],
                grads=[g(), nan, g()])


def _eval_case(seed=3):
    rng = np.random.RandomState(seed)
    return dict(errors=[[rng.rand(4, 3).astype(np.float32) for _ in range(2)]
                        for _ in range(2)])


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every unit case run once in one world of two ranks."""
    cases = {f"bn{g}_{d}": ("bn_stack", _bn_case(g, d)) for g, d in BN_CASES}
    cases["sl1"] = ("masked_sl1", _sl1_case())
    cases.update({f"guard{k}": ("guard", _guard_case(k)) for k in (1, 2)})
    cases["eval"] = ("evaluate_sum", _eval_case())
    ranks = W.run_world("units", 2, cases, str(tmp_path_factory.mktemp("w")),
                        timeout=600)
    return cases, ranks


def _unstripe(parts, groups):
    """The global batch from the ranks' group-major stacks."""
    per = [np.split(p, groups) for p in parts]
    return np.concatenate([np.concatenate([q[g] for q in per])
                           for g in range(groups)])


class _JNet(nn.Module):
    groups: int
    dtype: object

    @nn.compact
    def __call__(self, x, train=True):
        for i, ch in enumerate((8, 16)):
            x = JL.ConvBNRelu(ch, dtype=self.dtype, bn_groups=self.groups,
                              name=f"c{i}")(x, train)
        return x


def _jax_bn(case):
    """The JAX stack on the 8-device mesh, its batch sharded: output,
    input and parameter gradients of sum(y * r), batch statistics."""
    dt = jnp.bfloat16 if case["dtype"] == "bfloat16" else None
    net = _JNet(case["groups"], dt)
    x = jnp.asarray(case["x"].transpose(0, 2, 3, 1), dt or jnp.float32)
    r = jnp.asarray(case["r"].transpose(0, 2, 3, 1))
    v = jax.tree_util.tree_map(np.asarray, net.init(
        jax.random.PRNGKey(0), x, train=False))
    params = v["params"]
    for i in range(2):
        params[f"c{i}"]["conv"]["conv"]["kernel"] = \
            case["w"][i].transpose(2, 3, 1, 0)
        params[f"c{i}"]["bn"]["bn"]["scale"] = case["scale"][i]
        params[f"c{i}"]["bn"]["bn"]["bias"] = case["bias"][i]

    def loss(p, xx, rr):
        y, mut = net.apply({"params": p, "batch_stats": v["batch_stats"]},
                           xx, train=True, mutable=["batch_stats"])
        return (y.astype(jnp.float32) * rr).sum(), (y, mut["batch_stats"])

    mesh = JM.make_mesh()
    xs, rs = JM.shard_batch(mesh, x), JM.shard_batch(mesh, r)
    fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    (_, (y, stats)), (gp, gx) = fn(params, xs, rs)
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    return dict(
        y=f32(y).transpose(0, 3, 1, 2), x_grad=f32(gx).transpose(0, 3, 1, 2),
        stats=[(f32(stats[f"c{i}"]["bn"]["bn"]["mean"]),
                f32(stats[f"c{i}"]["bn"]["bn"]["var"])) for i in range(2)],
        grads={f"{i}.0.weight": f32(gp[f"c{i}"]["conv"]["conv"]["kernel"])
               .transpose(3, 2, 0, 1) for i in range(2)}
        | {f"{i}.1.{t}": f32(gp[f"c{i}"]["bn"]["bn"][j])
           for i in range(2) for t, j in (("weight", "scale"),
                                          ("bias", "bias"))})


def _rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _hold_stats(got, ref, tol, label):
    """Each layer's running mean and variance within ``tol`` of their
    scale."""
    for i in range(2):
        for a, b in zip(got["stats"][i][:2], ref["stats"][i][:2]):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=tol * np.abs(b).max(),
                                       err_msg=f"{label} stats {i}")


def _steps(a, b):
    """|a - b| in bfloat16 steps at the larger magnitude."""
    m = np.maximum(np.abs(a), np.abs(b))
    step = np.exp2(np.floor(np.log2(np.where(m > 0, m, 1.0))) - 7)
    return np.abs(a - b) / step


@pytest.mark.parametrize("groups, dtype", BN_CASES)
def test_batch_norm_statistics_are_global(world2, groups, dtype):
    """Two ranks, each with its own rows of every group, give world 1's
    conv+BN stack and the JAX package's on its 8-device mesh (the batch
    sharded, as tests/test_distributed.py runs it): the output, the
    gradients of sum(y * r) (summed over the ranks) and the running
    statistics, one EMA update per group.  Float32: outputs within 1e-5
    of their largest magnitude, gradients within 1e-4 relative L2,
    statistics within 1e-5 of their scale.  Bfloat16, against world 1
    (the statistics' float32 sums in other orders may round an output one
    bfloat16 step apart): outputs within one step on at most 2% of the
    elements, gradients within 1e-2 relative L2, statistics within 1e-5
    of their scale; against JAX as close as world 1 is (the one-device
    port's bfloat16 BatchNorm rounds where Flax's does, its convolutions
    sum in other orders) plus one bfloat16 step of the output's scale,
    1e-2 of the gradients' norm and 1e-5 of the statistics' scale.  A
    rank's own rows give other statistics (per-rank BatchNorm would pass
    none of this)."""
    cases, ranks = world2
    case = cases[f"bn{groups}_{dtype}"][1]
    one = W.bn_stack(case)
    two = [r[f"bn{groups}_{dtype}"] for r in ranks]
    ref = _jax_bn(case)
    y2 = _unstripe([t["y"] for t in two], groups)
    xg2 = _unstripe([t["x_grad"] for t in two], groups)
    grads2 = {k: sum(t["grads"][k] for t in two) for k in two[0]["grads"]}
    for i in range(2):
        for t in two:
            assert t["stats"][i][2] == groups
            for a, b in zip(t["stats"][i][:2], two[0]["stats"][i][:2]):
                assert np.array_equal(a, b)      # one global EMA on both
    if dtype == "float32":
        for label, other in (("world 1", one), ("JAX", ref)):
            np.testing.assert_allclose(
                y2, other["y"], rtol=0, atol=1e-5 * np.abs(other["y"]).max(),
                err_msg=label)
            assert _rel(xg2, other["x_grad"]) < 1e-4, (label, "x")
            for k, g in grads2.items():
                assert _rel(g, other["grads"][k]) < 1e-4, (label, k)
            _hold_stats(two[0], other, 1e-5, label)
    else:
        s = _steps(y2, one["y"])
        assert s.max() <= 1 and (s > 0).mean() <= 0.02
        assert _rel(xg2, one["x_grad"]) < 1e-2
        for k, g in grads2.items():
            assert _rel(g, one["grads"][k]) < 1e-2, k
        _hold_stats(two[0], one, 1e-5, "world 1")
        # against JAX as close as the one-device port is, plus a step
        step = 2.0 ** -8 * np.abs(ref["y"]).max()
        assert np.abs(y2 - ref["y"]).max() <= np.abs(
            one["y"] - ref["y"]).max() + step
        assert _rel(xg2, ref["x_grad"]) < _rel(one["x_grad"],
                                               ref["x_grad"]) + 1e-2
        for k, g in grads2.items():
            assert _rel(g, ref["grads"][k]) < _rel(
                one["grads"][k], ref["grads"][k]) + 1e-2, k
        for i in range(2):
            for a, b, c in zip(two[0]["stats"][i][:2], one["stats"][i][:2],
                               ref["stats"][i]):
                assert np.abs(a - c).max() <= np.abs(b - c).max() \
                    + 1e-5 * np.abs(c).max()
    # a rank's local statistics differ from the global ones
    local = W.bn_stack(dict(case, x=np.concatenate(
        [h[:ROWS // 2] for h in np.split(case["x"], groups)]),
        r=np.concatenate([h[:ROWS // 2] for h in np.split(case["r"], groups)])))
    assert _rel(local["stats"][0][1], one["stats"][0][1]) > 1e-3


def test_masked_count_is_global(world2):
    """The M2P term with 9 masked joints on rank 0 and 1 on rank 1: the
    ranks' mean value and their gradients (each over the world size) are
    world 1's masked mean, not the mean of the ranks' own means."""
    cases, ranks = world2
    one = W.masked_sl1(cases["sl1"][1])
    two = [r["sl1"] for r in ranks]
    assert np.isclose(np.mean([t["value"] for t in two]), one["value"],
                      rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        np.concatenate([t["grad"] for t in two]) / 2, one["grad"], rtol=1e-6,
        atol=1e-12)
    # each rank's own masked mean, averaged, is another number
    a, b, m = (cases["sl1"][1][k] for k in ("a", "b", "mask"))
    own = [W.masked_sl1(dict(a=a[s], b=b[s], mask=m[s]))["value"]
           for s in (slice(0, 3), slice(3, 6))]
    assert abs(np.mean(own) - one["value"]) > 0.1 * one["value"]


@pytest.mark.parametrize("n_fsdp", [1, 2])
def test_guard_rejects_everywhere_and_updates_as_world_one(world2, n_fsdp):
    """The guarded AdamW on two ranks with different gradients: the
    update of the ranks' mean gradient on both (bitwise world 1's fed
    that mean), a NaN in one element of rank 0's second gradient rejects
    the step on both ranks (parameters, moments and the update count
    kept), and the third is accepted again.  Under ``n_fsdp=2`` the
    moments live in two shards of the 23 elements (one padded);
    ``state_dict`` gathers world 1's whole buffers, and reloading it
    gives each rank its shard back."""
    cases, ranks = world2
    case = cases[f"guard{n_fsdp}"][1]
    mean = [[(g[0][i] + g[1][i]) / np.float32(2) for i in range(2)]
            for g in case["grads"]]
    one = W.guard(dict(case, n_fsdp=1, grads=[[m] for m in mean]))
    for t in (r[f"guard{n_fsdp}"] for r in ranks):
        assert [s[0] for s in t["steps"]] == [True, False, True]
        assert [s[2:] for s in t["steps"]] == [(1, 0), (1, 1), (2, 0)]
        for (_, p2, *_), (_, p1, *_) in zip(t["steps"], one["steps"]):
            for a, b in zip(p2, p1):
                assert np.array_equal(a, b)
        for k in ("mu", "nu"):
            assert np.array_equal(t["state"][k], one["state"][k])
            n = t["reloaded"][k].size
            assert n == (12 if n_fsdp == 2 else 23)
        assert t["state"]["count"] == one["state"]["count"]
    if n_fsdp == 2:
        whole = np.concatenate([r["guard2"]["reloaded"]["mu"]
                                for r in ranks])
        assert np.array_equal(whole[:23], one["state"]["mu"])
        assert whole[23] == 0


def test_evaluate_sums_errors_and_counts_over_ranks(world2):
    cases, ranks = world2
    rows = cases["eval"][1]["errors"]
    allrows = np.concatenate([b for r in rows for b in r], axis=1)
    for r in ranks:
        np.testing.assert_allclose(r["eval"], allrows.mean(1), rtol=1e-6)


@pytest.mark.parametrize("n, batch, seed", [(100, 8, 3), (17, 8, 0),
                                             (64, 32, 5)])
def test_shard_dataset_indices_match_jax(monkeypatch, n, batch, seed):
    for pid in (0, 1):
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda pid=pid: pid)
        ref = JD.shard_dataset_indices(n, batch, seed=seed)
        got = TD.shard_dataset_indices(n, batch, seed=seed, rank=pid,
                                       world=2)
        assert np.array_equal(got, ref)


class _Frames(BaseDataset):
    """Frames that are their index; the augmented path's draws are
    returned as they reach the augmentation."""
    augment, aug_para = True, (10, 0.2, 180)
    paras = img_size = None

    def __init__(self, n):
        self.n, self.rng = n, np.random.RandomState(0)

    def __len__(self):
        return self.n

    def _fetch_batch(self, idx, stripe=(0, 1)):
        out = self._aug_fast_batch(idx, None, np.zeros((self.n, 1, 3)),
                                   None, np.zeros((len(idx), 3)), stripe)
        return dict(out, idx=np.asarray(idx))


def test_loader_stripes_reassemble_the_global_batch(monkeypatch):
    """Two ranks' stripes of the shuffled augmented batches are world 1's
    batches, frame and augmentation draw alike; an eval pass without
    drop_last pads its tail by repeating its last frame before it
    stripes; a batch that does not divide raises; the mesh's stripe is
    the same split."""
    monkeypatch.setattr(aug_batch, "augment_fast_batch",
                        lambda *a, **k: {"draws": np.asarray(
                            [repr(d) for d in a[7]])})
    whole = list(_Frames(21).batches(8, shuffle=True, seed=4))
    parts = [list(_Frames(21).batches(8, shuffle=True, seed=4, rank=r,
                                      world=2)) for r in (0, 1)]
    assert len(whole) == 2
    for k, b in enumerate(whole):
        for key in ("idx", "draws"):
            assert np.array_equal(np.concatenate(
                [p[k][key] for p in parts]), b[key])
    monkeypatch.setattr(_Frames, "augment", False)
    monkeypatch.setattr(_Frames, "_fetch_batch",
                        lambda self, idx, stripe: {"idx": np.asarray(idx)})
    tail = [list(_Frames(10).batches(4, rank=r, world=2, drop_last=False))
            for r in (0, 1)]
    assert [b["idx"].tolist() for b in tail[0]] == [[0, 1], [4, 5], [8, 9]]
    assert [b["idx"].tolist() for b in tail[1]] == [[2, 3], [6, 7], [9, 9]]
    with pytest.raises(ValueError, match="does not divide"):
        next(_Frames(10).batches(5, rank=0, world=2))
    m = Mesh(world=2, rank=1)
    assert m.stripe(np.arange(8)).tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="does not divide"):
        m.stripe(np.arange(7))
    with pytest.raises(ValueError, match="n_fsdp=3"):
        check_layout(4, 3)


@pytest.fixture(scope="module")
def mano(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mano") / "m.npz")
    save_synthetic_mano(path)
    return path


def test_engine_on_two_devices_equals_one(mano):
    """``num_devices=2`` on ``devices=("cpu", "cpu")``: two replicas, each
    bucket split in two, the results concatenated in request order: the
    one-device engine's (a request of 3 in bucket 4, one of 6 in chunks
    of 4 and 2) within 1e-6 of each output's scale, not bitwise: oneDNN's
    convolutions and GEMMs round by the batch they are given (4 rows on
    one replica, 2 on each of two; ~1e-7 of the scale measured); a bucket
    that does not divide by 2, or more replicas than devices given,
    raises before anything is loaded."""
    sd = random_reference_state_dict(np.random.RandomState(0))
    cfg = Config(input_size=64, mano_model_path=mano)
    one = InferenceEngine(cfg, sd, buckets=(2, 4), device="cpu")
    two = InferenceEngine(cfg.replace(num_devices=2), sd, buckets=(2, 4),
                          devices=("cpu", "cpu"))
    assert len(two.replicas) == 2 and two.replicas[0][0] is not \
        two.replicas[1][0]
    from dsf_tpu_torch import demo
    for n in (3, 6):
        img, center, M, cube = demo.requests(one.renderer, n,
                                             np.random.RandomState(n))
        a = one.predict(img, center, M, cube)
        b = two.predict(img, center, M, cube)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-6 * np.abs(
                a[k]).max(), err_msg=k)
    with pytest.raises(ValueError, match=r"buckets \[1\]"):
        InferenceEngine(cfg.replace(num_devices=2), sd, buckets=(1, 4),
                        devices=("cpu", "cpu"))
    with pytest.raises(ValueError, match="num_devices=3"):
        InferenceEngine(cfg.replace(num_devices=3), sd, buckets=(3,),
                        devices=("cpu", "cpu"))


def test_kernels_launch_on_their_tensors_device(monkeypatch):
    """``build.on_device``, the guard every kernel wrapper launches under,
    enters the tensors' own card and takes that card's stream, not the
    caller's current device's; tensors on two cards, or on the CPU, raise.
    No wrapper takes a stream any other way.  (On a one-card machine the
    launch on a second card is not run.)"""
    seen = []

    class Dev:
        def __init__(self, d):
            seen.append(("device", d))

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    monkeypatch.setattr(torch.cuda, "device", Dev)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: (
        seen.append(("stream", d)), types.SimpleNamespace(cuda_stream=7))[1])
    on = lambda i: types.SimpleNamespace(device=torch.device("cuda", i))
    with build.on_device(on(1), None, on(1)) as stream:
        assert stream == 7
    assert seen == [("device", torch.device("cuda", 1)),
                    ("stream", torch.device("cuda", 1))]
    with pytest.raises(ValueError, match="cuda:0, cuda:1"):
        with build.on_device(on(1), on(0)):
            pass
    with pytest.raises(ValueError, match="one CUDA device"):
        with build.on_device(torch.zeros(1)):
            pass
    ops = os.path.join(os.path.dirname(build.__file__), "..", "ops")
    for f in sorted(os.listdir(ops)):
        if f.endswith("_kernel.py"):
            src = open(os.path.join(ops, f)).read()
            assert "current_stream" not in src and "build.on_device(" in src, f
