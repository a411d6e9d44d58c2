"""Port parity for the serving export: the serving path's kernels as
``torch.library`` custom ops (``dsf::raster_skip``, ``dsf::raster_binned``,
``dsf::encode``, ``dsf::decode``), ``InferenceEngine.export`` and
``load_exported``, on the CPU (input size 64, buckets (1, 2, 4), the
artifact at bucket 2), against the port's live ``predict`` and the JAX
package's ``load_exported`` of its own artifact from the same weights.

An artifact runs the ATen operators that the live engine runs, in the
same order, and the ops' CPU implementations are the plain versions the
live engine calls: the reloaded artifact equals live ``predict`` bitwise.
Against JAX's artifact the float32 outputs hold to
``tests/test_torch_serving.py``'s bounds (stage 1 1e-2 mm, stage 2
0.1 mm; 1e-4 and 1e-3 unitless).  bfloat16 rounds each layer to 8 bits
and the stage-2 re-render is discontinuous, so the two packages' bfloat16
artifacts are held to each other by a witness: at most 3x the distance
from JAX's bfloat16 artifact to its float32 one (what bfloat16 moves),
plus those bounds.
"""

import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from dsf_tpu import geometry as JG
from dsf_tpu.config import Config as JConfig
from dsf_tpu.mano import synthetic as JS
from dsf_tpu.models import torch_import as TI
from dsf_tpu.serving import InferenceEngine as JEngine
from dsf_tpu.serving import load_exported as j_load_exported
from dsf_tpu_torch import exported, kernels
from dsf_tpu_torch.config import Config
from dsf_tpu_torch.kernels import custom_ops
from dsf_tpu_torch.mano import model as TM
from dsf_tpu_torch.models.weights import random_reference_state_dict
from dsf_tpu_torch.ops import rasterize as ras
from dsf_tpu_torch.render import renderer as TR
from dsf_tpu_torch.serving import InferenceEngine, load_exported

torch.set_num_threads(2)

S = 64
PARAS = (588.03, 587.07, 320.0, 240.0)
BUCKETS = (1, 2, 4)
BUCKET = 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _atol(key):
    stage1 = key.endswith("_0")
    if "mm" in key:
        return 1e-2 if stage1 else 0.1
    return 1e-4 if stage1 else 1e-3


def _inputs(B, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.uniform(-1, 1, (B, 1, S, S)).astype(np.float32)
    img[:, :, :10] = 1.0
    center = rng.uniform([-40, -40, 650], [40, 40, 900],
                         (B, 3)).astype(np.float32)
    cube = np.full((B, 3), 250.0, np.float32)
    M = np.asarray(JG.crop_matrix(JG.xyz_to_uvd(center, PARAS), cube, PARAS,
                                  (S, S)))
    return img, center, M, cube


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    d = tmp_path_factory.mktemp("export")
    mano = str(d / "syn.npz")
    JS.save_synthetic_mano(mano)
    variables = TI.convert_mano_ocr_stage(
        random_reference_state_dict(np.random.RandomState(0)), refine=True)
    return dict(dir=d, mano=mano, variables=variables, arts={})


def _artifacts(env, dtype):
    """The port's engine, its CPU artifact at BUCKET and the JAX package's
    loaded artifact from the same weights, once per compute dtype."""
    if dtype not in env["arts"]:
        d = env["dir"]
        port = InferenceEngine(Config(input_size=S, mano_model_path=env["mano"],
                                      compute_dtype=dtype),
                               env["variables"], buckets=BUCKETS,
                               device="cpu")
        path = port.export(str(d / f"port_{dtype}.pt2"), bucket=BUCKET)
        ref = JEngine(JConfig(input_size=S, mano_model_path=env["mano"],
                              compute_dtype=dtype), env["variables"],
                      buckets=BUCKETS)
        jpath = ref.export(str(d / f"jax_{dtype}.bin"), bucket=BUCKET)
        env["arts"][dtype] = (port, path, j_load_exported(jpath))
    return env["arts"][dtype]


# ------------------------------------------------------------ the ops

def _raster_args(mano):
    """A stage-2 render's raster inputs at 32x32 (stride 2): two posed
    hands' projected vertices, the crop's sample positions, the faces."""
    m = TM.load_model(mano, device="cpu")
    r = TR.Renderer.create(m, "nyu", PARAS, (640, 480), (S, S))
    rng = np.random.RandomState(1)
    para = np.zeros((2, 62), np.float32)
    para[:, :48] = rng.randn(2, 48) * 0.3
    para[:, 58] = 1.0
    center = torch.tensor([[0.0, 0.0, 700.0], [20.0, -10.0, 800.0]])
    cube = torch.full((2, 3), 250.0)
    verts, _ = TM.get_mano_vertices(m, *TM.split_params(
        torch.from_numpy(para)), global_scale=1.0 / 125.0)
    verts = verts * cube[:, None] / 2.0 + center[:, None]
    com = JG.xyz_to_uvd(center.numpy()[:, None], PARAS)[:, 0]
    M = torch.from_numpy(np.asarray(JG.crop_matrix(com, cube.numpy(), PARAS,
                                                   (S, S))))
    rays = ras.crop_pixel_rays(M, r.crop_size, 2)
    return ras.project_verts(verts, PARAS), rays, m.faces


@pytest.mark.parametrize("op", custom_ops.OPS)
def test_opcheck(env, op):
    """torch.library.opcheck: the schema, the fake implementation's shapes
    and dtypes against the CPU implementation, and the op under
    aot_autograd with dynamic shapes; and the CPU implementation is the
    plain version, bitwise."""
    rng = np.random.RandomState(2)
    if op.startswith("raster"):
        proj, rays, faces = _raster_args(env["mano"])
        args = (proj, rays, faces, S // 2, S // 2)
        if op == "raster_skip":
            want = ras.raster_scan(proj, rays, faces)
        else:
            rows = ras.face_rows(proj, faces)
            want = ras.raster_binned_plain(
                rows, rays, (S // 2, S // 2),
                *ras.binned_tables(proj, rays, faces, (S // 2, S // 2), rows))
        assert (want[1] >= 0).float().mean() > 0.05
    elif op == "encode":
        from dsf_tpu_torch.ops import offset_codec as C
        joint = torch.from_numpy(rng.uniform(-1, 1, (2, 21, 3))
                                 .astype(np.float32))
        img = torch.from_numpy(rng.uniform(-1, 1, (2, 1, 32, 32))
                               .astype(np.float32))
        args = (joint, img, 0.8)
        want = C.joint2offset_plain(*args)
    else:
        from dsf_tpu_torch.ops import offset_codec as C
        field = torch.from_numpy(rng.randn(2, 84, 32, 32).astype(np.float32))
        depth = torch.from_numpy(rng.uniform(-1, 1, (2, 1, 32, 32))
                                 .astype(np.float32))
        args = (field, depth, 0.8, 30.0)
        want = C.decode_fwd_plain(*args)
    fn = getattr(torch.ops.dsf, op).default
    torch.library.opcheck(fn, args)
    got = fn(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and torch.equal(g, w)


# ------------------------------------------------------------ the export

def _live(port, args):
    return port.predict(*args, as_numpy=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_artifact_equals_live_predict(env, dtype):
    """The reloaded artifact at bucket 2 against live ``predict`` of the
    engine it came from: every output key, bitwise, in its dtype; the
    artifact's call launches no kernel on the CPU."""
    port, path, _ = _artifacts(env, dtype)
    call = load_exported(path, device="cpu")
    assert call.meta == {"bucket": BUCKET, "input_size": S, "device": "cpu",
                         "device_name": "cpu", "compute_dtype": dtype}
    args = _inputs(BUCKET, seed=3)
    before = dict(kernels.LAUNCHES)
    got = call(*args)
    assert kernels.LAUNCHES == before
    want = _live(port, args)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), (k, float(
            (got[k].float() - want[k].float()).abs().max()))


def test_artifact_matches_jax_artifact(env):
    """The port's float32 artifact against JAX's (``dsf_tpu.serving.
    load_exported``) on the same weights and requests, every key within
    the engine's bounds; the stage-2 render saw a hand."""
    port, path, jcall = _artifacts(env, "float32")
    call = load_exported(path, device="cpu")
    worst = {}
    for seed in (4, 5):
        args = _inputs(BUCKET, seed)
        got = {k: v.numpy() for k, v in call(*args).items()}
        ref = {k: np.asarray(v) for k, v in jcall(*args).items()}
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].shape == ref[k].shape and np.isfinite(got[k]).all()
            d = float(np.abs(got[k] - ref[k]).max())
            worst[k] = max(worst.get(k, 0.0), d)
            assert d <= _atol(k), (k, d)
        assert np.ptp(got["mano_mesh_mm_0"][..., 0], axis=1).min() > 30.0
    print("float32 artifact, port against JAX, max abs: "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))


def test_bf16_artifact_matches_jax_artifact(env):
    """The bfloat16 artifacts of both packages: the port's within 3x the
    distance from JAX's bfloat16 artifact to JAX's float32 one, plus the
    engine's bounds; every output finite, ``mano_para_*`` bfloat16."""
    _, path, jcall = _artifacts(env, "bfloat16")
    _, _, jcall32 = _artifacts(env, "float32")
    call = load_exported(path, device="cpu")
    args = _inputs(BUCKET, seed=4)
    raw = call(*args)
    assert raw["mano_para_0"].dtype == torch.bfloat16
    got = {k: v.float().numpy() for k, v in raw.items()}
    ref = {k: np.asarray(v, np.float32) for k, v in jcall(*args).items()}
    ref32 = {k: np.asarray(v) for k, v in jcall32(*args).items()}
    for k in ref:
        assert np.isfinite(got[k]).all(), k
        witness = float(np.abs(ref[k] - ref32[k]).max())
        d = float(np.abs(got[k] - ref[k]).max())
        print(f"bf16 artifact {k}: port against JAX {d:.4g}, JAX bf16 "
              f"against JAX f32 {witness:.4g}")
        assert d <= 3.0 * witness + _atol(k), (k, d, witness)


def test_binned_route_artifact(env, tmp_path, monkeypatch):
    """Exported with ``USE_PALLAS_SKIP`` off, the artifact holds
    ``dsf::raster_binned`` in place of ``dsf::raster_skip`` and equals the
    live engine under the same switch, bitwise."""
    port, path, _ = _artifacts(env, "float32")
    monkeypatch.setattr(ras, "USE_PALLAS_SKIP", False)
    binned = port.export(str(tmp_path / "binned.pt2"), bucket=1)
    names = {str(n.target) for n in torch.export.load(binned).graph.nodes
             if n.op == "call_function"}
    assert "dsf.raster_binned.default" in names
    assert "dsf.raster_skip.default" not in names
    skip_names = {str(n.target) for n in torch.export.load(path).graph.nodes
                  if n.op == "call_function"}
    assert {"dsf.raster_skip.default", "dsf.encode.default",
            "dsf.decode.default"} <= skip_names
    args = _inputs(1, seed=6)
    got = load_exported(binned, device="cpu")(*args)
    want = _live(port, args)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_loading_imports_no_model_code(env):
    """A fresh process loads and calls the artifact with the op registry
    alone: no ``dsf_tpu_torch.models``, ``render``, ``mano`` or
    ``training`` module gets imported (and nothing of JAX)."""
    _, path, _ = _artifacts(env, "float32")
    code = f"""
import sys
import numpy as np
from dsf_tpu_torch.exported import load_exported
call = load_exported({path!r}, device="cpu")
b, S = call.meta["bucket"], call.meta["input_size"]
rng = np.random.RandomState(0)
img = rng.uniform(-1, 1, (b, 1, S, S)).astype(np.float32)
center = np.tile([[0.0, 0.0, 750.0]], (b, 1)).astype(np.float32)
M = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
out = call(img, center, M, np.full((b, 3), 250.0, np.float32))
assert all(np.isfinite(v.float().numpy()).all() for v in out.values())
bad = sorted(m for m in sys.modules if m.split(".")[:2] in (
    ["dsf_tpu_torch", "models"], ["dsf_tpu_torch", "render"],
    ["dsf_tpu_torch", "mano"], ["dsf_tpu_torch", "training"])
    or m.split(".")[0] in ("jax", "dsf_tpu"))
print("IMPORTED", bad)
assert not bad, bad
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "IMPORTED []" in res.stdout


def test_wrong_shapes_and_devices_raise(env, tmp_path, monkeypatch):
    """A request of another bucket or crop size raises; an artifact
    exported on the card refuses ``device="cpu"`` (a stub file: this box
    has no card), a CPU one refuses the card (and ``None``, which is the
    card, raises without CUDA); a file without the metadata raises."""
    _, path, _ = _artifacts(env, "float32")
    call = load_exported(path, device="cpu")
    img, center, M, cube = _inputs(4)
    with pytest.raises(ValueError, match=r"takes \(2, 1, 64, 64\)"):
        call(img, center, M, cube)
    img, center, M, cube = _inputs(BUCKET)
    with pytest.raises(ValueError, match="M: the artifact takes"):
        call(img, center, M[:, :2], cube)
    with pytest.raises(ValueError, match="img: the artifact takes"):
        call(img[..., :32, :32], center, M, cube)
    stub = str(tmp_path / "cuda_stub.pt2")
    with zipfile.ZipFile(stub, "w") as z:
        z.writestr("cuda_stub/extra/" + exported.META,
                   '{"bucket": 2, "input_size": 64, "device": "cuda", '
                   '"device_name": "cuda:0", "compute_dtype": "float32"}')
    with pytest.raises(ValueError, match="exported on cuda"):
        load_exported(stub, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_exported(path)
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="exported on cpu"):
        load_exported(path, device="cuda")
    empty = str(tmp_path / "empty.pt2")
    with zipfile.ZipFile(empty, "w") as z:
        z.writestr("x/data.pkl", b"")
    with pytest.raises(ValueError, match="not an artifact"):
        load_exported(empty, device="cpu")
