"""Port parity for the bfloat16 compute dtype, the model and serving: the
two-stage ManoOCRStage eval forward with ``dtype=bfloat16`` against the
JAX package's (64x64 crops, B=2, the same variables), the serving decode
of a bfloat16 field, and the dtype surface of ``Trainer`` and
``InferenceEngine``.

bfloat16 rounds each layer's output to 8 significant bits, and the
stage-2 re-render is discontinuous in the stage-1 MANO parameters, so
the two packages' bfloat16 outputs are not held to each other directly.
Each is held against the port's float64 forward on the same weights (the
witness): the port's distance within a small multiple of JAX's, and
JAX's distance itself bounded.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dsf_tpu.mano import model as JM, synthetic as JS
from dsf_tpu.models import torch_import as TI
from dsf_tpu.models.backbone import ManoOCRStage as JManoOCRStage
from dsf_tpu.ops import offset_codec as JC
from dsf_tpu.render import renderer as JR
from dsf_tpu_torch.config import Config
from dsf_tpu_torch.mano import model as TM
from dsf_tpu_torch.models.backbone import ManoOCRStage
from dsf_tpu_torch.models.weights import (random_reference_state_dict,
                                          state_dict_from_jax)
from dsf_tpu_torch.ops import offset_codec as TC
from dsf_tpu_torch.render import renderer as TR
from dsf_tpu_torch.serving import InferenceEngine
from dsf_tpu_torch.training.trainer import Trainer
from torch_parity import float64_renderer

torch.set_num_threads(2)

PARAS = (588.03, 587.07, 320.0, 240.0)
S = 64
FG = 0.99


def _f(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(
        jnp.asarray(t).astype(jnp.float32))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mano") / "syn.npz")
    JS.save_synthetic_mano(path)
    jr = JR.Renderer.create(JM.load_model(path), "nyu", PARAS, (640, 480),
                            (S, S))
    tr = TR.Renderer.create(TM.load_model(path, device="cpu"), "nyu", PARAS,
                            (640, 480), (S, S))
    variables = TI.convert_mano_ocr_stage(
        random_reference_state_dict(np.random.RandomState(0)), refine=True)
    sd = state_dict_from_jax(variables)
    net = ManoOCRStage(joint_num=21, refine=True, dtype=torch.bfloat16)
    net.load_state_dict(sd)
    net64 = ManoOCRStage(joint_num=21, refine=True)
    net64.load_state_dict(sd)
    net.eval(), net64.double().eval()

    rng = np.random.RandomState(1)
    img = rng.uniform(-1, 1, (2, 1, S, S)).astype(np.float32)
    img[:, :, :8] = 1.0
    center = np.array([[10.0, -5.0, 700.0], [-20.0, 15.0, 800.0]], np.float32)
    cube = np.full((2, 3), 250.0, np.float32)
    jnet = JManoOCRStage(joint_num=21, refine=True, dtype=jnp.bfloat16)
    ref = jax.jit(lambda v, *a: jnet.apply(v, a[0], jr, *a[1:], train=False))(
        variables, jnp.asarray(img), jnp.asarray(center), jnp.asarray(cube))
    args = [torch.from_numpy(x) for x in (img, center, cube)]
    with torch.inference_mode():
        got = net(args[0], tr, args[1], args[2])
        exact = net64(args[0].double(), float64_renderer(tr),
                      args[1].double(), args[2].double())
    return dict(tr=tr, center=args[1], cube=args[2], img=args[0],
                ref=ref, got=got, exact=exact)


def test_outputs_are_bfloat16(setup):
    """Both stages' outputs are bfloat16 on both sides, the parameters
    float32, as in the JAX package (Flax's dtype casts per layer)."""
    for (gi, gm), (ri, rm) in zip(setup["got"], setup["ref"]):
        assert gi.dtype == gm.dtype == torch.bfloat16
        assert ri.dtype == rm.dtype == jnp.bfloat16
        assert gi.shape == (2, 84, S // 2, S // 2) and gm.shape == (2, 62)
        assert np.isfinite(_f(gi)).all() and np.isfinite(_f(gm)).all()


def _dist(a, exact):
    return float(np.linalg.norm(_f(a) - exact) / np.linalg.norm(exact))


@pytest.mark.parametrize("stage", [0, 1])
def test_stage_within_jax_distance_of_float64(setup, stage):
    """Each stage's offset field and MANO parameters, relative L2 from the
    float64 forward: the port's within 1.5x JAX's + 1e-3, and JAX's below
    5% (bfloat16's rounding, up to 2^-8 relative, compounding through
    some 20 layers; measured in the printed line).  Stage 2 also re-renders the stage-1 MANO
    parameters, each side its own: the silhouette pixels of the port's
    re-render that differ from the float64 one's are counted and held
    below 2% of the crop."""
    exact = [t.numpy() for t in setup["exact"][stage]]
    rows = []
    for k in range(2):
        d_port = _dist(setup["got"][stage][k], exact[k])
        d_jax = _dist(setup["ref"][stage][k], exact[k])
        rows.append((d_port, d_jax))
        assert d_jax < 0.05, (stage, k, d_jax)
        assert d_port <= 1.5 * d_jax + 1e-3, (stage, k, d_port, d_jax)
    print(f"stage {stage + 1} relative L2 from float64 (port, JAX): "
          f"field {rows[0]}, mano_para {rows[1]}")
    if stage == 1:
        r = setup["tr"]
        with torch.inference_mode():
            img_b, _, _, _ = TR.render_params(
                r, setup["got"][0][1].float(), setup["center"],
                setup["cube"], img_stride=2)
            img_e, _, _, _ = TR.render_params(
                float64_renderer(r), setup["exact"][0][1],
                setup["center"].double(), setup["cube"].double(),
                img_stride=2)
        flips = int(((img_b < FG) != (img_e < FG)).sum())
        print(f"stage-2 re-render silhouette flips against float64: {flips} "
              f"of {img_b.numel()}")
        assert (img_e < FG).float().mean() > 0.02
        assert flips <= 0.02 * img_b.numel()


def test_serving_decode_of_a_bf16_field(setup):
    """The serving decode of the stage-1 bfloat16 offset field: the port
    decodes it in float32 (on both devices; K4 on the card), the JAX
    package through its jnp path in bfloat16 (its softmax weights are
    bfloat16).  Each against the float64 decode of the same bfloat16
    values, in normalized uvd (1 = half the 250 mm cube): the port within
    1e-5, JAX's distance printed (the size ROADMAP Queue 3 records) and
    below 0.05."""
    field = setup["got"][0][0]
    img = setup["img"]
    port = TC.offset2joint_softmax(field, img, 0.8)
    assert port.dtype == torch.float32
    exact = TC.offset2joint_softmax(field.double(), img.double(), 0.8).numpy()
    ref = np.asarray(JC.offset2joint_softmax(
        jnp.asarray(_f(field), jnp.bfloat16), jnp.asarray(img.numpy()), 0.8),
        np.float64)
    d_port = np.abs(port.numpy() - exact).max()
    d_jax = np.abs(ref - exact).max()
    print(f"decode of a bf16 field from float64 (normalized uvd): port "
          f"float32 {d_port:.3g}, JAX bf16 {d_jax:.3g} "
          f"({d_jax * 125:.3g} mm at the 250 mm cube)")
    assert d_port <= 1e-5
    assert d_jax < 0.05


def test_engine_serves_bf16(tmp_path):
    """``InferenceEngine`` with ``compute_dtype="bfloat16"``: the net's
    parameters stay float32; ``predict`` returns float32 numpy arrays (a
    bfloat16 ``mano_para`` holds exactly in float32) and, with
    ``as_numpy=False``, bfloat16 ``mano_para`` tensors; "float16" raises."""
    path = str(tmp_path / "syn.npz")
    JS.save_synthetic_mano(path)
    sd = random_reference_state_dict(np.random.RandomState(0))
    cfg = Config(input_size=S, mano_model_path=path,
                 compute_dtype="bfloat16")
    eng = InferenceEngine(cfg, sd, buckets=(1, 2), device="cpu")
    assert all(p.dtype == torch.float32 for p in eng.net.parameters())
    rng = np.random.RandomState(2)
    img = rng.uniform(-1, 1, (2, 1, S, S)).astype(np.float32)
    img[:, :, :8] = 1.0
    center = np.array([[0.0, 0.0, 700.0]] * 2, np.float32)
    cube = np.full((2, 3), 250.0, np.float32)
    M = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    out = eng.predict(img, center, M, cube)
    for k, v in out.items():
        assert v.dtype == np.float32 and np.isfinite(v).all(), k
    raw = eng.predict(img, center, M, cube, as_numpy=False)
    assert raw["mano_para_0"].dtype == torch.bfloat16
    assert raw["joint_xyz_mm"].dtype == torch.float32
    np.testing.assert_array_equal(raw["mano_para_1"].float().numpy(),
                                  out["mano_para_1"])
    with pytest.raises(NotImplementedError, match="float16"):
        InferenceEngine(cfg.replace(compute_dtype="float16"), sd,
                        device="cpu")


def test_trainer_dtypes(tmp_path):
    """``Trainer`` builds the net and the generator in the compute dtype
    with float32 parameters; "float16" raises."""
    path = str(tmp_path / "syn.npz")
    JS.save_synthetic_mano(path)
    cfg = Config(input_size=S, batch_size=2, compute_dtype="bfloat16",
                 transferNet_pth=str(tmp_path / "missing"))
    tr = Trainer(cfg, path, device="cpu")
    st = tr.init_state()
    assert all(p.dtype == torch.float32 for p in st.net.parameters())
    assert st.net.mano_regress[2].compute_dtype == torch.bfloat16
    assert tr.transfer_net.model[-1].compute_dtype == torch.bfloat16
    x = torch.zeros(1, 1, S, S)
    assert tr.transfer(x).dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="float16"):
        Trainer(cfg.replace(compute_dtype="float16"), path, device="cpu")
