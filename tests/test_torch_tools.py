"""Port parity for the offline tools and the library pieces they bring:
``mano/model``'s ``vertex_seg``, ``losses/basic.masked_depth_loss``,
``tools/fit_mano`` (``fit_params_world`` and ``fit_params``),
``tools/eval_coll``, ``tools/intersect``, ``tools/kinect_preview`` and
``tools/bench_input``, against the JAX package on the CPU.

``fit_params`` renders at 64^2 (B=2) and takes the raster's gradient:
JAX's jitted render can put another face nearest on a pixel at a face's
edge (XLA's fused float32 code deciding the edge the other way), where
the port's render and JAX's eager one agree.  Those pixels are counted
(at most 4), their share of m2d is taken out of JAX's m2d and loss, and
the gradient may move by their share of the render's foreground.  Adam's
first update is lr * sign(g) per element, so two free runs part where a
gradient element near zero takes the other sign: the three steps below
each start from JAX's own parameters and Adam moments.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from dsf_tpu.losses import basic as JB
from dsf_tpu.mano import model as JM
from dsf_tpu.mano import spheres as JSph
from dsf_tpu.mano import synthetic as JS
from dsf_tpu.render import renderer as JR
from dsf_tpu.tools import eval_coll as JE
from dsf_tpu.tools import fit_mano as JF
from dsf_tpu.tools import intersect as JI
from dsf_tpu_torch import demo
from dsf_tpu_torch.losses import basic as TB
from dsf_tpu_torch.mano import model as TM
from dsf_tpu_torch.render import renderer as TR
from dsf_tpu_torch.tools import bench_input, eval_coll, fit_mano, intersect
from dsf_tpu_torch.tools import kinect_preview

torch.set_num_threads(2)

S, B, LR = 64, 2, 0.01
PARAS = demo.PARAS
FLIP_MAX = 4


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    npz = JS.save_synthetic_mano(str(d / "mano.npz"))
    jm, tm = JM.load_model(npz), TM.load_model(npz, device="cpu")
    jr = JR.Renderer.create(jm, "nyu", PARAS, (640, 480), (S, S))
    tr = TR.Renderer.create(tm, "nyu", PARAS, (640, 480), (S, S))
    # the target: hands rendered from seeded parameters
    para, center, cube = demo.posed_params(tr, B, np.random.RandomState(0))
    with torch.no_grad():
        target = TR.render_params(tr, para, center, cube)[0]
    return dict(npz=npz, jm=jm, tm=tm, jr=jr, tr=tr, target=target.numpy(),
                center=center.numpy(), cube=cube.numpy())


def _rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-300))


def test_vertex_seg_matches_jax(env):
    got = env["tm"].vertex_seg.numpy()
    ref = np.asarray(env["jm"].vertex_seg)
    assert got.dtype == ref.dtype == np.int32 and got.shape == (778,)
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got)) == 16


def test_masked_depth_loss_matches_jax():
    """Within 1e-6 relative (a few float32 steps at ~0.9): the two sums
    of 4096 pixels run in other orders, each a few float32 steps from the
    float64 value (printed), so 1e-7 would hold the sum order, not the
    loss."""
    rng = np.random.RandomState(1)
    real = rng.uniform(-1, 1, (3, 1, S, S)).astype(np.float32)
    synth = rng.uniform(-1, 1, (3, 1, S, S)).astype(np.float32)
    real[:, :, :20] = 1.0
    synth[:, :, 40:] = 1.0
    synth[2] = 1.0                       # one sample: only real's mask
    got = TB.masked_depth_loss(torch.from_numpy(real),
                               torch.from_numpy(synth)).numpy()
    ref = np.asarray(JB.masked_depth_loss(jnp.asarray(real),
                                          jnp.asarray(synth)))
    assert got.shape == ref.shape == (3, 1)
    r64, s64 = real.astype(np.float64), synth.astype(np.float64)
    mask = ((r64 < 0.99) | (s64 < 0.99)).astype(np.float64)
    exact = ((np.abs(r64 - s64) * mask).sum((-1, -2))
             / (mask.sum((-1, -2)) + 1e-8))
    print(f"masked_depth_loss from float64: port "
          f"{np.abs(got - exact).max():.3g}, JAX {np.abs(ref - exact).max():.3g}"
          f"; port against JAX {np.abs(got - ref).max():.3g}")
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_fit_params_world_matches_jax(env):
    """Six steps of the reference's opt_depth objective at B=2: the loss
    histories within 2e-5 relative, the fitted parameters within 1e-5,
    and the fit descends.  The point-to-vertex term squares differences
    of coordinates hundreds of mm from the origin that lie a few mm
    apart, so a float32 step of a parameter moves the loss by ~1e-6 of
    itself: the two histories start a few 1e-7 apart and part to 1.02e-5
    by the sixth step, while the parameters stay within 1e-5."""
    rng = np.random.RandomState(3)
    quat0 = (rng.randn(B, 3) * 0.2).astype(np.float32)
    theta0 = (rng.randn(B, 45) * 0.2).astype(np.float32)
    cam0 = np.concatenate([np.ones((B, 1)), rng.randn(B, 3) * 20],
                          axis=1).astype(np.float32)
    vt, jt = JM.get_mano_vertices(env["jm"], jnp.asarray(quat0 + 0.1),
                                  jnp.asarray(theta0 + 0.1),
                                  jnp.zeros((B, 10)), jnp.asarray(cam0))
    j3d = np.asarray(jt, np.float32)
    sel = rng.choice(vt.shape[1], 64, replace=False)
    pcl = np.asarray(vt)[:, sel] + rng.randn(B, 64, 3).astype(np.float32)
    ref_p, ref_hist = JF.fit_params_world(env["jm"], pcl, j3d, quat0, theta0,
                                          cam0, steps=6, lr=LR)
    got_p, got_hist = fit_mano.fit_params_world(
        env["tm"], pcl, j3d, quat0, theta0, cam0, steps=6, lr=LR,
        device="cpu")
    assert len(got_hist) == 6 and all(isinstance(h, float) for h in got_hist)
    np.testing.assert_allclose(got_hist, ref_hist, rtol=2e-5, atol=0)
    for k in ("quat", "theta", "beta", "cam"):
        np.testing.assert_allclose(got_p[k].numpy(), np.asarray(ref_p[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert got_hist[-1] < got_hist[0]


# ------------------------------------------------------------ fit_params

def _jax_loss(jr, center, cube, target):
    """fit_params' objective in JAX (dsf_tpu/tools/fit_mano.py:93-104,
    no joint labels), built from the JAX package's own parts."""
    def loss_fn(p):
        img, _, jxyz, mesh = JR.render_params(jr, p, center, cube)
        m2d = JB.masked_depth_loss(img, target).mean()
        beta = jnp.mean(p[:, 48:58] ** 2)
        coll = JSph.collision_loss(jr.mano, jxyz,
                                   jax.lax.stop_gradient(mesh))
        return m2d + 10.0 * beta + coll, {"m2d": m2d, "beta": beta,
                                          "coll": coll}
    return loss_fn


def _port_loss_grad(env, p):
    t = {k: torch.from_numpy(env[k]) for k in ("target", "center", "cube")}
    pt = torch.from_numpy(np.asarray(p, np.float32)).requires_grad_(True)
    loss, aux = fit_mano.fit_loss(env["tr"], pt, t["target"], t["center"],
                                  t["cube"])
    (g,) = torch.autograd.grad(loss, pt)
    return (dict({k: float(v) for k, v in aux.items()},
                 loss=float(loss.detach())), g.numpy())


def _render_flips(env, p):
    """The crop render at p, the port's against JAX's jitted one: the
    pixels more than 1e-3 apart, the render's foreground, and the m2d
    those pixels move (JAX's m2d less m2d with the port's depth there)."""
    t = {k: torch.from_numpy(env[k]) for k in ("target", "center", "cube")}
    with torch.no_grad():
        port = TR.render_params(env["tr"], torch.from_numpy(
            np.asarray(p, np.float32)), t["center"], t["cube"])[0]
    jimg = torch.from_numpy(np.asarray(jax.jit(
        lambda q: JR.render_params(env["jr"], q, jnp.asarray(env["center"]),
                                   jnp.asarray(env["cube"]))[0])(
        jnp.asarray(p))))
    flipped = (port - jimg).abs() > 1e-3
    m2d = lambda img: float(TB.masked_depth_loss(img, t["target"]).mean())
    shift = m2d(jimg) - m2d(torch.where(flipped, port, jimg))
    return int(flipped.sum()), int((port < 0.99).sum()), shift


def _hold(env, got, ref, g, jg, p):
    """got / ref: the terms at p; g / jg: the gradients.  Within 1e-5
    relative once the flipped pixels' m2d share is out of JAX's, the
    gradient within 2e-3 relative L2 plus the flips' foreground share."""
    flips, fg, shift = _render_flips(env, p)
    print(f"fit_params render at p: {flips} pixels whose nearest face "
          f"differs from JAX's jitted render, of {fg}; m2d share {shift}")
    assert flips <= FLIP_MAX
    expected = dict(ref, m2d=ref["m2d"] - shift, loss=ref["loss"] - shift)
    assert set(got) == set(expected)
    for k in expected:
        np.testing.assert_allclose(got[k], expected[k], rtol=1e-5,
                                   atol=1e-12, err_msg=k)
    assert np.abs(jg).max() > 0
    assert _rel(g, jg) <= 2e-3 + flips / fg, _rel(g, jg)


def test_fit_params_first_step_matches_jax(env):
    """One step of fit_params from the neutral init: the terms at the init
    (as both return them), the gradient there against jax.grad of the JAX
    objective, and the update lr * sign(g) but where g's sign differs."""
    ref_p, ref = JF.fit_params(env["jr"], jnp.asarray(env["target"]),
                               jnp.asarray(env["center"]),
                               jnp.asarray(env["cube"]), steps=1, lr=LR)
    got_p, got = fit_mano.fit_params(env["tr"], env["target"], env["center"],
                                     env["cube"], steps=1, lr=LR,
                                     device="cpu")
    assert all(isinstance(v, float) for v in got.values())
    p0 = np.zeros((B, 62), np.float32)
    p0[:, 58] = 1.0
    loss_fn = _jax_loss(env["jr"], jnp.asarray(env["center"]),
                        jnp.asarray(env["cube"]), jnp.asarray(env["target"]))
    (_, jaux), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jnp.asarray(p0))
    # the test's JAX objective is fit_params' own
    for k in jaux:
        np.testing.assert_allclose(float(jaux[k]), ref[k], rtol=1e-6,
                                   err_msg=k)
    terms, g = _port_loss_grad(env, p0)
    for k in terms:
        np.testing.assert_allclose(got[k], terms[k], rtol=1e-6, err_msg=k)
    _hold(env, got, ref, g, np.asarray(jg), p0)
    # the update lr g / (|g| + 1e-8): lr sign(g) but where |g| nears 1e-8,
    # so equal where the signs agree, and at most lr elsewhere
    step, jstep = got_p.numpy() - p0, np.asarray(ref_p) - p0
    firm = _firm(g, np.asarray(jg))
    np.testing.assert_allclose(step[firm], jstep[firm], rtol=0, atol=1e-5)
    assert (np.abs(step) <= LR * (1 + 1e-6)).all()
    assert got["m2d"] > 0


def _firm(g, jg):
    """The gradient elements whose signs agree, where Adam's update must
    agree; an element whose sign differs lies within the gradients'
    largest difference of zero (at most 5% of them)."""
    firm = np.sign(g) == np.sign(jg)
    gap = np.abs(g - jg).max()
    print(f"gradient signs that differ: {int((~firm).sum())} of {firm.size}"
          f" (largest |g| among them {np.abs(jg)[~firm].max(initial=0)}, "
          f"the gradients' largest difference {gap})")
    assert (np.abs(jg)[~firm] <= gap).all()
    assert firm.mean() >= 0.95, firm.mean()
    return firm


def test_fit_params_three_steps_match_jax(env):
    """Three Adam steps of the JAX objective (optax.adam(0.01), jitted),
    then at each of JAX's parameters the port's terms and gradient, and
    the port's update (torch.optim.Adam with JAX's moments and count
    carried) against optax's update of the port's gradient.  (Against
    JAX's own next parameters the carried moments amplify the gradients'
    2e-3: where an element's gradient turns, m nearly cancels.)"""
    loss_fn = _jax_loss(env["jr"], jnp.asarray(env["center"]),
                        jnp.asarray(env["cube"]), jnp.asarray(env["target"]))
    tx = optax.adam(LR)

    @jax.jit
    def step(p, s):
        (loss, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        u, s = tx.update(g, s)
        return optax.apply_updates(p, u), s, loss, aux, g

    p = jnp.zeros((B, 62)).at[:, 58].set(1.0)
    s = tx.init(p)
    for k in range(3):
        adam = s[0]
        p_next, s_next, jloss, jaux, jg = step(p, s)
        ref = dict({n: float(v) for n, v in jaux.items()}, loss=float(jloss))
        got, g = _port_loss_grad(env, p)
        _hold(env, got, ref, g, np.asarray(jg), np.asarray(p))
        pt = torch.from_numpy(np.array(p)).requires_grad_(True)
        opt = torch.optim.Adam([pt], lr=LR)
        if int(adam.count):
            opt.state[pt] = {"step": torch.tensor(float(adam.count)),
                             "exp_avg": torch.from_numpy(np.array(adam.mu)),
                             "exp_avg_sq": torch.from_numpy(np.array(adam.nu))}
        pt.grad = torch.from_numpy(g)
        opt.step()
        # the update is optax's of the port's own gradient from JAX's
        # moments, to float32 rounding (the gradients are held above)
        u, _ = tx.update(jnp.asarray(g), s)
        np.testing.assert_allclose(
            pt.detach().numpy(), np.asarray(optax.apply_updates(p, u)),
            rtol=0, atol=1e-6, err_msg=f"step {k}")
        p, s = p_next, s_next


# ------------------------------------------------------------- the tools

def _meshes(env, n, seed, scale=1.0):
    """n posed MANO meshes in world mm (779 vertices), fingers curled into
    each other, shrunk by ``scale`` about their centres (the voxel tests'
    arrays grow with the cube of the size over the pitch: the synthetic
    hand is ~200 mm wide and a part holds ~600 faces)."""
    para, center, cube = demo.posed_params(env["tr"], n,
                                           np.random.RandomState(seed))
    para[:, 3:48] *= 2.0
    with torch.no_grad():
        _, mesh = TR.get_mesh_xyz(env["tr"], para)
    return (mesh * scale * cube[:, None] / 2 + center[:, None]).numpy()


def test_eval_coll_matches_jax(env, tmp_path):
    """evaluate_meshes and main() on a file written as the port's loop
    writes mesh_result_*.txt (np.savetxt of (B, 779 * 3) rows, %.3f), at
    the tool's 2 mm and 1 mm pitches on hands shrunk 10x: the volumes
    equal JAX's."""
    world = _meshes(env, 2, 5, scale=0.1)
    path = str(tmp_path / "mesh_result_3_0.txt")
    with open(path, "w") as fh:
        np.savetxt(fh, world.reshape(len(world), -1), fmt="%.3f")
    got = eval_coll.evaluate_meshes(path, env["npz"])
    ref = JE.evaluate_meshes(path, env["npz"])
    assert got.shape == (2,) and (got > 0).all()
    np.testing.assert_array_equal(got, ref)
    out = str(tmp_path / "coll.txt")
    eval_coll.main([path, "--mano", env["npz"], "--out", out, "--limit", "1"])
    np.testing.assert_allclose(np.loadtxt(out, ndmin=1), ref[:1],
                               rtol=0, atol=5e-5)


def test_intersect_matches_jax(env, tmp_path):
    """get_all_volumes over hand/object pairs at 8 mm: the object a closed
    box through the hand (an OBJ read by load_obj), and one away from it."""
    world = _meshes(env, 2, 6)
    faces = env["tm"].faces.numpy()
    lo, hi = world[0].min(0), world[0].max(0)
    mid = (lo + hi) / 2
    corners = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                        for z in (0, 1)], np.float64)
    box_v = mid + (corners - 0.5) * (hi - lo) * 0.5
    box_f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                      [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                      [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    obj = tmp_path / "box.obj"
    obj.write_text("".join(f"v {a} {b} {c}\n" for a, b, c in box_v)
                   + "".join(f"f {a + 1} {b + 1} {c + 1}\n"
                             for a, b, c in box_f))
    ov, of = intersect.load_obj(str(obj))
    jv, jf = JI.load_obj(str(obj))
    np.testing.assert_array_equal(ov, jv)
    np.testing.assert_array_equal(of, jf)
    pairs = [((world[0].astype(np.float64), faces), (ov, of)),
             ((world[1].astype(np.float64), faces), (ov + 500.0, of))]
    got = intersect.get_all_volumes(pairs, pitch=8.0, workers=2)
    ref = JI.get_all_volumes(pairs, pitch=8.0, workers=2)
    assert got == ref and got[0] > 0 and got[1] == 0.0


def test_kinect_preview_matches_jax(tmp_path):
    """The preview PNG's pixels bitwise the JAX package's (PIL reads its
    input and writes its output), from a 16-bit depth PNG; both previews
    read back with the port's reader (PIL serves the JAX side only)."""
    pytest.importorskip("PIL")
    from dsf_tpu.tools import kinect_preview as JK
    from dsf_tpu_torch.data.readers import read_gray_png
    from dsf_tpu_torch.tools.prerender import write_png16
    rng = np.random.RandomState(2)
    depth = rng.randint(0, 2000, (48, 64)).astype(np.uint16)
    depth[:4] = 0
    src = str(tmp_path / "in.png")
    write_png16(src, depth)
    got, ref = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    kinect_preview.normalize_kinect_png(src, got)
    JK.normalize_kinect_png(src, ref)
    a, b = read_gray_png(got, bits=(8,)), read_gray_png(ref, bits=(8,))
    assert a.shape == b.shape == (48, 64)
    np.testing.assert_array_equal(a, b)
    assert 0 < a.max() and (a[:4] == 0).all()


def test_bench_input_runs_on_a_tiny_set(env, tmp_path, capsys):
    """The loader benchmark on a fake NYU set of 4 train frames (rendered
    by the port on the CPU): both measurements, positive, printed."""
    from dsf_tpu_torch.data.fake import make_fake_nyu
    root = make_fake_nyu(str(tmp_path / "data"), env["npz"], n_train=4,
                         n_test=1, batch_size=5, device="cpu")
    fps = bench_input.main(["--root", root, "--batch_size", "2",
                            "--n_batches", "2", "--img_size", str(S)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [l.split('"metric": ')[1].split(",")[0] for l in lines] == [
        '"nyu_input_pipeline_fps"', '"nyu_input_pipeline_fps_cached"']
    assert fps > 0
    assert os.path.isdir(os.path.join(root, "nyu", "train"))
