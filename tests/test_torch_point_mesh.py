"""Port parity for the point -> mesh distance (ops/point_mesh.py) against
dsf_tpu/ops/point_mesh.py: the exact point-triangle distance, the plain
nearest-face argmin (K3's plain version) against the JAX scan and against
the Pallas kernel in interpret mode, the factorized part mask, and the
gradients of point_face_distance.  K3 itself runs on the card only
(test_torch_kernels_cuda.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from dsf_tpu.mano import synthetic as JS
from dsf_tpu.ops import point_mesh as JPM
from dsf_tpu_torch.mano import model as TM
from dsf_tpu_torch.ops import point_mesh as PM
from dsf_tpu_torch.ops import point_mesh_kernel as PK

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _regions(p, tri):
    """Which of the 7 closest-point regions (A, B, C, AB, AC, BC, face)
    each point falls in, by the same sign tests (float64)."""
    p, tri = p.astype(np.float64), tri.astype(np.float64)
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    ab, ac = b - a, c - a
    d1, d2 = ((p - a) * ab).sum(-1), ((p - a) * ac).sum(-1)
    d3, d4 = ((p - b) * ab).sum(-1), ((p - b) * ac).sum(-1)
    d5, d6 = ((p - c) * ab).sum(-1), ((p - c) * ac).sum(-1)
    vc, vb, va = d1 * d4 - d3 * d2, d5 * d2 - d1 * d6, d3 * d6 - d5 * d4
    r = np.full(p.shape[:-1], 6)
    r = np.where((va <= 0) & (d4 >= d3) & (d5 >= d6), 5, r)
    r = np.where((vb <= 0) & (d2 >= 0) & (d6 <= 0), 4, r)
    r = np.where((vc <= 0) & (d1 >= 0) & (d3 <= 0), 3, r)
    r = np.where((d6 >= 0) & (d5 <= d6), 2, r)
    r = np.where((d3 >= 0) & (d4 <= d3), 1, r)
    return np.where((d1 <= 0) & (d2 <= 0), 0, r)


def test_point_tri_sqdist_matches_jax_in_all_regions():
    """Points around random triangles, in each of the seven regions: the
    squared distances to 1e-6 relative (plus 1e-9 near zero), the same
    float32 formula in another order of fused operations."""
    rng = np.random.RandomState(0)
    tri = rng.randn(4000, 3, 3).astype(np.float32)
    p = (tri.mean(1) + rng.randn(4000, 3) * 1.5).astype(np.float32)
    regions = _regions(p, tri)
    assert np.bincount(regions, minlength=7).min() >= 50
    got = PM.point_tri_sqdist(_t(p), _t(tri)).numpy()
    ref = np.asarray(JPM.point_tri_sqdist(jnp.asarray(p), jnp.asarray(tri)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-9)


@pytest.fixture(scope="module")
def hand(tmp_path_factory):
    """Posed synthetic MANO meshes (B=2) in normalized units and points
    around them, as the ICP sees them."""
    path = str(tmp_path_factory.mktemp("mano") / "syn.npz")
    JS.save_synthetic_mano(path)
    tm = TM.load_model(path, device="cpu")
    rng = np.random.RandomState(1)
    B, P = 2, 700
    para = np.zeros((B, 62), np.float32)
    para[:, :48] = rng.randn(B, 48) * 0.3
    para[:, 58] = 1.0
    verts, _ = TM.get_mano_vertices(tm, *TM.split_params(_t(para)),
                                    global_scale=1.0 / 125.0)
    verts = verts.numpy()
    idx = rng.randint(0, verts.shape[1], (B, P))
    pts = (np.take_along_axis(verts, idx[..., None], 1)
           + rng.randn(B, P, 3) * 0.03).astype(np.float32)
    return dict(tm=tm, verts=verts, pts=pts,
                faces=tm.faces.numpy(), mask=tm.joint_face_mask.numpy())


def _argmins(pts, tris, mask=None, part=None):
    got = PM.argmin_faces_plain(_t(pts), _t(tris),
                                None if mask is None else _t(mask),
                                None if part is None else _t(part))
    ref = JPM._argmin_faces(jnp.asarray(pts), jnp.asarray(tris),
                            None if mask is None else jnp.asarray(mask),
                            None if part is None else jnp.asarray(part))
    return [x.numpy() for x in got], [np.asarray(x) for x in ref]


def _hold_winners(pts, tris, d_ref, i_got, i_ref, ties_at_most):
    """Indices equal except on ties, where the port's face must reach the
    JAX winner's distance (1e-6 relative plus 1e-8, as the distances)."""
    diff = i_got != i_ref
    assert diff.sum() <= ties_at_most, diff.sum()
    win = np.take_along_axis(tris, i_got[..., None, None].astype(np.int64), 1)
    d_win = np.asarray(JPM.point_tri_sqdist(jnp.asarray(pts),
                                            jnp.asarray(win)))
    np.testing.assert_allclose(d_win[diff], d_ref[diff], rtol=1e-6,
                               atol=1e-8)


def test_plain_argmin_matches_jax_scan(hand):
    """Unmasked, on the hand mesh: the distances to 1e-6 relative plus
    1e-8 (the closest point rounds to ~6e-8 of the unit-sized coordinates,
    a few 1e-9 of a squared distance of 1e-3; XLA fuses the formula into
    other roundings), the faces equal apart from ties (a point nearest to
    a vertex is as near to every face around it)."""
    tris = hand["verts"][:, hand["faces"]]
    (d, i), (d_r, i_r) = _argmins(hand["pts"], tris)
    np.testing.assert_allclose(d, d_r, rtol=1e-6, atol=1e-8)
    _hold_winners(hand["pts"], tris, d_r, i, i_r, ties_at_most=len(d.ravel()) // 10)
    assert (i == i_r).mean() > 0.9


def test_plain_argmin_masked_matches_jax_scan(hand):
    """The ICP's 16-column table (15 bone parts and an admit-all column)
    with parts -1 and 16 (out of range) among the points: those admit no
    face, keep dmin 1e10 and imin 0 on both sides."""
    tris = hand["verts"][:, hand["faces"]]
    T = tris.shape[1]
    table = np.concatenate([hand["mask"], np.ones((T, 1), bool)], axis=1)
    part = np.random.RandomState(2).randint(-1, 17, hand["pts"].shape[:2])
    (d, i), (d_r, i_r) = _argmins(hand["pts"], tris, table, part)
    none = (part < 0) | (part > 15)
    assert none.sum() > 50
    assert (d[none] == 1e10).all() and (i[none] == 0).all()
    assert (d_r[none] == 1e10).all() and (i_r[none] == 0).all()
    np.testing.assert_allclose(d[~none], d_r[~none], rtol=1e-6, atol=1e-8)
    _hold_winners(hand["pts"], tris, d_r, i, i_r,
                  ties_at_most=len(d.ravel()) // 10)
    # every winner is admissible for its point
    ok = table[i[~none], part[~none]]
    assert ok.all()


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    import dsf_tpu.ops.pallas_point_mesh as PPM
    monkeypatch.setattr(PPM.pl, "pallas_call", patched)


def test_plain_argmin_matches_pallas_kernel(interpret_pallas, hand):
    """K3's plain version against the TPU kernel it stands for
    (argmin_faces_pallas, in interpret mode), masked as the ICP masks: the
    winning face's exact distance to 1e-5 relative plus 1e-7 (the kernel's
    divide-free distances round differently, so near-ties may pick another
    face)."""
    from dsf_tpu.ops.pallas_point_mesh import argmin_faces_pallas
    tris = hand["verts"][:1, hand["faces"][:256]]
    pts = hand["pts"][:1, :512]
    table = np.concatenate([hand["mask"][:256], np.ones((256, 1), bool)], 1)
    part = np.random.RandomState(3).randint(-1, 17, (1, 512))
    d, i = [x.numpy() for x in PM.argmin_faces_plain(
        _t(pts), _t(tris), _t(table), _t(part))]
    _, i_k = argmin_faces_pallas(jnp.asarray(pts), jnp.asarray(tris),
                                 jnp.asarray(table), jnp.asarray(part))
    i_k = np.asarray(i_k)
    # parts out of range, and parts none of these 256 faces touches
    none = d >= 1e10
    assert none.sum() > 20
    assert (i_k[none] == 0).all() and (i[none] == 0).all()
    win = np.take_along_axis(tris, i_k[..., None, None].astype(np.int64), 1)
    d_win = PM.point_tri_sqdist(_t(pts), _t(win)).numpy()
    np.testing.assert_allclose(d_win[~none], d[~none], rtol=1e-5, atol=1e-7)
    assert (i_k == i).mean() > 0.9


def test_point_face_distance_gradients_match_jax(hand):
    """Values and gradients (points and vertices) of point_face_distance
    under the ICP's mask, against jax.grad: through the winning face only,
    to 1e-5 relative of the largest entry (the winner's distance in the
    same formula; sums over a vertex's faces in other orders)."""
    tris_faces = hand["faces"]
    T = tris_faces.shape[0]
    table = np.concatenate([hand["mask"], np.ones((T, 1), bool)], axis=1)
    part = np.random.RandomState(4).randint(-1, 16, hand["pts"].shape[:2])
    w = np.random.RandomState(5).randn(*hand["pts"].shape[:2]).astype(np.float32)

    def jloss(p, v):
        d = JPM.point_face_distance(p, v, jnp.asarray(tris_faces),
                                    jnp.asarray(table), jnp.asarray(part))
        return jnp.sum(d * w)

    jval = jloss(jnp.asarray(hand["pts"]), jnp.asarray(hand["verts"]))
    jgp, jgv = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(hand["pts"]),
                                               jnp.asarray(hand["verts"]))
    p = _t(hand["pts"]).requires_grad_(True)
    v = _t(hand["verts"]).requires_grad_(True)
    d = PM.point_face_distance(p, v, hand["tm"].faces, _t(table), _t(part))
    val = (d * _t(w)).sum()
    val.backward()
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
    for got, ref in ((p.grad, jgp), (v.grad, jgv)):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_kernel_face_rows_on_the_capped_hand(hand):
    """K3's precondition, non-degenerate faces, holds for the wrist-capped
    hand (1538 faces and 16 caps on the appended centroid vertex): every
    edge and every area is positive, so the face rows are finite, and they
    are the Pallas kernel's _face_constants27 rows."""
    from dsf_tpu.ops.pallas_point_mesh import _face_constants27
    tris = hand["verts"][:, hand["faces"]].astype(np.float64)
    ab, ac = tris[:, :, 1] - tris[:, :, 0], tris[:, :, 2] - tris[:, :, 0]
    bc = tris[:, :, 2] - tris[:, :, 1]
    area2 = np.linalg.norm(np.cross(ab, ac), axis=-1)
    for e in (ab, ac, bc):
        assert np.linalg.norm(e, axis=-1).min() > 1e-6
    assert area2.min() > 1e-9 and area2[:, -16:].min() > 1e-6
    rows = PK.face_constants(_t(hand["verts"][:, hand["faces"]])).numpy()
    assert rows.shape == (2, 1554, 28) and np.isfinite(rows).all()
    ref = np.asarray(_face_constants27(
        jnp.asarray(hand["verts"][:, hand["faces"]]))).transpose(0, 2, 1)
    np.testing.assert_allclose(rows[..., :27], ref, rtol=1e-5, atol=1e-7)
    words = PK.part_words(torch.from_numpy(hand["mask"])).numpy()
    for k in range(15):
        assert np.array_equal((words >> k) & 1, hand["mask"][:, k])
