"""Port parity for the two ICP argmin variants, K7 (``USE_V2_KERNEL``) and
K8 (``USE_CULLED_KERNEL``), against dsf_tpu: their plain versions against
``argmin_faces_pallas_v2`` and ``argmin_faces_pallas_culled`` run in
interpret mode, their skip tables against brute force, and the fused ICP
under each switch against JAX's under the same switch.  The kernels run
on the card only (test_torch_kernels_cuda.py).

Both sides are held against a float64 witness: the least float64
distance over each point's admissible faces.  A variant's winner may be
another face of (almost) the same distance where faces tie (a point
nearest to a vertex is as near to every face around it), so each side is
held by the exact distance of its winning face."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from dsf_tpu.losses import icp as JI
from dsf_tpu.mano import model as JM, synthetic as JS
from dsf_tpu.ops import pallas_point_mesh as JPPM
from dsf_tpu.ops import point_mesh as JPM
from dsf_tpu_torch.losses import icp as TI
from dsf_tpu_torch.mano import model as TM
from dsf_tpu_torch.ops import point_mesh as PM

torch.set_num_threads(2)

# a winning face's float64 distance may exceed the float64 minimum by the
# float32 rounding of the two distances it was chosen between (measured:
# every winner of both sides is an exact minimum, to 1e-15)
WIN_ATOL = 1e-6


def dmin_atol(pts):
    """How far a float32 dmin may lie from float64: the divide-free and the
    16-constant forms subtract |p|^2 + |q|^2 (~30 for these points) to get
    the distance, so a few float32 ulps of that (measured up to 6.5e-6,
    JAX's forms; the port's Ericson form 8.3e-7)."""
    return 1e-6 * float((pts.astype(np.float64) ** 2).sum(-1).max())


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(JPPM.pl, "pallas_call", patched)
    yield


def _problem(seed, masked, B=2, V=60, F=200, P=640, extra=0.07):
    """Random non-degenerate faces (F = 200: two 128-face chunks, the last
    ragged) and points; masked: the fused ICP's 16-column table (column 15
    admits every face) with parts -1 .. 16 (-1 and 16 admit none)."""
    rng = np.random.RandomState(seed)
    verts = rng.randn(B, V, 3).astype(np.float32)
    faces = np.stack([rng.choice(V, 3, replace=False) for _ in range(F)])
    pts = (rng.randn(B, P, 3) * 1.3).astype(np.float32)
    tris = verts[:, faces]
    if not masked:
        return tris, pts, None, None
    # parts by blocks of faces, so that part-sorted chunks are nearly pure
    mask = np.zeros((F, 15), bool)
    mask[np.arange(F), (np.arange(F) * 15) // F] = True
    mask |= rng.rand(F, 15) < extra
    mask = np.concatenate([mask, np.ones((F, 1), bool)], axis=1)
    part = rng.randint(-1, 17, (B, P)).astype(np.int32)
    # tiles of points of few parts, as sorted points give them
    part = np.sort(part, axis=1)
    return tris, pts, mask, part


def _exact(pts, tris, idx):
    """float64 distance of each point to its face idx."""
    p = torch.from_numpy(pts).double()
    t = torch.from_numpy(tris).double()
    B, P = idx.shape
    win = torch.gather(t, 1, torch.as_tensor(np.asarray(idx)).long()
                       [..., None, None].expand(B, P, 3, 3))
    return PM.point_tri_sqdist(p, win).numpy()


def _witness(pts, tris, mask, part):
    """float64 least distance over each point's admissible faces (1e10 for
    a point that admits none)."""
    d, _ = PM.argmin_faces_plain(torch.from_numpy(pts).double(),
                                 torch.from_numpy(tris).double(),
                                 None if mask is None else _t(mask),
                                 None if part is None else _t(part))
    return d.numpy()


def _hold(name, d_win, d64, none):
    err = np.abs(d_win - d64)[~none]
    assert err.max() <= WIN_ATOL, (name, err.max())


@pytest.mark.parametrize("masked", [False, True])
def test_v2_plain_matches_pallas_v2(interpret_pallas, masked):
    """K7's plain version and the Pallas v2 kernel (interpret mode, its
    512-point tiles) on the same faces: each side's winning face within
    WIN_ATOL of the float64 minimum, both dmin within ``dmin_atol`` of it,
    admissible winners, and (1e10, 0) where nothing is admissible."""
    tris, pts, mask, part = _problem(5, masked)
    B, P = pts.shape[:2]
    T = tris.shape[1]
    words = PM.v2_words(None if mask is None else _t(mask),
                        None if part is None else _t(part), B, P, T, "cpu")
    d_p, i_p = PM.argmin_faces_v2_plain(
        _t(pts), _t(tris), None if mask is None else _t(mask),
        None if part is None else _t(part), words)
    d_j, i_j = JPPM.argmin_faces_pallas_v2(
        jnp.asarray(pts), jnp.asarray(tris),
        None if mask is None else jnp.asarray(mask),
        None if part is None else jnp.asarray(part))
    d_j, i_j = np.asarray(d_j), np.asarray(i_j)
    d64 = _witness(pts, tris, mask, part)
    none = d64 >= 1e10
    assert none.any() == masked
    for name, d, i in (("port", d_p.numpy(), i_p.numpy()), ("jax", d_j, i_j)):
        _hold(name, _exact(pts, tris, i), d64, none)
        np.testing.assert_allclose(d[~none], d64[~none], rtol=0,
                                   atol=dmin_atol(pts))
        assert (d[none] >= 1e10).all() and (i[none] == 0).all()
        if masked:
            pp = np.where(none, 15, part)
            assert mask[i[~none], pp[~none]].all()


@pytest.mark.parametrize("masked", [False, True])
def test_culled_plain_matches_pallas_culled(interpret_pallas, masked):
    """K8 through the port's dispatch on the CPU (part-sorted faces, sorted
    points, the run table, its plain version, then un-sorted) and the
    Pallas culled kernel (interpret mode, its 512-point tiles): each side's
    winner within WIN_ATOL of the float64 minimum and its dmin (the
    16-constant form on both sides) within ``dmin_atol`` of it; the ids
    are the caller's (perm[0] where nothing is admissible, as JAX gives
    it)."""
    tris, pts, mask, part = _problem(6, masked)
    d_p, i_p = PM.argmin_faces_culled(
        _t(pts), _t(tris), None if mask is None else _t(mask),
        None if part is None else _t(part))
    d_j, i_j = JPPM.argmin_faces_pallas_culled(
        jnp.asarray(pts), jnp.asarray(tris),
        None if mask is None else jnp.asarray(mask),
        None if part is None else jnp.asarray(part))
    d_j, i_j = np.asarray(d_j), np.asarray(i_j)
    d64 = _witness(pts, tris, mask, part)
    none = d64 >= 1e10
    for name, d, i in (("port", d_p.numpy(), i_p.numpy()), ("jax", d_j, i_j)):
        _hold(name, _exact(pts, tris, i), d64, none)
        np.testing.assert_allclose(d[~none], d64[~none], rtol=0,
                                   atol=dmin_atol(pts))
        assert (d[none] >= 1e10).all()
    if masked:
        perm0 = int(PM.face_part_perm(_t(mask))[0])
        assert perm0 == int(JPPM._face_part_perm(mask, mask.shape[0])[0])
        assert (i_p.numpy()[none] == perm0).all() and (i_j[none] == perm0).all()


def test_v2_words_are_the_admissible_blocks():
    """K7's skip words against numpy brute force: bit ci of (cloud, tile)
    is set exactly when a point of the 128-point tile admits a face of
    128-face chunk ci; some blocks are clear; and clearing a set bit that
    holds a point's winner changes the plain version's answer, so the
    plain version reads the words."""
    tris, pts, mask, part = _problem(7, True, F=300, P=768, extra=0.0)
    B, P = pts.shape[:2]
    T = tris.shape[1]
    words = PM.v2_words(_t(mask), _t(part), B, P, T, "cpu").numpy()
    ext = np.concatenate([mask, np.zeros((T, 1), bool)], 1)
    pp = np.where((part >= 0) & (part < 16), part, 16)
    NT, nc = -(-P // 128), -(-T // 128)
    ref = np.zeros((B, NT), np.int64)
    for b in range(B):
        for ti in range(NT):
            for ci in range(nc):
                adm = ext[ci * 128:(ci + 1) * 128][:, pp[b, ti * 128:
                                                          (ti + 1) * 128]]
                ref[b, ti] |= int(adm.any()) << ci
    assert np.array_equal(words, ref)
    assert (ref != (1 << nc) - 1).any()
    d, i = PM.argmin_faces_v2_plain(_t(pts), _t(tris), _t(mask), _t(part),
                                    _t(words))
    hit = np.argwhere(i.numpy() >= 128)[0]
    b, ti = hit[0], hit[1] // 128
    cleared = words.copy()
    cleared[b, ti] &= ~2
    d2, _ = PM.argmin_faces_v2_plain(_t(pts), _t(tris), _t(mask), _t(part),
                                     _t(cleared))
    assert d2[b, hit[1]] > d[b, hit[1]]


def _culled_reference(pts, tris, mask, part, eps):
    """K8's set-up rule in numpy float64 (ref: argmin_faces_pallas_culled,
    pallas_point_mesh.py:671-734) on faces already in part order: the
    stable point order by (part, nearest admissible chunk), and, with the
    bound test lb <= ub moved by -eps and +eps of (1 + ub), the chunks
    each point needs (a table built in float32 must hold everything of the
    -eps one and nothing outside the +eps one)."""
    B, P, _ = pts.shape
    T = tris.shape[1]
    G = -(-T // 128)
    tris = tris.astype(np.float64)
    cent = tris.mean(2)
    face_r = np.sqrt(((tris - cent[:, :, None]) ** 2).sum(-1).max(-1) + 1e-20)
    c_g = np.stack([cent[:, g * 128:(g + 1) * 128].mean(1) for g in range(G)], 1)
    r_g = np.stack([(np.sqrt(((cent[:, g * 128:(g + 1) * 128]
                               - c_g[:, g:g + 1]) ** 2).sum(-1) + 1e-20)
                     + face_r[:, g * 128:(g + 1) * 128]).max(1)
                    for g in range(G)], 1)
    K = mask.shape[1]
    pp = np.where((part >= 0) & (part < K), part, K)
    ext = np.concatenate([mask, np.zeros((T, 1), bool)], 1)
    chunk_part = np.stack([ext[g * 128:(g + 1) * 128].any(0) for g in range(G)])
    adm = chunk_part.T[pp]                                       # (B, P, G)
    dpc = np.sqrt(((pts.astype(np.float64)[:, :, None] - c_g[:, None]) ** 2
                   ).sum(-1) + 1e-20)
    m = JPPM._CULL_MARGIN
    lb = np.maximum(dpc - r_g[:, None] - m, 0.0) ** 2
    ub = np.where(adm, (dpc + r_g[:, None] + m) ** 2, 1e10).min(-1)
    order = np.argsort(pp * G + np.argmin(np.where(adm, dpc, 1e10), -1),
                       axis=1, kind="stable")
    needs = [adm & (lb <= ub[..., None] + e * (1 + ub[..., None]))
             for e in (-eps, eps)]
    return order, needs


def _tile_of(perm, tiles, tcount):
    """Each point's tile (B, P), -1 for a point of no tile."""
    B, P = perm.shape
    out = np.full((B, P), -1)
    for b in range(B):
        for t in range(tcount[b, 0]):
            _, first, count, _ = tiles[b, t]
            out[b, perm[b, first:first + count]] = t
    return out


def _tile_runs(need, tile_of, maxT):
    """(B, maxT, G): the OR of each tile's points' needed chunks."""
    B, P, G = need.shape
    runs = np.zeros((B, maxT, G), bool)
    for b in range(B):
        for p in range(P):
            if tile_of[b, p] >= 0:
                runs[b, tile_of[b, p]] |= need[b, p]
    return runs


def test_culled_run_table_keeps_every_winner():
    """K8's set-up on a mesh of four tight 128-face chunks set 4 units
    apart, with points among and beside them: the chunks each point needs,
    the point order and the tiles' run words against the rule in numpy
    float64 (all it keeps with the bound test 1e-5 of (1 + ub) tighter,
    nothing it drops with it as much looser), no tile mixing parts, the
    bounds cull chunks that admissibility keeps, the chunk of every
    point's float64 nearest admissible face is in its tile's run word, and
    clearing a run bit that holds a point's winner changes the plain
    version's answer."""
    rng = np.random.RandomState(8)
    B, P, F, tile = 2, 768, 512, 32
    cen = (np.stack([(np.arange(F) // 128) * 4.0, np.zeros(F), np.zeros(F)],
                    -1) + rng.uniform(-0.3, 0.3, (F, 3)))
    tris = (cen[None, :, None] + 0.1 * rng.randn(B, F, 3, 3)).astype(np.float32)
    # parts by blocks of faces in index order: already part-sorted
    mask = np.zeros((F, 15), bool)
    mask[np.arange(F), (np.arange(F) * 15) // F] = True
    mask = np.concatenate([mask, np.ones((F, 1), bool)], axis=1)
    part = np.sort(rng.randint(-1, 17, (B, P)), axis=1).astype(np.int32)
    pts = np.stack([rng.uniform(-1, 13, (B, P)), rng.uniform(-1, 1, (B, P)),
                    rng.uniform(-1, 1, (B, P))], -1)
    pts[:, ::4, 1] += rng.uniform(2, 6, (B, P // 4))
    pts = pts.astype(np.float32)
    assert np.array_equal(PM.face_part_perm(_t(mask)).numpy(), np.arange(F))
    needed = PM.culled_needed(_t(pts), _t(tris), _t(mask), _t(part))[0]
    perm, key, need, tiles, tcount = PM.culled_tables(
        _t(pts), _t(tris), _t(mask), _t(part), tile)
    ref_order, (need_lo, need_hi) = _culled_reference(pts, tris, mask, part,
                                                      1e-5)
    needed = needed.numpy()
    assert (needed | ~need_lo).all() and (need_hi | ~needed).all()
    assert np.array_equal(need.numpy(), PM.need_words(_t(needed)).numpy())
    assert np.array_equal(perm.numpy(), ref_order)
    perm, tiles, tcount = perm.numpy(), tiles.numpy(), tcount.numpy()
    tile_of = _tile_of(perm, tiles, tcount)
    pp = np.where((part >= 0) & (part < 16), part, 16)
    assert ((tile_of >= 0) == (pp < 16)).all()
    for b in range(B):
        t = tile_of[b][pp[b] < 16]
        assert (tiles[b, t, 0] == pp[b][pp[b] < 16]).all()
    G = needed.shape[-1]
    run_np = ((tiles[..., 3:4] >> np.arange(G)) & 1).astype(bool)
    run_lo, run_hi = (_tile_runs(n, tile_of, tiles.shape[1])
                      for n in (need_lo, need_hi))
    assert (run_np | ~run_lo).all() and (run_hi | ~run_np).all()
    wide = _tile_runs(_culled_reference(pts, tris, mask, part, 1e10)[1][1],
                      tile_of, tiles.shape[1])
    assert run_np.sum() < wide.sum()
    d64, i64 = PM.argmin_faces_plain(_t(pts).double(), _t(tris).double(),
                                     _t(mask), _t(part))
    ok = (d64 < 1e10).numpy()
    bi = np.arange(B)[:, None].repeat(P, 1)
    assert run_np[bi[ok], tile_of[ok], i64.numpy()[ok] // 128].all()
    tables = PM.argmin_tables_plain(_t(pts), _t(tris), _t(mask), _t(part),
                                    culled=True, tile=tile)
    assert np.array_equal(tables.tiles.numpy(), tiles)
    d, i = PM.argmin_faces_culled_plain(_t(pts), tables)
    j = int(np.argwhere(ok[0])[0][0])
    cut = tables.tiles.clone()
    cut[0, tile_of[0, j], 3] &= ~(1 << (int(i64[0, j]) // 128))
    d2, _ = PM.argmin_faces_culled_plain(_t(pts), tables._replace(tiles=cut))
    assert d2[0, j] > d[0, j]


@pytest.fixture(scope="module")
def hand(tmp_path_factory):
    """Two posed synthetic MANO meshes in normalized units, clouds near
    them and part labels 0..15 (0, palm or background, admits no face),
    in both packages' models."""
    path = str(tmp_path_factory.mktemp("mano") / "syn.npz")
    JS.save_synthetic_mano(path)
    tm = TM.load_model(path, device="cpu")
    rng = np.random.RandomState(9)
    B, P = 2, 400
    para = np.zeros((B, 62), np.float32)
    para[:, :48] = rng.randn(B, 48) * 0.3
    para[:, 58] = 1.0
    mesh, _ = TM.get_mano_vertices(tm, *TM.split_params(_t(para)),
                                   global_scale=1.0 / 125.0)
    mesh = mesh.numpy()
    idx = rng.randint(0, mesh.shape[1], (B, P))
    pcl = (np.take_along_axis(mesh, idx[..., None], 1)
           + rng.randn(B, P, 3) * 0.02).astype(np.float32)
    joint_pcl = (np.take_along_axis(mesh, idx[..., None], 1)
                 + rng.randn(B, P, 3) * 0.01).astype(np.float32)
    seg = rng.randint(0, 16, (B, P)).astype(np.int64)
    return dict(tm=tm, jm=JM.load_model(path), mesh=mesh, pcl=pcl,
                joint_pcl=joint_pcl, seg=seg, w=rng.rand(B, 15).astype(np.float32))


def _fused_icp_against_jax(hand, switch, monkeypatch, order=None):
    """icp_and_joint_icp with the same switch on both sides and the faces
    (with their part table) taken in ``order``, held as
    ``test_fused_icp_under_each_switch_matches_jax`` says."""
    monkeypatch.setattr(PM, "USE_V2_KERNEL", switch == "v2")
    monkeypatch.setattr(PM, "USE_CULLED_KERNEL", switch == "culled")
    monkeypatch.setattr(JPM, "USE_V2_KERNEL", switch == "v2")
    monkeypatch.setattr(JPM, "USE_CULLED_KERNEL", switch == "culled")
    tm, jm, w = hand["tm"], hand["jm"], hand["w"]
    order = np.arange(tm.faces.shape[0]) if order is None else order
    faces, mask = tm.faces.numpy()[order], tm.joint_face_mask.numpy()[order]
    ins = [hand["mesh"], hand["pcl"], hand["joint_pcl"]]

    def port(dtype):
        leaves = [_t(x).to(dtype).requires_grad_(True) for x in ins]
        d2m, pd2m = TI.icp_and_joint_icp(leaves[0], leaves[1], leaves[2],
                                         _t(faces), _t(mask), _t(hand["seg"]))
        (d2m.sum() + (pd2m * _t(w).to(dtype)).sum()).backward()
        return ([d2m.detach().numpy(), pd2m.detach().numpy()],
                [x.grad.numpy() for x in leaves])

    def f(mesh, pcl, joint_pcl):
        a, b = JI.icp_and_joint_icp(mesh, pcl, joint_pcl, jnp.asarray(faces),
                                    jnp.asarray(mask),
                                    jnp.asarray(hand["seg"]))
        return a.sum() + (b * w).sum(), (a, b)

    (_, vals_j), g_j = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in ins))
    vals_j = [np.asarray(v) for v in vals_j]
    g_j = [np.asarray(g) for g in g_j]
    vals_p, g_p = port(torch.float32)
    vals_64, g_64 = port(torch.float64)
    assert (vals_j[1] > 0).sum() >= 10
    for vp, vj, v64 in zip(vals_p, vals_j, vals_64):
        np.testing.assert_allclose(vp, vj, rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(vj, v64, rtol=1e-5, atol=1e-12)

    def close(a, b, tol):
        if switch != "culled":
            np.testing.assert_allclose(a, b, rtol=0, atol=tol)
            return
        assert np.linalg.norm(a - b) <= 2e-3 * np.linalg.norm(b)
        assert (np.abs(a - b) > tol).mean() <= 0.01

    for gp, gj, g64 in zip(g_p, g_j, g_64):
        tol = 1e-4 * np.abs(g64).max()
        np.testing.assert_allclose(gp, g64, rtol=0, atol=tol)
        close(gp, gj, tol)
        close(gj, g64, tol)


@pytest.mark.parametrize("switch", ["v1", "v2", "culled"])
def test_fused_icp_under_each_switch_matches_jax(hand, switch, monkeypatch):
    """icp_and_joint_icp with the same switch on both sides (JAX on the CPU
    takes its XLA argmin under every switch; under v2 it sorts the faces by
    part first, the port's K7 inside its argmin), each side also held
    against the port in float64: d2m and pd2m to 1e-5 relative, and the
    gradients in the mesh and in both clouds to 1e-4 of each one's largest
    entry (measured: 1.1e-6 at most).  Under culled the port's argmin is
    K8's 16-constant form and JAX's its Ericson scan: a near-tie that the
    two forms round apart sends one point's gradient through another face
    (3 of 800 points here, 3.5e-3 of the largest entry, 5.3e-4 relative
    L2), so between the two the gradients are held at 2e-3 relative L2
    with at most 1% of the entries beyond 1e-4 of the largest."""
    _fused_icp_against_jax(hand, switch, monkeypatch)


def test_v2_fused_icp_on_an_unsorted_face_table(hand, monkeypatch):
    """Under ``USE_V2_KERNEL`` the port's ``point_face_distance`` no longer
    sorts the faces; K7's argmin sorts them inside and returns the
    caller's face ids.  With the faces and their table in a shuffled order
    (not sorted by part): the fused ICP still matches JAX's (which sorts
    first) as the switch test holds it, and the winning face gathered for
    the gradient is the same vertex triple as the former route's (sort,
    argmin over the sorted faces, gather from them), every point, also
    those that admit no face (the first face in the part order)."""
    tm = hand["tm"]
    T = tm.faces.shape[0]
    order = np.random.RandomState(10).permutation(T)
    _fused_icp_against_jax(hand, "v2", monkeypatch, order)
    faces, mask = tm.faces[order], tm.joint_face_mask[order]
    table = torch.cat([mask, torch.ones(T, 1, dtype=torch.bool)], 1)
    assert not torch.equal(PM.face_part_perm(table), torch.arange(T))
    seg = _t(hand["seg"])
    pts = torch.cat([_t(hand["pcl"]), _t(hand["joint_pcl"])])
    part = torch.cat([torch.full_like(seg, 15),
                      torch.where(seg >= 1, seg - 1,
                                  torch.full_like(seg, -1))])
    tris = torch.cat([_t(hand["mesh"])] * 2)[:, faces]
    _, ids = PM.argmin_faces(pts, tris, table, part)
    perm = PM.face_part_perm(table)
    faces_s, table_s = faces[perm], table[perm]
    words = PM.v2_words(table_s, part, *pts.shape[:2], T, "cpu")
    _, i_s = PM.argmin_faces_v2_plain(pts, torch.cat([_t(hand["mesh"])] * 2)
                                      [:, faces_s], table_s, part, words)
    assert (part < 0).any()
    assert torch.equal(faces[ids.long()], faces_s[i_s.long()])


@pytest.mark.parametrize("masked", [False, True])
def test_v2_tables_plain_match_pallas_v2(interpret_pallas, monkeypatch,
                                         masked):
    """K7's plain set-up tables (``v2_tables_plain``, the plain version of
    its set-up kernel) against what ``argmin_faces_pallas_v2`` (interpret
    mode, 128-point tiles as K7's) computes on the faces JAX's
    ``point_face_distance`` sorts: the face order equals JAX's
    ``_face_part_perm``; the rows (in that order) its
    ``_face_constants27`` within float32 rounding (1e-5 relative + 1e-7);
    the skip words its flags exactly; the face words and the points' parts
    its one-hot tables; the chunk ORs the OR of each chunk's words."""
    tris, pts, mask, part = _problem(12, masked)
    B, P = pts.shape[:2]
    T = tris.shape[1]
    seen = {}
    interp = JPPM.pl.pallas_call

    def capture(*a, **k):
        call = interp(*a, **k)

        def run(*args):
            seen["args"] = args
            return call(*args)
        return run

    monkeypatch.setattr(JPPM.pl, "pallas_call", capture)
    tb = PM.v2_tables_plain(_t(pts), _t(tris),
                            None if mask is None else _t(mask),
                            None if part is None else _t(part))
    perm = (np.arange(T) if mask is None
            else JPPM._face_part_perm(mask, T).astype(np.int64))
    assert np.array_equal(tb.fperm.numpy(), perm)
    if masked:
        assert not np.array_equal(perm, np.arange(T))
    JPPM.argmin_faces_pallas_v2(
        jnp.asarray(pts), jnp.asarray(tris[:, perm]),
        None if mask is None else jnp.asarray(mask[perm]),
        None if part is None else jnp.asarray(part), tile_n=PM.TILE)
    flags, _, fc, _, oh, pm_tab = (np.asarray(a) for a in seen["args"])
    assert np.array_equal(tb.skip.numpy(), flags)
    np.testing.assert_allclose(tb.rows.numpy()[..., :27],
                               fc[:, :, :T].transpose(0, 2, 1), rtol=1e-5,
                               atol=1e-7)
    assert (tb.rows.numpy()[..., 27] == 0).all()
    words = tb.words.numpy().astype(np.int64) & 0xFFFFFFFF
    if masked:
        K = mask.shape[1]
        bits = (words[None] >> np.arange(32)[:, None]) & 1       # (32, T)
        assert np.array_equal(bits[:K], pm_tab[:K, :T] > 0.5)
        assert not bits[K:].any()
        assert np.array_equal(tb.parts.numpy(), oh[:, :P].argmax(-1))
    else:
        assert (words == 0xFFFFFFFF).all() and not tb.parts.numpy().any()
    G = -(-T // 128)
    ors = [np.bitwise_or.reduce(words[g * 128:(g + 1) * 128])
           for g in range(G)]
    assert np.array_equal(tb.chunk_or.numpy().astype(np.int64) & 0xFFFFFFFF,
                          ors)
