"""The plain versions of K3's and K8's set-up (ops/point_mesh.py:
part_face_lists, group_points_by_part, argmin_tables_plain; the face rows
of ops/point_mesh_kernel.py:face_constants and face_constants16) against
brute force, and the plain walk over their tiles and part lists against
the plain dense argmin (bit for bit) and the Pallas kernel in interpret
mode.  The set-up kernel and the argmin body run on the card only
(test_torch_kernels_cuda.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from dsf_tpu.mano import synthetic as JS
from dsf_tpu.ops import pallas_point_mesh as JPPM
from dsf_tpu_torch.mano import model as TM
from dsf_tpu_torch.ops import point_mesh as PM
from dsf_tpu_torch.ops import point_mesh_kernel as PK

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def hand(tmp_path_factory):
    """Posed wrist-capped synthetic MANO meshes (B=3) in normalized units,
    700 points near each, the ICP's 16-column table (column 15 admits
    every face) and parts -1 .. 16 (-1 and 16 admit none)."""
    path = str(tmp_path_factory.mktemp("mano") / "syn.npz")
    JS.save_synthetic_mano(path)
    tm = TM.load_model(path, device="cpu")
    rng = np.random.RandomState(11)
    B, P = 3, 700
    para = np.zeros((B, 62), np.float32)
    para[:, :48] = rng.randn(B, 48) * 0.3
    para[:, 58] = 1.0
    verts, _ = TM.get_mano_vertices(tm, *TM.split_params(_t(para)),
                                    global_scale=1.0 / 125.0)
    verts = verts.numpy()
    idx = rng.randint(0, verts.shape[1], (B, P))
    pts = (np.take_along_axis(verts, idx[..., None], 1)
           + rng.randn(B, P, 3) * 0.03).astype(np.float32)
    faces = tm.faces.numpy()
    T = faces.shape[0]
    table = np.concatenate([tm.joint_face_mask.numpy(), np.ones((T, 1), bool)],
                           1)
    part = rng.randint(-1, 17, (B, P))
    return dict(tris=verts[:, faces], pts=pts, table=table, part=part)


def _dot(x, y):
    """A float32 dot product rounded after every product and sum, left to
    right (numpy's float32 arithmetic rounds each operation)."""
    return (x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1]) + x[..., 2] * y[..., 2]


def test_face_rows_round_each_operation_in_order(hand):
    """``face_constants`` and ``face_constants16`` bit for bit against a
    float32 evaluation in numpy in the order csrc/argmin_setup.cuh writes
    with __fmul_rn / __fadd_rn / __fsub_rn (and IEEE reciprocals), so the
    set-up kernel can equal them word for word."""
    tris = hand["tris"].astype(np.float32)
    a, b, c = tris[..., 0, :], tris[..., 1, :], tris[..., 2, :]
    ab, ac, bc = b - a, c - a, c - b
    n = np.stack([ab[..., 1] * ac[..., 2] - ab[..., 2] * ac[..., 1],
                  ab[..., 2] * ac[..., 0] - ab[..., 0] * ac[..., 2],
                  ab[..., 0] * ac[..., 1] - ab[..., 1] * ac[..., 0]], -1)
    one = np.float32(1.0)
    cols = [a, ab, ac, n] + [v[..., None] for v in (
        _dot(ab, a), _dot(ac, a), _dot(ab, b), _dot(ac, b), _dot(ab, c),
        _dot(ac, c), _dot(a, a), _dot(b, b), _dot(c, c),
        one / _dot(ab, ab), one / _dot(ac, ac), one / _dot(bc, bc),
        _dot(bc, b), _dot(n, a),
        one / np.maximum(_dot(n, n), np.float32(1e-12)),
        np.zeros_like(a[..., 0]))]
    ref27 = np.concatenate(cols, -1)
    ref16 = np.concatenate(cols[:3] + cols[4:11], -1)
    got27 = PK.face_constants(_t(tris)).numpy()
    got16 = PM.face_constants16(_t(tris)).numpy()
    assert ref27.dtype == np.float32 and ref27.shape[-1] == 28
    assert np.array_equal(got27.view(np.int32), ref27.view(np.int32))
    assert np.array_equal(got16.view(np.int32), ref16.view(np.int32))


def test_part_face_lists_against_the_table(hand):
    """Each column's list is exactly the faces it admits, ascending, then
    -1; lens count them; choff[k, g] counts those before chunk g."""
    ext = np.concatenate([hand["table"], np.zeros((len(hand["table"]), 1),
                                                  bool)], 1)
    T, Kp = ext.shape
    lists, lens, choff = (x.numpy() for x in PM.part_face_lists(_t(ext)))
    G = -(-T // 128)
    assert lists.shape == (Kp, T) and choff.shape == (Kp, G + 1)
    for k in range(Kp):
        faces = np.flatnonzero(ext[:, k])
        assert lens[k] == len(faces)
        assert np.array_equal(lists[k, :len(faces)], faces)
        assert (lists[k, len(faces):] == -1).all()
        for g in range(G + 1):
            assert choff[k, g] == (faces < g * 128).sum()
    assert lens[-1] == 0 and lens[15] == T


@pytest.mark.parametrize("tile", [256, 64, 5])
def test_group_points_by_part_tiles_each_point_once(hand, tile):
    """Every point of a part in [0, K) lies in exactly one tile, of its own
    part, of at most ``tile`` points, and the tiles of a part list its
    points in the stable order (ascending index); points of part K lie in
    none and fill the order's tail; run words OR the tiles' need words."""
    K = 16
    pp = np.where((hand["part"] >= 0) & (hand["part"] < K), hand["part"], K)
    B, P = pp.shape
    need = np.random.RandomState(12).randint(0, 2 ** 13, (B, P))
    perm, tiles, tcount = (x.numpy() for x in PM.group_points_by_part(
        _t(pp), 1, K, tile, _t(need).int()))
    assert tiles.shape == (B, P // tile + K + 1, 4)
    for b in range(B):
        assert np.array_equal(perm[b], np.argsort(pp[b], kind="stable"))
        seen = np.zeros(P, int)
        order = []
        for t in range(tcount[b, 0]):
            k, first, count, run = tiles[b, t]
            assert 0 < count <= tile
            members = perm[b, first:first + count]
            assert (pp[b, members] == k).all()
            assert run == np.bitwise_or.reduce(need[b, members])
            seen[members] += 1
            order += list(members)
        assert (seen == (pp[b] < K)).all()
        # within each part, the tiles run in ascending point index
        for k in range(K):
            mine = [p for p in order if pp[b, p] == k]
            assert mine == sorted(mine)
        assert tcount[b, 1] == (pp[b] < K).sum()
        assert (tiles[b, tcount[b, 0]:] == 0).all()
    _, tiles3, _ = PM.group_points_by_part(_t(pp), 1, K, tile)
    assert (tiles3.numpy()[..., 3][tiles3.numpy()[..., 2] > 0] == -1).all()


@pytest.mark.parametrize("masked", [True, False])
def test_tile_walk_bitwise_equals_plain_argmin(hand, masked):
    """K3's argmin as its kernel walks it (tiles of one part, each against
    its part's list; ``argmin_faces_tiles_plain``) equals
    ``argmin_faces_plain`` bit for bit, dmin and imin, on the capped hand
    masked as the ICP masks (and unmasked); the tables are K3's plain
    set-up at the kernel's tile and at a small one."""
    pts, tris = _t(hand["pts"]), _t(hand["tris"])
    mask = _t(hand["table"]) if masked else None
    part = _t(hand["part"]) if masked else None
    dp, ip = PM.argmin_faces_plain(pts, tris, mask, part)
    for tile in (PK.TILE_POINTS, 48):
        tables = PM.argmin_tables_plain(pts, tris, mask, part, tile=tile)
        d, i = PM.argmin_faces_tiles_plain(pts, tris, tables)
        assert torch.equal(d, dp) and torch.equal(i, ip)
    if masked:
        none = dp >= 1e10
        assert none.sum() > 50 and (ip[none] == 0).all()


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(JPPM.pl, "pallas_call", patched)


def test_tile_walk_matches_pallas_kernel(interpret_pallas, hand):
    """The plain tile walk against the TPU kernel it stands for
    (argmin_faces_pallas, in interpret mode) on 256 faces of the hand,
    masked as the ICP masks, as test_plain_argmin_matches_pallas_kernel
    holds the dense plain argmin: the winning face's exact distance to
    1e-5 relative + 1e-7, (1e10, 0) where nothing is admissible."""
    tris = hand["tris"][:1, :256]
    pts = hand["pts"][:1, :512]
    table = hand["table"][:256]
    part = hand["part"][:1, :512]
    tables = PM.argmin_tables_plain(_t(pts), _t(tris), _t(table), _t(part))
    d, i = (x.numpy() for x in PM.argmin_faces_tiles_plain(
        _t(pts), _t(tris), tables))
    _, i_k = JPPM.argmin_faces_pallas(jnp.asarray(pts), jnp.asarray(tris),
                                      jnp.asarray(table), jnp.asarray(part))
    i_k = np.asarray(i_k)
    none = d >= 1e10
    assert none.sum() > 20
    assert (i_k[none] == 0).all() and (i[none] == 0).all()
    win = np.take_along_axis(tris, i_k[..., None, None].astype(np.int64), 1)
    d_win = PM.point_tri_sqdist(_t(pts), _t(win)).numpy()
    np.testing.assert_allclose(d_win[~none], d[~none], rtol=1e-5, atol=1e-7)
    assert (i_k == i).mean() > 0.9


def test_culled_tables_on_the_hand_keep_every_winner(hand):
    """K8's plain set-up on the capped hand (``argmin_tables_plain(...,
    culled=True)``): faces in ``face_part_perm``'s order, the lists over
    that order, keys part x G + nearest chunk, and every point's winning
    face (the plain dense argmin's, in the part order) in a chunk its
    tile's run word keeps; the plain K8 on these tables agrees with the
    plain dense argmin by the exact distance of its winners."""
    pts, tris = _t(hand["pts"]), _t(hand["tris"])
    table, part = _t(hand["table"]), _t(hand["part"])
    tb = PM.argmin_tables_plain(pts, tris, table, part, culled=True)
    fperm = tb.fperm.long()
    assert torch.equal(fperm, PM.face_part_perm(table))
    ext, pp = PM._extend_part_tables(table, part)
    lists, lens, _ = PM.part_face_lists(ext[fperm])
    assert torch.equal(tb.lists, lists) and torch.equal(tb.lens, lens)
    G = -(-tris.shape[1] // 128)
    assert torch.equal(tb.key.long() // G, pp)
    dp, ip = PM.argmin_faces_plain(pts, tris, table, part)
    inv = torch.argsort(fperm)
    B, P = pts.shape[0], pts.shape[1]
    tiles = tb.tiles.long()
    ok = dp < 1e10
    for b in range(B):
        for t in range(int(tb.tcount[b, 0])):
            _, first, count, run = tiles[b, t].tolist()
            members = tb.perm[b, first:first + count].long()
            chunk = inv[ip[b, members].long()] // 128
            kept = ((run >> chunk) & 1).bool()
            assert kept[ok[b, members]].all()
    d8, i8 = PM.argmin_faces_culled_plain(pts, tb)
    i8 = tb.fperm[i8.long()].long()
    win = torch.gather(tris, 1, i8[..., None, None].expand(B, P, 3, 3))
    dw = PM.point_tri_sqdist(pts, win)
    torch.testing.assert_close(dw[ok], dp[ok], rtol=1e-5, atol=1e-7)
    assert (d8[~ok] >= 1e10).all() and (i8[~ok] == fperm[0]).all()
