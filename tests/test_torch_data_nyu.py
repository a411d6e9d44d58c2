"""Port parity for the NYU host data path: the PNG reader, OpenCV's
nearest warps in the host library, the crop geometry, the NYU loader's
eval and augmented batches, and the fake NYU set, each against the JAX
package (which reads and warps with cv2) on the same files and seeds.

Every comparison is bitwise: the port's reader, warps and batches are
the same arithmetic as cv2's and the JAX package's, not an approximation
of them.  The fake set is the JAX package's (``dsf_tpu.data.fake``: PNGs
written by libpng through cv2.imwrite); PNGs with each of the five row
filters are written here.
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from dsf_tpu.data import aug_batch as JA
from dsf_tpu.data import crop as JC
from dsf_tpu.data import datasets as JD
from dsf_tpu.data import readers as JR
from dsf_tpu.data.fake import make_fake_nyu as jax_make_fake_nyu
from dsf_tpu.mano import synthetic as JS
from dsf_tpu_torch.data import crop as TC
from dsf_tpu_torch.data import datasets as TD
from dsf_tpu_torch.data import native, readers as TR
from dsf_tpu_torch.data.fake import make_fake_nyu

torch.set_num_threads(2)

PARAS = (588.03, 587.07, 320.0, 240.0)
N_TRAIN, N_TEST, S = 8, 6, 64
KEYS = ("img", "xyz_gt", "uvd_gt", "center", "M", "cube")


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    d = tmp_path_factory.mktemp("nyu")
    mano = JS.save_synthetic_mano(str(d / "mano.npz"))
    jax_make_fake_nyu(str(d / "data"), mano, n_train=N_TRAIN, n_test=N_TEST)
    return str(d / "data" / "nyu"), mano


def _pngs(root):
    return [os.path.join(root, ph, f) for ph in ("train", "test")
            for f in sorted(os.listdir(os.path.join(root, ph)))
            if f.endswith(".png")]


def test_reader_matches_cv2_on_the_fake_set(fake):
    """Every PNG of the JAX package's fake set, written by cv2.imwrite,
    reads bitwise as the JAX reader (cv2.imread) reads it.  (OpenCV 5.0.0
    filters its rows with Sub; test_reader_undoes_every_filter covers the
    other four filters.)"""
    root, _ = fake
    paths = _pngs(root)
    assert len(paths) == N_TRAIN + 3 * N_TEST
    for p in paths:
        got, ref = TR.nyu_reader(p), JR.nyu_reader(p)
        assert got.dtype == ref.dtype == np.float32
        assert np.array_equal(got, ref), p


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(x, kinds, bpp):
    """PNG-filter the (H, rb) bytes ``x``, row r with ``kinds[r]``."""
    x = x.astype(np.int32)
    out = np.zeros((x.shape[0], 1 + x.shape[1]), np.uint8)
    for r, f in enumerate(kinds):
        prior = x[r - 1] if r else np.zeros_like(x[r])
        left = np.concatenate([np.zeros(bpp, np.int32), x[r, :-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        pred = {0: 0, 1: left, 2: prior, 3: (left + prior) // 2,
                4: _paeth(left, prior, ul)}[f]
        out[r, 0] = f
        out[r, 1:] = (x[r] - pred) & 0xFF
    return out


def _write_png(path, rgb, kinds, colour=2):
    H, W, C = rgb.shape
    rows = _filter_rows(rgb.reshape(H, W * C), kinds, C)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, colour,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", ["none", "sub", "up", "average", "paeth",
                                   "mixed", "rgba"])
def test_reader_undoes_every_filter(tmp_path, kinds):
    """A packed depth frame written with each PNG row filter (and with all
    five mixed, and as RGBA) reads as cv2.imread reads it."""
    rng = np.random.RandomState(3)
    H, W = 48, 40
    yy, xx = np.mgrid[:H, :W]
    depth = (700 + 3 * xx + 5 * yy + rng.randint(0, 300, (H, W))).astype(
        np.uint16)
    depth[rng.rand(H, W) < 0.2] = 0
    C = 4 if kinds == "rgba" else 3
    rgb = np.zeros((H, W, C), np.uint8)
    rgb[:, :, 1], rgb[:, :, 2] = depth >> 8, depth & 0xFF
    if C == 4:
        rgb[:, :, 3] = 255
    names = ["none", "sub", "up", "average", "paeth"]
    per_row = (rng.randint(0, 5, H) if kinds in ("mixed", "rgba")
               else np.full(H, names.index(kinds)))
    path = str(tmp_path / "f.png")
    _write_png(path, rgb, per_row, colour=6 if C == 4 else 2)
    got = TR.nyu_reader(path)
    assert np.array_equal(got, JR.nyu_reader(path))
    assert np.array_equal(got, depth.astype(np.float32))


def test_writer_reads_back_with_cv2(tmp_path):
    """``write_nyu_png``'s file is NYU's packed layout to cv2.imread."""
    depth = np.random.RandomState(4).randint(0, 2000, (30, 50)).astype(
        np.uint16)
    path = str(tmp_path / "w.png")
    TR.write_nyu_png(path, depth)
    assert np.array_equal(JR.nyu_reader(path), depth.astype(np.float32))
    bgr = cv2.imread(path)
    assert np.array_equal(native.nyu_unpack(bgr), depth.astype(np.float32))


def _crop(rng, size=S):
    """A raw-depth crop with a hand-like blob, zeros around it."""
    yy, xx = np.mgrid[:size, :size]
    c = size / 2 + rng.uniform(-8, 8, 2)
    r2 = (yy - c[0]) ** 2 + (xx - c[1]) ** 2
    img = np.where(r2 < (size / 3) ** 2, 650 + 0.05 * r2 + rng.rand(size, size)
                   * 20, 0).astype(np.float32)
    return img


ANGLES = [90.0, -90.0, 180.0, -180.0, 270.0, 45.0, 0.5, 359.5]


@pytest.mark.parametrize("size", [S, 128, 63])
def test_rotation_warp_matches_cv2(size):
    """rotate_hand's warp: getRotationMatrix2D about (size//2, size//2) and
    warpAffine nearest, constant 0 border, bitwise as cv2 over the exact
    quarter turns and a seeded sweep of angles."""
    rng = np.random.RandomState(size)
    angles = ANGLES + list(rng.uniform(-180, 180, 40))
    for a in angles:
        rot = np.mod(a, 360)
        img = _crop(rng, size)
        R = cv2.getRotationMatrix2D((size // 2, size // 2), -rot, 1)
        Rp = native.rotation_matrix_2d((size // 2, size // 2), -rot, 1)
        assert np.array_equal(Rp, R), a
        ref = cv2.warpAffine(img, R, (size, size), flags=cv2.INTER_NEAREST,
                             borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        got = native.warp_affine_nearest(img, R, (size, size), 0.0)
        assert np.array_equal(got, ref), (a, int((got != ref).sum()))


def _recrop_matrices(rng, n):
    """move_com's and scale_hand's recrop matrices Mnew @ inv(M), as
    aug_batch builds them, plus pure half-pixel shifts."""
    mats = []
    cube = np.array([250.0, 250.0, 250.0])
    for k in range(n):
        com = np.array([rng.uniform(150, 490), rng.uniform(100, 380),
                        rng.uniform(450, 950)], np.float32)
        M = JC.crop_matrix_deep_pp(com, cube, (S, S), PARAS)
        if k % 3 == 0:
            off = rng.uniform(-1, 1, 3) * 10
            new_com = JC.joint_3d_to_img(JC.joint_img_to_3d(com, PARAS) + off,
                                         PARAS)
            Mnew = JC.com_to_transform(new_com, cube, (S, S), PARAS)
        elif k % 3 == 1:
            sc = abs(1.0 + rng.uniform(-1, 1) * 0.2)
            Mnew = JC.com_to_transform(com, cube * sc, (S, S), PARAS)
        else:
            Mnew = M.copy()
            Mnew[:2, 2] += rng.randint(-6, 6, 2) + 0.5
        mats.append(Mnew @ np.linalg.inv(M))
    return mats


def test_perspective_warp_matches_cv2():
    """recrop_hand's warp: warpPerspective nearest over move_com's and
    scale_hand's matrices and half-pixel shifts, bitwise as cv2."""
    rng = np.random.RandomState(7)
    for T in _recrop_matrices(rng, 90):
        img = _crop(rng)
        ref = cv2.warpPerspective(img, T, (S, S), flags=cv2.INTER_NEAREST,
                                  borderMode=cv2.BORDER_CONSTANT,
                                  borderValue=0.0)
        got = native.warp_perspective_nearest(img, T, (S, S), 0.0)
        assert np.array_equal(got, ref), int((got != ref).sum())


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_crop_and_augment_match_jax(fake, mode):
    """The per-sample crop (crop_image_deep_pp and its matrix) and
    augment_crop in each mode (rot, com, sc, none), bitwise as the JAX
    package's, which calls cv2, on the fake set's frames."""
    root, _ = fake
    rng = np.random.RandomState(10 + mode)
    ds = JD.NYUDataset(root, "train", img_size=S)
    for i in range(4):
        depth = JR.nyu_reader(os.path.join(root, "train",
                                           f"depth_1_{i + 1:07d}.png"))
        com = JC.joint_3d_to_img(ds.center_xyz[i], PARAS)
        cube = np.array([250.0, 250.0, 250.0])
        ref_img, ref_M = JC.crop_image_deep_pp(depth, com, cube, (S, S),
                                               PARAS)
        img, M = TC.crop_image_deep_pp(depth, com, cube, (S, S), PARAS)
        assert np.array_equal(img, ref_img) and np.array_equal(M, ref_M)
        assert np.array_equal(TC.crop_matrix_deep_pp(com, cube, (S, S), PARAS),
                              ref_M)
        _, off, rot, sc = TC.rand_augment(rng)
        gt = ds.all_joints_xyz[i] - ds.center_xyz[i]
        ref = JC.augment_crop(ref_img.copy(), gt, com, cube, ref_M, mode, off,
                              rot, sc, PARAS)
        got = TC.augment_crop(img.copy(), gt, com, cube, M, mode, off, rot,
                              sc, PARAS)
        for a, b in zip(got, ref):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def _equal_batches(got, ref):
    assert sorted(got) == sorted(ref) == sorted(KEYS)
    for k in KEYS:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        assert np.array_equal(got[k], ref[k]), k


@pytest.mark.parametrize("view", [0, 1, 2])
def test_eval_batches_match_jax(fake, view):
    """The test split's batches of 4 (the second a 2-frame tail), every
    key bitwise as the JAX loader's fast path."""
    root, _ = fake
    ref = list(JD.NYUDataset(root, "test", view=view, img_size=S).batches(
        4, drop_last=False))
    ds = TD.NYUDataset(root, "test", view=view, img_size=S)
    got = list(ds.batches(4, drop_last=False))
    ds.close()
    assert [len(b["img"]) for b in got] == [4, 2]
    for g, r in zip(got, ref):
        _equal_batches(g, r)


def test_augmented_batches_match_jax(fake):
    """Two shuffled passes of augmented train batches from the same seeds:
    every key bitwise as the JAX loader's batched augmentation, all four
    modes drawn; the port's prefetching yields the same batches."""
    root, _ = fake
    assert JA.available()
    jds = JD.NYUDataset(root, "train", img_size=S, seed=5)
    ref = list(jds.batches(4, shuffle=True, seed=2, loop=False)) + list(
        jds.batches(4, shuffle=True, seed=3, loop=False))
    draws = JA.draw_params(np.random.RandomState(5), 2 * N_TRAIN,
                           jds.aug_para)
    assert {d[0] for d in draws} == {0, 1, 2, 3}
    tds = TD.NYUDataset(root, "train", img_size=S, seed=5)
    tds.enable_depth_cache()
    got = list(tds.batches(4, shuffle=True, seed=2, loop=False)) + list(
        tds.prefetch_batches(4, shuffle=True, seed=3, loop=False))
    tds.close()
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        _equal_batches(g, r)


def test_item_is_a_batch_of_one(fake):
    root, _ = fake
    ds = TD.NYUDataset(root, "test", view=1, img_size=S)
    item = ds[3]
    batch = list(ds.batches(1, shuffle=False, drop_last=False))[3]
    ds.close()
    assert item["img"].shape == (1, S, S)
    for k in KEYS:
        assert np.array_equal(item[k], batch[k][0])


def test_prefetch_raises_a_worker_error_and_stops(fake):
    """A worker's exception reaches the consumer (a missing frame mid-pass
    must not hang the loop), and closing the generator ends its thread."""
    root, _ = fake
    ds = TD.NYUDataset(root, "test", img_size=S)
    ds.data_path = os.path.join(root, "missing")
    with pytest.raises(FileNotFoundError):
        next(ds.prefetch_batches(2))
    ds = TD.NYUDataset(root, "test", img_size=S)
    gen = ds.prefetch_batches(1, prefetch=1, loop=True)
    next(gen)
    gen.close()
    ds.close()


def test_port_fake_set_matches_jax(fake, tmp_path):
    """The port's make_fake_nyu on the CPU (the plain dense raster) draws
    the JAX package's hands: its first train frame's joints equal JAX's to
    float32 LBS rounding and its depth PNG differs on at most 0.5% of the
    hand's pixels (silhouette flips and depths the two rasters truncate
    apart)."""
    import scipy.io as sio
    root, mano = fake
    out = make_fake_nyu(str(tmp_path), mano, n_train=1, n_test=1,
                        device="cpu")
    mine = os.path.join(out, "nyu")
    assert sorted(os.listdir(os.path.join(mine, "test"))) == sorted(
        ["joint_data.mat", "center_test_0_refined.txt",
         "center_test_1_refined.txt", "center_test_2_refined.txt"]
        + [f"depth_{v}_0000001.png" for v in (1, 2, 3)])
    a = sio.loadmat(os.path.join(mine, "train", "joint_data.mat"))
    b = sio.loadmat(os.path.join(root, "train", "joint_data.mat"))
    np.testing.assert_allclose(a["joint_xyz"][:, 0], b["joint_xyz"][:, 0],
                               atol=1e-3)
    np.testing.assert_array_equal(
        np.loadtxt(os.path.join(mine, "train", "center_train_0_refined.txt")),
        np.loadtxt(os.path.join(root, "train",
                                "center_train_0_refined.txt"))[0])
    d_port = TR.nyu_reader(os.path.join(mine, "train", "depth_1_0000001.png"))
    d_jax = JR.nyu_reader(os.path.join(root, "train", "depth_1_0000001.png"))
    fg = int((d_jax > 0).sum())
    assert fg > 1000
    assert int((d_port != d_jax).sum()) <= 0.005 * fg
