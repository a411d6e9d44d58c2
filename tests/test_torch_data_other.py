"""Port parity for the host data path of ICVL, MSRA, SHREC and DHG: the
single-band PNG reader against PIL (the JAX package's reader), the MSRA
reader, the four loaders' batches against the JAX loaders', and the MANO
converter, each on the same files and seeds.

Every comparison is bitwise.  The sets are the port's stand-ins
(tests/torch_fake_sets.py: rendered MANO hands in each dataset's layout,
one or two distinct renders a sequence on the CPU); PNGs with each row filter are
written here.
"""

import os
import pickle
import struct
import sys
import types
import zlib

import numpy as np
import pytest
import scipy.sparse
import torch

from dsf_tpu.data import aug_batch as JA
from dsf_tpu.data import datasets as JD
from dsf_tpu.data import readers as JR
from dsf_tpu.mano import convert as JCV
from dsf_tpu_torch.data import datasets as TD
from dsf_tpu_torch.data import readers as TR
from dsf_tpu_torch.mano import convert as TCV
from dsf_tpu_torch.mano import synthetic
from dsf_tpu_torch.tools import prerender
import torch_fake_sets as F

torch.set_num_threads(2)

S = 64
KEYS = ("img", "xyz_gt", "uvd_gt", "center", "M", "cube")
N_TRAIN, N_TEST = 6, 5
MSRA_FRAMES = {2: (("1", "T"), 2), 3: (("1",), 3), 7: (("Y",), 3)}


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """Each stand-in built once: ICVL (6 train, 5 test frames that pass
    the filter, one short-named subsequence and one invalid centre), MSRA
    (P2 the test subject; P3 and P7, cubes 180 and 160, the train split),
    SHREC (a sequence with joints and one centred on the depth blob) and
    DHG (two truncated sequences)."""
    d = tmp_path_factory.mktemp("sets")
    mano = str(d / "mano.npz")
    synthetic.save_synthetic_mano(mano)
    kw = dict(device="cpu", unique=1)
    return dict(
        mano=mano,
        icvl=F.make_icvl(str(d), mano, N_TRAIN, N_TEST, device="cpu",
                         unique=2),
        msra=F.make_msra(str(d), mano, MSRA_FRAMES, test_id=2, **kw),
        shrec=F.make_shrec(str(d), mano, n=3, n_blob=2, **kw),
        dhg=F.make_dhg(str(d), mano, **kw))


# ------------------------------------------------------------ readers

FILTERS = ["none", "sub", "up", "average", "paeth", "mixed"]


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png(path, raw, W, H, depth, colour, kinds, bpp, interlace=0):
    """A PNG of the (H, rb) bytes ``raw``, row r filtered with kinds[r]
    looking back ``bpp`` bytes."""
    x = raw.astype(np.int32)
    rows = np.zeros((H, 1 + x.shape[1]), np.uint8)
    for r, f in enumerate(kinds):
        prior = x[r - 1] if r else np.zeros_like(x[r])
        left = np.concatenate([np.zeros(bpp, np.int32), x[r, :-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        pred = {1: left, 2: prior, 3: (left + prior) // 2,
                4: _paeth(left, prior, ul)}.get(f, 0)
        rows[r, 0] = f
        rows[r, 1:] = (x[r] - pred) & 0xFF
    ihdr = struct.pack(">IIBBBBB", W, H, depth, colour, 0, 0, interlace)
    with open(path, "wb") as f:
        f.write(TR.PNG_SIGNATURE + TR.png_chunk(b"IHDR", ihdr)
                + TR.png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + TR.png_chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", FILTERS)
@pytest.mark.parametrize("bits", [8, 16])
def test_gray_reader_matches_pil(tmp_path, bits, kinds):
    """A depth frame as 8- and 16-bit grayscale written with each PNG row
    filter (the filters look back a whole sample: 2 bytes at 16 bits; the
    samples big-endian), and with all five mixed: icvl_reader and
    shrec_reader read it bitwise as the JAX package's PIL readers, and
    prerender.read_png16 reads the 16-bit one."""
    rng = np.random.RandomState(bits)
    H, W = 37, 45
    yy, xx = np.mgrid[:H, :W]
    hi = 255 if bits == 8 else 65535
    img = np.clip(300 + 97 * xx + 181 * yy + rng.randint(0, 9000, (H, W)),
                  0, hi)
    img[rng.rand(H, W) < 0.2] = 0
    img = img.astype(np.uint8 if bits == 8 else np.uint16)
    raw = img.astype(">u2").view(np.uint8) if bits == 16 else img
    per_row = (rng.randint(0, 5, H) if kinds == "mixed"
               else np.full(H, FILTERS.index(kinds)))
    path = str(tmp_path / "g.png")
    _png(path, raw.reshape(H, -1), W, H, bits, 0, per_row, bits // 8)
    ref = JR.icvl_reader(path)
    for reader in (TR.icvl_reader, TR.shrec_reader):
        got = reader(path)
        assert got.dtype == ref.dtype == np.float32
        assert np.array_equal(got, ref)
    assert np.array_equal(ref, img.astype(np.float32))
    assert np.array_equal(JR.shrec_reader(path), ref)
    if bits == 16:
        assert np.array_equal(prerender.read_png16(path), img)


def test_gray_reader_rejects_what_it_cannot_read(tmp_path):
    """Colour PNGs (PIL's reader asserts one band) raise, as do the gray
    depths PIL unpacks but the datasets never store (4-bit), interlaced
    files and an unknown row filter."""
    rgb = np.zeros((4, 12), np.uint8)
    cases = {"rgb": (rgb, 4, 8, 2, [0] * 4, 3, 0),
             "gray4": (np.zeros((4, 2), np.uint8), 4, 4, 0, [0] * 4, 1, 0),
             "interlaced": (np.zeros((4, 4), np.uint8), 4, 8, 0, [0] * 4, 1,
                            1),
             "filter": (np.zeros((4, 4), np.uint8), 4, 8, 0, [0, 5, 0, 0], 1,
                        0)}
    for name, (raw, W, depth, colour, kinds, bpp, il) in cases.items():
        path = str(tmp_path / f"{name}.png")
        _png(path, raw, W, 4, depth, colour, kinds, bpp, il)
        with pytest.raises(ValueError):
            TR.icvl_reader(path)
    with pytest.raises(AssertionError):
        JR.icvl_reader(str(tmp_path / "rgb.png"))


def test_msra_reader_matches_jax(tmp_path):
    """A seeded MSRA frame written by write_msra_bin (the header, the
    non-zero box's patch): the depth image and the world points bitwise
    as the JAX reader's, and the frame back unchanged."""
    rng = np.random.RandomState(0)
    depth = np.zeros((240, 320), np.float32)
    depth[60:150, 90:171] = rng.uniform(200, 600, (90, 81))
    depth[rng.rand(240, 320) < 0.3] = 0
    path = str(tmp_path / "000000_depth.bin")
    TR.write_msra_bin(path, depth)
    paras = (241.42, 241.42, 160.0, 120.0)
    got, ref = TR.msra_reader(path, paras), JR.msra_reader(path, paras)
    assert np.array_equal(got[0], depth)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[1].shape[0] == int((depth != 0).sum())


# ------------------------------------------------------------ loaders

def _equal(got, ref, keys=KEYS):
    assert sorted(got) == sorted(keys)
    for k in keys:
        r = np.asarray(ref[k])
        assert got[k].dtype == r.dtype and got[k].shape == r.shape, k
        assert np.array_equal(got[k], r), k


def _pair(sets, name, phase):
    root = sets[name]
    if name == "icvl":
        make = lambda D: D.ICVLDataset(root, phase, img_size=S, seed=5)
    else:
        make = lambda D: D.MSRADataset(root, phase, test_persons=2,
                                       img_size=S, seed=5)
    return make(JD), make(TD)


@pytest.mark.parametrize("name, phase", [("icvl", "test"), ("icvl", "train"),
                                         ("msra", "test"),
                                         ("msra", "train")])
def test_batches_match_jax(sets, name, phase):
    """ICVL's and MSRA's batches of 4 (the test splits' eval batches, the
    tail kept; the train splits' augmented batches over two shuffled
    passes from the same seeds), every key bitwise as the JAX loader's
    batched fast path; MSRA's train batches mix two subjects' cubes."""
    jds, tds = _pair(sets, name, phase)
    assert len(tds) == len(jds) > 0
    if phase == "test":
        kw = [dict(drop_last=False)]
    else:
        assert JA.available()
        tds.enable_depth_cache()
        kw = [dict(shuffle=True, seed=2), dict(shuffle=True, seed=3)]
    ref = [b for k in kw for b in jds.batches(4, **k)]
    got = [b for k in kw for b in tds.batches(4, **k)]
    tds.close()
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        _equal(g, r)
    if name == "msra" and phase == "train":
        assert {180.0, 160.0} <= set(np.concatenate(
            [b["cube"][:, 0] for b in got]).tolist())


def test_icvl_filter_centres_and_flat_layout(sets, tmp_path):
    """ICVL's test list: the short-named subsequence and the invalid
    centre are dropped (the centre file read by the line's position
    before filtering), full_img keeps the former; the flip restores the
    rendered hand (u = 320 - the stored u, x = -the stored centre x); the
    flat Testing/labels.txt layout reads as the JAX loader reads it."""
    root = sets["icvl"]
    tds = TD.ICVLDataset(root, "test", img_size=S)
    jds = JD.ICVLDataset(root, "test", img_size=S)
    assert len(tds) == N_TEST and tds.img_names == jds.img_names
    assert not any("/22/" in n for n in tds.img_names)
    full = TD.ICVLDataset(root, "test", img_size=S, full_img=True)
    assert len(full) == N_TEST + 1 == len(JD.ICVLDataset(root, "test",
                                                         full_img=True))
    for a in ("all_joints_uvd", "all_joints_xyz", "center_xyz"):
        assert np.array_equal(getattr(tds, a), getattr(jds, a)), a
    lines = open(os.path.join(root, "test_seq_1.txt")).read().split("\n")
    stored = np.asarray(lines[0].split()[1:], np.float32).reshape(16, 3)
    np.testing.assert_array_equal(tds.all_joints_uvd[0, :, 0],
                                  320 - stored[:, 0])

    flat = tmp_path / "flat"
    (flat / "Testing" / "Depth").mkdir(parents=True)
    rows = []
    for i, line in enumerate(ln for ln in lines[:N_TEST // 2] if ln):
        name, rest = line.split(" ", 1)
        os.link(os.path.join(root, "Depth", name),
                flat / "Testing" / "Depth" / f"f{i}.png")
        rows.append(f"f{i}.png {rest}")
    (flat / "Testing" / "labels.txt").write_text("\n".join(rows) + "\n")
    got = next(TD.ICVLDataset(str(flat), "test", img_size=S).batches(
        8, drop_last=False))
    ref = next(JD.ICVLDataset(str(flat), "test", img_size=S).batches(
        8, drop_last=False))
    assert len(got["img"]) == len(rows)
    _equal(got, ref)


def test_msra_centres_record_and_length_check(sets, tmp_path):
    """MSRA's refined centres (the y-negation round trip) and joints as
    the JAX loader's, bitwise; write_record's two files byte for byte;
    a centre file with a row too few raises in both."""
    root = sets["msra"]
    out = {}
    for tag, D in (("port", TD), ("jax", JD)):
        copy = tmp_path / tag
        copy.mkdir()
        for f in os.listdir(root):
            os.symlink(os.path.join(root, f), copy / f)
        ds = D.MSRADataset(str(copy), "train", test_persons=2,
                           write_record=True)
        out[tag] = (ds, [open(copy / f, "rb").read() for f in
                         ("msra_record_list.txt", "msra_label.txt")])
    (tds, trec), (jds, jrec) = out["port"], out["jax"]
    assert trec == jrec and len(trec[0]) > 0
    for a in ("joints_xyz", "cubes", "center_xyz"):
        assert np.array_equal(getattr(tds, a), getattr(jds, a)), a
    assert tds.rel_files == jds.rel_files
    bad = tmp_path / "bad"
    bad.mkdir()
    for f in os.listdir(root):
        if f.startswith("P"):
            os.symlink(os.path.join(root, f), bad / f)
    rows = np.loadtxt(os.path.join(root, "center_test_2_refined.txt"))
    np.savetxt(bad / "center_test_2_refined.txt", rows[:-1])
    for D in (TD, JD):
        with pytest.raises(ValueError, match="center file rows"):
            D.MSRADataset(str(bad), "test", test_persons=2)


def test_shrec_items_match_jax(sets):
    """Every SHREC frame (joints from skeletons_world_pred.txt, and the
    second sequence's centred on the depth blob), served as a batch,
    bitwise JAX's ``__getitem__``."""
    jds = JD.SHRECDataset(sets["shrec"], img_size=S)
    tds = TD.SHRECDataset(sets["shrec"], img_size=S)
    assert [s[0] for s in tds.samples] == [s[0] for s in jds.samples]
    assert [s[1] is None for s in tds.samples] == [False] * 3 + [True] * 2
    got = next(tds.batches(len(tds), drop_last=False))
    tds.close()
    for i in range(len(jds)):
        _equal({k: v[i] for k, v in got.items()}, jds[i])


def test_dhg_items_match_jax(sets):
    """DHG's frames as batches, bitwise JAX's ``__getitem__``: unaugmented
    (the flipped image and centre u, the 250 mm cube, gesture and
    label28), and augmented with the draws JAX's item path takes in one
    thread (its per-thread RandomState, seeded from the dataset's)."""
    root = sets["dhg"]
    keys = KEYS + ("gesture", "label28")
    jds = JD.DHGDataset(root, img_size=S)
    tds = TD.DHGDataset(root, img_size=S)
    plain = next(tds.batches(len(tds), drop_last=False))
    assert len(jds) == len(tds) == 6
    assert plain["label28"].tolist() == [0] * 3 + [3] * 3
    for i in range(len(jds)):
        _equal({k: v[i] for k, v in plain.items()}, jds[i], keys)
    jaug = JD.DHGDataset(root, img_size=S, augment=True, seed=7)
    taug = TD.DHGDataset(root, img_size=S, augment=True)
    taug.rng = np.random.RandomState(
        np.random.RandomState(7).randint(0, 2 ** 31 - 1))
    got = next(taug.batches(len(taug), drop_last=False))
    for i in range(len(jaug)):
        _equal({k: v[i] for k, v in got.items()}, jaug[i], keys)
    assert not np.array_equal(got["img"], plain["img"])


# ------------------------------------------------------------ converter

class _Ch:
    """A stand-in for chumpy.Ch to pickle with: its state is {"x": the
    array}, as chumpy pickles its arrays."""

    def __init__(self, x):
        self.x = x


def test_convert_mano_pkl_matches_jax(tmp_path, monkeypatch):
    """A MANO-like pickle whose arrays are chumpy objects and whose
    J_regressor is a scipy sparse matrix, read where chumpy is not
    installed (each converter injects its stub): the port's npz and
    returned arrays bitwise the JAX converter's."""
    rng = np.random.RandomState(0)
    mod, ch = types.ModuleType("chumpy"), types.ModuleType("chumpy.ch")
    _Ch.__module__, _Ch.__qualname__ = "chumpy.ch", "Ch"
    ch.Ch = mod.Ch = _Ch
    model = {
        "v_template": _Ch(rng.randn(30, 3)),
        "shapedirs": _Ch(rng.randn(30, 3, 10)),
        "J_regressor": scipy.sparse.csc_matrix(
            np.where(rng.rand(16, 30) < 0.1, rng.rand(16, 30), 0.0)),
        "hands_components": rng.randn(45, 45),
        "hands_mean": _Ch(rng.randn(45)),
        "posedirs": rng.randn(30, 3, 135),
        "kintree_table": np.stack([np.arange(16) - 1, np.arange(16)]),
        "weights": _Ch(rng.rand(30, 16)),
        "f": rng.randint(0, 30, (40, 3)).astype(np.uint32),
        "bs_style": "lbs",
    }
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "chumpy", mod)
        mp.setitem(sys.modules, "chumpy.ch", ch)
        blob = pickle.dumps(model, protocol=2)
    pkl = tmp_path / "MANO_RIGHT.pkl"
    pkl.write_bytes(blob)
    out = {}
    for tag, conv in (("port", TCV), ("jax", JCV)):
        for name in [m for m in sys.modules if m.split(".")[0] == "chumpy"]:
            monkeypatch.delitem(sys.modules, name)
        npz = tmp_path / f"{tag}.npz"
        out[tag] = (conv.convert_mano_pkl(str(pkl), str(npz)),
                    dict(np.load(npz)))
    for i in range(2):
        got, ref = out["port"][i], out["jax"][i]
        assert sorted(got) == sorted(ref) == sorted(TCV.FIELDS)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and np.array_equal(
                got[k], ref[k]), k
    np.testing.assert_array_equal(out["port"][0]["J_regressor"],
                                  model["J_regressor"].toarray().astype(
                                      np.float32))
    assert out["port"][0]["f"].dtype == np.int32
