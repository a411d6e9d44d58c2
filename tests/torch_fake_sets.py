"""Seeded stand-ins for the ICVL, MSRA, SHREC and DHG datasets, written by
the port in each dataset's own layout (the licensed sets are not in the
repository).

Random MANO hands, centred at depths the dataset's camera sees, are
rendered full frame on that camera through the port's offline
pre-render (``tools.prerender.prerender_dataset``: the dense raster, K6
on a card, once per batch) and written with the port's writers
(``prerender.write_png16``, ``readers.write_msra_bin``).  The labels are
the rendered hands' joints in the dataset's joint order, stored as the
dataset stores them: ICVL's images mirrored with u as 320 - u and the
refined centres' x negated, MSRA's joints with y and z negated and its
centres with y negated, DHG's images mirrored with u as 640 - u and its
joints in metres, so that each loader's reading restores the rendered
hand.

The CPU tests build them with a few distinct hands (``unique``: the
frames cycle through that many renders, since the CPU raster takes
seconds a frame) and chip_smoke.py at full size on the card.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from dsf_tpu_torch.config import CAMERA
from dsf_tpu_torch.data import readers
from dsf_tpu_torch.data.datasets import MSRADataset
from dsf_tpu_torch.device import exact_float32, resolve_device
from dsf_tpu_torch.mano import model as mano_model
from dsf_tpu_torch.mano.constants import MANO2ICVL, MANO2MSRA
from dsf_tpu_torch.tools import prerender

# the hands' centre depth in mm: ICVL's and MSRA's cameras see hands at
# 150-600 mm, SHREC's and DHG's at 500-1200
NEAR, FAR = (250.0, 450.0), (550.0, 800.0)


def render_hands(mano_npz, n, dataset, depth, rng, device=None, unique=None,
                 scale=1.0, batch_size=32):
    """n full frames of ``dataset``'s camera, each a random MANO hand
    (scale ``scale``) whose joints' mean sits at a centre drawn in front
    of the camera at ``depth`` (lo, hi) mm; the frames cycle through
    ``unique`` renders (all n distinct when None).  Returns (depths (n, H,
    W) uint16 mm, joints (n, 21, 3) float32 world mm in MANO's order)."""
    dev = resolve_device(device)
    k = n if unique is None else min(n, unique)
    para = np.zeros((k, 62), np.float32)
    para[:, :3] = rng.uniform(-np.pi, np.pi, (k, 3))
    para[:, 3:48] = rng.randn(k, 45) * 0.3
    para[:, 48:58] = rng.randn(k, 10) * 0.5
    para[:, 58] = scale
    centre = np.stack([rng.uniform(-30, 30, k), rng.uniform(-30, 30, k),
                       rng.uniform(depth[0], depth[1], k)], 1)
    m = mano_model.load_model(mano_npz, device=dev)
    with torch.no_grad(), exact_float32():
        _, joints = mano_model.get_mano_vertices(
            m, *mano_model.split_params(torch.from_numpy(para).to(dev)))
    joints = joints.cpu().numpy().astype(np.float64)
    para[:, 59:] = centre - joints.mean(1)
    joints = (joints + para[:, None, 59:]).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        prerender.prerender_dataset(mano_npz, para, tmp, dataset=dataset,
                                    batch_size=batch_size, device=dev)
        depths = np.stack([prerender.read_png16(os.path.join(
            tmp, f"render_{i + 1:07d}.png")) for i in range(k)])
    pick = np.arange(n) % k
    return depths[pick], joints[pick]


def to_uvd(xyz, dataset):
    fx, fy, fu, fv = CAMERA[dataset][0]
    return np.stack([xyz[..., 0] * fx / xyz[..., 2] + fu,
                     xyz[..., 1] * fy / xyz[..., 2] + fv, xyz[..., 2]], -1)


def _rows(a):
    return [" ".join(f"{v:.4f}" for v in r) for r in
            np.asarray(a, np.float64).reshape(len(a), -1)]


def make_icvl(root, mano_npz, n_train=128, n_test=40, seed=0, device=None,
              unique=None, batch_size=32):
    """``{root}/icvl`` in the reference's layout: train.txt, test_seq_1.txt
    and test_seq_2.txt (16 joints' uvd a line, u stored as 320 - u),
    center_{train,test}_refined.txt (x negated) and Depth/ (mirrored
    16-bit PNGs).  The test lists hold ``n_test`` frames that pass the
    subsequence filter plus two that the loader drops: a short-named
    subsequence ("22/") and an ``invalid`` centre.  Returns the directory."""
    rng = np.random.RandomState(seed)
    out = os.path.join(root, "icvl")
    W = CAMERA["icvl"][1][0]
    n = n_train + n_test + 2
    depths, joints = render_hands(mano_npz, n, "icvl", NEAR, rng, device,
                                  unique, batch_size=batch_size)
    names = ([f"201403121135/image_{i:04d}.png" for i in range(n_train)]
             + [f"test_seq_1/image_{i:04d}.png" for i in range(n_test // 2)]
             + ["22/image_0000.png"]
             + [f"test_seq_2/image_{i:04d}.png"
                for i in range(n_test - n_test // 2 + 1)])
    uvd = to_uvd(joints[:, MANO2ICVL], "icvl")
    uvd[:, :, 0] = W - uvd[:, :, 0]
    centres = joints.mean(1)
    centres[:, 0] = -centres[:, 0]
    lines, cent = [], []
    for i, (name, d) in enumerate(zip(names, depths)):
        path = os.path.join(out, "Depth", name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prerender.write_png16(path, np.ascontiguousarray(d[:, ::-1]))
        lines.append(name + " " + _rows(uvd[i:i + 1])[0])
        cent.append(_rows(centres[i:i + 1])[0])
    cent[-1] = "invalid invalid invalid"
    t1 = n_train + n_test // 2 + 1
    for fname, sl in (("train.txt", slice(0, n_train)),
                      ("test_seq_1.txt", slice(n_train, t1)),
                      ("test_seq_2.txt", slice(t1, n))):
        with open(os.path.join(out, fname), "w") as f:
            f.write("\n".join(lines[sl]) + "\n")
    for fname, sl in (("center_train_refined.txt", slice(0, n_train)),
                      ("center_test_refined.txt", slice(n_train, n))):
        with open(os.path.join(out, fname), "w") as f:
            f.write("\n".join(cent[sl]) + "\n")
    return out


def make_msra(root, mano_npz, frames=None, test_id=2, seed=0, device=None,
              unique=None, batch_size=32):
    """``{root}/msra``: for each person p and gesture g of ``frames``
    {p: (gestures, frames a gesture)} (default: P2, the test subject, 20
    frames of gestures 1 and 2; P3 and P7 32 of each), P{p}/{g}/joint.txt
    (y and z negated) and {i:06d}_depth.bin, with the MANO hand scaled to
    the person's cube / 200; and center_{train,test}_{test_id}_refined.txt
    (y negated) in the loader's frame order.  Returns the directory."""
    frames = frames or {2: (("1", "2"), 20), 3: (("1", "2"), 32),
                        7: (("1", "2"), 32)}
    rng = np.random.RandomState(seed)
    out = os.path.join(root, "msra")
    centres = {"train": [], "test": []}
    for p in sorted(frames):
        gestures, n = frames[p]
        # the loader's order, which the centre files follow
        for g in sorted(gestures, key=MSRADataset.GESTURES.index):
            depths, joints = render_hands(
                mano_npz, n, "msra", NEAR, rng, device, unique,
                scale=MSRADataset.PERSON_CUBES[p] / 200.0,
                batch_size=batch_size)
            gdir = os.path.join(out, f"P{p}", g)
            os.makedirs(gdir, exist_ok=True)
            raw = joints[:, MANO2MSRA] * np.array([1, -1, -1], np.float32)
            with open(os.path.join(gdir, "joint.txt"), "w") as f:
                f.write(f"{n}\n" + "\n".join(_rows(raw)) + "\n")
            for i, d in enumerate(depths):
                readers.write_msra_bin(os.path.join(gdir, f"{i:06d}_depth.bin"),
                                       d)
            c = joints.mean(1) * np.array([1, -1, 1], np.float32)
            centres["test" if p == test_id else "train"].append(c)
    for phase, cs in centres.items():
        if cs:
            np.savetxt(os.path.join(out, f"center_{phase}_{test_id}"
                                    "_refined.txt"),
                       np.concatenate(cs), fmt="%.4f")
    return out


def make_shrec(root, mano_npz, n=40, n_blob=0, seed=0, device=None,
               unique=None, batch_size=32):
    """``{root}/shrec``: one sequence of ``n`` 640x480 frames
    ({i}_depth.png from 1) with skeletons_world_pred.txt (21 MANO joints,
    world mm, a row per frame in the loader's sorted name order), and
    with ``n_blob`` > 0 a second sequence of that many frames without one
    (the loader centres those on the depth blob).  Returns the directory."""
    rng = np.random.RandomState(seed)
    out = os.path.join(root, "shrec")
    for seq, k, pred in (("gesture_1/finger_1/subject_1/essai_1", n, True),
                         ("gesture_2/finger_1/subject_1/essai_1", n_blob,
                          False)):
        if not k:
            continue
        d = os.path.join(out, *seq.split("/"))
        os.makedirs(d, exist_ok=True)
        depths, joints = render_hands(mano_npz, k, "shrec", FAR, rng, device,
                                      unique, batch_size=batch_size)
        names = [f"{i + 1}_depth.png" for i in range(k)]
        for name, img in zip(names, depths):
            prerender.write_png16(os.path.join(d, name), img)
        if pred:
            order = np.argsort(names)
            np.savetxt(os.path.join(d, "skeletons_world_pred.txt"),
                       joints[order].reshape(k, -1), fmt="%.4f")
    return out


def make_dhg(root, mano_npz, seqs=((1, 1, 1, 1, 5, 1, 3), (2, 2, 1, 1, 5, 0, 2)),
             seed=0, device=None, unique=None, batch_size=32):
    """``{root}/dhg`` in DHG's layout: for each (gesture, finger, subject,
    essai, frames, start, end) of ``seqs``, gesture_{g}/finger_{f}/
    subject_{s}/essai_{e}/ with depth_{i}.png from 1 (640x480, mirrored),
    skeleton_image.txt (every frame's 21 joints' uv, u as 640 - u) and
    skeletons_world_pred_normal_DSSF.txt (the truncated frames' world
    joints in metres), and informations_troncage_sequences.txt.  Returns
    the directory."""
    rng = np.random.RandomState(seed)
    out = os.path.join(root, "dhg")
    W = CAMERA["shrec"][1][0]
    lines = []
    for g, fi, s, e, n, start, end in seqs:
        d = os.path.join(out, f"gesture_{g}", f"finger_{fi}",
                         f"subject_{s}", f"essai_{e}")
        os.makedirs(d, exist_ok=True)
        depths, joints = render_hands(mano_npz, n, "shrec", FAR, rng, device,
                                      unique, batch_size=batch_size)
        for i, img in enumerate(depths):
            prerender.write_png16(os.path.join(d, f"depth_{i + 1}.png"),
                                  np.ascontiguousarray(img[:, ::-1]))
        uv = to_uvd(joints, "shrec")[..., :2]
        uv[..., 0] = W - uv[..., 0]
        np.savetxt(os.path.join(d, "skeleton_image.txt"),
                   uv.reshape(n, -1), fmt="%.4f")
        np.savetxt(os.path.join(d, "skeletons_world_pred_normal_DSSF.txt"),
                   joints[start:end + 1].reshape(-1, 63) / 1000.0,
                   fmt="%.6f")
        lines.append(f"{g} {fi} {s} {e} {start} {end}")
    with open(os.path.join(out, "informations_troncage_sequences.txt"),
              "w") as f:
        f.write("\n".join(lines) + "\n")
    return out
