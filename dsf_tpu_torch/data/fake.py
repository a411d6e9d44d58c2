"""A synthetic on-disk NYU-format dataset (counterpart of
dsf_tpu/data/fake.py) for end-to-end runs on machines without the
licensed dataset.

Random MANO hands are rendered at NYU's 640x480 with the port's raster
(``rasterize.rasterize_depth`` over ``full_frame_pixel_rays``: the dense
route, K6 on a card, once per render batch) and written in the layout
``datasets.NYUDataset`` reads: packed depth PNGs (``readers.write_nyu_png``;
test frames for all 3 views), joint_data.mat (3 views x N x 36 x 3),
the refined centre files, and the per-frame parameter bank under
``posePara_lm_collosion``.  The random draws are the JAX package's, in
its order, so one seed gives both packages the same hands.
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dsf_tpu_torch.config import CAMERA
from dsf_tpu_torch.data import readers
from dsf_tpu_torch.device import exact_float32, resolve_device
from dsf_tpu_torch.mano import model as mano_model
from dsf_tpu_torch.mano.constants import NYU_CALCULATE, NYU_JOINT_SELECT
from dsf_tpu_torch.ops import rasterize as R

DRAW_CHUNK = 8      # the JAX package's render batch: its draws come in 8s


def _draw_params(rng, n):
    return np.concatenate([
        rng.uniform(-np.pi, np.pi, (n, 3)), rng.randn(n, 45) * 0.3,
        rng.randn(n, 10) * 0.5, np.ones((n, 1)), np.zeros((n, 3))],
        axis=1).astype(np.float32)


def make_fake_nyu(root, mano_npz, n_train=64, n_test=32, seed=0,
                  batch_size=32, device=None):
    """Write ``{root}/nyu/{train,test}`` with ``n_train`` / ``n_test``
    frames rendered ``batch_size`` at a time on ``device`` (``cuda`` when
    None; raises without it).  Returns ``root``."""
    import scipy.io as sio

    dev = resolve_device(device)
    paras, (W, H) = CAMERA["nyu"]
    m = mano_model.load_model(mano_npz, device=dev)
    rays = R.full_frame_pixel_rays((W, H), device=dev)
    rng = np.random.RandomState(seed)

    for phase, n in (("train", n_train), ("test", n_test)):
        pdir = os.path.join(root, "nyu", phase)
        os.makedirs(pdir, exist_ok=True)
        paras_l, centers_l = [], []
        for _ in range(0, n, DRAW_CHUNK):
            paras_l.append(_draw_params(rng, DRAW_CHUNK))
            centers_l.append(np.concatenate(
                [rng.uniform(-60, 60, (DRAW_CHUNK, 2)),
                 rng.uniform(600, 900, (DRAW_CHUNK, 1))],
                axis=1).astype(np.float32))
        params = np.concatenate(paras_l)[:n]
        centers = np.concatenate(centers_l)[:n]

        n_views = 3 if phase == "test" else 1
        joints_l = []
        with torch.no_grad(), exact_float32(), \
                ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as ex:
            writes = []
            for s in range(0, n, batch_size):
                p = torch.from_numpy(params[s:s + batch_size]).to(dev)
                c3 = torch.from_numpy(centers[s:s + batch_size]).to(dev)
                verts, joints = mano_model.get_mano_vertices(
                    m, *mano_model.split_params(p))
                c = joints.mean(1, keepdim=True)
                verts = verts - c + c3[:, None]
                joints = joints - c + c3[:, None]
                depth = R.rasterize_depth(verts, m.faces, rays, paras)
                depth = depth.reshape(-1, H, W).cpu().numpy()
                joints_l.append(joints.cpu().numpy())
                for b, img in enumerate(depth):
                    path = os.path.join(pdir, f"depth_1_{s + b + 1:07d}.png")
                    writes.append(ex.submit(readers.write_nyu_png, path,
                                            img.astype(np.uint16)))
            for w in writes:
                w.result()
        for v in range(1, n_views):
            for i in range(n):
                shutil.copyfile(os.path.join(pdir, f"depth_1_{i + 1:07d}.png"),
                                os.path.join(pdir, f"depth_{v + 1}_{i + 1:07d}.png"))

        all_joints = np.concatenate(joints_l)            # (N, 21, 3)
        # joint_data.mat in NYU's raw 36-joint layout: the first 14 of the
        # 21 joints go to the slots NYU_JOINT_SELECT[NYU_CALCULATE] reads
        raw_uvd = np.zeros((3, n, 36, 3), np.float32)
        raw_xyz = np.zeros((3, n, 36, 3), np.float32)
        sel = NYU_JOINT_SELECT[NYU_CALCULATE]
        fx, fy, fu, fv = paras
        for v in range(3):
            xyz14 = all_joints[:, :14]
            # the loader applies jointImgTo3D(joint3DToImg(xyz, flip=-1)),
            # y -> -y: pre-negate so it recovers our y
            xyz_neg = xyz14.copy()
            xyz_neg[:, :, 1] = -xyz_neg[:, :, 1]
            raw_xyz[v][:, sel] = xyz_neg
            uvd = xyz14.copy()
            uvd[:, :, 0] = xyz14[:, :, 0] * fx / xyz14[:, :, 2] + fu
            uvd[:, :, 1] = xyz14[:, :, 1] * fy / xyz14[:, :, 2] + fv
            raw_uvd[v][:, sel] = uvd
        sio.savemat(os.path.join(pdir, "joint_data.mat"),
                    {"joint_uvd": raw_uvd, "joint_xyz": raw_xyz})
        for v in range(n_views):
            np.savetxt(os.path.join(pdir, f"center_{phase}_{v}_refined.txt"),
                       centers, fmt="%.4f")

        # per-frame MANO parameters (ref layout read_modelPara,
        # render_loader.py:1324-1332)
        ppdir = os.path.join(root, "nyu", "posePara_lm_collosion")
        os.makedirs(ppdir, exist_ok=True)
        para_bank = _draw_params(rng, n)
        for sfx, sl in (("glb", slice(0, 3)), ("pose", slice(3, 48)),
                        ("shape", slice(48, 58)), ("scale", slice(58, 59)),
                        ("trans", slice(59, 62))):
            np.savetxt(os.path.join(ppdir, f"nyu-{phase}-0-{sfx}.txt"),
                       para_bank[:, sl], fmt="%.6f")
    return root
