"""Seeded inputs for smoke runs and profiles of the port, made without any
asset or checkpoint: the synthetic MANO asset, a random reference-layout
state dict, and requests and "real" training batches that are rendered
MANO hands.

Nothing here is random beyond numpy generators the caller seeds.
"""

from __future__ import annotations

import numpy as np
import torch

from dsf_tpu_torch import geometry as geo
from dsf_tpu_torch.config import CAMERA, CUBE, JOINT, Config, net_depth
from dsf_tpu_torch.mano.constants import transfer_for_dataset
from dsf_tpu_torch.models.weights import random_reference_state_dict
from dsf_tpu_torch.render import renderer as rnd

PARAS = CAMERA["nyu"][0]
# the hands' depth in mm by the renderer's synth depth range: NYU's
# (500-1200 mm) or ICVL's and MSRA's (150-600 mm)
POSED_DEPTH = {(500.0, 1200.0): (650.0, 900.0), (150.0, 600.0): (250.0, 450.0)}


def posed_params(renderer, B: int, rng: np.random.RandomState,
                 cube_size: float = 250.0):
    """(mano_para (B, 62), center (B, 3) mm, cube (B, 3) mm) on the
    renderer's device: random poses in front of its camera, at the depths
    of its synth range (``POSED_DEPTH``)."""
    lo, hi = POSED_DEPTH[tuple(renderer.depth_range)]
    para = np.zeros((B, 62), np.float32)
    para[:, :48] = rng.randn(B, 48).astype(np.float32) * 0.3
    para[:, 58] = rng.uniform(0.9, 1.1, B)
    para[:, 59:] = rng.randn(B, 3).astype(np.float32) * 0.05
    center = rng.uniform([-40, -40, lo], [40, 40, hi], (B, 3)).astype(np.float32)
    cube = np.full((B, 3), cube_size, np.float32)
    dev = renderer.mano.device
    return tuple(torch.from_numpy(x).to(dev) for x in (para, center, cube))


def requests(renderer, n: int, rng: np.random.RandomState):
    """n crops as numpy arrays (img (n, 1, S, S), center, M, cube): rendered
    hands as normalized depth at the renderer's crop size."""
    para, center, cube = posed_params(renderer, n, rng)
    with torch.inference_mode():
        img, _, _, _ = rnd.render_params(renderer, para, center, cube)
        com = geo.xyz_to_uvd(center[:, None], renderer.paras)[:, 0]
        M = geo.crop_matrix(com, cube, renderer.paras, renderer.crop_size)
    return [t.cpu().numpy() for t in (img, center, M, cube)]


def real_batch(renderer, B: int, rng: np.random.RandomState,
               para=None, dataset: str = "nyu") -> dict:
    """A seeded "real" batch of ``dataset``'s shape for the Finetune and
    FinetuneStage steps, as tensors on the renderer's device (its camera
    is the dataset's): rendered MANO hands from ``posed_params`` at the
    dataset's cube (or with the MANO parameters ``para`` (B, 62) in their
    place) as normalized depth crops ("img" (B, 1, S, S)), "center",
    "cube", "M" (B, 3, 3), and "xyz_gt" (B, J, 3), J the dataset's joint
    count, the rendered joints in its joint order
    (``transfer_for_dataset``); joints without a MANO counterpart (NYU's
    last two) repeat the wrist (the step reads the mapped ones)."""
    posed, center, cube = posed_params(renderer, B, rng,
                                       float(CUBE[dataset][0]))
    para = posed if para is None else para.to(posed)
    with torch.no_grad():
        img, _, joint_xyz, _ = rnd.render_params(renderer, para, center, cube)
        com = geo.xyz_to_uvd(center[:, None], renderer.paras)[:, 0]
        M = geo.crop_matrix(com, cube, renderer.paras, renderer.crop_size)
    tm = transfer_for_dataset(dataset)
    xyz_gt = joint_xyz[:, tm + [0] * (JOINT[dataset] - len(tm))]
    return {"img": img, "center": center, "cube": cube, "M": M,
            "xyz_gt": xyz_gt}


def engine(mano_path: str, device, input_size: int = 128,
           buckets=(1, 8, 32), seed: int = 0,
           compute_dtype: str = "float32", net: str = "ResNet_stage_18"):
    """The two-stage ManoOCRStage InferenceEngine of ``net`` (ResNet trunks
    of depth 18, 50, 101 or 152) with seeded random weights (a visible
    stage-1 hand, see random_reference_state_dict), computing in
    ``compute_dtype``."""
    from dsf_tpu_torch.serving import InferenceEngine
    cfg = Config(dataset="nyu", stage_num=2, input_size=input_size,
                 mano_model_path=mano_path, compute_dtype=compute_dtype,
                 net=net)
    sd = random_reference_state_dict(np.random.RandomState(seed),
                                     depth=net_depth(cfg))
    return InferenceEngine(cfg, sd, buckets=buckets, device=device)
