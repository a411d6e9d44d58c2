"""Per-batch MANO parameter fitting by gradient descent ("IK")
(counterpart of dsf_tpu/tools/fit_mano.py; ref: the offline ``opt_depth``
tool, render_loader.py:3594-3653, which made the posePara_lm_collosion
parameter banks).

Both fits run ``torch.optim.Adam`` at PyTorch's defaults, which are
``optax.adam``'s (betas 0.9 / 0.999, eps 1e-8).  Neither reads a loss on
the host before its last step: the losses stay on the device and become
floats at the end, as the JAX package's return values are.

``fit_params`` goes through the crop render: each step renders the
parameters with K1 (the skip raster; K10 with ``USE_PALLAS_SKIP`` off)
and its backward takes the raster's gradient through K2, the per-face
moments.  ``fit_params_world`` is LBS and a point-to-vertex term, with
no kernel.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dsf_tpu_torch.device import exact_float32, resolve_device
from dsf_tpu_torch.losses.basic import masked_depth_loss, smooth_l1
from dsf_tpu_torch.mano import model as mano_model
from dsf_tpu_torch.mano import spheres as sph
from dsf_tpu_torch.render import renderer as rnd


def _on(x, dev) -> torch.Tensor:
    """x (a numpy array or a tensor) as float32 on dev."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32))
    return x.to(dev, torch.float32)


def _check_device(model_dev, dev, what) -> None:
    if model_dev != dev:
        raise ValueError(f"{what} lives on {model_dev}, the fit runs on "
                         f"{dev}: build it there")


def fit_params_world(mano: mano_model.ManoModel, pcl_xyz, joints_xyz,
                     quat, theta, cam, beta=None, steps: int = 1000,
                     lr: float = 0.01, device=None):
    """The reference ``opt_depth`` objective (render_loader.py:3594-3653):
    Adam over (quat, theta, beta, cam) minimizing torch-default
    SmoothL1(joints, labels) + mean(beta^2) + mean(theta^2) + mean(min
    over verts of the squared point-to-vertex distance), in world mm.
    beta starts at zeros, as the reference's (:3614).

    pcl_xyz (B, P, 3) mm; joints_xyz (B, 21, 3) mm; ``mano`` on ``device``
    (``cuda`` when None).  Returns (params dict of tensors, the loss of
    each step as a list of floats)."""
    dev = resolve_device(device)
    _check_device(mano.device, dev, "the MANO model")
    B = quat.shape[0]
    params = {"quat": _on(quat, dev), "theta": _on(theta, dev),
              "beta": (torch.zeros((B, 10), device=dev) if beta is None
                       else _on(beta, dev)),
              "cam": _on(cam, dev)}
    for p in params.values():
        p.requires_grad_(True)
    pcl_xyz, joints_xyz = _on(pcl_xyz, dev), _on(joints_xyz, dev)
    opt = torch.optim.Adam(list(params.values()), lr=lr)
    losses = []
    with exact_float32():
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            verts, joints = mano_model.get_mano_vertices(
                mano, params["quat"], params["theta"], params["beta"],
                params["cam"])
            z = joints - joints_xyz
            az = torch.abs(z)
            sl1 = torch.where(az < 1.0, 0.5 * z * z, az - 0.5).mean()
            d2 = ((pcl_xyz[:, :, None] - verts[:, None]) ** 2).sum(-1)
            loss = (sl1 + (params["beta"] ** 2).mean()
                    + (params["theta"] ** 2).mean() + d2.amin(-1).mean())
            loss.backward()
            opt.step()
            losses.append(loss.detach())
    history = torch.stack(losses).tolist() if losses else []
    return {k: p.detach() for k, p in params.items()}, history


def fit_loss(r: rnd.Renderer, p, target_img, center, cube,
             target_joints_xyz=None, joint_w: float = 100.0,
             depth_w: float = 1.0, beta_w: float = 10.0,
             coll_w: float = 1.0):
    """``fit_params``' objective at the parameters p (B, 62): the m2d term
    of p's crop render against target_img, the beta prior, the collision
    term on the detached mesh and, with labels, the SmoothL1 joint term.
    Returns (loss, aux dict of the terms), tensors on p's device."""
    img, _, jxyz, mesh = rnd.render_params(r, p, center, cube)
    m2d = masked_depth_loss(img, target_img).mean()
    beta_loss = torch.mean(p[:, 48:58] ** 2)
    coll = sph.collision_loss(r.mano, jxyz, mesh.detach()).mean()
    loss = depth_w * m2d + beta_w * beta_loss + coll_w * coll
    aux = {"m2d": m2d, "beta": beta_loss, "coll": coll}
    if target_joints_xyz is not None:
        jl = smooth_l1(jxyz, target_joints_xyz) * joint_w
        loss = loss + jl
        aux["joint"] = jl
    return loss, aux


def fit_params(r: rnd.Renderer, target_img, center, cube,
               target_joints_xyz=None, init_params=None, steps: int = 200,
               lr: float = 0.01, joint_w: float = 100.0,
               depth_w: float = 1.0, beta_w: float = 10.0,
               coll_w: float = 1.0, device=None):
    """Fit (B, 62) MANO parameters to normalized depth crops with Adam.

    target_img (B, 1, S, S) normalized depth at the renderer's crop size;
    center, cube (B, 3) mm; target_joints_xyz optional (B, 21, 3)
    normalized-xyz labels; init_params (B, 62), default zeros with the
    scale (index 58) at 1.  The renderer lives on ``device`` (``cuda``
    when None).  Returns (params (B, 62), the last step's terms as floats:
    ``fit_loss``'s aux and "loss", at the parameters before the last
    update, as the JAX package's)."""
    dev = resolve_device(device)
    _check_device(r.mano.device, dev, "the renderer")
    target_img, center, cube = (_on(x, dev) for x in (target_img, center,
                                                      cube))
    if target_joints_xyz is not None:
        target_joints_xyz = _on(target_joints_xyz, dev)
    B = target_img.shape[0]
    if init_params is None:
        p = torch.zeros((B, 62), device=dev)
        p[:, 58] = 1.0                       # scale
    else:
        p = _on(init_params, dev).clone()
    p.requires_grad_(True)
    opt = torch.optim.Adam([p], lr=lr)
    terms: Dict[str, torch.Tensor] = {}
    with exact_float32():
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            loss, aux = fit_loss(r, p, target_img, center, cube,
                                 target_joints_xyz, joint_w, depth_w, beta_w,
                                 coll_w)
            loss.backward()
            opt.step()
            terms = {k: v.detach() for k, v in dict(aux, loss=loss).items()}
    return p.detach(), {k: float(v) for k, v in terms.items()}

