"""Crop-frame renderer (counterpart of dsf_tpu/render/renderer.py; ref:
render_model/mano_layer.py Render).

Depth is rasterized directly at crop pixels through M^-1 rays (see
ops/rasterize.py); labels (joint_trans) use the same projection and
matrix, so image/label alignment is exact by construction.  The serving
path needs ``render_params`` (the stage-2 re-render inside the net) and
``get_mesh_xyz``; the Pretrain step adds the synth-sample factory
``synth_sample`` and its sphere occlusion ``mask_img``.  The reference's
other renders (``normal_render``, ``m_render`` through a given crop
matrix, ``mesh_to_img``, ``get_depth`` with a view rotation) go through
the same crop raster; the image augmentations ``synth2real`` and
``patch_gaussian`` and ``mass_center`` are plain PyTorch, as the JAX
package computes them outside any Pallas kernel.

Random draws come in as tensors (``MaskDraws``, the depth placement, the
noise of ``synth2real`` and ``patch_gaussian``): ``draw_*`` makes each
from an explicit ``torch.Generator`` with the JAX package's
distributions, and tests hand in the values ``jax.random`` drew.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from dsf_tpu_torch import geometry as geo
from dsf_tpu_torch.mano import model as mano
from dsf_tpu_torch.ops import rasterize as ras

DEPTH_RANGE = {  # ref: mano_layer.py:978-981
    "nyu": (500.0, 1200.0),
    "msra": (150.0, 600.0),
    "icvl": (150.0, 600.0),
    "shrec": (500.0, 1200.0),
    "hands": (500.0, 1200.0),
}


@dataclasses.dataclass(frozen=True)
class Renderer:
    mano: mano.ManoModel
    paras: tuple              # (fx, fy, cx, cy)
    img_size: tuple           # (W, H) full frame
    crop_size: tuple = (128, 128)
    depth_range: tuple = (500.0, 1200.0)
    flip: float = 1.0

    @staticmethod
    def create(mano_model, dataset, paras, img_size, crop_size=(128, 128)):
        return Renderer(
            mano=mano_model, paras=tuple(paras), img_size=tuple(img_size),
            crop_size=tuple(crop_size),
            depth_range=DEPTH_RANGE.get(dataset, (500.0, 1200.0)))


def _raster_crop(r: Renderer, verts, M, stride=1):
    """Rasterize world-mm verts into the (crop/stride)^2 frame through M
    -> (B, 1, crop_h/stride, crop_w/stride) depth mm (0 = background).
    stride > 1 rasters the nearest-downsample pixel subset directly.  The
    pixel layout goes in as ``tile_hw``, as the JAX renderer passes it:
    the skip raster (K1) by default, the binned raster (K10) with
    ``rasterize.USE_PALLAS_SKIP`` off."""
    H, W = r.crop_size[1] // stride, r.crop_size[0] // stride
    rays = ras.crop_pixel_rays(M, r.crop_size, stride)
    z = ras.rasterize_depth(verts, r.mano.faces, rays, r.paras, r.flip,
                            tile_hw=(H, W))
    return z.reshape(verts.shape[0], 1, H, W)


def _normalize(r: Renderer, depth_img, com_uvd, cube):
    return geo.normalize_depth(depth_img[:, 0], com_uvd[:, 2],
                               cube[:, 2])[:, None]


def synth_sample(r: Renderer, model_para, cube, depth_z, augment_view,
                 augment_shape, augment_center, augment_size,
                 mask: Optional[MaskDraws]):
    """Synthetic training-sample factory (ref: Render.forward).

    model_para (B, 62) [rot3 | pose45 | shape10 | cam4]; the hand is
    centred on its joint mean and placed at (0, 0, depth_z), with
    ``depth_z`` (B, 1) drawn in the renderer's depth range.  The draws:
    ``augment_view`` (B, 3) rotation about that point, ``augment_shape``
    (B, 10) added to the MANO shape, ``augment_center`` (B, 3) mm added to
    the crop centre, ``augment_size`` (B, 1) scaling the cube, each None
    to leave that step out (the JAX factory's None); ``mask`` the
    sphere-occlusion draws, or None for no occlusion.  Returns (img,
    joint_uvd, verts_uvd, joint_xyz, verts_xyz, center3d, cube, M)."""
    rot, theta, beta, cam = mano.split_params(model_para)
    if augment_shape is not None:
        beta = beta + augment_shape

    verts, joints = mano.get_mano_vertices(r.mano, rot, theta, beta, cam)
    synth_center = joints.mean(dim=1, keepdim=True)
    verts = verts - synth_center
    joints = joints - synth_center

    center3d = torch.cat([torch.zeros_like(depth_z).expand(-1, 2), depth_z],
                         dim=-1)
    verts = verts + center3d[:, None]
    joints = joints + center3d[:, None]

    if augment_view is not None:
        verts = geo.rotate_points_about(verts, center3d, augment_view)
        joints = geo.rotate_points_about(joints, center3d, augment_view)
    if augment_center is not None:
        center3d = center3d + augment_center
    if augment_size is not None:
        cube = cube * augment_size

    com_uvd = geo.xyz_to_uvd(center3d[:, None], r.paras, r.flip)[:, 0]
    M = geo.crop_matrix(com_uvd, cube, r.paras, r.crop_size)

    depth = _raster_crop(r, verts, M)
    img = _normalize(r, depth, com_uvd, cube)

    joint_uvd = geo.joint_trans(joints, M, com_uvd, cube, r.paras,
                                r.crop_size[0], r.flip)
    verts_uvd = geo.joint_trans(verts, M, com_uvd, cube, r.paras,
                                r.crop_size[0], r.flip)
    joint_xyz = (joints - center3d[:, None]) / cube[:, None] * 2.0
    verts_xyz = (verts - center3d[:, None]) / cube[:, None] * 2.0

    if mask is not None:
        img = mask_img(img, joint_uvd, mask)
    return img, joint_uvd, verts_uvd, joint_xyz, verts_xyz, center3d, cube, M


def render_params(r: Renderer, model_para, center3d, cube, img_stride=1):
    """Crop-frame re-render of predicted MANO params (ref: Render.render;
    cam in normalized units via the 1/125 global pre-scale).

    Returns (img, joint_uvd, joint_xyz, mesh_xyz): xyz in normalized cube
    units, img normalized depth at crop/img_stride resolution."""
    rot, theta, beta, cam = mano.split_params(model_para)
    verts, joints = mano.get_mano_vertices(r.mano, rot, theta, beta, cam,
                                           global_scale=1.0 / 125.0)
    verts = verts * cube[:, None] / 2.0 + center3d[:, None]
    joints = joints * cube[:, None] / 2.0 + center3d[:, None]

    com_uvd = geo.xyz_to_uvd(center3d[:, None], r.paras, r.flip)[:, 0]
    M = geo.crop_matrix(com_uvd, cube, r.paras, r.crop_size)
    depth = _raster_crop(r, verts, M, img_stride)
    img = _normalize(r, depth, com_uvd, cube)

    joint_uvd = geo.joint_trans(joints, M, com_uvd, cube, r.paras,
                                r.crop_size[0], r.flip)
    joint_xyz = (joints - center3d[:, None]) / cube[:, None] * 2.0
    mesh_xyz = (verts - center3d[:, None]) / cube[:, None] * 2.0
    return img, joint_uvd, joint_xyz, mesh_xyz


def normal_render(r: Renderer, model_para, center3d, cube):
    """The variant that places the normalized mesh at (v + 1) / 2 * cube +
    center (ref: Render.normal_render, mano_layer.py:1042-1068).  Returns
    (img, joint_uvd, joint_xyz, verts_xyz)."""
    rot, theta, beta, cam = mano.split_params(model_para)
    verts, joints = mano.get_mano_vertices(r.mano, rot, theta, beta, cam,
                                           global_scale=1.0 / 125.0)
    verts = (verts + 1.0) / 2.0 * cube[:, None] + center3d[:, None]
    joints = (joints + 1.0) / 2.0 * cube[:, None] + center3d[:, None]
    com_uvd = geo.xyz_to_uvd(center3d[:, None], r.paras, r.flip)[:, 0]
    M = geo.crop_matrix(com_uvd, cube, r.paras, r.crop_size)
    depth = _raster_crop(r, verts, M)
    img = _normalize(r, depth, com_uvd, cube)
    joint_uvd = geo.joint_trans(joints, M, com_uvd, cube, r.paras,
                                r.crop_size[0], r.flip)
    joint_xyz = (joints - center3d[:, None]) / cube[:, None] * 2.0
    verts_xyz = (verts - center3d[:, None]) / cube[:, None] * 2.0
    return img, joint_uvd, joint_xyz, verts_xyz


def m_render(r: Renderer, model_para, center3d, cube, M,
             mask: Optional[MaskDraws]):
    """Render raw-unit (mm) params through the given crop matrix M (ref:
    Render.M_render, mano_layer.py:1100-1131), occluded by ``mask``'s
    draws, or not when it is None.  Returns the image only."""
    rot, theta, beta, cam = mano.split_params(model_para)
    verts, joints = mano.get_mano_vertices(r.mano, rot, theta, beta, cam)
    com_uvd = geo.xyz_to_uvd(center3d[:, None], r.paras, r.flip)[:, 0]
    depth = _raster_crop(r, verts, M)
    img = _normalize(r, depth, com_uvd, cube)
    if mask is not None:
        joint_uvd = geo.joint_trans(joints, M, com_uvd, cube, r.paras,
                                    r.crop_size[0], r.flip)
        img = mask_img(img, joint_uvd, mask)
    return img


def mesh_to_img(r: Renderer, hand_mesh, center3d, cube):
    """World-mm mesh (B, V, 3) -> normalized crop depth (B, 1, H, W) (ref:
    Render.mesh2img, mano_layer.py:1190-1202)."""
    com_uvd = geo.xyz_to_uvd(center3d[:, None], r.paras, r.flip)[:, 0]
    M = geo.crop_matrix(com_uvd, cube, r.paras, r.crop_size)
    depth = _raster_crop(r, hand_mesh, M)
    return _normalize(r, depth, com_uvd, cube)


def get_depth(r: Renderer, verts, joints, center3d, cube, M, rot=None):
    """Render world verts through the given M, turned first by the
    axis-angle ``rot`` (B, 3) about center3d when given (ref:
    Render.getDepth, mano_layer.py:1204-1218).  Returns (img, joint_uvd)."""
    com_uvd = geo.xyz_to_uvd(center3d[:, None], r.paras, r.flip)[:, 0]
    if rot is not None:
        verts = geo.rotate_points_about(verts, center3d, rot)
        joints = geo.rotate_points_about(joints, center3d, rot)
    depth = _raster_crop(r, verts, M)
    img = _normalize(r, depth, com_uvd, cube)
    joint_uvd = geo.joint_trans(joints, M, com_uvd, cube, r.paras,
                                r.crop_size[0], r.flip)
    return img, joint_uvd


def get_mesh_xyz(r: Renderer, model_para):
    """Params -> (joints, mesh) in normalized units (ref: get_mesh_xyz)."""
    rot, theta, beta, cam = mano.split_params(model_para)
    verts, joints = mano.get_mano_vertices(r.mano, rot, theta, beta, cam,
                                           global_scale=1.0 / 125.0)
    return joints, verts


# ---------------------------------------------------------------------------
# image-space augmentations
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MaskDraws:
    """The random draws of one ``mask_img`` call, shared across the batch
    where the reference's numpy choice is.

    n_active: spheres in use (the first ``n_active`` of K); joint_ids (K,)
    distinct joint indices (the head of a permutation); offs (B, K, 3) the
    jitter of each sphere centre in normalized uvd; radius (B, K) the radii
    before the unused spheres are disabled."""
    n_active: int
    joint_ids: torch.Tensor
    offs: torch.Tensor
    radius: torch.Tensor

    def to(self, device) -> "MaskDraws":
        return MaskDraws(self.n_active, self.joint_ids.to(device),
                         self.offs.to(device), self.radius.to(device))


def draw_mask(gen: torch.Generator, batch: int, joint_num: int,
              mask_offset=0.15, mask_para=0.3, min_mask_num=3,
              max_mask_num=10) -> MaskDraws:
    """Draws for ``mask_img`` on the CPU from ``gen``, with the JAX
    package's distributions (ref: Render.mask_img): n_active uniform in
    [min_mask_num, max_mask_num), a random permutation's first
    max_mask_num joints, jitter uniform in +-mask_offset, radii uniform in
    [0, mask_para)."""
    n_active = int(torch.randint(min_mask_num, max_mask_num, (),
                                 generator=gen))
    joint_ids = torch.randperm(joint_num, generator=gen)[:max_mask_num]
    K = joint_ids.shape[0]
    offs = (torch.rand(batch, K, 3, generator=gen) - 0.5) * mask_offset * 2
    radius = torch.rand(batch, K, generator=gen) * mask_para
    return MaskDraws(n_active, joint_ids, offs, radius)


def mask_img(img, img_joint, draws: MaskDraws):
    """Random sphere occlusion around joints (ref: Render.mask_img): white
    out (set to 1) the pixels within ``radius`` of a jittered joint in
    normalized (u, v, d) space.  Fixed-shape as in the JAX package: all K
    spheres are evaluated, the unused ones with radius -1."""
    B, _, H, W = img.shape
    K = draws.joint_ids.shape[0]
    active = torch.arange(K, device=img.device) < draws.n_active
    mask_uvd = img_joint[:, draws.joint_ids, :] + draws.offs        # (B, K, 3)
    radius = torch.where(active[None], draws.radius,
                         torch.full_like(draws.radius, -1.0))

    uu, vv = geo.norm_grid_center(W, img.dtype, img.device)
    pix = torch.stack([uu, vv], -1).reshape(1, 1, H * W, 2)
    pix_d = img.reshape(B, 1, H * W, 1)
    pix_uvd = torch.cat([pix.expand(B, 1, H * W, 2), pix_d], dim=-1)
    diff = pix_uvd - mask_uvd[:, :, None, :]                          # (B,K,HW,3)
    sq = diff * diff
    dist = torch.sqrt(sq[..., 0] + sq[..., 1] + sq[..., 2])
    hit = (dist < radius[:, :, None]).any(dim=1)
    return torch.where(hit.reshape(B, 1, H, W), torch.ones_like(img), img)


def _gaussian_kernel(size=5, sigma=1.7, dtype=torch.float32, device=None):
    x = torch.arange(size, dtype=dtype, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x / sigma) ** 2 / 2.0)
    k = g[:, None] * g[None, :]
    return k / k.sum()


def draw_synth2real(gen: torch.Generator, shape, noise_patch=2):
    """``synth2real``'s draw on the CPU from ``gen``: standard normal
    noise (B, C, H // noise_patch, W // noise_patch) for an image of
    ``shape`` (B, C, H, W)."""
    B, C, H, W = shape
    return torch.randn(B, C, H // noise_patch, W // noise_patch,
                       generator=gen)


def synth2real(normal, img, noise=0.1, noise_patch=2, sigma=1.7,
               bk_value=0.95):
    """Synth depth -> pseudo-real (ref: Render.synth2real,
    mano_layer.py:1222-1231): the standard normal draw ``normal`` (B, C,
    H / noise_patch, W / noise_patch) times ``noise``, held over
    noise_patch^2 pixels, added to the foreground (img < bk_value), then a
    5x5 Gaussian of ``sigma`` (0: none) over the image padded by
    reflection.  One channel, as the JAX package's convolution takes."""
    n = normal * noise
    n = n.repeat_interleave(noise_patch, -1).repeat_interleave(noise_patch,
                                                               -2)
    img = img + n * (img < bk_value).to(img.dtype)
    if sigma != 0:
        x = F.pad(img, (2, 2, 2, 2), mode="reflect")
        k = _gaussian_kernel(5, sigma, img.dtype, img.device)[None, None]
        img = F.conv2d(x, k)
    return img


def draw_patch_gaussian(gen: torch.Generator, shape, patch_scale=0.125):
    """``patch_gaussian``'s draw on the CPU from ``gen``: uniform in [0, 1),
    (B, C, ps, ps) with ps = int(H * patch_scale), for an image of
    ``shape`` (B, C, H, W)."""
    B, C, H, W = shape
    ps = int(H * patch_scale)
    return torch.rand(B, C, ps, ps, generator=gen)


def patch_gaussian(uniform, img, patch_scale=0.125):
    """Patchy uniform noise on the foreground (ref: PatchGaussian,
    mano_layer.py:1349-1355): (uniform - 0.5) * 0.1, each draw held over
    a 1 / patch_scale square of pixels."""
    n = (uniform - 0.5) * 0.1
    up = int(1 / patch_scale)
    n = n.repeat_interleave(up, -1).repeat_interleave(up, -2)
    return img + (img < 0.99).to(img.dtype) * n


def mass_center(img):
    """(B, 3) centre of mass (u, v, d) of the foreground (> 0) pixels of img
    (B, 1, H, W) (ref: Render.massCenter, mano_layer.py:1275-1286); NaN for
    an image with none."""
    B, C, H, W = img.shape
    xv, yv = torch.meshgrid(
        torch.arange(H, dtype=img.dtype, device=img.device),
        torch.arange(W, dtype=img.dtype, device=img.device), indexing="ij")
    stacked = torch.cat([yv.expand(B, 1, H, W), xv.expand(B, 1, H, W), img],
                        dim=1)
    fg = (img > 0).to(img.dtype)
    return (stacked * fg).mean((-1, -2)) / fg.mean((-1, -2))
