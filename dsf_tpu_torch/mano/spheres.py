"""66-sphere hand approximation: collision loss and point-cloud part
segmentation (counterpart of dsf_tpu/mano/spheres.py; ref:
render_model/mano_layer.py:229-426).

Sphere layout: 21 palm spheres (wrist + 5 palm bones x 4 interpolants)
followed by 45 finger spheres (15 bones x 3 interpolants, bone-major).
The pairwise collision mask is static, built once in numpy with the
reference's exclusions (same-bone, adjacent-bone, finger-root-to-palm,
thumb-root-to-palm) and asymmetries.

The FinetuneStage step runs ``collision_loss`` and ``seg_pcl``; beside
them are the reference's other part labellings of a cloud (``seg_pcl_21``,
``seg_pcl_finger``) and its point-to-part distances (to the part's mesh
vertices, ``point2mesh_part_distance``, or to its sphere surfaces,
``point2sphere_distance*``), alternatives to the face-based ICP losses.
"""

from __future__ import annotations

import numpy as np
import torch

from dsf_tpu_torch import geometry as geo
from dsf_tpu_torch.mano.constants import BONE_CHILD

PALM_N = 21          # 1 + 5 * 4
FINGER_N = 45        # 15 * 3
INTERVAL = 3         # finger spheres per bone
PALM_PER_BONE = 4

# ref interval_value: linspace(0, 1, per_adj_shpere + 2)[:-1] with
# per_adj_shpere=2 -> [0, 1/3, 2/3] (mano_layer.py:231)
_FINGER_T = np.linspace(0, 1, INTERVAL + 1)[:-1]
_PALM_T = np.linspace(0, 1, PALM_PER_BONE + 2)[1:-1]               # [.2 .4 .6 .8]
_PALM_CHILD = [1, 4, 7, 10, 13]


def build_collision_mask() -> np.ndarray:
    """(66, 66) float mask of the sphere pairs that contribute to the
    collision penalty (ref: mano_layer.py:239-269)."""
    plam_mask = np.concatenate(
        [np.zeros((PALM_N, PALM_N)), np.ones((PALM_N, FINGER_N))], axis=1)
    finger_mask = np.ones((FINGER_N, PALM_N + FINGER_N))
    for fi in range(15):
        root = fi // 3 + 1
        if fi in (0, 3, 6, 9, 12):         # proximal bone of each finger
            for fb in range(INTERVAL):
                finger_mask[INTERVAL * fi + fb, root * PALM_PER_BONE] = 0
                plam_mask[root * PALM_PER_BONE, PALM_N + INTERVAL * fi + fb] = 0
                s = PALM_N + INTERVAL * fi
                finger_mask[INTERVAL * fi + fb, s:s + INTERVAL + 3] = 0
        else:
            s = PALM_N + INTERVAL * fi
            mx = PALM_N + 3 * INTERVAL * root
            for fb in range(INTERVAL):
                finger_mask[INTERVAL * fi + fb,
                            s - INTERVAL:min(s + INTERVAL * 2 + 1, mx)] = 0
    thumb_root = 12 * INTERVAL
    finger_mask[thumb_root:thumb_root + INTERVAL + 1, :PALM_N] = 0
    mask = np.concatenate([plam_mask, finger_mask], axis=0)
    mask[:PALM_N, PALM_N + thumb_root:PALM_N + thumb_root + INTERVAL + 1] = 0
    return mask.astype(np.float32)


COLLISION_MASK = build_collision_mask()


def _const(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def sphere_centers(joints):
    """(B, 21, 3) joints -> (B, 66, 3) sphere centres."""
    B = joints.shape[0]
    ft = _const(_FINGER_T, joints).reshape(1, 1, -1, 1)
    pt = _const(_PALM_T, joints).reshape(1, 1, -1, 1)

    palm_child = joints[:, _PALM_CHILD]                 # (B, 5, 3)
    palm_parent = joints[:, 0:1]                        # (B, 1, 3)
    palm_c = (palm_child - palm_parent)[:, :, None, :] * pt \
        + palm_parent[:, :, None, :]
    palm_c = torch.cat([palm_parent, palm_c.reshape(B, -1, 3)], dim=1)

    f_parent = joints[:, 1:16]
    f_c = (joints[:, BONE_CHILD] - f_parent)[:, :, None, :] * ft \
        + f_parent[:, :, None, :]
    return torch.cat([palm_c, f_c.reshape(B, -1, 3)], dim=1)


def _mean_smallest_k(d, k):
    """Mean of the k smallest values along the last axis.  topk with
    largest=False selects the multiset the JAX package's k passes of
    extract-min select (both break value ties toward the lower index), in
    ascending order; the sum is taken in that order, as the passes add."""
    vals = torch.topk(d, k, dim=-1, largest=False, sorted=True).values
    acc = vals[..., 0]
    for i in range(1, k):
        acc = acc + vals[..., i]
    return geo.div(acc, k)


def sphere_radii(model, joints, mesh):
    """(B, 66) sphere radii from per-joint distances to the 10 nearest
    assigned mesh vertices (ref: get_sphere_radius, mano_layer.py:271-317)."""
    B = joints.shape[0]
    diff = joints[:, :, None, :] - mesh[:, None, : model.n_verts, :]
    d = torch.sqrt((diff * diff).sum(-1) + 1e-8)
    assigned = model.vertex_joint_mask.T[None]          # (1, 21, 778)
    d = torch.where(assigned, d, torch.full_like(d, 100.0))
    nearest = _mean_smallest_k(d, 10)
    joint_r = torch.cat([nearest[:, :16],
                         geo.div(nearest[:, [3, 6, 9, 12, 15]], 1.5)],
                        dim=-1)

    palm_child = joint_r[:, _PALM_CHILD]
    palm_parent = torch.clamp(joint_r[:, 0:1] - 0.05, 0.01, 0.4)
    pt = _const(_PALM_T, joints).reshape(1, 1, -1)
    palm_r = (palm_child - palm_parent)[:, :, None] * pt + palm_parent[:, :, None]
    palm_r = torch.cat([palm_parent, palm_r.reshape(B, -1)], dim=1)

    ft = _const(_FINGER_T, joints).reshape(1, 1, -1)
    f_parent = joint_r[:, 1:16]
    f_r = (joint_r[:, BONE_CHILD] - f_parent)[:, :, None] * ft \
        + f_parent[:, :, None]
    return torch.cat([palm_r, f_r.reshape(B, -1)], dim=1)


def collision_loss(model, joints, mesh):
    """(B,) per-sample mean sphere-pair penetration, gated per sphere row
    (ref: calculate_coll, mano_layer.py:373-386; the JAX package's
    ``keep_batch=True``, whose mean is its scalar).  The reference's
    ``error.sum(-1, keepdim=True).sum(-1, keepdim=True)`` sums the last axis
    twice, so its "batch mask" is (B, 66, 1): each sphere whose summed
    penetration is already >= 0.1 is zeroed, not each sample."""
    c = sphere_centers(joints)
    r = sphere_radii(model, joints, mesh)
    diff = c[:, :, None, :] - c[:, None, :, :]
    dis = torch.sqrt((diff * diff).sum(-1) + 1e-8)
    pair_r = r[:, :, None] + r[:, None, :]
    err = torch.clamp_min(pair_r - dis, 0.0) * _const(COLLISION_MASK, dis)
    gate = (err.sum(-1, keepdim=True) < 0.1).to(err.dtype)
    return (err * gate).sum(-1).mean(-1)


def _seg_nearest(model, joints, joints_mano, mesh, pcl):
    """Whether each point of pcl (B, P, 3) lies nearer a palm sphere's
    surface than a finger sphere's, and its first nearest finger sphere
    (0..44): centres from ``joints``, radii from ``joints_mano``."""
    c = sphere_centers(joints)
    r = sphere_radii(model, joints_mano, mesh)
    fc, fr = c[:, PALM_N:], r[:, PALM_N:]
    pc, pr = c[:, :PALM_N], r[:, :PALM_N]

    fd = torch.sqrt(((pcl[:, :, None] - fc[:, None]) ** 2).sum(-1) + 1e-8)
    fd = torch.abs(fd - fr[:, None])
    f_min = fd.min(-1).values

    pd = torch.sqrt(((pcl[:, :, None] - pc[:, None]) ** 2).sum(-1) + 1e-8)
    pd = torch.abs(pd - pr[:, None])
    p_min = pd.min(-1).values
    return p_min < f_min, torch.argmin(fd, -1)


def seg_pcl(model, joints, joints_mano, mesh, pcl):
    """Assign each point of pcl (B, P, 3) to a bone part 0..15 (0 = palm)
    -> (B, P) int64.  Centres come from ``joints`` (the pixel branch),
    radii from ``joints_mano`` (the MANO branch) (ref: seg_pcl,
    mano_layer.py:404-426).  Ties in either argmin go to the first
    sphere, as in the JAX package."""
    palm, arg = _seg_nearest(model, joints, joints_mano, mesh, pcl)
    f_id = arg // INTERVAL + 1
    return torch.where(palm, torch.zeros_like(f_id), f_id)


_SEG21_MAP = np.array(
    [1, 1, 2, 2, 2, 3, 3, 3, 16, 4, 4, 5, 5, 5, 6, 6, 6, 17, 7, 7, 8, 8, 8,
     9, 9, 9, 18, 10, 10, 11, 11, 11, 12, 12, 12, 19, 13, 13, 14, 14, 14, 15,
     15, 15, 20], dtype=np.int32)

_SEGFINGER_MAP = np.repeat(np.arange(1, 6, dtype=np.int32), 9)


def _seg_with_map(model, joints, joints_mano, mesh, pcl, id_map):
    """``seg_pcl`` with the finger sphere -> part map ``id_map`` (45,):
    (B, P) int32, 0 for the palm."""
    palm, arg = _seg_nearest(model, joints, joints_mano, mesh, pcl)
    f_id = torch.as_tensor(id_map, device=pcl.device)[arg]
    return torch.where(palm, torch.zeros_like(f_id), f_id)


def seg_pcl_21(model, joints, joints_mano, mesh, pcl):
    """The 21-part variant: 0 palm, 1..15 finger segments, 16..20 tips
    (ref: seg_pcl_21, mano_layer.py:468-491)."""
    return _seg_with_map(model, joints, joints_mano, mesh, pcl, _SEG21_MAP)


def seg_pcl_finger(model, joints, joints_mano, mesh, pcl):
    """The 5-finger variant: 0 palm, 1..5 fingers (ref: seg_pcl_finger,
    mano_layer.py:523-546)."""
    return _seg_with_map(model, joints, joints_mano, mesh, pcl,
                         _SEGFINGER_MAP)


# ---------------------------------------------------------------------------
# point -> sphere / per-part mesh distance variants
# (ref: mano_layer.py:429-567 — alternatives to the face-based ICP losses)
# ---------------------------------------------------------------------------

def point2mesh_part_distance(model, mesh, pcl, pcl_seg):
    """(B, 15): per part, the mean over all points of the least squared
    distance to the vertices argmax-skinned to that part's joint (ref:
    calculate_point2mesh_distance, mano_layer.py:429-441).

    The reference's semantics are kept: the loop is 0-based (part 0 pairs
    the palm points, seg 0, with the wrist's vertices; parts 1..14 pair
    bone seg k with joint k's vertices; bone 15 is never evaluated, unlike
    the 1-based ``point2sphere_distance``), and the mean runs over every
    point, a point of another part counting 1e5."""
    mesh778 = mesh[:, : model.n_verts]
    d = ((pcl[:, :, None] - mesh778[:, None]) ** 2).sum(-1)     # (B, P, V)
    far = torch.full_like(d, 1e5)
    losses = []
    for part in range(15):
        vert_ok = model.vertex_seg == part
        dmin = torch.where(vert_ok[None, None], d, far).min(-1).values
        dmin = torch.where(pcl_seg == part, dmin, torch.full_like(dmin, 1e5))
        losses.append(dmin.mean(-1))
    return torch.stack(losses, -1)


def _point2sphere_part(model, joint, mesh, pcl, pcl_seg, groups, n_parts):
    """Per part 1..n_parts, the mean |distance to the nearest sphere
    surface of the part's group| over the part's points, where a point at
    distance 0 does not count; a part with none gives 0 (ref:
    calculate_point2shpere_distance*, mano_layer.py:444-567).  groups
    (n_parts, 45) bool: each part's finger spheres."""
    c = sphere_centers(joint)
    r = sphere_radii(model, joint, mesh)
    fc, fr = c[:, PALM_N:], r[:, PALM_N:]
    d = torch.sqrt(((pcl[:, :, None] - fc[:, None]) ** 2).sum(-1) + 1e-8)
    d = torch.abs(d - fr[:, None])                               # (B, P, 45)
    inf = torch.full_like(d, float("inf"))
    groups = torch.as_tensor(groups, device=pcl.device)
    losses = []
    for part in range(n_parts):
        dmin = torch.where(groups[part][None, None], d, inf).min(-1).values
        dsel = torch.where(pcl_seg == part + 1, dmin, torch.zeros_like(dmin))
        valid = (dsel > 0).sum(-1)
        loss = dsel.sum(-1) / (valid + 1e-8)
        losses.append(torch.where(valid == 0, torch.zeros_like(loss), loss))
    return torch.stack(losses, -1)


def _bone_groups():
    g = np.zeros((15, FINGER_N), bool)
    for i in range(15):
        g[i, i * INTERVAL:(i + 1) * INTERVAL] = True
    return g


def _joint21_groups():
    id_list = [[0, 1], [2, 3, 4], [5, 6, 7], [9, 10], [11, 12, 13],
               [14, 15, 16], [18, 19], [20, 21, 22], [23, 24, 25],
               [27, 28], [29, 30, 31], [32, 33, 34], [36, 37],
               [38, 39, 40], [41, 42, 43], [8], [17], [26], [35], [44]]
    g = np.zeros((20, FINGER_N), bool)
    for i, ids in enumerate(id_list):
        g[i, ids] = True
    return g


def _finger_groups():
    g = np.zeros((5, FINGER_N), bool)
    for i in range(5):
        g[i, i * 3 * INTERVAL:(i + 1) * 3 * INTERVAL] = True
    return g


def point2sphere_distance(model, joint, mesh, pcl, pcl_seg):
    """(B, 15) the per-bone variant (ref: calculate_point2shpere_distance)."""
    return _point2sphere_part(model, joint, mesh, pcl, pcl_seg,
                              _bone_groups(), 15)


def point2sphere_distance_21(model, joint, mesh, pcl, pcl_seg):
    """(B, 20) the per-joint variant (ref:
    calculate_point2shpere_distance_21, id groups mano_layer.py:501-506)."""
    return _point2sphere_part(model, joint, mesh, pcl, pcl_seg,
                              _joint21_groups(), 20)


def point2sphere_distance_finger(model, joint, mesh, pcl, pcl_seg):
    """(B, 5) the per-finger variant (ref:
    calculate_point2shpere_distance_finger)."""
    return _point2sphere_part(model, joint, mesh, pcl, pcl_seg,
                              _finger_groups(), 5)
