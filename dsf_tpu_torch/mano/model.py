"""MANO hand model: linear blend skinning on torch tensors (counterpart of
dsf_tpu/mano/model.py; ref: render_model/mano_layer.py:82-770).

A ``ManoModel`` holds its constants as tensors on one device.  Every
product is float32 (the JAX package runs them at Precision.HIGHEST); on a
GPU the caller keeps TF32 off (``device.exact_float32``), since LBS feeds
millimetre-level outputs.

The part-segmentation tables are the JAX package's five:
``joint_face_mask`` (the joint ICP's admissible faces) and
``vertex_joint_mask`` (the sphere radii's vertices), which the
FinetuneStage losses read, ``vertex_seg`` (each vertex's joint), which
``tools/eval_coll`` reads, and ``finger_seg`` and ``finger_face_mask``
(each vertex's finger, the finger ICP's admissible faces).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dsf_tpu_torch import geometry as geo
from dsf_tpu_torch.device import resolve_device
from dsf_tpu_torch.mano import constants as C


@dataclasses.dataclass(frozen=True)
class ManoModel:
    """MANO constants.  Shapes for the real model: v_template (778, 3),
    shapedirs (10, 2334), J_regressor (778, 21) [16 kinematic + 5
    fingertip rows], hands_comp (45, 45), hands_mean (45,), posedirs
    (135, 2334), weights (778, 16), faces (1554, 3) int64 [wrist-capped],
    joint_face_mask (1554, 15) bool [face t touches a vertex skinned > 0.1
    to joint k + 1], vertex_joint_mask (778, 21) bool [J_regressor > 0],
    vertex_seg (778,) int32 [the joint of each vertex's largest skinning
    weight], finger_seg (778,) int32 [its finger: 0 palm, 1..5],
    finger_face_mask (1554, 5) bool [face t touches a vertex skinned > 0.1
    to a joint of finger k + 1]."""

    v_template: torch.Tensor
    shapedirs: torch.Tensor
    J_regressor: torch.Tensor
    hands_comp: torch.Tensor
    hands_mean: torch.Tensor
    posedirs: torch.Tensor
    weights: torch.Tensor
    faces: torch.Tensor
    joint_face_mask: torch.Tensor
    vertex_joint_mask: torch.Tensor
    vertex_seg: torch.Tensor
    finger_seg: torch.Tensor
    finger_face_mask: torch.Tensor
    parents: tuple
    n_verts: int

    @property
    def device(self) -> torch.device:
        return self.v_template.device


def _face_membership(faces: np.ndarray, vert_sets) -> np.ndarray:
    """(T, K) bool: face t touches any vertex in vert_sets[k] (the
    reference's per-joint face lists as fixed-shape masks)."""
    out = np.zeros((faces.shape[0], len(vert_sets)), dtype=bool)
    for k, vs in enumerate(vert_sets):
        out[:, k] = np.isin(faces, np.asarray(list(vs))).any(axis=1)
    return out


def load_model(npz_path: str, device=None) -> ManoModel:
    """Build a ManoModel from a converted npz, with the reference's
    constructor transforms: reshaped blend-shape bases, the joint
    regressor extended by 5 fingertip vertices, 16 wrist-capping faces,
    the part tables (ref: mano_layer.py:149-185).
    ``device`` defaults to ``cuda`` and raises without it (see
    ``device.resolve_device``)."""
    device = resolve_device(device)
    raw = np.load(npz_path)
    v_template = raw["v_template"].astype(np.float32)          # (778, 3)
    n_verts = v_template.shape[0]

    sd = raw["shapedirs"].astype(np.float32)
    shapedirs = sd.reshape(-1, sd.shape[-1]).T                  # (10, 2334)
    pd = raw["posedirs"].astype(np.float32)
    posedirs = pd.reshape(-1, pd.shape[-1]).T                   # (135, 2334)

    Jreg = raw["J_regressor"].astype(np.float32).T              # (778, 16)
    addition = np.zeros((n_verts, 5), np.float32)
    for col, vid in enumerate(C.FINGERTIP_VERTS):
        addition[vid, col] = 1.0
    J_regressor = np.concatenate([Jreg, addition], axis=1)      # (778, 21)

    parents = tuple(int(p) for p in raw["kintree_table"][0])
    parents = ((-1,) + parents[1:]) if parents[0] != -1 else parents
    faces = np.concatenate([raw["f"].astype(np.int64),
                            C.WRIST_FACES.astype(np.int64)], axis=0)
    weights = raw["weights"].astype(np.float32)                 # (778, 16)
    vertex_joint = [np.nonzero(weights[:, j] > 0.1)[0] for j in range(16)]
    vertex_seg = np.argmax(weights, axis=1).astype(np.int32)
    finger_sets = [np.concatenate([vertex_joint[3 * i + 1],
                                   vertex_joint[3 * i + 2],
                                   vertex_joint[3 * i + 3]]) for i in range(5)]

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    return ManoModel(
        v_template=t(v_template),
        shapedirs=t(shapedirs),
        J_regressor=t(J_regressor),
        hands_comp=t(raw["hands_components"].astype(np.float32)),
        hands_mean=t(raw["hands_mean"].astype(np.float32)),
        posedirs=t(posedirs),
        weights=t(weights),
        faces=t(faces),
        joint_face_mask=t(_face_membership(faces, vertex_joint[1:])),
        vertex_joint_mask=t(J_regressor > 0),
        vertex_seg=t(vertex_seg),
        finger_seg=t(C.JOINT2FINGER[vertex_seg].astype(np.int32)),
        finger_face_mask=t(_face_membership(faces, finger_sets)),
        parents=parents,
        n_verts=n_verts,
    )


def _global_rigid_transform(Rs, Js, parents):
    """Kinematic chain: per-joint rotations (B, 16, 3, 3) + rest joints
    (B, 16, 3) -> posed joints (B, 16, 3) and skinning transforms
    (B, 16, 4, 4) (ref: batch_global_rigid_transformation)."""
    B = Rs.shape[0]

    def make_A(R, t):
        Rh = torch.cat([R, R.new_zeros(B, 1, 3)], dim=1)
        th = torch.cat([t, t.new_ones(B, 1)], dim=1)[..., None]
        return torch.cat([Rh, th], dim=2)

    results = [make_A(Rs[:, 0], Js[:, 0])]
    for i in range(1, len(parents)):
        p = parents[i]
        results.append(torch.matmul(results[p],
                                    make_A(Rs[:, i], Js[:, i] - Js[:, p])))
    G = torch.stack(results, dim=1)                     # (B, 16, 4, 4)

    new_J = G[:, :, :3, 3]
    # A = G - G @ [J; 0]  (remove the rest-pose joint offset)
    Jw0 = torch.cat([Js, Js.new_zeros(B, Js.shape[1], 1)], dim=-1)
    init_bone = torch.einsum("bjmn,bjn->bjm", G, Jw0)
    A = G.clone()
    A[:, :, :, 3] = G[:, :, :, 3] - init_bone
    return new_J, A


def lbs(model: ManoModel, beta, theta, rot, pose_is_pca: bool = True):
    """MANO forward: shape + pose -> (verts (B, 779, 3), joints (B, 21, 3),
    Rs) (ref: MANO_SMPL.forward).  beta (B, 10); theta (B, <=45) PCA
    coefficients (or (B, 45) axis-angles with pose_is_pca=False); rot
    (B, 3) axis-angle or (B, 4) quaternion."""
    B = beta.shape[0]
    n = model.n_verts

    v_shaped = torch.matmul(beta, model.shapedirs).reshape(B, n, 3)
    v_shaped = v_shaped + model.v_template
    J = torch.einsum("bvk,vj->bjk", v_shaped, model.J_regressor[:, :16])

    if rot.shape[-1] == 3:
        global_rot = geo.rodrigues(rot).reshape(B, 1, 3, 3)
    else:
        global_rot = geo.quat_to_mat(rot).reshape(B, 1, 3, 3)

    if pose_is_pca:
        full_pose = (torch.matmul(theta, model.hands_comp[: theta.shape[-1]])
                     + model.hands_mean)
    else:
        full_pose = theta
    Rs = geo.rodrigues(full_pose.reshape(-1, 3)).reshape(B, 15, 3, 3)

    eye = torch.eye(3, dtype=Rs.dtype, device=Rs.device)
    pose_feature = (Rs - eye).reshape(B, 135)
    v_posed = v_shaped + torch.matmul(pose_feature,
                                      model.posedirs).reshape(B, n, 3)

    _, A = _global_rigid_transform(torch.cat([global_rot, Rs], dim=1), J,
                                   model.parents)

    T = torch.einsum("vj,bjmn->bvmn", model.weights, A)
    v_h = torch.cat([v_posed, v_posed.new_ones(B, n, 1)], dim=-1)
    verts = torch.einsum("bvmn,bvn->bvm", T, v_h)[..., :3]
    joints = torch.einsum("bvk,vj->bjk", verts, model.J_regressor)

    # close the wrist: centroid of the wrist ring as vertex 778
    wrist_vert = verts[:, C.WRIST_RING, :].mean(dim=1, keepdim=True)
    verts = torch.cat([verts, wrist_vert], dim=1)
    return verts, joints, Rs


def get_mano_vertices(model: ManoModel, rot, pose, shape, cam,
                      global_scale=None):
    """Camera params: mm conversion + scale + translation (ref:
    get_mano_vertices).  cam: (B, 4) = [scale, tx, ty, tz]."""
    verts, joints, _ = lbs(model, shape, pose, rot)
    scale = cam[:, 0].reshape(-1, 1, 1)
    trans = cam[:, 1:].reshape(cam.shape[0], 1, -1)
    joints = joints * 1000.0
    verts = verts * 1000.0
    if global_scale is not None:
        joints = joints * global_scale
        verts = verts * global_scale
    verts = verts * scale + trans
    joints = joints * scale + trans
    return verts, joints


def split_params(model_para):
    """62-D (or 63-D quat) MANO param vector -> (rot, pose45, shape10,
    cam4) (layout glb | pose | shape | cam)."""
    quat_dim = 4 if model_para.shape[-1] == 63 else 3
    rot = model_para[:, :quat_dim]
    pose = model_para[:, quat_dim:quat_dim + 45]
    shape = model_para[:, quat_dim + 45:quat_dim + 55]
    cam = model_para[:, quat_dim + 55:]
    return rot, pose, shape, cam
