"""ICP-family losses: data -> model distances on the MANO mesh
(counterpart of dsf_tpu/losses/icp.py; ref: metric/meshLoss.py:347-395).

Where the reference replicates the cloud per part and builds 15 ragged
part meshes (JointICPLoss), one distance pass with a per-point
admissible-face mask gives the same result.  Every loss here runs one
``point_face_distance`` pass, so K3 on the card (K7 or K8 under their
switches): ``icp_loss`` with no part table, ``joint_icp_loss`` with the
15-column joint table, ``finger_icp_loss`` with the 5-column finger
table, and the fused ``icp_and_joint_icp`` the FinetuneStage step runs
with both in one pass.  ``chamfer_distance`` is plain PyTorch, as in the
JAX package.
"""

from __future__ import annotations

import torch

from dsf_tpu_torch.ops.point_mesh import point_face_distance


def icp_loss(mesh, pcl, faces):
    """(B,) mean per-point squared distance from the cloud pcl (B, P, 3) to
    the whole mesh (B, V, 3) (ref: ICPLoss, meshLoss.py:347-353: the
    reference's point_mesh_face_distance returns squared distances)."""
    return point_face_distance(pcl, mesh, faces).mean(-1)


def _part_reduce(d, pcl_seg, n_parts):
    """(B, n_parts): per part 1..n_parts, the mean distance of that part's
    points; a part with no point of positive distance gives 0 (ref
    empty-part guard, meshLoss.py:370-373)."""
    losses = []
    for part in range(1, n_parts + 1):
        dis = torch.where(pcl_seg == part, d, torch.zeros_like(d))
        valid = (dis > 0).sum(-1)
        loss = dis.sum(-1) / (valid + 1e-8)
        losses.append(torch.where(valid == 0, torch.zeros_like(loss), loss))
    return torch.stack(losses, dim=-1)


def _masked_part_loss(mesh, pcl, faces, part_face_mask, pcl_seg, n_parts):
    """(B, n_parts): per part 1..n_parts, the mean distance of that part's
    points to that part's faces (``part_face_mask`` (T, n_parts) column
    part - 1); empty parts give 0.  The mask goes to the argmin factorized,
    a table and each point's part (seg outside 1..n_parts admits no face),
    never as a (P x T) tensor."""
    point_part = torch.where((pcl_seg >= 1) & (pcl_seg <= n_parts),
                             pcl_seg - 1, torch.full_like(pcl_seg, -1))
    d = point_face_distance(pcl, mesh, faces, part_mask=part_face_mask,
                            point_part=point_part)
    return _part_reduce(d, pcl_seg, n_parts)


def joint_icp_loss(mesh, pcl, faces, joint_face_mask, pcl_seg):
    """(B, 15) per-bone-part masked mean squared distance (ref:
    JointICPLoss, meshLoss.py:377-395; part p takes the faces touching
    vertices skinned > 0.1 to joint p)."""
    return _masked_part_loss(mesh, pcl, faces, joint_face_mask, pcl_seg, 15)


def finger_icp_loss(mesh, pcl, faces, finger_face_mask, pcl_seg):
    """(B, 5) the per-finger variant (ref: FingerICPLoss,
    meshLoss.py:356-374), with ``ManoModel.finger_face_mask``."""
    return _masked_part_loss(mesh, pcl, faces, finger_face_mask, pcl_seg, 5)


def chamfer_distance(x, y):
    """(B,) symmetric mean squared chamfer distance between the clouds x
    (B, N, 3) and y (B, M, 3) (parity for render_loss.py:4,50's
    surface_loss)."""
    diff = x[:, :, None] - y[:, None]
    sq = diff * diff
    d = sq[..., 0] + sq[..., 1] + sq[..., 2]                  # (B, N, M)
    return d.min(-1).values.mean(-1) + d.min(-2).values.mean(-1)


def icp_and_joint_icp(mesh, pcl, joint_pcl, faces, joint_face_mask, pcl_seg):
    """ICPLoss and JointICPLoss from one nearest-face pass over the stacked
    [full cloud | joint cloud].

    The part table gains a 16th column that admits every face: the full
    cloud's points take it, the joint cloud's points their bone part
    (seg 1..15 -> 0..14; palm and background points, seg 0, admit none and
    drop out of the part means).  mesh (B, V, 3); pcl, joint_pcl (B, P, 3);
    pcl_seg (B, P).  Returns (d2m (B,), pd2m (B, 15)), squared distances."""
    B = pcl.shape[0]
    T = joint_face_mask.shape[0]
    table = torch.cat([joint_face_mask.bool(),
                       joint_face_mask.new_ones((T, 1), dtype=torch.bool)],
                      dim=1)                                  # (T, 16)
    pp_joint = torch.where((pcl_seg >= 1) & (pcl_seg <= 15), pcl_seg - 1,
                           torch.full_like(pcl_seg, -1))
    pp_full = torch.full_like(pp_joint, 15)
    d = point_face_distance(torch.cat([pcl, joint_pcl]),
                            torch.cat([mesh, mesh]), faces, part_mask=table,
                            point_part=torch.cat([pp_full, pp_joint]))
    return d[:B].mean(-1), _part_reduce(d[B:], pcl_seg, 15)
