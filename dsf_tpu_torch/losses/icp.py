"""ICP-family losses: data -> model distances on the MANO mesh
(counterpart of dsf_tpu/losses/icp.py; ref: metric/meshLoss.py:347-395).

Where the reference replicates the cloud per part and builds 15 ragged
part meshes (JointICPLoss), one distance pass with a per-point
admissible-face mask gives the same result.  Ported: the fused
``icp_and_joint_icp`` the FinetuneStage step runs.
"""

from __future__ import annotations

import torch

from dsf_tpu_torch.ops.point_mesh import point_face_distance


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
