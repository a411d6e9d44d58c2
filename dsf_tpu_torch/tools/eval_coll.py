"""Offline self-intersection volume metric over exported hand meshes
(counterpart of dsf_tpu/tools/eval_coll.py, numpy on the host).

Rebuild of eval_coll.py: split the MANO mesh into 15 watertight bone
parts, voxelize each at a given pitch, and sum the volume of voxels
contained in more than one (non-adjacent) part
(ref: eval_coll.py:348-373 get_part_mesh hole-capping,
:611-626 self_intersection, :641-675 main loop; the reference leans on
trimesh + blender — here containment is a dependency-free even-odd
ray-parity test in NumPy, with the same coarse(2mm)->fine(1mm) refine
schedule).

The meshes are the rows ``training.loop`` writes with ``save_mesh``
(``mesh_result_{2S-1}_{view}.txt``: 779 vertices x 3 in world mm a row).
The MANO tables are read with ``mano.model.load_model(..., device="cpu")``:
nothing here runs on a device.

Usage: python -m dsf_tpu_torch.tools.eval_coll mesh_result_3_0.txt --mano mano.npz
"""

from __future__ import annotations

import argparse

import numpy as np

# bone-part kinematic adjacency to skip (parent/child pairs share
# geometry legitimately; ref: eval_coll.py:611-626 skips them)
_PART_PARENT = {1: None, 2: 1, 3: 2, 4: None, 5: 4, 6: 5, 7: None, 8: 7,
                9: 8, 10: None, 11: 10, 12: 11, 13: None, 14: 13, 15: 14}


def build_part_meshes(verts, faces, joint_face_mask, vertex_seg):
    """Split (779, 3) mesh into 15 per-bone sub-meshes and cap each
    boundary loop with a centroid fan so parity tests see a closed
    surface (ref get_part_mesh adds 14 hole-capping centroid verts)."""
    parts = []
    for part in range(15):
        fsel = faces[np.asarray(joint_face_mask[:, part])]
        vids = np.unique(fsel)
        remap = -np.ones(verts.shape[0], np.int64)
        remap[vids] = np.arange(len(vids))
        pv = verts[vids]
        pf = remap[fsel]
        # boundary edges (appear once)
        edges = np.concatenate([pf[:, [0, 1]], pf[:, [1, 2]], pf[:, [2, 0]]])
        key = np.sort(edges, axis=1)
        _, idx, counts = np.unique(key, axis=0, return_index=True,
                                   return_counts=True)
        boundary = edges[idx[counts == 1]]
        if len(boundary):
            centroid = pv[np.unique(boundary)].mean(0, keepdims=True)
            ci = len(pv)
            pv = np.concatenate([pv, centroid])
            caps = np.stack([boundary[:, 0], boundary[:, 1],
                             np.full(len(boundary), ci)], axis=1)
            pf = np.concatenate([pf, caps])
        parts.append((pv, pf))
    return parts


def voxel_contains(points, verts, faces):
    """Even-odd parity along +z: a point is inside if a ray crosses the
    surface an odd number of times."""
    tri = verts[faces]                              # (T, 3, 3)
    p = points[:, None, :]                          # (P, 1, 3)
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    # 2D (xy) barycentric test
    d = (b[:, 1] - c[:, 1]) * (a[:, 0] - c[:, 0]) + \
        (c[:, 0] - b[:, 0]) * (a[:, 1] - c[:, 1])
    d = np.where(np.abs(d) < 1e-12, 1e-12, d)
    w0 = ((b[:, 1] - c[:, 1]) * (p[..., 0] - c[:, 0]) +
          (c[:, 0] - b[:, 0]) * (p[..., 1] - c[:, 1])) / d
    w1 = ((c[:, 1] - a[:, 1]) * (p[..., 0] - c[:, 0]) +
          (a[:, 0] - c[:, 0]) * (p[..., 1] - c[:, 1])) / d
    w2 = 1.0 - w0 - w1
    inside_xy = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
    z_hit = w0 * a[:, 2] + w1 * b[:, 2] + w2 * c[:, 2]
    crossings = (inside_xy & (z_hit > p[..., 2])).sum(-1)
    return (crossings % 2) == 1


def self_intersection(parts, pitch=2.0):
    """Total intersected volume (mm^3) between non-adjacent parts."""
    boxes = [(pv.min(0), pv.max(0)) for pv, _ in parts]
    total = 0.0
    for i in range(15):
        for j in range(i + 1, 15):
            if _PART_PARENT.get(j + 1) == i + 1 or _PART_PARENT.get(i + 1) == j + 1:
                continue
            lo = np.maximum(boxes[i][0], boxes[j][0])
            hi = np.minimum(boxes[i][1], boxes[j][1])
            if (hi <= lo).any():
                continue
            axes = [np.arange(l + pitch / 2, h, pitch) for l, h in zip(lo, hi)]
            if any(len(a) == 0 for a in axes):
                continue
            grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
            inside = voxel_contains(grid, *parts[i]) & \
                voxel_contains(grid, *parts[j])
            total += inside.sum() * pitch ** 3
    return total


def evaluate_meshes(mesh_file, mano_npz, pitch_coarse=2.0, pitch_fine=1.0,
                    limit=None):
    from dsf_tpu_torch.mano import model as mano_model
    m = mano_model.load_model(mano_npz, device="cpu")
    faces = m.faces.numpy()
    jfm = m.joint_face_mask.numpy()
    vseg = m.vertex_seg.numpy()
    meshes = np.loadtxt(mesh_file).reshape(-1, 779, 3)
    if limit:
        meshes = meshes[:limit]
    vols = []
    for verts in meshes:
        parts = build_part_meshes(verts, faces, jfm, vseg)
        v = self_intersection(parts, pitch_coarse)
        if v > 0:
            v = self_intersection(parts, pitch_fine)
        vols.append(v)
    return np.asarray(vols)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mesh_file")
    ap.add_argument("--mano", required=True)
    ap.add_argument("--out", default="coll_vox.txt")
    ap.add_argument("--limit", type=int, default=None)
    args = ap.parse_args(argv)
    vols = evaluate_meshes(args.mesh_file, args.mano, limit=args.limit)
    np.savetxt(args.out, vols, fmt="%.4f")
    print(f"mean intersection volume: {vols.mean():.3f} mm^3 over {len(vols)}")


if __name__ == "__main__":
    main()
