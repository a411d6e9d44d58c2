"""Needles for the raster tests, shared by the CPU tests and the card's:
faces 0.001-0.005 px wide laid through a crop's own sample positions, so
that whether a sample is inside rests on the rounding of the edge
functions alone.  No JAX here: the card's tests import it too."""

import numpy as np
import torch


def add_needles(proj, pix, faces, hw, seed, n=24):
    """proj (B, V, 3), pix (B, H*W, 2) row-major over hw = (H, W), faces
    (F, 3) -> (proj (B, V + 3n, 3), faces (F + n, 3)) with n needles an
    image appended: each runs from one sample to another 6-15 samples
    along a row, a column or a diagonal of the layout (through the samples
    between), its third vertex 0.001-0.005 px off the middle of that edge,
    on either side, in front of every other face."""
    rng = np.random.RandomState(seed)
    B = proj.shape[0]
    H, W = hw
    grid = pix.reshape(B, H, W, 2)
    steps = ((0, 1), (1, 0), (1, 1))
    verts = []
    for b in range(B):
        near = float(proj[b, :, 2].min()) - 50.0
        for k in range(n):
            dy, dx = steps[k % 3]
            L = rng.randint(6, 16)
            y = rng.randint(1, H - 1 - L * dy)
            x = rng.randint(1, W - 1 - L * dx)
            e1 = grid[b, y, x].double()
            e2 = grid[b, y + L * dy, x + L * dx].double()
            d = e2 - e1
            normal = torch.stack([-d[1], d[0]]) / torch.linalg.norm(d)
            w = rng.uniform(0.001, 0.005) * (1 if k % 2 else -1)
            apex = (e1 + e2) / 2 + w * normal
            z = near + rng.uniform(0, 20)
            for p in (e1, e2, apex):
                verts.append(torch.cat([p, p.new_tensor([z])]))
    verts = torch.stack(verts).to(proj.dtype).reshape(B, 3 * n, 3)
    new = torch.arange(3 * n, dtype=faces.dtype, device=faces.device)
    return (torch.cat([proj, verts.to(proj.device)], 1),
            torch.cat([faces, proj.shape[1] + new.reshape(n, 3)]))
