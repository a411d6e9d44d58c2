"""dsf_tpu_torch.ops (counterpart of dsf_tpu/ops)."""

from dsf_tpu_torch.ops.rasterize import (  # noqa: F401
    project_verts,
    rasterize_depth,
    crop_pixel_rays,
    full_frame_pixel_rays,
)
