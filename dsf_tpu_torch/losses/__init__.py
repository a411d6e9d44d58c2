"""dsf_tpu_torch.losses (counterpart of dsf_tpu/losses)."""

from dsf_tpu_torch.losses.basic import smooth_l1, weighted_smooth_l1, masked_depth_loss  # noqa: F401
from dsf_tpu_torch.losses.icp import icp_loss, joint_icp_loss, finger_icp_loss, chamfer_distance  # noqa: F401
