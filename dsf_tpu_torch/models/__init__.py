"""dsf_tpu_torch.models (counterpart of dsf_tpu/models)."""

from dsf_tpu_torch.models.backbone import ManoOCR, ManoOCRStage  # noqa: F401
from dsf_tpu_torch.models.cyclegan import ResnetGenerator  # noqa: F401
