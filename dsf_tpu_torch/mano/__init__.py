"""dsf_tpu_torch.mano (counterpart of dsf_tpu/mano)."""

from dsf_tpu_torch.mano.constants import (  # noqa: F401
    MANO2HANDS,
    MANO2ICVL,
    MANO2MSRA,
    MANO2NYU,
    HANDS2MANO,
    transfer_for_dataset,
)
from dsf_tpu_torch.mano.model import ManoModel, lbs, get_mano_vertices  # noqa: F401
