"""Configuration: a copy of dsf_tpu/config.py (the reference Config's
field surface as a frozen dataclass) with the per-dataset ``CAMERA`` table
moved in from dsf_tpu/training/trainer.py, so the port imports nothing of
dsf_tpu.  ``batch_size`` is the global batch, split over the ranks of a
``torchrun`` world; ``n_fsdp`` shards the parameters and the optimizer
state over that many ranks (ZeRO-3, ``parallel.fsdp``; it must divide the
world: ``check_world``); ``num_devices`` is the
serving engine's replicas (``check_devices``).  ``cache_depths`` is read
by the loop (``training/loop.py``: the loader's decode-once depth cache).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

JOINT = {"nyu": 14, "icvl": 16, "msra": 21, "shrec": 21}
STEP = {"nyu": 10, "msra": 5, "icvl": 4, "shrec": 5}
EPOCH = {"nyu": 15, "msra": 10, "icvl": 8, "shrec": 10}
CUBE = {
    "nyu": (250, 250, 250),
    "msra": (200, 200, 200),
    "icvl": (200, 200, 200),
    "shrec": (200, 200, 200),
}

# camera intrinsics (fx, fy, cx, cy) and frame size (W, H) per dataset
# (ref: render_loader.py loader __init__s; all loaders use flip=1)
CAMERA = {
    "nyu": ((588.03, 587.07, 320.0, 240.0), (640, 480)),
    "icvl": ((240.99, 240.96, 160.0, 120.0), (320, 240)),
    "msra": ((241.42, 241.42, 160.0, 120.0), (320, 240)),
    "shrec": ((463.889, 463.889, 320.0, 240.0), (640, 480)),
    "hands": ((475.065948, 475.065857, 315.944855, 245.287079), (640, 480)),
}


@dataclasses.dataclass(frozen=True)
class Config:
    # phase / stage (ref: config.py:32-39)
    phase: str = "train"                  # 'train' | 'test'
    root_dir: str = "./data"
    dataset: str = "nyu"                  # 'nyu' | 'icvl' | 'msra' | 'shrec'
    model_save: str = ""
    add_info: str = "Finetune-Stage"
    train_stage: str = "Finetune"         # 'Pretrain' | 'Finetune'
    stage_num: int = 2
    mask: bool = True

    # exports (ref: config.py:41-43)
    save_mesh: bool = False
    save_result: bool = True
    save_obj: bool = False

    # loss weights (ref: config.py:45-50)
    deconv_weight: float = 1.0
    coord_weight: float = 100.0
    model_weight: float = 1.0
    partICP_weight: float = 1.0
    M2P_weight: float = 1.0
    coll_weight: float = 1.0

    # checkpoints / assets (ref: config.py:53-69)
    finetune_dir: str = ""
    load_model: str = ""
    transferNet_pth: str = ""
    mano_model_path: str = "./MANO/mano_right.npz"

    save_dir: str = "./checkpoint"
    train_img_type: str = "real"
    test_img_type: str = "real"
    test_id: int = 0                      # msra leave-one-out subject

    test_during_train: bool = True
    image_every: int = 200

    batch_size: int = 32
    input_size: int = 128

    center_type: str = "refine"           # 'joint_mean' | 'refine'
    loss_type: str = "L1Loss"
    augment_para: Tuple[float, float, float] = (10, 0.2, 180)

    lr: float = 1e-3
    opt: str = "adamw"
    scheduler: str = "step"

    net: str = "ResNet_stage_18"
    feature_type: Tuple[str, ...] = ("offset",)
    feature_para: Tuple[float, ...] = (0.8,)

    # accelerator knobs (compute_dtype: the net's and the generator's type,
    # float32 or bfloat16, device.compute_dtype; num_devices: the engine's
    # replicas; n_fsdp: the ranks that share one copy of the parameters
    # and the optimizer state, ZeRO-3)
    num_devices: int = 1
    n_fsdp: int = 1
    compute_dtype: str = "float32"        # 'float32' | 'bfloat16'
    cache_depths: bool = True
    seed: int = 0

    @property
    def joint_num(self) -> int:
        return JOINT[self.dataset]

    @property
    def cube_size(self) -> Tuple[int, int, int]:
        return CUBE[self.dataset]

    @property
    def max_epoch(self) -> int:
        return EPOCH[self.dataset]

    @property
    def step_size(self) -> int:
        return STEP[self.dataset]

    def run_name(self) -> str:
        """Auto-composed run directory name (ref: train_render.py:42-62)."""
        if self.model_save:
            return self.model_save
        name = (f"{self.net}_{self.opt}_centerType{self.center_type}"
                f"_coord_weight_{self.coord_weight}"
                f"_deconv_weight_{self.deconv_weight}"
                f"_step_size_{self.step_size}"
                f"_CubeSize_{self.cube_size[0]}_")
        name += "".join(f"{ft}_{fp}" for ft, fp in
                        zip(self.feature_type, self.feature_para))
        if self.finetune_dir:
            name = "finetune_" + name
        return name + self.add_info

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def check_world(cfg: Config, world: int) -> None:
    """Raise ValueError unless ``cfg.n_fsdp`` divides ``world`` ranks and
    ``world`` divides the global ``cfg.batch_size``; it touches no device
    and no file."""
    from dsf_tpu_torch.parallel.mesh import check_layout
    check_layout(world, cfg.n_fsdp, cfg.batch_size)


def check_devices(cfg: Config, available: int) -> None:
    """Raise ValueError when the engine is asked for more replicas
    (``cfg.num_devices``) than the ``available`` devices (given or
    visible); it touches no device and no file."""
    if cfg.num_devices < 1 or cfg.num_devices > available:
        raise ValueError(f"num_devices={cfg.num_devices}: {available} "
                         "device(s) given or visible")


def net_depth(cfg: Config) -> int:
    """The ResNet depth that ``cfg.net`` names (``ResNet_stage_50`` -> 50);
    raises NotImplementedError for another net and ValueError for a depth
    without a trunk (``models.resnet.RESNET_SPECS``: 18, 50, 101, 152),
    touching no device and no file."""
    from dsf_tpu_torch.models.resnet import RESNET_SPECS
    if "ResNet" not in cfg.net:
        raise NotImplementedError(cfg.net)
    depth = int(cfg.net.split("_")[-1])
    if depth not in RESNET_SPECS:
        raise ValueError(f"net {cfg.net!r}: ResNet depths "
                         f"{sorted(RESNET_SPECS)}")
    return depth
