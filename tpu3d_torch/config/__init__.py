"""tpu3d_torch.config — the port's copy of the detector config tree."""

from .config import (
    AttrDict,
    as_attrdict,
    cfg,
    cfg_from_file,
    cfg_from_list,
    fresh_cfg,
    save_config_to_file,
    train_numerics,
)

__all__ = ["AttrDict", "as_attrdict", "cfg",
           "cfg_from_file", "cfg_from_list", "fresh_cfg",
           "save_config_to_file", "train_numerics"]
