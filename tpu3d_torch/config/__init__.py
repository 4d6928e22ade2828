"""tpu3d_torch.config — the port's copy of the detector config tree."""

from .config import (
    OFFLINE_NOT_PORTED,
    AttrDict,
    as_attrdict,
    cfg,
    cfg_from_file,
    cfg_from_list,
    fresh_cfg,
    save_config_to_file,
)

__all__ = ["OFFLINE_NOT_PORTED", "AttrDict", "as_attrdict", "cfg",
           "cfg_from_file", "cfg_from_list", "fresh_cfg",
           "save_config_to_file"]
