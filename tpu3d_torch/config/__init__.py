"""tpu3d_torch.config — the port's copy of the detector config tree."""

from .config import (
    AttrDict,
    as_attrdict,
    cfg,
    cfg_from_file,
    fresh_cfg,
)

__all__ = ["AttrDict", "as_attrdict", "cfg", "cfg_from_file",
           "fresh_cfg"]
