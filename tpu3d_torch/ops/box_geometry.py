"""Box geometry on tensors (counterpart of ``tpu3d/ops/box_geometry.py``),
in the ``(x, y, z, h, w, l, ry)`` bottom-center rect-camera convention."""

from __future__ import annotations

import torch


def rotate_points_along_y(pc: torch.Tensor, angle) -> torch.Tensor:
    """x' = cos·x − sin·z ; z' = sin·x + cos·z on the last-dim (x, *, z, ...)
    layout; ``angle`` broadcasts against ``pc[..., 0]``."""
    c, s = torch.cos(angle), torch.sin(angle)
    x, z = pc[..., 0], pc[..., 2]
    out = pc.clone()
    out[..., 0] = c * x - s * z
    out[..., 2] = s * x + c * z
    return out
