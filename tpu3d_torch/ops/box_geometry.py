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


def points_in_boxes3d(pts: torch.Tensor, boxes3d: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) points × (..., M, 7) boxes -> (..., N, M) bool: the
    analytic rotated-box test, faces included (y points down, a box spans
    [y - h, y])."""
    box = boxes3d[..., None, :, :]  # (..., 1, M, 7)
    p = pts[..., :, None, :]        # (..., N, 1, 3)
    dx = p[..., 0] - box[..., 0]
    dy = p[..., 1] - box[..., 1]
    dz = p[..., 2] - box[..., 2]
    h, w, l, ry = box[..., 3], box[..., 4], box[..., 5], box[..., 6]
    c, s = torch.cos(ry), torch.sin(ry)
    local_x = c * dx - s * dz
    local_z = s * dx + c * dz
    in_x = torch.abs(local_x) <= l / 2.0
    in_z = torch.abs(local_z) <= w / 2.0
    in_y = (dy <= 0) & (dy >= -h)
    return in_x & in_y & in_z


def enlarge_box3d(boxes3d: torch.Tensor, extra_width: float) -> torch.Tensor:
    """Grow every box by ``extra_width`` on each side (its bottom moves down
    by as much)."""
    large = boxes3d.clone()
    large[..., 3:6] += extra_width * 2
    large[..., 1] += extra_width
    return large
