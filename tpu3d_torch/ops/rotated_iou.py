"""Rotated-box BEV overlap and IoU (counterpart of
``tpu3d/ops/rotated_iou.py``, which is XLA there and plain PyTorch here).

The intersection area of two convex quads is the shoelace integral over
each quad's edges clipped (Liang-Barsky) to the other quad: a fixed number
of elementwise ops per pair, no sort and no scatter. Each pair is shifted
to its own local frame first, and the two passes clip against a slightly
enlarged and a slightly shrunk quad (±1e-4), so coincident edges are
counted once.

Criterion: -2 raw intersection area, -1 IoU, 0 inter/area(A), 1
inter/area(B).
"""

from __future__ import annotations

import torch


def _box_to_bev_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) [xc, zc, l, w, ry] -> (..., 4, 2) corners, clockwise (the
    bottom-face order of the box corner template)."""
    xc, zc, l, w, ry = boxes.unbind(-1)
    sx = boxes.new_tensor([1, 1, -1, -1]) * (l[..., None] / 2)
    sz = boxes.new_tensor([1, -1, -1, 1]) * (w[..., None] / 2)
    c, s = torch.cos(ry)[..., None], torch.sin(ry)[..., None]
    x = c * sx + s * sz + xc[..., None]
    z = -s * sx + c * sz + zc[..., None]
    return torch.stack([x, z], dim=-1)


def boxes3d_to_bev5(boxes3d: torch.Tensor) -> torch.Tensor:
    """(..., 7) [x, y, z, h, w, l, ry] -> (..., 5) [xc, zc, l, w, ry]."""
    return boxes3d[..., [0, 2, 5, 4, 6]]


def _cross2(o, a, b):
    """cross(a - o, b - o) of (..., 2) points."""
    return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
            - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0]))


def _clipped_edge_integral(cx, cy, eps: float):
    """Shoelace integral of cx's edges clipped to the inside of quad cy
    (inside = cross <= -eps), both (..., 4, 2) clockwise -> (...,)."""
    p = cx
    q = torch.roll(cx, -1, dims=-2)
    e1 = cy[..., None, :, :]
    e2 = torch.roll(cy, -1, dims=-2)[..., None, :, :]
    pv = p[..., :, None, :]
    qv = q[..., :, None, :]
    f_p = _cross2(e1, e2, pv) + eps  # (..., 4 edges, 4 constraints)
    f_q = _cross2(e1, e2, qv) + eps
    slope = f_q - f_p
    degenerate = torch.abs(slope) < 1e-12
    tstar = -f_p / torch.where(degenerate, 1e-12, slope)
    inside0 = f_p <= 0
    t_lo = torch.where(degenerate, torch.where(inside0, 0.0, 1e30),
                       torch.where(slope < 0, tstar, 0.0))
    t_hi = torch.where(degenerate, torch.where(inside0, 1.0, -1e30),
                       torch.where(slope > 0, tstar, 1.0))
    t0 = torch.clamp(t_lo.amax(dim=-1), 0.0, 1.0)
    t1 = torch.clamp(t_hi.amin(dim=-1), 0.0, 1.0)
    d = q - p
    p0 = p + t0[..., None] * d
    p1 = p + t1[..., None] * d
    contrib = p0[..., 0] * p1[..., 1] - p0[..., 1] * p1[..., 0]
    return torch.where(t1 > t0, contrib, 0.0).sum(dim=-1)


def _pair_intersection_area(corners_a, corners_b):
    """Intersection area of convex quads, (..., 4, 2) each -> (...,)."""
    mid = 0.5 * (corners_a.mean(dim=-2, keepdim=True)
                 + corners_b.mean(dim=-2, keepdim=True))
    ca = corners_a - mid
    cb = corners_b - mid
    margin = 1e-4  # above centred-frame f32 noise, below any box dimension
    ia = _clipped_edge_integral(ca, cb, eps=-margin)
    ib = _clipped_edge_integral(cb, ca, eps=margin)
    return 0.5 * torch.abs(ia + ib)


def rotated_overlap_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
                        criterion: int = -2) -> torch.Tensor:
    """(N, 5) × (M, 5) [xc, zc, l, w, ry] -> (N, M) overlap by
    ``criterion`` (module docstring)."""
    if criterion not in (-2, -1, 0, 1):
        raise ValueError(f"bad criterion {criterion}")
    ca = _box_to_bev_corners(boxes_a)
    cb = _box_to_bev_corners(boxes_b)
    n, m = ca.shape[0], cb.shape[0]
    inter = _pair_intersection_area(ca[:, None].expand(n, m, 4, 2),
                                    cb[None, :].expand(n, m, 4, 2))
    if criterion == -2:
        return inter
    area_a = (boxes_a[:, 2] * boxes_a[:, 3])[:, None]
    area_b = (boxes_b[:, 2] * boxes_b[:, 3])[None, :]
    if criterion == -1:
        return inter / torch.clamp(area_a + area_b - inter, min=1e-8)
    if criterion == 0:
        return inter / torch.clamp(area_a, min=1e-8)
    return inter / torch.clamp(area_b, min=1e-8)


def boxes_iou_bev(boxes_a3d: torch.Tensor,
                  boxes_b3d: torch.Tensor) -> torch.Tensor:
    """(N, 7) × (M, 7) -> (N, M) rotated BEV IoU."""
    return rotated_overlap_bev(boxes3d_to_bev5(boxes_a3d),
                               boxes3d_to_bev5(boxes_b3d), criterion=-1)


def boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 7) × (M, 7) -> (N, M) 3D IoU: BEV intersection times the overlap
    of the y extents (y points down; a box spans [y - h, y])."""
    inter_bev = rotated_overlap_bev(boxes3d_to_bev5(boxes_a),
                                    boxes3d_to_bev5(boxes_b), criterion=-2)
    ymax = torch.minimum(boxes_a[:, None, 1], boxes_b[None, :, 1])
    ymin = torch.maximum(boxes_a[:, None, 1] - boxes_a[:, None, 3],
                         boxes_b[None, :, 1] - boxes_b[None, :, 3])
    inter3d = inter_bev * torch.clamp(ymax - ymin, min=0.0)
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return inter3d / torch.clamp(vol_a + vol_b - inter3d, min=1e-8)


def boxes_iou3d_aligned(boxes_a: torch.Tensor,
                        boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., 7) × (..., 7) -> (...) 3D IoU of each box with its partner,
    the same arithmetic per pair as ``boxes_iou3d``."""
    inter_bev = _pair_intersection_area(
        _box_to_bev_corners(boxes3d_to_bev5(boxes_a)),
        _box_to_bev_corners(boxes3d_to_bev5(boxes_b)))
    ymax = torch.minimum(boxes_a[..., 1], boxes_b[..., 1])
    ymin = torch.maximum(boxes_a[..., 1] - boxes_a[..., 3],
                         boxes_b[..., 1] - boxes_b[..., 3])
    inter3d = inter_bev * torch.clamp(ymax - ymin, min=0.0)
    vol_a = boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5]
    vol_b = boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5]
    return inter3d / torch.clamp(vol_a + vol_b - inter3d, min=1e-8)
