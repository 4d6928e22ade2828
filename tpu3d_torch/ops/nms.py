"""Exact greedy BEV NMS, rotated or axis-aligned.

Counterpart of ``tpu3d/ops/nms.py`` (``nms_bev``, ``nms_blocked_sorted``),
which is XLA there and plain PyTorch here. The proposal layer takes the
axis-aligned IoU (``RPN.NMS_TYPE: normal``), the RCNN's final NMS the
rotated one.
"""

from __future__ import annotations

import torch

from .rotated_iou import rotated_overlap_bev


def _aligned_iou_cross(a5: torch.Tensor, b5: torch.Tensor) -> torch.Tensor:
    """Axis-aligned IoU of (M, 5) vs (N, 5) BEV5 [xc, zc, l, w, ry] boxes,
    rotation ignored (nms_normal parity) -> (M, N)."""
    ax1, ax2 = a5[:, 0] - a5[:, 2] / 2, a5[:, 0] + a5[:, 2] / 2
    az1, az2 = a5[:, 1] - a5[:, 3] / 2, a5[:, 1] + a5[:, 3] / 2
    bx1, bx2 = b5[:, 0] - b5[:, 2] / 2, b5[:, 0] + b5[:, 2] / 2
    bz1, bz2 = b5[:, 1] - b5[:, 3] / 2, b5[:, 1] + b5[:, 3] / 2
    iw = (torch.minimum(ax2[:, None], bx2[None, :])
          - torch.maximum(ax1[:, None], bx1[None, :])).clamp(min=0)
    ih = (torch.minimum(az2[:, None], bz2[None, :])
          - torch.maximum(az1[:, None], bz1[None, :])).clamp(min=0)
    inter = iw * ih
    area_a = (ax2 - ax1) * (az2 - az1)
    area_b = (bx2 - bx1) * (bz2 - bz1)
    return inter / torch.clamp(area_a[:, None] + area_b[None, :] - inter,
                               min=1e-8)


def nms_blocked_sorted(boxes5_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                       thresh: float, max_out: int, rotated: bool = False,
                       block: int = 256):
    """Greedy NMS over score-sorted (N, 5) BEV boxes: suppress j when
    IoU(kept i, j) > thresh for an earlier i. Returns ((max_out,) i32
    positions into the sorted arrays, (max_out,) bool keep mask).

    The IoU work runs as (block, N) slabs. Within a block the greedy keep
    set is the fixpoint of
        K_{t+1}[j] = base[j] & ~any_{i<j}(K_t[i] & IoU[i, j] > thresh),
    reached in as many steps as the longest suppression chain (typically a
    handful), so the host waits once per fixpoint step and once per block,
    never once per candidate. The walk stops once ``max_out`` are kept.
    """
    dev = boxes5_sorted.device
    n = boxes5_sorted.shape[0]
    out_idx = torch.zeros(max_out, dtype=torch.int32, device=dev)
    out_mask = torch.zeros(max_out, dtype=torch.bool, device=dev)
    if n == 0:
        return out_idx, out_mask
    block = min(block, n)
    n_blocks = -(-n // block)
    n_pad = n_blocks * block
    boxes = torch.nn.functional.pad(boxes5_sorted, (0, 0, 0, n_pad - n))
    valid = torch.nn.functional.pad(valid_sorted, (0, n_pad - n))
    col_ids = torch.arange(n_pad, device=dev)
    blk = torch.arange(block, device=dev)
    upper = blk[None, :] > blk[:, None]
    suppressed = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    kept = 0
    for b in range(n_blocks):
        if kept >= max_out:
            break
        start = b * block
        rows_b = boxes[start:start + block]
        iou = (rotated_overlap_bev(rows_b, boxes, criterion=-1) if rotated
               else _aligned_iou_cross(rows_b, boxes))
        hit = iou > thresh
        base = valid[start:start + block] & ~suppressed[start:start + block]
        tri = hit[:, start:start + block] & upper
        keep = base
        while True:
            new = base & ~(keep[:, None] & tri).any(dim=0)
            if torch.equal(new, keep):
                break
            keep = new
        rows = start + blk
        take = keep & (torch.cumsum(keep.to(torch.int32), 0) <= max_out - kept)
        taken = rows[take].to(torch.int32)
        out_idx[kept:kept + taken.numel()] = taken
        out_mask[kept:kept + taken.numel()] = True
        suppressed |= (keep[:, None] & hit
                       & (col_ids[None, :] > rows[:, None])).any(dim=0)
        kept += taken.numel()
    return out_idx, out_mask


def nms_bev(boxes5: torch.Tensor, scores: torch.Tensor, thresh: float,
            max_out: int, valid: torch.Tensor | None = None,
            rotated: bool = True):
    """Greedy BEV NMS over (N, 5) [xc, zc, l, w, ry] boxes in descending
    score order (stable, valid candidates first): suppress j when
    IoU(kept i, j) > thresh. Returns ((max_out,) i32 indices into boxes5,
    0 in the slots past the keeps, and (max_out,) bool keep mask)."""
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    order = torch.argsort(torch.where(valid, -scores, torch.inf), stable=True)
    pos, mask = nms_blocked_sorted(boxes5[order], valid[order], thresh,
                                   max_out, rotated=rotated)
    idx = torch.where(mask, order[pos.long()], 0).to(torch.int32)
    return idx, mask
