"""ROI point pooling: a fixed number of points per (enlarged) box.

Counterpart of ``tpu3d/ops/roipool.py`` (reference: roipool3d_cuda), in
plain PyTorch and f32. For each ROI it takes the first ``num_sampled``
points inside the enlarged box in index order; a box holding fewer fills
its slots by wraparound (slot k reads hit k % count); an empty box gives
zeros and sets its empty flag. The first-k selection is one sort of int32
index keys, as tpu3d does on the TPU. ``roipool3d_table`` gathers one
table alone, as tpu3d's accelerator path pools its bf16 hi/lo table.
"""

from __future__ import annotations

import torch

from .box_geometry import enlarge_box3d, points_in_boxes3d


def _pool_slots(pts: torch.Tensor, boxes3d: torch.Tensor,
                pool_extra_width: float, num_sampled: int):
    """Each ROI's K = ``num_sampled`` point ids -> (slots (B, M, K) i64,
    empty (B, M) bool)."""
    B, N, _ = pts.shape
    big = enlarge_box3d(boxes3d, pool_extra_width)
    inside = points_in_boxes3d(pts, big).transpose(1, 2)  # (B, M, N)
    iota = torch.arange(N, dtype=torch.int32, device=pts.device)
    keys = torch.where(inside, iota, N)
    if N < num_sampled:  # fewer points than slots: pad with sentinels
        keys = torch.nn.functional.pad(keys, (0, num_sampled - N), value=N)
    # keys are distinct below the sentinel N, so the ascending prefix is the
    # first num_sampled interior points in index order
    sel = torch.sort(keys, dim=2).values[..., :num_sampled]
    counts = (sel < N).sum(dim=2, keepdim=True)
    empty = counts[..., 0] == 0
    k = torch.arange(num_sampled, device=pts.device)
    src = torch.where(counts > 0, k % counts.clamp(min=1), 0)
    return torch.gather(sel.clamp(max=N - 1), 2, src).long(), empty


def _gather_rows(table: torch.Tensor, slots: torch.Tensor,
                 empty: torch.Tensor) -> torch.Tensor:
    """table (B, N, C) rows at slots (B, M, K), zeros for an empty ROI."""
    B, M, K = slots.shape
    flat = slots.reshape(B, M * K, 1)
    rows = torch.gather(table, 1, flat.expand(-1, -1, table.shape[-1]))
    return torch.where(~empty[..., None, None], rows.reshape(B, M, K, -1),
                       torch.zeros((), dtype=table.dtype,
                                   device=table.device))


def roipool3d(pts: torch.Tensor, feats: torch.Tensor, boxes3d: torch.Tensor,
              pool_extra_width: float, num_sampled: int):
    """pts (B, N, 3), feats (B, N, C), boxes3d (B, M, 7) -> (pooled xyz
    (B, M, K, 3), pooled feats (B, M, K, C), empty (B, M) bool), K =
    ``num_sampled``."""
    slots, empty = _pool_slots(pts, boxes3d, pool_extra_width, num_sampled)
    return (_gather_rows(pts, slots, empty), _gather_rows(feats, slots, empty),
            empty)


def roipool3d_table(pts: torch.Tensor, table: torch.Tensor,
                    boxes3d: torch.Tensor, pool_extra_width: float,
                    num_sampled: int):
    """tpu3d's ``roipool3d(split="features")``: the rows of ``table`` (B, N,
    C, any dtype) alone, one gather, the points ``pts`` (B, N, 3) only
    choosing them -> (pooled (B, M, K, C), empty (B, M) bool). Under the
    accelerator's contract the caller's table carries the coordinates as a
    bf16 hi/lo pair beside the bf16 features (``bf16_table``)."""
    slots, empty = _pool_slots(pts, boxes3d, pool_extra_width, num_sampled)
    return _gather_rows(table, slots, empty), empty


def bf16_table(xyz: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
    """tpu3d's pooled table on its accelerator
    (``tpu3d/models/point_rcnn.py:117-121``): [hi, lo, features] in bf16,
    hi = bf16(xyz) and lo = bf16(xyz - hi), so that hi + lo gives the
    coordinates back to ~1e-3 m after the gather."""
    hi = xyz.to(torch.bfloat16)
    lo = (xyz - hi.float()).to(torch.bfloat16)
    return torch.cat([hi, lo, features.to(torch.bfloat16)], dim=-1)


def roipool3d_numpy(pts, feats, boxes3d, pool_extra_width, num_sampled):
    """The same pooling on the host in numpy (tpu3d's ``roipool3d_numpy``),
    for the RCNN-offline samples the loader builds: pts (B, N, 3), feats
    (B, N, C), boxes3d (B, M, 7) -> (pooled (B, M, K, 3 + C) f32, empty
    (B, M) bool)."""
    import numpy as np

    from ..kitti.boxes import enlarge_box3d as np_enlarge
    from ..kitti.boxes import points_in_boxes3d as np_inside

    pts, feats, boxes3d = map(np.asarray, (pts, feats, boxes3d))
    B, N, _ = pts.shape
    M = boxes3d.shape[1]
    C = feats.shape[-1]
    pooled = np.zeros((B, M, num_sampled, 3 + C), dtype=np.float32)
    empty = np.zeros((B, M), dtype=bool)
    for b in range(B):
        big = np_enlarge(boxes3d[b], pool_extra_width)
        inside = np_inside(pts[b], big)  # (N, M)
        data = np.concatenate([pts[b], feats[b]], axis=1)
        for m in range(M):
            hits = np.where(inside[:, m])[0]
            if len(hits) == 0:
                empty[b, m] = True
                continue
            take = hits[np.arange(num_sampled) % len(hits)]
            pooled[b, m] = data[take]
    return pooled, empty
