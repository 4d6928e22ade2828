"""ROI point pooling: a fixed number of points per (enlarged) box.

Counterpart of ``tpu3d/ops/roipool.py`` (reference: roipool3d_cuda), in
plain PyTorch and f32. For each ROI it takes the first ``num_sampled``
points inside the enlarged box in index order; a box holding fewer fills
its slots by wraparound (slot k reads hit k % count); an empty box gives
zeros and sets its empty flag. The first-k selection is one sort of int32
index keys, as tpu3d does on the TPU.
"""

from __future__ import annotations

import torch

from .box_geometry import enlarge_box3d, points_in_boxes3d


def roipool3d(pts: torch.Tensor, feats: torch.Tensor, boxes3d: torch.Tensor,
              pool_extra_width: float, num_sampled: int):
    """pts (B, N, 3), feats (B, N, C), boxes3d (B, M, 7) -> (pooled xyz
    (B, M, K, 3), pooled feats (B, M, K, C), empty (B, M) bool), K =
    ``num_sampled``."""
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
    slots = torch.gather(sel.clamp(max=N - 1), 2, src).long()  # (B, M, K)
    M = slots.shape[1]
    flat = slots.reshape(B, M * num_sampled, 1)
    px = torch.gather(pts, 1, flat.expand(-1, -1, 3))
    pf = torch.gather(feats, 1, flat.expand(-1, -1, feats.shape[-1]))
    keep = ~empty[..., None, None]
    px = torch.where(keep, px.reshape(B, M, num_sampled, 3), 0.0)
    pf = torch.where(keep, pf.reshape(B, M, num_sampled, -1), 0.0)
    return px, pf, empty


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
