"""Radius-bounded nearest-k search, ball query from it, and grouping.

Counterpart of ``tpu3d/ops/grouping.py``. ``nearest_k`` launches the CUDA
kernel in ``csrc/nearest_k.cu`` for CUDA tensors and runs ``nearest_k_plain``
for CPU tensors. Both are exact: the k nearest points, nearest first, ties
to the lower id.

Kernel note (in full in the source): it replaces
``tpu3d/ops/grouping.py::_nearest_k_pallas``. A brute sweep is bound by its
M·N distance operations; one thread per center keeps its sorted list in
registers while the points stream through shared memory as broadcasts.
"""

from __future__ import annotations

import torch

from . import _build
from .sampling import _d2


def _radius2(max_radius: float | None) -> float:
    return float("inf") if max_radius is None else float(max_radius) ** 2


def nearest_k_plain(centers: torch.Tensor, pts: torch.Tensor, k: int,
                    max_radius: float | None = None):
    """Plain PyTorch version of the kernel: the whole distance row, a
    stable sort, the first k."""
    B, M, _ = centers.shape
    N = pts.shape[1]
    r2 = torch.tensor(_radius2(max_radius), dtype=torch.float32)
    out_d, out_i = [], []
    for c in centers.split(512, dim=1):  # bounds the (B, chunk, N) block
        d2 = _d2(c[:, :, None, :], pts[:, None, :, :])
        d2 = torch.where(d2 < r2.to(d2.device), d2, torch.inf)
        if N < k:
            d2 = torch.cat([d2, d2.new_full((*d2.shape[:2], k - N),
                                            torch.inf)], 2)
        d, i = torch.sort(d2, dim=2, stable=True)
        d, i = d[..., :k], i[..., :k].to(torch.int32)
        out_d.append(d)
        out_i.append(torch.where(torch.isinf(d), N, i))
    return torch.cat(out_d, 1), torch.cat(out_i, 1)


def nearest_k(centers: torch.Tensor, pts: torch.Tensor, k: int,
              max_radius: float | None = None):
    """(B, M, 3) centers × (B, N, 3) points -> ((B, M, k) f32 d²,
    (B, M, k) i32 ids), nearest first, ties to the lower id.

    With ``max_radius``, points at d² >= max_radius² are left out: slots
    past the in-radius neighbours hold d² = +inf and id N, so they are never
    ball-query hits. Only callers that radius-filter the result (with radii
    up to max_radius) may pass it.
    """
    if centers.device.type == "cpu":
        return nearest_k_plain(centers, pts, k, max_radius)
    _build.check_cuda_tensor(centers, "centers", torch.float32, 3)
    _build.check_cuda_tensor(pts, "pts", torch.float32, 3)
    B, M, _ = centers.shape
    N = pts.shape[1]
    if (centers.shape[2] != 3 or pts.shape[0] != B or pts.shape[2] != 3
            or not 1 <= k <= 64):
        raise ValueError(f"nearest_k takes (B, M, 3), (B, N, 3) and "
                         f"1 <= k <= 64, got {tuple(centers.shape)}, "
                         f"{tuple(pts.shape)}, k={k}")
    d2 = torch.empty(B, M, k, dtype=torch.float32, device=centers.device)
    idx = torch.empty(B, M, k, dtype=torch.int32, device=centers.device)
    _build.launch("nearest_k", centers.data_ptr(), pts.data_ptr(), B, M, N, k,
                  _radius2(max_radius), d2.data_ptr(), idx.data_ptr())
    return d2, idx


def ball_query_from_nearest(d2: torch.Tensor, idx: torch.Tensor,
                            radius: float, nsample: int,
                            n_pts: int) -> torch.Tensor:
    """Ball query from nearest-k candidates: the first ``nsample``
    candidates inside the radius, short rows padded with the first hit,
    rows without a hit all 0 (the CUDA reference's fill)."""
    d2, idx = d2[..., :nsample], idx[..., :nsample]
    hit = (d2 < radius * radius) & (idx < n_pts)
    first = torch.where(hit[..., 0:1], idx[..., 0:1], 0)
    return torch.where(hit, idx, first).to(torch.int32)


def _ball_query_first(centers, pts, radius, nsample):
    """tpu3d's "first" rule (``tpu3d/ops/grouping.py:413-426``): the first
    ``nsample`` in-radius ids in index order, short rows padded with the
    first hit, rows without a hit all 0. XLA code in tpu3d, so plain torch
    on every device, a chunk of centers at a time."""
    N = pts.shape[1]
    iota = torch.arange(N, dtype=torch.int32, device=pts.device)
    out = []
    for c in centers.split(512, dim=1):  # bounds the (B, chunk, N) block
        d2 = _d2(c[:, :, None, :], pts[:, None, :, :])
        keys = torch.where(d2 < radius * radius, iota, N)
        if N < nsample:  # fewer points than slots: pad with misses
            keys = torch.cat([keys, keys.new_full((*keys.shape[:2],
                                                   nsample - N), N)], 2)
        idx = keys.sort(dim=2).values[..., :nsample]
        hit = idx < N
        first = torch.where(hit[..., 0:1], idx[..., 0:1], 0)
        out.append(torch.where(hit, idx, first))
    return torch.cat(out, 1).to(torch.int32)


def ball_query(centers: torch.Tensor, pts: torch.Tensor, radius: float,
               nsample: int, method: str = "auto") -> torch.Tensor:
    """(B, M, 3) centers × (B, N, 3) points -> (B, M, nsample) i32 ids of
    points inside ``radius``, short rows padded with the first hit, rows
    without a hit all 0, by tpu3d's ``method``:

    - "nearest": the ``nsample`` nearest, nearest first, ties to the lower
      id (the nearest-k kernel);
    - "first": the first ``nsample`` in index order (plain torch);
    - "auto": "nearest", the rule tpu3d takes off the TPU. On the TPU it
      takes "first" at the RCNN's shapes, which picks another set only when
      more than ``nsample`` points lie inside.

    Another method raises, as in tpu3d."""
    if method not in ("auto", "nearest", "first"):
        raise ValueError(f"ball_query method must be 'auto', 'nearest' or "
                         f"'first', got {method!r}")
    if method == "first":
        return _ball_query_first(centers, pts, radius, nsample)
    d2, idx = nearest_k(centers, pts, nsample, max_radius=radius)
    return ball_query_from_nearest(d2, idx, radius, nsample, pts.shape[1])


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) gathered by (B, M, S) -> (B, M, S, C)."""
    B, M, S = idx.shape
    flat = idx.reshape(B, M * S).long()[..., None]
    out = torch.gather(features, 1, flat.expand(-1, -1, features.shape[-1]))
    return out.reshape(B, M, S, features.shape[-1])
