"""Radius-bounded nearest-k search, ball query from it, and grouping.

Counterpart of ``tpu3d/ops/grouping.py``. ``nearest_k`` launches the CUDA
kernel in ``csrc/nearest_k.cu`` for CUDA tensors and runs ``nearest_k_plain``
for CPU tensors. Both are exact: the k nearest points, nearest first, ties
to the lower id, optionally with their coordinates.

Kernel note (in full in the source): it replaces
``tpu3d/ops/grouping.py::_nearest_k_pallas`` as ``nearest_k_windowed``
drives it. A warp serves each center; in the windowed form
(``nearest_k_route``) each scene's points are sorted by depth
(``depth_sort``) and each warp sweeps only its center's depth window,
which it finds by a search over the sorted depths with the sweep's own
rounded predicate (``depth_windows`` is its plain version); in the brute
form a block stages its scene's points through shared memory and sweeps
them all. In-radius hits go by ballot to a per-center list in shared memory
and are ranked by (d², id) at the end.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .interpolate import depth_sort
from .sampling import _d2

# the windowed form pays a depth sort (torch.sort) per call, which the
# brute sweep from shared memory beats below this many distance
# evaluations per call. Device times on an H100 at the 19 level shapes
# chip_smoke.py sweeps (PERF.md): windowed faster at each one at or above
# it (train RCNN SA_0, 1024 x 128 x 512 = 2^26, 0.172 ms against 0.188
# brute; train SA_1, 16 x 1024 x 4096, 0.057 against 0.134), brute at each
# one below (eval RCNN SA_0, 200 x 128 x 512, 0.044 against 0.059; eval
# SA_1, 2 x 1024 x 4096, 0.028 against 0.043)
NK_WINDOW_MIN_EVALS = 1 << 26


def _radius2(max_radius: float | None) -> float:
    return float("inf") if max_radius is None else float(max_radius) ** 2


def nearest_k_route(B: int, M: int, N: int, r2max: float) -> bool:
    """Whether the kernel takes the windowed form: a finite radius (else a
    window holds every point) and at least ``NK_WINDOW_MIN_EVALS`` brute
    evaluations. A speed choice only: both forms give the plain result to
    the bit."""
    return math.isfinite(r2max) and B * M * N >= NK_WINDOW_MIN_EVALS


def depth_windows(zs: torch.Tensor, centers: torch.Tensor,
                  max_radius: float | None):
    """Plain version of the kernel's window search: (lo, hi), (B, M) i64,
    the run [lo, hi) of depth-sorted positions whose rounded depth term
    fl(fl(cz - z)²) is below max_radius². lo counts the positions "below"
    (z < cz, term at or above the radius²: a prefix), N - hi those "above"
    (not z <= cz, term not below it: a suffix). Every point that
    ``nearest_k_plain`` keeps lies inside (``csrc/nearest_k.cu`` gives the
    argument)."""
    r2 = torch.tensor(_radius2(max_radius), dtype=torch.float32,
                      device=zs.device)
    N = zs.shape[1]
    lo, hi = [], []
    for c in centers.split(512, dim=1):  # bounds the (B, chunk, N) block
        cz, z = c[..., 2:3], zs[:, None, :]
        dz = cz - z
        near = dz * dz < r2
        lo.append(((z < cz) & ~near).sum(2))
        hi.append(N - (~((z <= cz) | near)).sum(2))
    return torch.cat(lo, 1), torch.cat(hi, 1)


def nearest_k_plain(centers: torch.Tensor, pts: torch.Tensor, k: int,
                    max_radius: float | None = None,
                    with_coords: bool = False):
    """Plain PyTorch version of the kernel: the whole distance row, a
    stable sort, the first k; with ``with_coords`` the slots' coordinates,
    0 in the padded slots."""
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
    d2, idx = torch.cat(out_d, 1), torch.cat(out_i, 1)
    if not with_coords:
        return d2, idx
    hit = (idx < N)[..., None]
    # detached: the kernel's coordinates carry no gradient either
    xyz = torch.where(hit, group_points(pts.detach(), idx.clamp(max=N - 1)),
                      0.0)
    return d2, idx, xyz


def nearest_k(centers: torch.Tensor, pts: torch.Tensor, k: int,
              max_radius: float | None = None, with_coords: bool = False):
    """(B, M, 3) centers × (B, N, 3) points -> ((B, M, k) f32 d²,
    (B, M, k) i32 ids[, (B, M, k, 3) f32 coordinates]), nearest first,
    ties to the lower id.

    With ``max_radius``, points at d² >= max_radius² are left out: slots
    past the in-radius neighbours hold d² = +inf, id N and coordinates 0,
    so they are never ball-query hits. Only callers that radius-filter the
    result (with radii up to max_radius) may pass it.

    The coordinates are copies of the points', with no gradient to
    ``pts`` on any device; a caller that differentiates with respect to the
    points gathers them from the ids.
    """
    if centers.device.type == "cpu":
        return nearest_k_plain(centers, pts, k, max_radius, with_coords)
    B, M = centers.shape[:2]
    r2 = _radius2(max_radius)
    return launch_nearest_k(centers, pts, k, r2,
                            nearest_k_route(B, M, pts.shape[1], r2),
                            with_coords)


# the most neighbours the kernel takes (csrc/nearest_k.cu's kMaxK)
NEAREST_K_MAX = 1024


def launch_nearest_k(centers: torch.Tensor, pts: torch.Tensor, k: int,
                     r2max: float, windowed: bool,
                     with_coords: bool = False):
    """The kernel in a given form (``nearest_k`` chooses it;
    ``chip_smoke.py`` times both). One counted launch; the windowed form
    sorts the points by depth first."""
    _build.check_cuda_tensor(centers, "centers", torch.float32, 3)
    _build.check_cuda_tensor(pts, "pts", torch.float32, 3)
    B, M, _ = centers.shape
    N = pts.shape[1]
    if (centers.shape[2] != 3 or pts.shape[0] != B or pts.shape[2] != 3
            or not 1 <= k <= NEAREST_K_MAX):
        raise ValueError(f"nearest_k takes (B, M, 3), (B, N, 3) and "
                         f"1 <= k <= {NEAREST_K_MAX}, got "
                         f"{tuple(centers.shape)}, "
                         f"{tuple(pts.shape)}, k={k}")
    dev = centers.device
    d2 = torch.empty(B, M, k, dtype=torch.float32, device=dev)
    idx = torch.empty(B, M, k, dtype=torch.int32, device=dev)
    xyz = (torch.empty(B, M, k, 3, dtype=torch.float32, device=dev)
           if with_coords else None)
    zs = order = None
    if windowed:
        zs, order = depth_sort(pts)
    _build.launch("nearest_k", centers.data_ptr(), pts.data_ptr(),
                  None if zs is None else zs.data_ptr(),
                  None if order is None else order.data_ptr(), B, M, N, k,
                  r2max, d2.data_ptr(), idx.data_ptr(),
                  None if xyz is None else xyz.data_ptr())
    return (d2, idx, xyz) if with_coords else (d2, idx)


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


def group_points_backward_plain(grad: torch.Tensor, idx: torch.Tensor,
                                N: int) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/group_points_bwd.cu``: grad (B, M, S,
    C), idx (B, M, S) -> d_features (B, N, C), each entry's row added into
    its point's in ascending (m·S + s) order, from +0.0 (``index_add_``,
    which on the CPU adds in source order)."""
    B, M, S = idx.shape
    C = grad.shape[-1]
    rows = (idx.long() + N * torch.arange(B, device=idx.device)[:, None,
                                                                None])
    out = grad.new_zeros(B * N, C)
    return out.index_add_(0, rows.reshape(-1), grad.reshape(-1, C)).view(
        B, N, C)


def group_points_workspace(B: int, N: int, M: int, S: int) -> int:
    """Ints of the backward kernel's workspace (offsets, then keys)."""
    fn = _build.library("group_points_bwd").tpu3d_group_points_bwd_workspace
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return fn(B, N, M, S)


def group_points_backward(grad: torch.Tensor, idx: torch.Tensor,
                          N: int) -> torch.Tensor:
    """The grouping gather's backward: the kernel of
    ``csrc/group_points_bwd.cu`` for CUDA tensors, else the plain version.
    The same bits on every call either way."""
    if grad.device.type == "cpu":
        return group_points_backward_plain(grad, idx, N)
    B, M, S = idx.shape
    C = grad.shape[-1]
    _build.check_cuda_tensor(grad, "grad", torch.float32, 4)
    _build.check_cuda_tensor(idx, "idx", torch.int32, 3)
    if grad.shape[:3] != idx.shape:
        raise ValueError(f"grad {tuple(grad.shape)} and idx "
                         f"{tuple(idx.shape)} disagree")
    out = torch.empty(B, N, C, dtype=torch.float32, device=grad.device)
    ws = torch.empty(group_points_workspace(B, N, M, S), dtype=torch.int32,
                     device=grad.device)
    _build.launch("group_points_bwd", grad.data_ptr(), idx.data_ptr(), B, N,
                  M, S, C, out.data_ptr(), ws.data_ptr(), ws.numel())
    return out


class _GroupPoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, idx):
        B, M, S = idx.shape
        ctx.save_for_backward(idx)
        ctx.n = features.shape[1]
        flat = idx.reshape(B, M * S).long()[..., None]
        out = torch.gather(features, 1, flat.expand(-1, -1,
                                                    features.shape[-1]))
        return out.reshape(B, M, S, features.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        if grad.device.type == "cuda":
            idx = idx.to(torch.int32)
        return group_points_backward(grad.contiguous(), idx.contiguous(),
                                     ctx.n), None


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) gathered by (B, M, S) -> (B, M, S, C). Its backward adds
    each point's slots in ascending (m·S + s) order (``_GroupPoints``), so
    it gives the same bits on every call, where ``torch.gather``'s
    scatter-add on the card does not."""
    return _GroupPoints.apply(features, idx)


def ball_query_numpy(centers, pts, radius: float, nsample: int):
    """Host oracle, (B, M, 3) x (B, N, 3) -> (B, M, nsample) i32: the first
    ``nsample`` points within ``radius`` in index order, the rest of the
    row filled with the first of them, zeros for a center with none (the
    CUDA ball query's fill)."""
    import numpy as np

    centers, pts = np.asarray(centers), np.asarray(pts)
    B, M, _ = centers.shape
    out = np.zeros((B, M, nsample), dtype=np.int32)
    for b in range(B):
        for m in range(M):
            d2 = np.sum((pts[b] - centers[b, m]) ** 2, axis=-1)
            hits = np.where(d2 < radius * radius)[0]
            if len(hits) == 0:
                continue
            take = hits[:nsample]
            out[b, m, :len(take)] = take
            out[b, m, len(take):] = take[0]
    return out
