"""The 3 nearest neighbours, and three-point interpolation for feature
propagation with its gradient.

Counterpart of ``tpu3d/ops/interpolate.py``. ``three_nn`` launches the CUDA
kernel in ``csrc/three_nn.cu`` for CUDA tensors, in the form
``three_nn_route`` picks, and runs ``three_nn_plain`` for CPU tensors; the
FP levels take their neighbours from ``furthest_point_sample_with_3nn``,
which calls it on its split route (SA_0 of a 16-scene batch of 32768
points, and the RPN levels of fewer than 256 points). ``three_interpolate``
is a ``torch.autograd.Function``: its forward launches the CUDA kernel in
``csrc/three_interpolate.cu`` and its backward the one in
``csrc/three_interpolate_bwd.cu`` for CUDA tensors; for CPU tensors they
run ``three_interpolate_plain`` and ``three_interpolate_backward_plain``.

Kernel notes (in full in the sources): they replace
``tpu3d/ops/interpolate.py::_three_nn_pallas``, ``_ti_fwd_kernel`` and
``_ti_bwd_kernel``. ``three_nn`` is bound by operations; one thread per
query folds known points into a top-3 sorted by (d², id), with d² rounded
step by step, so it equals the plain version bit for bit. Its windowed
form sorts each scene's known points by depth (``depth_sort``) and lets
each query widen from its own depth both ways until the depth term alone
passes its third d², so it evaluates a few percent of the pairs; its brute
form sweeps every known point, staged through shared memory. The
interpolation kernels are bound by bytes; one warp per output row
reads each gathered row as whole 128-byte lines in f32. The backward
inverts the ids into per-source lists of keys m·3 + j (CSR, in a workspace
from torch's allocator) and gathers: one warp per source and 256 channels
sorts its list and sums the weighted gradient rows in ascending key order,
then writes its part of the row once, so it adds no float by an atomic,
needs no zeroing pass, and gives the same bits on every call: those of the
plain version's ``index_add_`` on the CPU, which adds in that order.
"""

from __future__ import annotations

import torch

from . import _build


def _d2(pts: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(x-rx)²+(y-ry)²+(z-rz)², summed left to right as the kernels do."""
    d = pts - ref
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def three_nn_plain(unknown: torch.Tensor, known: torch.Tensor):
    """Plain PyTorch version of the kernel: every query's d² to every known
    point, then a stable sort, so equal d² keep the lower index."""
    B, N = known.shape[0], known.shape[1]
    rows = max(1, (1 << 24) // max(B * N, 1))  # bounds the (B, rows, N) block
    nn_d2, nn_idx = [], []
    for q in unknown.split(rows, dim=1):
        d, i = torch.sort(_d2(q[:, :, None, :], known[:, None, :, :]), dim=2,
                          stable=True)
        nn_d2.append(d[..., :3])
        nn_idx.append(i[..., :3].to(torch.int32))
    return torch.cat(nn_d2, 1), torch.cat(nn_idx, 1)


def depth_sort(pts: torch.Tensor):
    """(B, N, 3) -> (zs (B, N) f32, order (B, N) i64): each scene's depths
    z ascending and the ids of the points in that order (a stable sort:
    equal depths keep id order; NaN depths last). The windowed kernels'
    index (``three_nn``'s and ``grouping.nearest_k``'s), and the plain
    windows'."""
    zs, order = torch.sort(pts[..., 2].contiguous(), dim=1, stable=True)
    return zs.contiguous(), order.contiguous()


def three_nn_windows(zs: torch.Tensor, unknown: torch.Tensor,
                     third: torch.Tensor):
    """Plain version of the windows an exact windowed search cannot skip:
    (lo, hi), (B, M) i64, the run [lo, hi) of depth-sorted positions (``zs``
    from ``depth_sort`` of the known points) whose depth term
    fl(fl(uz - z)²) is at most ``third`` (B, M), each query's third d².
    Every one of a query's 3 nearest lies inside (its d² is at least its
    depth term), and the kernel's windowed form evaluates each point inside
    before it stops (``csrc/three_nn.cu`` gives the argument). The run is
    contiguous: on each side of the query's own depth position (the first
    z not below uz) the term never falls away from it."""
    B, N = zs.shape
    uz = unknown[..., 2].contiguous()
    start = torch.searchsorted(zs, uz, side="left")

    def term_at(p):
        dz = uz - zs.gather(1, p.clamp(max=N - 1))
        return dz * dz

    def first(lo, hi, pred):
        """The first position of [lo, hi) where ``pred`` holds, pred false
        then true along it (hi where it never holds)."""
        while (lo < hi).any():
            live, mid = lo < hi, (lo + hi) // 2
            yes = pred(mid)
            hi = torch.where(live & yes, mid, hi)
            lo = torch.where(live & ~yes, mid + 1, lo)
        return lo

    lo = first(torch.zeros_like(start), start,
               lambda p: term_at(p) <= third)
    hi = first(start, torch.full_like(start, N),
               lambda p: term_at(p) > third)
    return lo, hi


# the windowed form pays a depth sort of the known points (torch.sort) and
# a pack, which the brute sweep beats below this many pairs per call.
# Device times on an H100 at the shapes chip_smoke.py sweeps (PERF.md):
# windowed faster at each one at or above it, brute at each one below
THREE_NN_WINDOW_MIN_PAIRS = 1 << 26


def three_nn_route(B: int, M: int, N: int) -> bool:
    """Whether the kernel takes the windowed form: at least
    ``THREE_NN_WINDOW_MIN_PAIRS`` pairs. A speed choice only: both forms
    give the plain result to the bit."""
    return B * M * N >= THREE_NN_WINDOW_MIN_PAIRS


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """(B, M, 3) queries, (B, N, 3) known points, f32 -> (d2 (B, M, 3) f32,
    idx (B, M, 3) i32): each query's 3 nearest known points, nearest first,
    ties to the lowest index, with d² as ``_three_nn_pallas`` returns it
    (tpu3d's ``three_nn`` returns sqrt(max(d², 0))). The CUDA kernel needs
    N >= 3."""
    if unknown.device.type == "cpu":
        return three_nn_plain(unknown, known)
    B, M, N = unknown.shape[0], unknown.shape[1], known.shape[1]
    return launch_three_nn(unknown, known, three_nn_route(B, M, N))


def launch_three_nn(unknown: torch.Tensor, known: torch.Tensor,
                    windowed: bool):
    """The kernel in a given form (``three_nn`` chooses it;
    ``chip_smoke.py`` times both). One counted launch; the windowed form
    sorts the known points by depth first."""
    _build.check_cuda_tensor(unknown, "unknown", torch.float32, 3)
    _build.check_cuda_tensor(known, "known", torch.float32, 3)
    B, M, three = unknown.shape
    N = known.shape[1]
    if three != 3 or known.shape[0] != B or known.shape[2] != 3 or N < 3:
        raise ValueError(f"three_nn takes (B, M, 3) queries and (B, N>=3, 3) "
                         f"known points, got {tuple(unknown.shape)} and "
                         f"{tuple(known.shape)}")
    dev = unknown.device
    nn_d2 = torch.empty(B, M, 3, dtype=torch.float32, device=dev)
    nn_idx = torch.empty(B, M, 3, dtype=torch.int32, device=dev)
    order = packed = None
    if windowed:
        order = depth_sort(known)[1]
        packed = torch.empty(B, N, 4, dtype=torch.float32, device=dev)
    _build.launch("three_nn", unknown.data_ptr(), known.data_ptr(),
                  None if order is None else order.data_ptr(), B, M, N,
                  None if packed is None else packed.data_ptr(),
                  nn_d2.data_ptr(), nn_idx.data_ptr())
    return nn_d2, nn_idx


def three_interpolate_plain(features: torch.Tensor, idx: torch.Tensor,
                            weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gather, then the weighted sum in
    neighbour order."""
    B, M, _ = idx.shape
    C = features.shape[-1]
    flat = idx.reshape(B, M * 3).long()[..., None].expand(-1, -1, C)
    g = torch.gather(features, 1, flat).reshape(B, M, 3, C)
    w = weight[..., None]
    return w[:, :, 0] * g[:, :, 0] + w[:, :, 1] * g[:, :, 1] \
        + w[:, :, 2] * g[:, :, 2]


def three_interpolate_backward_plain(features: torch.Tensor,
                                     idx: torch.Tensor, weight: torch.Tensor,
                                     grad: torch.Tensor,
                                     need_weight: bool = True):
    """Plain PyTorch version of the backward kernel: ``index_add_`` of the
    weighted gradient rows into the source rows (on the CPU a sequential
    sum in ascending (b, m·3 + j) from +0.0, the kernel's order), and each
    neighbour's dot product with the gradient -> (d_features (B, N, C),
    d_weight (B, M, 3) or None)."""
    B, M, _ = idx.shape
    N, C = features.shape[1], features.shape[2]
    flat = idx.reshape(B, M * 3).long()
    rows = (flat + N * torch.arange(B, device=idx.device)[:, None]).reshape(-1)
    contrib = (weight[..., None] * grad[:, :, None, :]).reshape(-1, C)
    d_features = grad.new_zeros(B * N, C).index_add_(0, rows, contrib)
    d_weight = None
    if need_weight:
        g = torch.gather(features, 1, flat[..., None].expand(-1, -1, C))
        d_weight = (g.reshape(B, M, 3, C) * grad[:, :, None, :]).sum(-1)
    return d_features.reshape(B, N, C), d_weight


def _check(features, idx, weight):
    _build.check_cuda_tensor(features, "features", torch.float32, 3)
    _build.check_cuda_tensor(idx, "idx", torch.int32, 3)
    _build.check_cuda_tensor(weight, "weight", torch.float32, 3)
    B, M = features.shape[0], idx.shape[1]
    if idx.shape != (B, M, 3) or weight.shape != (B, M, 3):
        raise ValueError(f"three_interpolate takes idx and weight of shape "
                         f"(B, M, 3), got {tuple(idx.shape)} and "
                         f"{tuple(weight.shape)} for B={B}")


def three_interpolate_forward(features: torch.Tensor, idx: torch.Tensor,
                              weight: torch.Tensor) -> torch.Tensor:
    """The forward alone: the kernel for CUDA tensors, else the plain
    version."""
    if features.device.type == "cpu":
        return three_interpolate_plain(features, idx, weight)
    _check(features, idx, weight)
    B, N, C = features.shape
    M = idx.shape[1]
    out = torch.empty(B, M, C, dtype=torch.float32, device=features.device)
    _build.launch("three_interpolate", features.data_ptr(), idx.data_ptr(),
                  weight.data_ptr(), B, N, M, C, out.data_ptr())
    return out


def backward_workspace(B: int, N: int, M: int) -> int:
    """Ints of workspace the backward kernel takes (its C entry checks):
    the per-source list offsets (B·N + 1), then the lists' flat keys
    m·3 + j (3·B·M)."""
    return B * N + 1 + 3 * B * M


def three_interpolate_backward(features: torch.Tensor, idx: torch.Tensor,
                               weight: torch.Tensor, grad: torch.Tensor,
                               need_weight: bool = True):
    """The backward alone: (d_features, d_weight or None) from the output
    gradient, by the kernel for CUDA tensors, else the plain version."""
    if features.device.type == "cpu":
        return three_interpolate_backward_plain(features, idx, weight, grad,
                                                need_weight)
    _check(features, idx, weight)
    _build.check_cuda_tensor(grad, "grad", torch.float32, 3)
    B, N, C = features.shape
    M = idx.shape[1]
    if grad.shape != (B, M, C):
        raise ValueError(f"three_interpolate's gradient must be {(B, M, C)}, "
                         f"got {tuple(grad.shape)}")
    dev = features.device
    # every row is written by the kernel, so no zeroing pass
    d_features = torch.empty(B, N, C, dtype=torch.float32, device=dev)
    d_weight = (torch.empty(B, M, 3, dtype=torch.float32, device=dev)
                if need_weight else None)
    n_ws = backward_workspace(B, N, M)
    workspace = torch.empty(n_ws, dtype=torch.int32, device=dev)
    _build.launch("three_interpolate_bwd", features.data_ptr(),
                  idx.data_ptr(), weight.data_ptr(), grad.data_ptr(), B, N,
                  M, C, d_features.data_ptr(),
                  d_weight.data_ptr() if need_weight else None,
                  workspace.data_ptr(), n_ws)
    return d_features, d_weight


class _ThreeInterpolate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, idx, weight):
        ctx.save_for_backward(features, idx, weight)
        return three_interpolate_forward(features, idx, weight)

    @staticmethod
    def backward(ctx, grad):
        features, idx, weight = ctx.saved_tensors
        need_features, _, need_weight = ctx.needs_input_grad
        if not (need_features or need_weight):
            return None, None, None
        d_features, d_weight = three_interpolate_backward(
            features, idx, weight, grad.contiguous(), need_weight)
        return (d_features if need_features else None), None, d_weight


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """(B, N, C) f32 features, (B, M, 3) i32 idx, (B, M, 3) f32 weights ->
    (B, M, C): out[m] = Σ_j weight[m, j] · features[idx[m, j]].

    Differentiable in ``features`` and ``weight``; the backward computes
    d_weight only when autograd asks for it (the FP levels' weights are
    constants, so the train step never does)."""
    return _ThreeInterpolate.apply(features, idx, weight)


def interpolation_weights(dist: torch.Tensor,
                          eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights normalised to 1 (pointnet2_modules parity)."""
    recip = 1.0 / (dist + eps)
    return recip / recip.sum(dim=-1, keepdim=True)


def nn_dist_from_idx(unknown: torch.Tensor, known: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """The distances of (B, M, 3) queries to their picked (B, M, 3) ``idx``
    rows of the (B, N, 3) sources, recomputed from the coordinates, so
    differentiable in both -> (B, M, 3): sqrt(max(d², 0))."""
    B, M, _ = idx.shape
    picked = torch.gather(known, 1, idx.long().reshape(B, M * 3, 1).expand(
        -1, -1, 3)).reshape(B, M, 3, 3)
    d2 = torch.sum((unknown[:, :, None, :] - picked) ** 2, dim=-1)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def three_nn_numpy(unknown, known):
    """Host oracle: each query's 3 nearest sources by a stable sort ->
    ((B, M, 3) f64 distances, (B, M, 3) i32 ids)."""
    import numpy as np

    unknown, known = np.asarray(unknown), np.asarray(known)
    B, M, _ = unknown.shape
    dists = np.zeros((B, M, 3))
    idx = np.zeros((B, M, 3), dtype=np.int32)
    for b in range(B):
        d2 = np.sum((unknown[b][:, None] - known[b][None]) ** 2, axis=-1)
        order = np.argsort(d2, axis=1, kind="stable")[:, :3]
        idx[b] = order
        dists[b] = np.sqrt(np.take_along_axis(d2, order, axis=1))
    return dists, idx
