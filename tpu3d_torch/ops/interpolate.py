"""The 3 nearest neighbours, and three-point interpolation for feature
propagation with its gradient.

Counterpart of ``tpu3d/ops/interpolate.py``. ``three_nn`` launches the CUDA
kernel in ``csrc/three_nn.cu`` for CUDA tensors and runs
``three_nn_plain`` for CPU tensors; the FP levels take their neighbours
from ``furthest_point_sample_with_3nn``, which calls it on its split route
(SA_0 of a 16-scene batch of 32768 points). ``three_interpolate`` is a
``torch.autograd.Function``: its forward launches the CUDA kernel in
``csrc/three_interpolate.cu`` and its backward the one in
``csrc/three_interpolate_bwd.cu`` for CUDA tensors; for CPU tensors they
run ``three_interpolate_plain`` and ``three_interpolate_backward_plain``.

Kernel notes (in full in the sources): they replace
``tpu3d/ops/interpolate.py::_three_nn_pallas``, ``_ti_fwd_kernel`` and
``_ti_bwd_kernel``. ``three_nn`` is bound by operations; one thread per
query folds the known points, staged through shared memory, into a sorted
top-3 with d² rounded step by step, so it equals the plain version bit for
bit. The interpolation kernels are bound by bytes; one warp per output row
reads each gathered row as whole 128-byte lines in f32, and the backward
adds the weighted gradient rows into the source rows with float atomics.
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


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """(B, M, 3) queries, (B, N, 3) known points, f32 -> (d2 (B, M, 3) f32,
    idx (B, M, 3) i32): each query's 3 nearest known points, nearest first,
    ties to the lowest index, with d² as ``_three_nn_pallas`` returns it
    (tpu3d's ``three_nn`` returns sqrt(max(d², 0))). The CUDA kernel needs
    N >= 3."""
    if unknown.device.type == "cpu":
        return three_nn_plain(unknown, known)
    _build.check_cuda_tensor(unknown, "unknown", torch.float32, 3)
    _build.check_cuda_tensor(known, "known", torch.float32, 3)
    B, M, three = unknown.shape
    if three != 3 or known.shape[0] != B or known.shape[2] != 3 \
            or known.shape[1] < 3:
        raise ValueError(f"three_nn takes (B, M, 3) queries and (B, N>=3, 3) "
                         f"known points, got {tuple(unknown.shape)} and "
                         f"{tuple(known.shape)}")
    nn_d2 = torch.empty(B, M, 3, dtype=torch.float32, device=unknown.device)
    nn_idx = torch.empty(B, M, 3, dtype=torch.int32, device=unknown.device)
    _build.launch("three_nn", unknown.data_ptr(), known.data_ptr(), B, M,
                  known.shape[1], nn_d2.data_ptr(), nn_idx.data_ptr())
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
    weighted gradient rows into the source rows, and each neighbour's dot
    product with the gradient -> (d_features (B, N, C), d_weight (B, M, 3)
    or None)."""
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
    d_features = torch.zeros(B, N, C, dtype=torch.float32,
                             device=features.device)
    d_weight = (torch.empty(B, M, 3, dtype=torch.float32,
                            device=features.device) if need_weight else None)
    _build.launch("three_interpolate_bwd", features.data_ptr(),
                  idx.data_ptr(), weight.data_ptr(), grad.data_ptr(), B, N,
                  M, C, d_features.data_ptr(),
                  d_weight.data_ptr() if need_weight else None)
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
