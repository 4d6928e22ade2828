"""Three-point interpolation for feature propagation.

Counterpart of ``tpu3d/ops/interpolate.py``. ``three_interpolate`` launches
the CUDA kernel in ``csrc/three_interpolate.cu`` for CUDA tensors and runs
``three_interpolate_plain`` for CPU tensors. The 3 neighbours come from
``furthest_point_sample_with_3nn``'s cache, so no standalone three_nn is
needed on this path.

Kernel note (in full in the source): it replaces
``tpu3d/ops/interpolate.py::_ti_fwd_kernel``. The gather-and-sum is bound
by bytes; one warp per output row reads each gathered row as whole
128-byte lines with 16-byte loads, in f32.
"""

from __future__ import annotations

import torch

from . import _build


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


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """(B, N, C) f32 features, (B, M, 3) i32 idx, (B, M, 3) f32 weights ->
    (B, M, C): out[m] = Σ_j weight[m, j] · features[idx[m, j]]."""
    if features.device.type == "cpu":
        return three_interpolate_plain(features, idx, weight)
    _build.check_cuda_tensor(features, "features", torch.float32, 3)
    _build.check_cuda_tensor(idx, "idx", torch.int32, 3)
    _build.check_cuda_tensor(weight, "weight", torch.float32, 3)
    B, N, C = features.shape
    M = idx.shape[1]
    if idx.shape != (B, M, 3) or weight.shape != (B, M, 3):
        raise ValueError(f"three_interpolate takes idx and weight of shape "
                         f"(B, M, 3), got {tuple(idx.shape)} and "
                         f"{tuple(weight.shape)} for B={B}")
    out = torch.empty(B, M, C, dtype=torch.float32, device=features.device)
    _build.launch("three_interpolate", features.data_ptr(), idx.data_ptr(),
                  weight.data_ptr(), B, N, M, C, out.data_ptr())
    return out


def interpolation_weights(dist: torch.Tensor,
                          eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights normalised to 1 (pointnet2_modules parity)."""
    recip = 1.0 / (dist + eps)
    return recip / recip.sum(dim=-1, keepdim=True)
