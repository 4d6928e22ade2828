"""Fused grouped gather + two-layer MLP + max-pool, the RCNN's no-BN set
abstraction at eval.

Counterpart of ``tpu3d/ops/fused_sa.py::fused_gathered_mlp_pool`` with
``train=False``. ``fused_gathered_mlp_pool`` launches the CUDA kernel in
``csrc/fused_sa.cu`` for CUDA tensors and runs
``fused_gathered_mlp_pool_plain`` for CPU tensors. Both compute in f32 (the
TPU kernel rounds to bf16 at its layer boundaries), so they are held to
tpu3d's CPU path, which is f32 too.

Kernel note (in full in the source): it replaces
``tpu3d/ops/fused_sa.py::_nobn2_eval_kernel``. The two Dense layers make it
bound by operations; one block per (row, center) gathers its S x C1 slab
into shared memory, so the slab never reaches device memory, and runs both
layers and the max-pool there, with the weights streamed through shared
memory in slices that the block's eight warps share.
"""

from __future__ import annotations

import torch

from . import _build
from .grouping import group_points


def fused_gathered_mlp_pool_plain(pre, idx, center, w1, b1, w2, b2):
    """Plain PyTorch version of the kernel: the grouped slab made in full,
    a chunk of rows at a time so that each intermediate stays near 64 MB."""
    R, M, S = idx.shape
    chunk = max(1, (1 << 24) // (M * S * max(w1.shape[1], w2.shape[1])))
    outs = []
    for r0 in range(0, R, chunk):
        rows = slice(r0, r0 + chunk)
        x0 = group_points(pre[rows], idx[rows]) - center[rows][:, :, None, :]
        x1 = torch.relu(x0) @ w1 + b1
        x2 = torch.relu(x1) @ w2 + b2
        outs.append(torch.relu(x2).amax(dim=2))
    return torch.cat(outs)


def fused_gathered_mlp_pool(pre: torch.Tensor, idx: torch.Tensor,
                            center: torch.Tensor, w1: torch.Tensor,
                            b1: torch.Tensor, w2: torch.Tensor,
                            b2: torch.Tensor) -> torch.Tensor:
    """pre (R, N, C1) per-point layer-0 pre-activations, idx (R, M, S) i32
    group ids into N, center (R, M, C1) per-center term, w1 (C1, C2), b1
    (C2,), w2 (C2, C3), b2 (C3,) -> (R, M, C3):
        max_s ReLU(ReLU(ReLU(pre[idx] - center) @ w1 + b1) @ w2 + b2).

    The CUDA kernel takes f32 tensors with S in (16, 32, 64), C1 a multiple
    of 4 up to 256, C2 and C3 each 128 or 256, R <= 65535, and ids in
    [0, N) (an id outside stops the kernel with a device fault); a CUDA
    tensor outside that raises.
    """
    if pre.device.type == "cpu":
        return fused_gathered_mlp_pool_plain(pre, idx, center, w1, b1, w2, b2)
    for t, name, ndim in ((pre, "pre", 3), (center, "center", 3),
                          (w1, "w1", 2), (b1, "b1", 1), (w2, "w2", 2),
                          (b2, "b2", 1)):
        _build.check_cuda_tensor(t, name, torch.float32, ndim)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _build.check_cuda_tensor(idx, "idx", torch.int32, 3)
    R, N, C1 = pre.shape
    M, S = idx.shape[1], idx.shape[2]
    C2, C3 = w1.shape[1], w2.shape[1]
    if (idx.shape[0] != R or center.shape != (R, M, C1)
            or w1.shape[0] != C1 or b1.shape != (C2,)
            or w2.shape[0] != C2 or b2.shape != (C3,)):
        raise ValueError(
            f"fused_sa shapes disagree: pre {tuple(pre.shape)}, idx "
            f"{tuple(idx.shape)}, center {tuple(center.shape)}, w1 "
            f"{tuple(w1.shape)}, b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, "
            f"b2 {tuple(b2.shape)}")
    if (S not in (16, 32, 64) or C1 % 4 or not 4 <= C1 <= 256
            or C2 not in (128, 256) or C3 not in (128, 256) or R > 65535):
        raise ValueError(
            f"fused_sa takes S in (16, 32, 64), C1 % 4 == 0 and C1 <= 256, "
            f"C2 and C3 in (128, 256), R <= 65535; got R={R}, S={S}, "
            f"C1={C1}, C2={C2}, C3={C3}")
    out = torch.empty(R, M, C3, dtype=torch.float32, device=pre.device)
    _build.launch("fused_sa", pre.data_ptr(), idx.data_ptr(),
                  center.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                  w2.data_ptr(), b2.data_ptr(), R, N, M, S, C1, C2, C3,
                  out.data_ptr())
    return out
