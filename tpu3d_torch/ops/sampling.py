"""Furthest point sampling, alone or with each point's 3 nearest picks, and
gathers.

Counterpart of ``tpu3d/ops/sampling.py``. ``furthest_point_sample_with_3nn``
launches the CUDA kernel in ``csrc/fps3nn.cu`` and ``furthest_point_sample``
the one in ``csrc/fps.cu`` for a CUDA tensor; for a CPU tensor each runs
its ``*_plain`` version.

Kernel notes (in full in the sources). FPS is a chain of npoint dependent
argmax steps, so it is bound by the latency of one pick, not by bytes or
operations. ``fps3nn.cu`` replaces ``_fps3nn_pallas`` (the RPN's few long
rows): one block per scene keeps the coordinates in shared memory and the
running min in registers, with one barrier per pick, and the top-3 runs as
a separate parallel kernel. ``fps.cu`` replaces ``_fps_pallas`` (the RCNN's
many short rows): one warp per row, one shuffle argmax per pick, no block
barrier.
"""

from __future__ import annotations

import torch

from . import _build


def _d2(pts: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(x-rx)²+(y-ry)²+(z-rz)², summed left to right as the kernels do."""
    d = pts - ref
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def furthest_point_sample_plain(xyz: torch.Tensor,
                                npoint: int) -> torch.Tensor:
    """Plain PyTorch version of both FPS kernels, one pick per loop step."""
    B, N, _ = xyz.shape
    rows = torch.arange(B, device=xyz.device)
    idx = torch.zeros(B, npoint, dtype=torch.int32, device=xyz.device)
    mind = torch.full((B, N), float("inf"), device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for j in range(1, npoint):
        mind = torch.minimum(mind, _d2(xyz, xyz[rows, last][:, None, :]))
        last = torch.argmax(mind, dim=1)  # first maximum: ties to lowest index
        idx[:, j] = last.to(torch.int32)
    return idx


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(R, N, 3) f32 -> (R, npoint) i32 FPS picks: pick 0 is point 0, each
    later pick the argmax of every point's running min d² to the picks so
    far, ties to the lowest index.

    The CUDA kernel takes rows of 1 <= npoint <= N <= 2048 points (the
    RCNN's pooled rows); a CUDA tensor outside that raises.
    """
    if xyz.device.type == "cpu":
        return furthest_point_sample_plain(xyz, npoint)
    _build.check_cuda_tensor(xyz, "xyz", torch.float32, 3)
    R, N, three = xyz.shape
    if three != 3 or not 1 <= npoint <= N or N > 2048:
        raise ValueError(f"fps takes (R, N<=2048, 3) and 1 <= npoint <= N, "
                         f"got {tuple(xyz.shape)} and npoint={npoint}")
    idx = torch.empty(R, npoint, dtype=torch.int32, device=xyz.device)
    _build.launch("fps", xyz.data_ptr(), R, N, npoint, idx.data_ptr())
    return idx


def furthest_point_sample_with_3nn_plain(xyz: torch.Tensor, npoint: int):
    """Plain PyTorch version of the kernel, one pick per loop step."""
    B = xyz.shape[0]
    rows = torch.arange(B, device=xyz.device)
    idx = furthest_point_sample_plain(xyz, npoint)
    picks = xyz[rows[:, None], idx.long()]  # (B, npoint, 3)
    nn_d2, nn_idx = [], []
    for pts in xyz.split(2048, dim=1):  # bounds the (B, chunk, npoint) block
        d2 = _d2(pts[:, :, None, :], picks[:, None, :, :])
        # stable sort: equal d² keep the earlier pick, as the kernel's strict <
        d, i = torch.sort(d2, dim=2, stable=True)
        nn_d2.append(d[..., :3])
        nn_idx.append(i[..., :3].to(torch.int32))
    return idx, torch.cat(nn_d2, 1), torch.cat(nn_idx, 1)


def furthest_point_sample_with_3nn(xyz: torch.Tensor, npoint: int):
    """(B, N, 3) f32 -> (idx (B, npoint) i32, nn_d2 (B, N, 3) f32,
    nn_idx (B, N, 3) i32).

    Pick 0 is point 0; each later pick is the argmax of every point's
    running min d² to the picks so far, ties to the lowest index. nn_d2 and
    nn_idx are each point's 3 nearest picks (positions into idx), nearest
    first, ties to the earlier pick: the FP levels' three_nn, for free.
    """
    if xyz.device.type == "cpu":
        return furthest_point_sample_with_3nn_plain(xyz, npoint)
    _build.check_cuda_tensor(xyz, "xyz", torch.float32, 3)
    B, N, three = xyz.shape
    if three != 3 or not 3 <= npoint <= N or N > 16384:
        raise ValueError(f"fps3nn takes (B, N<=16384, 3) and 3 <= npoint <= "
                         f"N, got {tuple(xyz.shape)} and npoint={npoint}")
    idx = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    nn_d2 = torch.empty(B, N, 3, dtype=torch.float32, device=xyz.device)
    nn_idx = torch.empty(B, N, 3, dtype=torch.int32, device=xyz.device)
    _build.launch("fps3nn", xyz.data_ptr(), B, N, npoint, idx.data_ptr(),
                  nn_d2.data_ptr(), nn_idx.data_ptr())
    return idx, nn_d2, nn_idx


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) gathered by (B, M) -> (B, M, C)."""
    return torch.gather(features, 1,
                        idx.long()[..., None].expand(-1, -1, features.shape[-1]))
