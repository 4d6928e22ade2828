"""Furthest point sampling, alone or with each point's 3 nearest picks, and
gathers.

Counterpart of ``tpu3d/ops/sampling.py``. ``furthest_point_sample_with_3nn``
takes tpu3d's route for the shape (``fused_route``): the fused FPS+3NN
kernel in ``csrc/fps3nn.cu``, or FPS, a gather and the standalone
``three_nn``. ``furthest_point_sample`` launches ``csrc/fps.cu`` for rows
of up to 2048 points and the long-row FPS in ``csrc/fps3nn.cu`` for up to
32768. For a CPU tensor each kernel's ``*_plain`` version runs instead.

Kernel notes (in full in the sources). FPS is a chain of npoint dependent
argmax steps, so it is bound by the latency of one pick, not by bytes or
operations. ``fps3nn.cu`` replaces ``_fps3nn_pallas`` (the RPN's few long
rows): one block per scene keeps the coordinates in shared memory and the
running min in registers, with one barrier per pick, and the top-3 runs as
a separate parallel kernel; above 16384 points a 2-CTA cluster per scene
splits the cloud and meets at one cluster barrier per pick. ``fps.cu``
replaces ``_fps_pallas`` (the RCNN's many short rows): one warp per row,
one shuffle argmax per pick, no block barrier.
"""

from __future__ import annotations

import torch

from . import _build
from .interpolate import _d2, three_nn, three_nn_plain

# tpu3d's fused FPS+3NN keeps ~16 (B, N) f32 arrays in the TPU's VMEM and
# takes the fused route only below this many bytes (sampling.py:163)
_FUSED_VMEM_BYTES = 28 * 1024 * 1024


def fused_route(B: int, N: int, npoint: int) -> bool:
    """Whether ``furthest_point_sample_with_3nn`` takes the fused FPS+3NN
    route at this shape, else FPS, a gather and a standalone three_nn.

    This mirrors tpu3d's route (``tpu3d/ops/sampling.py:163-166``: its
    fused Pallas kernel needs the batch's state in VMEM, N a multiple of
    128 of at least 256, and npoint >= 3), not a limit of the card, so that
    both packages take the same route at every shape: a 16-scene batch of
    32768 points takes the split route at SA_0."""
    return (B * N * 4 * 16 < _FUSED_VMEM_BYTES and N % 128 == 0 and N >= 256
            and npoint >= 3)


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

    For a CUDA tensor, rows of up to 2048 points (the RCNN's pooled rows)
    take ``fps.cu``, rows of up to 32768 (the RPN's SA_0 on the split
    route) the long-row FPS of ``fps3nn.cu``; anything else raises.
    """
    if xyz.device.type == "cpu":
        return furthest_point_sample_plain(xyz, npoint)
    _build.check_cuda_tensor(xyz, "xyz", torch.float32, 3)
    R, N, three = xyz.shape
    if three != 3 or not 1 <= npoint <= N or N > 32768:
        raise ValueError(f"fps takes (R, N<=32768, 3) and 1 <= npoint <= N, "
                         f"got {tuple(xyz.shape)} and npoint={npoint}")
    idx = torch.empty(R, npoint, dtype=torch.int32, device=xyz.device)
    _build.launch("fps" if N <= 2048 else "fps_long", xyz.data_ptr(), R, N,
                  npoint, idx.data_ptr())
    return idx


def furthest_point_sample_with_3nn_plain(xyz: torch.Tensor, npoint: int):
    """Plain PyTorch version of the fused kernel: FPS, then each point's 3
    nearest picks by a stable sort (equal d² keep the earlier pick, as the
    kernel's strict <)."""
    idx = furthest_point_sample_plain(xyz, npoint)
    return (idx, *three_nn_plain(xyz, gather_points(xyz, idx)))


def fps_then_three_nn(xyz: torch.Tensor, npoint: int):
    """The split route of ``furthest_point_sample_with_3nn``, tpu3d's
    ``sampling.py:168-173``: FPS, a gather, ``three_nn`` of every point to
    the picks, and nn_d2 = dist · dist with dist = sqrt(max(d², 0)) (the
    square of tpu3d's rounded distance, not the kernel's d²)."""
    idx = furthest_point_sample(xyz, npoint)
    d2, nn_idx = three_nn(xyz, gather_points(xyz, idx))
    dist = _sqrt_rn(d2.clamp(min=0.0))
    return idx, dist * dist, nn_idx


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root of x >= 0, the same bits
    on every device: PyTorch's float32 sqrt is not correctly rounded on
    every device, and the card and the CPU differ. The float64 root rounded
    to float32 is within an ulp; one step then moves it into the rounding
    interval of sqrt(x), bounded by the midpoints to its neighbours, whose
    squares are exact in float64. A float64 x takes torch.sqrt."""
    if x.dtype == torch.float64:
        return torch.sqrt(x)
    wide = x.double()
    r = torch.sqrt(wide).to(x.dtype)
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    down = torch.nextafter(r, torch.zeros_like(r))

    def mid_sq(a, b):
        return ((a.double() + b.double()) / 2) ** 2

    return torch.where(wide >= mid_sq(r, up), up,
                       torch.where(wide < mid_sq(down, r), down, r))


def furthest_point_sample_with_3nn(xyz: torch.Tensor, npoint: int):
    """(B, N, 3) f32 -> (idx (B, npoint) i32, nn_d2 (B, N, 3) f32,
    nn_idx (B, N, 3) i32).

    Pick 0 is point 0; each later pick is the argmax of every point's
    running min d² to the picks so far, ties to the lowest index. nn_d2 and
    nn_idx are each point's 3 nearest picks (positions into idx), nearest
    first, ties to the earlier pick: the FP levels' three_nn.

    The fused route (``fused_route``) takes them from the FPS+3NN kernel,
    for up to 32768 points; the split route is ``fps_then_three_nn``.
    """
    B, N, _ = xyz.shape
    if not fused_route(B, N, npoint):
        return fps_then_three_nn(xyz, npoint)
    if xyz.device.type == "cpu":
        return furthest_point_sample_with_3nn_plain(xyz, npoint)
    _build.check_cuda_tensor(xyz, "xyz", torch.float32, 3)
    if xyz.shape[2] != 3 or N > 32768 or npoint > N:
        raise ValueError(f"fps3nn takes (B, N<=32768, 3) and npoint <= N, "
                         f"got {tuple(xyz.shape)} and npoint={npoint}")
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
