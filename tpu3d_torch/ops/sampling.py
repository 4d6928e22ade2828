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
rows): one thread-block cluster of k CTAs per scene, each CTA a slice of
the cloud in registers; per pick every warp sends its winner into every
CTA's shared memory (st.async, counted by an mbarrier), with no
cluster-wide barrier; ``fps_geometry`` chooses (k, threads, points per
thread) from (B, N). The top-3 runs as a separate parallel kernel. ``fps.cu`` replaces ``_fps_pallas`` (the RCNN's many
short rows): one warp per row, one shuffle argmax per pick, no block
barrier.
"""

from __future__ import annotations

import ctypes
import math

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


# The pick loop's launch geometry (csrc/fps3nn.cu), from one sweep on an
# H100 (PERF.md): a pick costs least with about FPS_SCENE_THREADS threads
# per scene in CTAs of FPS_CTA_THREADS (k · warps = 32 partials per pick,
# one per lane of the reading warp) and up to 16 points per thread; a level
# of up to FPS_ONE_CTA_N points runs on one CTA of up to 256 threads. k
# halves (and the CTA doubles) while B·k would pass the SMs or k the
# largest cluster. The kernel is compiled for at most FPS_PPT_THREADS[ppt]
# threads (its registers).
FPS_MAX_CLUSTER = 16
FPS_SCENE_THREADS = 1024
FPS_CTA_THREADS = 128
FPS_ONE_CTA_N = 1024
FPS_PPT = (1, 2, 4, 8, 16)
FPS_PPT_THREADS = {1: 1024, 2: 1024, 4: 1024, 8: 512, 16: 256}
H100_SMS = 132


def _warps(n: int) -> int:
    return 32 * math.ceil(n / 32)


def fps_geometry(B: int, N: int, max_cluster: int = FPS_MAX_CLUSTER,
                 sms: int = H100_SMS) -> tuple[int, int, int]:
    """(k, threads, ppt) of the pick loop for B scenes of N points: k CTAs
    per scene (a power of 2 up to ``max_cluster``), ``threads`` per CTA
    (whole warps) and ``ppt`` points per thread, k · threads · ppt >= N."""
    if not 1 <= N <= 32768 or B < 1:
        raise ValueError(f"the FPS pick loop takes 1 <= N <= 32768 and B >= "
                         f"1, got B={B}, N={N}")
    if N <= FPS_ONE_CTA_N:
        ppt = next(p for p in FPS_PPT if _warps(math.ceil(N / p)) <= 256)
        return 1, _warps(math.ceil(N / ppt)), ppt
    ppt = next((p for p in FPS_PPT if FPS_SCENE_THREADS * p >= N), 16)
    total = _warps(math.ceil(N / ppt))  # threads per scene
    threads = min(FPS_CTA_THREADS, total)
    k = 1 << math.ceil(math.log2(math.ceil(total / threads)))
    while (k > 1 and (k > max_cluster or B * k > sms)
           and 2 * threads <= FPS_PPT_THREADS[ppt]):
        k //= 2
        threads *= 2
    if k > max_cluster:
        raise ValueError(f"N={N} needs clusters of {k} CTAs, more than "
                         f"{max_cluster}")
    return k, threads, ppt


_cluster_ok: dict[tuple[int, int, int], bool] = {}


def card_takes(geometry: tuple[int, int, int]) -> bool:
    """Whether this card runs the pick loop's clusters of this (k, threads,
    ppt): clusters of up to 8 always; 16 only with the non-portable size
    and at least one active cluster (``tpu3d_fps_cluster_ok``)."""
    if geometry[0] <= 8:
        return True
    if geometry not in _cluster_ok:
        fn = _build.library("fps3nn").tpu3d_fps_cluster_ok
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
        _cluster_ok[geometry] = bool(fn(*geometry))
    return _cluster_ok[geometry]


def card_geometry(B: int, N: int) -> tuple[int, int, int]:
    """``fps_geometry`` for this card: its SM count, and clusters of 16 only
    where it takes them (``card_takes``), else of up to 8."""
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    geom = fps_geometry(B, N, sms=sms)
    if not card_takes(geom):
        geom = fps_geometry(B, N, max_cluster=8, sms=sms)
    return geom


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
    route) the long-row FPS of ``fps3nn.cu`` on ``card_geometry``'s
    (k, threads, ppt); anything else raises.
    """
    if xyz.device.type == "cpu":
        return furthest_point_sample_plain(xyz, npoint)
    _build.check_cuda_tensor(xyz, "xyz", torch.float32, 3)
    R, N, three = xyz.shape
    if three != 3 or not 1 <= npoint <= N or N > 32768:
        raise ValueError(f"fps takes (R, N<=32768, 3) and 1 <= npoint <= N, "
                         f"got {tuple(xyz.shape)} and npoint={npoint}")
    idx = torch.empty(R, npoint, dtype=torch.int32, device=xyz.device)
    if N <= 2048:
        _build.launch("fps", xyz.data_ptr(), R, N, npoint, idx.data_ptr())
    else:
        _build.launch("fps_long", xyz.data_ptr(), R, N, npoint,
                      *card_geometry(R, N), idx.data_ptr())
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
    for up to 32768 points, its pick loop on ``card_geometry``'s (k,
    threads, ppt); the split route is ``fps_then_three_nn``.
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
    _build.launch("fps3nn", xyz.data_ptr(), B, N, npoint,
                  *card_geometry(B, N), idx.data_ptr(),
                  nn_d2.data_ptr(), nn_idx.data_ptr())
    return idx, nn_d2, nn_idx


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) gathered by (B, M) -> (B, M, C)."""
    return torch.gather(features, 1,
                        idx.long()[..., None].expand(-1, -1, features.shape[-1]))


def furthest_point_sample_numpy(xyz, npoint: int):
    """Host FPS oracle, (B, N, 3) -> (B, npoint) i32, in float64 when given
    it: pick 0 is point 0, each later pick the first argmax of the running
    min d²."""
    import numpy as np

    xyz = np.asarray(xyz)
    B, N, _ = xyz.shape
    out = np.zeros((B, npoint), dtype=np.int32)
    for b in range(B):
        min_dist = np.full(N, np.inf)
        last = 0
        for i in range(1, npoint):
            d = np.sum((xyz[b] - xyz[b, last]) ** 2, axis=-1)
            min_dist = np.minimum(min_dist, d)
            last = int(np.argmax(min_dist))
            out[b, i] = last
    return out
