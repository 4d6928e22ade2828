"""The kernel clock, the recorders of the models' nearest-k and FPS calls,
and the seeded nearest-k inputs that ``chip_smoke.py`` and
``tools/compare_kernels.py`` share; the BatchNorm layers of every sign that
``chip_smoke.py`` and the card tests hold kernel 9's eval form on.

torch and the port are imported inside each function, never at import:
``compare_kernels.py`` loads this file from beside itself and then times
the ``tpu3d_torch`` of another checkout (``--root``), which need not have
it. Needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import statistics
import time


# an upper bound on the SM clock (an H100's boost clock is 1.98 GHz), so a
# spin of n cycles lasts at least n / SPIN_HZ seconds
SPIN_HZ = 2.0e9
MAX_SPIN_S = 1.0


class DeviceMs(float):
    """Device ms per call of a function (``cuda_ms``), with ``queued``: ms
    per call of calls enqueued back to back between one pair of CUDA
    events on an idle card; ``call``: the ms of one call between its own
    events on an idle stream; ``covered``: whether the device figure is the
    card's alone (else it is ``queued``)."""

    def __new__(cls, ms: float, queued: float, call: float, covered: bool):
        obj = super().__new__(cls, ms)
        obj.queued, obj.call, obj.covered = queued, call, covered
        return obj


def cuda_ms(fn, reps: int) -> DeviceMs:
    """Time ``fn`` on the card, after a warm-up and a synchronize, three
    ways:

    - the device time: a spin kernel (``torch.cuda._sleep``) holds the card
      while the host queues ``reps`` calls between one pair of CUDA events,
      so the card runs them back to back without waiting for the host; per
      call. It is kept only if the start event is still pending once the
      last call is queued (the spin outlasted the host's work), the spin
      growing from twice the host's enqueue time up to ``MAX_SPIN_S``. A
      function that waits for the card inside (a host sync) cannot be
      covered: its device figure is then the queued one, ``covered`` False;
    - ``queued``: ``reps`` calls enqueued back to back between one pair of
      events on an idle card, divided by ``reps``: the slower of the card
      and the host's enqueue rate;
    - ``call``: the median of ``reps`` single calls, each between its own
      events on an idle stream, so it also counts the wrapper's host time
      (allocation, checks, the ctypes call) before its kernels are queued.
    """
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def timed(spin_s):
        """ms per call of ``reps`` calls between the events, after a spin
        of ``spin_s`` seconds; whether the spin outlasted the queueing."""
        if spin_s:
            torch.cuda._sleep(int(spin_s * SPIN_HZ))
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        host_s = time.perf_counter() - t0
        covered = not start.query()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, host_s, covered

    queued, host_s, _ = timed(0.0)
    device, covered = queued, False
    spin_s = 2 * host_s + 1e-3
    while spin_s <= MAX_SPIN_S:
        ms, host_s, covered = timed(spin_s)
        if covered:
            device = ms
            break
        spin_s = 4 * max(spin_s, host_s)
    calls = []
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        calls.append(start.elapsed_time(end))
    return DeviceMs(device, queued, statistics.median(calls), covered)


def split_ms(fn, reps: int = 3) -> dict:
    """One call of ``fn`` split by launch: torch.profiler's device time
    per kernel (its ``__global__`` name, read as ``parse_trace.py`` reads
    a trace: torch's own under ``at::``) and per memcpy / memset, and the
    host's waits on the card (``aten::_local_scalar_dense``: a tensor read
    on the host), each in ms per call over ``reps`` calls from an idle
    card after a warm-up -> {name: [ms per call, launches per call]}."""
    import importlib.util
    import os
    import tempfile
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    spec = importlib.util.spec_from_file_location(
        "parse_trace", Path(__file__).with_name("parse_trace.py"))
    pt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pt)
    fn()
    torch.cuda.synchronize()
    # a warm-up step the profiler discards, then ``reps`` calls, each from
    # an idle card (so a host read waits for this call's work alone)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                  active=reps,
                                                  repeat=1)) as prof:
        for _ in range(reps + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        ops = pt.load_device_ops(path)
    finally:
        os.unlink(path)
    out = {}
    for cat, name, us, n in ops:
        base, torch_own = pt.kernel_base(name) if cat == "kernel" else (
            cat, False)
        key = f"torch {base}" if torch_own else base
        ms, k = out.get(key, (0.0, 0.0))
        out[key] = [ms + us / 1e3 / reps, k + n / reps]
    waits = [e for e in prof.events() if e.name == "aten::_local_scalar_dense"]
    if waits:
        out["host read"] = [sum(e.cpu_time_total for e in waits) / 1e3 / reps,
                            len(waits) / reps]
    return out


@contextlib.contextmanager
def record_nearest_k():
    """Records every nearest_k call the models make while open, as
    (centers, pts, k, max_radius, with_coords, result); the calls still
    run (and count) as they would. It rebinds ``nearest_k`` in
    ``ops/grouping.py`` and ``models/pointnet2.py``, its callers."""
    from tpu3d_torch.models import pointnet2
    from tpu3d_torch.ops import grouping

    calls, real = [], grouping.nearest_k

    def recording(centers, pts, k, max_radius=None, **kw):
        out = real(centers, pts, k, max_radius=max_radius, **kw)
        calls.append((centers, pts, k, max_radius,
                      kw.get("with_coords", False), out))
        return out

    grouping.nearest_k = pointnet2.nearest_k = recording
    try:
        yield calls
    finally:
        grouping.nearest_k = pointnet2.nearest_k = real


@contextlib.contextmanager
def record_fps():
    """Records every ``furthest_point_sample`` call the models make while
    open, as (xyz, npoint, result); the calls still run (and count) as
    they would. It rebinds the name in ``ops/sampling.py`` (the split
    route of FPS+3NN) and ``models/pointnet2.py`` (the RCNN's SA levels),
    its callers."""
    from tpu3d_torch.models import pointnet2
    from tpu3d_torch.ops import sampling

    calls, real = [], sampling.furthest_point_sample

    def recording(xyz, npoint):
        out = real(xyz, npoint)
        calls.append((xyz, npoint, out))
        return out

    sampling.furthest_point_sample = pointnet2.furthest_point_sample = \
        recording
    try:
        yield calls
    finally:
        sampling.furthest_point_sample = pointnet2.furthest_point_sample = \
            real


def fps_pyramid(x, npoints):
    """The FPS pyramid of ``x``: [x, its level-1 picks, ...]."""
    import torch

    from tpu3d_torch.ops import furthest_point_sample

    out = [x]
    for n in npoints:
        idx = furthest_point_sample(out[-1], n).long()
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        out.append(out[-1][rows, idx].contiguous())
    return out


def dense_inputs(g):
    """default.yaml's six eval shapes on dense clouds (16384 points in 8 x
    4 x 8 m, pooled ROIs of 512 points in a 0.6 m cube), where every center
    has at least k points within its radius: [(centers, pts, k, radius)]."""
    import torch

    lo = torch.tensor([-4.0, -1.0, 0.0], device="cuda")
    x = lo + torch.rand(2, 16384, 3, generator=g, device="cuda") * \
        torch.tensor([8.0, 4.0, 8.0], device="cuda")
    rpn = fps_pyramid(x, (4096, 1024, 256, 64))
    rows = (torch.rand(200, 512, 3, generator=g, device="cuda") - 0.5) * 0.6
    rcnn = fps_pyramid(rows, (128, 32))
    return ([(rpn[i + 1], rpn[i], 32, r)
             for i, r in enumerate((0.5, 1.0, 2.0, 4.0))]
            + [(rcnn[1], rcnn[0], 64, 0.2), (rcnn[2], rcnn[1], 64, 0.4)])


def bn_eval_layers(g, widths):
    """Three BatchNorm layers for kernel 9's eval form, drawn from the
    card generator ``g``: gammas of both signs (a quarter negative) with
    some exactly +0 and -0, betas, running (mean, var), so that each
    folded mul is positive, negative or zero -> (gammas, betas, stats)."""
    import torch

    gammas, betas, stats = [], [], []
    for c in widths:
        u = torch.rand(c, generator=g, device=g.device)
        gamma = (0.5 + torch.rand(c, generator=g, device=g.device)) * \
            torch.where(u < 0.25, -1.0, 1.0)
        gamma[::9] = 0.0
        gamma[4::13] = -0.0
        gammas.append(gamma)
        betas.append(0.2 * torch.randn(c, generator=g, device=g.device))
        stats.append((0.2 * torch.randn(c, generator=g, device=g.device),
                      0.5 + torch.rand(c, generator=g, device=g.device)))
    return gammas, betas, stats
