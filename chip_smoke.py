#!/usr/bin/env python3
"""Drive tpu3d_torch's eval paths and its train step on one NVIDIA card
and check them.

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit code
and no result line:

1. the card's name and power limit, as nvidia-smi gives them;
2. build every CUDA kernel from tpu3d_torch/csrc (one nvcc per source, all
   at once) and print the build time and ptxas's registers and spills;
3. each kernel against its plain PyTorch version on the card, at the shapes
   its path gives it, with its time (device time: calls run back to back
   on the card behind a spin kernel that outlasts their queueing, per
   call; beside it the queued ms, calls enqueued back to back between one
   pair of CUDA events on an idle card, which reads the host's enqueue
   rate where that is slower, and the call ms,
   one call timed alone from an idle stream, which also counts the
   wrapper's host time), the plain version's time, the time of one library
   call that computes the same function where there is one, and the least
   time the card could take for the same work. The eval kernels take the
   eval paths' inputs (the RPN's levels, and the RCNN's pooled ROIs of the
   joint forward, at B=2), and again the train step's shapes (B=16, the
   1024 sampled ROIs) for the per-step figures; nearest_k takes the six
   calls recorded from the eval forward and from the train step's forward,
   the dense box's six levels (every center with at least k points within
   its radius) and double.yaml's SA_0 (B=4), each bit for bit (d², ids,
   coordinates) through its own form and through both forms, each timed
   (the sweep), with a second bound: the
   evaluations inside the depth windows of the run's data; FPS over the
   RCNN's pooled rows (fps.cu) beside its dependent-chain floor, a minimal
   pick (rows of 32 points, one warp argmax) times the level's picks; the
   training kernels the train step's (B=16: the interpolation's backward
   at the four FP levels, two calls equal to the bit and d_features equal
   to the CPU plain version's to the bit, the fused SA op's training
   forward and backward on the 1024 rows the proposal target layer
   samples);
   configs/double.yaml's SA_0 at 32768 points: the train route's long-row
   FPS (fps_long) and standalone three_nn at B=16, the eval route's
   FPS+3NN at B=4, each bit for bit; the slab form of the fused SA op at
   the RCNN's SA_1: its eval kernel (fused_sa_slab) on the pooled ROIs of
   configs/quickstart.yaml's eval (B=8) and of configs/smoke.yaml's (B=2),
   its training forward and backward (fused_sa_slab_train,
   fused_sa_slab_bwd) on the rows that the train steps' proposal target
   layer samples (quickstart B=4, smoke B=2); the same eval kernel with
   BatchNorm packs (fused_sa_slab_bn) at the RCNN's SA_0 and SA_1 of
   default.yaml with RCNN.USE_BN true (eval, B=2); and that chain's seven
   training kernels (three statistics passes, the last two writing x1 and
   x2, the final reduction, two backward waves and the elementwise pass)
   at SA_0 and SA_1 of its train step (B=16), each against its plain
   piece, then the whole training op on 128 rows against autograd of its
   plain version; every fused entry at the widened shapes (S 8, 24 and
   128, widths 256, 384 and 512) against its plain version. The gather
   backward (fused_sa_bwd) runs
   twice per level: under the seeded routing (the plain forward's argmax;
   reached slots, tiles and TFLOP/s over the reached slots printed) and
   under full spread (every channel live at a slot drawn uniformly over S,
   against its routed plain version, the bound over every slot). FPS's
   pick loop at every level it serves on each path (default, double,
   quickstart and smoke, eval and train): the geometry (k CTAs per
   cluster, threads, points per thread) it chooses and its neighbours,
   each bit for bit, in us per pick; the 3-NN pass as FPS+3NN less the
   picks alone; and the dependent-chain floor, one point per thread;
4. both eval paths at configs/default.yaml's full width (B=2 scenes of
   16384 points, NPOINTS 4096/1024/256/64, TEST pre/post-NMS 9000/100),
   with seeded weights and planted-cluster scenes, each with every launch
   count set to 0 just before it and read just after: the RPN-only path
   (make_rpn_infer_step, RCNN off) must launch its three kernels, the joint
   path (make_infer_step, as shipped: 200 ROIs of 512 points, RCNN SA
   128/32/GroupAll, score threshold and rotated final NMS) all five; shapes,
   finite values, some valid rois and some final boxes; ms per batch. In
   this run of every path driven (phases 4, 5 and 7-11), each nearest_k
   call is recorded and its d², ids and coordinates held to the plain
   version on its inputs, bit for bit, and so is each fps call's picks;
5. the train step (make_train_step) at the same full width in joint mode,
   B=16 scenes with their gt boxes (TRAIN pre/post-NMS 9000/512, 64 ROIs
   of 512 points per scene, jitter and augmentation on): one warm-up step,
   then five timed, the counts set to 0 just before the first timed step
   and read just after, which must launch the seven kernels of the path;
   loss and grad_norm finite and every parameter changed; ms per step and
   peak device memory; then one step in rpn mode, checked the same way;
6. scene 0 through the plain path on the CPU: the RPN's FPS picks of every
   level must be equal and rpn_cls / rpn_reg close; then the RCNN stage,
   fed the card's rois, backbone outputs and scores: the pooled points, the
   refinement outputs and the final boxes must agree with the card's; then
   the training: the RCNN loss and rcnn_net gradients on the card's
   sampled targets of scene 0, and the RPN's train-mode loss and gradients
   of scene 0 with dropout 0, each against the CPU plain path (the RPN's
   against a noise floor taken over four nudges of the weights);
7. configs/double.yaml as shipped (32768 points per scene, the RPN's
   widths of default.yaml): the joint eval path at B=4, which must launch
   the five eval kernels (fps3nn once per RPN level, SA_0's through its
   long-row FPS) and neither three_nn nor fps_long; then the joint train
   step at B=16 (1 warm-up, 3 timed), whose SA_0 takes the split route and
   must launch three_nn and fps_long once per step beside the seven kernels
   of phase 5; then scene 0's SA_0 split route on the card against the CPU
   plain route, bit for bit;
8. configs/quickstart.yaml as shipped (4096 points, RCNN SA_1 on the slab
   route, RPN SA_3 on the split route): the joint eval path at B=8 (the
   eval CLI's default batch) and the joint train step at B=4 (the README
   quickstart's batch; 1 warm-up, 5 timed), each with its exact launch
   counts (QUICK_EVAL, QUICK_TRAIN); then scene 0 against the CPU plain
   path: the RCNN stage and the final boxes, and the RCNN's training
   gradients on the card's sampled targets;
9. configs/smoke.yaml as shipped: the joint eval path and the joint train
   step at B=2, with their exact launch counts (SMOKE_EVAL, SMOKE_TRAIN);
10. default.yaml with RCNN.USE_BN true, set in memory (no file in configs/
   sets it), seeded weights with BatchNorm statistics away from 0 and 1:
   the joint eval path at B=2, with its exact launch counts (BN_EVAL:
   fused_sa_slab_bn at SA_0 and SA_1, no fused_sa); then scene 0's RCNN
   stage and final boxes against the CPU plain path;
11. the same config in training: the joint train step at B=16 (1 warm-up,
   3 timed), with its exact launch counts (default's train step without
   the gather form's training pair, and each of the seven BatchNorm
   training kernels twice); ms per step and peak device memory; one more
   step, after which each RCNN SA level's running statistics must equal
   m·old + (1 − m)·(the batch statistics the op returned); then scene 0's
   RCNN loss and gradients against the CPU plain path, under a noise floor
   measured there;
12. the widened RCNN: default.yaml with the RCNN's SA_0 at NSAMPLE 128 and
   MLPs 256 -> 384 -> 256 and 256 -> 256 -> 384, set in memory, without
   and with BatchNorm: the joint eval path and a joint train step at B=2,
   each of whose fused kernels must launch once per RCNN level;
13. one JSON line of the kernels, then the result line.

Every phase prints its seconds. Needs one CUDA card; the kernels have no
CPU mode. Imports nothing of JAX or of tpu3d.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0  # scenes, weights and interpolation features
BATCH = 2
TRAIN_BATCH = 16  # the training CLI's default --batch_size
DOUBLE_BATCH = 4  # configs/double.yaml's eval batch (BASELINE.md)
QUICK_EVAL_BATCH = 8  # the eval CLI's default --batch_size
QUICK_TRAIN_BATCH = 4  # the README quickstart's --batch_size
SMOKE_BATCH = 2
BN_BATCH = 2  # the default.yaml eval batch
DEVICE = "cuda"  # the card
BN_CHECK_ROWS = 128  # rows of the whole BatchNorm training op's check

# H100 SXM peaks from NVIDIA's data sheet, at the full 700 W: device memory
# rate and float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

SOURCES = {  # kernel: (source, the TPU kernel it replaces)
    "fps3nn": ("tpu3d_torch/csrc/fps3nn.cu", "tpu3d/ops/sampling.py:176"),
    "nearest_k": ("tpu3d_torch/csrc/nearest_k.cu", "tpu3d/ops/grouping.py:80"),
    "three_interpolate": ("tpu3d_torch/csrc/three_interpolate.cu",
                          "tpu3d/ops/interpolate.py:262"),
    "fps": ("tpu3d_torch/csrc/fps.cu", "tpu3d/ops/sampling.py:73"),
    "fused_sa": ("tpu3d_torch/csrc/fused_sa.cu", "tpu3d/ops/fused_sa.py:771"),
    "three_interpolate_bwd": ("tpu3d_torch/csrc/three_interpolate_bwd.cu",
                              "tpu3d/ops/interpolate.py:276"),
    "fused_sa_train": ("tpu3d_torch/csrc/fused_sa.cu",
                       "tpu3d/ops/fused_sa.py:752"),
    "fused_sa_bwd": ("tpu3d_torch/csrc/fused_sa_bwd.cu",
                     "tpu3d/ops/fused_sa.py:782"),
    "three_nn": ("tpu3d_torch/csrc/three_nn.cu", "tpu3d/ops/interpolate.py:62"),
    "fps_long": ("tpu3d_torch/csrc/fps3nn.cu", "tpu3d/ops/sampling.py:73"),
    "fused_sa_slab": ("tpu3d_torch/csrc/fused_sa.cu",
                      "tpu3d/ops/fused_sa.py:594"),
    "fused_sa_slab_train": ("tpu3d_torch/csrc/fused_sa.cu",
                            "tpu3d/ops/fused_sa.py:575"),
    "fused_sa_slab_bwd": ("tpu3d_torch/csrc/fused_sa_bwd.cu",
                          "tpu3d/ops/fused_sa.py:604"),
    "fused_sa_slab_bn": ("tpu3d_torch/csrc/fused_sa.cu",
                         "tpu3d/ops/fused_sa.py:203"),
    "fused_sa_bn_stats0": ("tpu3d_torch/csrc/fused_sa_bn.cu",
                           "tpu3d/ops/fused_sa.py:158"),
    "fused_sa_bn_stats1": ("tpu3d_torch/csrc/fused_sa_bn.cu",
                           "tpu3d/ops/fused_sa.py:164"),
    "fused_sa_bn_stats2": ("tpu3d_torch/csrc/fused_sa_bn.cu",
                           "tpu3d/ops/fused_sa.py:171"),
    "fused_sa_bn_final": ("tpu3d_torch/csrc/fused_sa.cu",
                          "tpu3d/ops/fused_sa.py:178"),
    "fused_sa_bn_wave1": ("tpu3d_torch/csrc/fused_sa_bn.cu",
                          "tpu3d/ops/fused_sa.py:255"),
    "fused_sa_bn_wave2": ("tpu3d_torch/csrc/fused_sa_bn.cu",
                          "tpu3d/ops/fused_sa.py:272"),
    "fused_sa_bn_apply": ("tpu3d_torch/csrc/fused_sa_bn.cu",
                          "tpu3d/ops/fused_sa.py:291"),
}
# the BatchNorm chain's training kernels, in the order the step runs them
BN_TRAIN_KERNELS = ("fused_sa_bn_stats0", "fused_sa_bn_stats1",
                    "fused_sa_bn_stats2", "fused_sa_bn_final",
                    "fused_sa_bn_wave1", "fused_sa_bn_wave2",
                    "fused_sa_bn_apply")
# the kernels of each path whose launches are counted
EVAL_KERNELS = ("fps3nn", "nearest_k", "three_interpolate", "fps", "fused_sa")
TRAIN_KERNELS = ("fps3nn", "nearest_k", "three_interpolate",
                 "three_interpolate_bwd", "fps", "fused_sa_train",
                 "fused_sa_bwd")
RPN_TRAIN_KERNELS = ("fps3nn", "nearest_k", "three_interpolate",
                     "three_interpolate_bwd")
DOUBLE_TRAIN_KERNELS = TRAIN_KERNELS + ("three_nn", "fps_long")
# exact launches per forward or step of the new paths, every other count 0:
# quickstart's RPN SA_3 (64 points) and smoke's SA_2-3 take the split route
# (fps + three_nn), the RCNN's SA_0 (256 / 128 sources) the gather kernel,
# its SA_1 (64 / 32 sources) the slab kernel; with BatchNorm both RCNN
# levels take the slab kernel with BatchNorm packs
QUICK_EVAL = {"fps3nn": 3, "three_nn": 1, "fps": 3, "nearest_k": 6,
              "three_interpolate": 4, "fused_sa": 1, "fused_sa_slab": 1}
QUICK_TRAIN = {"fps3nn": 3, "three_nn": 1, "fps": 3, "nearest_k": 6,
               "three_interpolate": 4, "three_interpolate_bwd": 4,
               "fused_sa_train": 1, "fused_sa_bwd": 1,
               "fused_sa_slab_train": 1, "fused_sa_slab_bwd": 1}
SMOKE_EVAL = dict(QUICK_EVAL, fps3nn=2, three_nn=2, fps=4)
SMOKE_TRAIN = dict(QUICK_TRAIN, fps3nn=2, three_nn=2, fps=4)
BN_EVAL = {"fps3nn": 4, "nearest_k": 6, "three_interpolate": 4, "fps": 2,
           "fused_sa_slab_bn": 2}
# the paths the new kernels are timed and labelled at
QUICK_PATH = {"eval": f"quickstart.yaml eval B={QUICK_EVAL_BATCH}",
              "train": f"quickstart.yaml train B={QUICK_TRAIN_BATCH}"}
SMOKE_PATH = {"eval": f"smoke.yaml eval B={SMOKE_BATCH}",
              "train": f"smoke.yaml train B={SMOKE_BATCH}"}
BN_PATH = f"default.yaml with RCNN.USE_BN eval B={BN_BATCH}"
BN_TRAIN_PATH = f"default.yaml with RCNN.USE_BN train B={TRAIN_BATCH}"
# every other function of tpu3d that reaches pl.pallas_call, with its
# status: none, every one has its kernel
NOT_PORTED = []


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def cuda_ms(fn, reps: int):
    """Device ms per call of ``fn`` (calls run back to back on the card
    behind a spin that outlasts their queueing), with its ``queued`` and
    ``call`` ms: ``tpu3d_torch/tools/kernel_bench.py``'s clock, shared with
    ``tools/compare_kernels.py``."""
    from tpu3d_torch.tools.kernel_bench import cuda_ms as clock

    return clock(fn, reps)


def wall_ms(fn, reps: int) -> float:
    """Median host-clock time of ``fn`` ending in a synchronize."""
    import torch

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Phases:
    """Seconds of each phase, printed as it ends."""

    def __init__(self):
        self.t = time.perf_counter()

    def done(self, label: str) -> None:
        now = time.perf_counter()
        print(f"phase {label}: {now - self.t:.1f} s")
        self.t = now


def routed_slots(arg, grad, ppre, S):
    """The pooled gradients that reach the network, dval = grad where
    ppre > 0, and the slots of S they route to: -> (nnz, the non-zero dval;
    slots, the distinct (group, argmax slot) pairs of those channels, the
    only slots whose d_x1, and so dW1, db1 and d_x0, can be non-zero)."""
    import torch

    live = torch.where(ppre > 0, grad, 0.0) != 0
    R, M, _ = arg.shape
    groups = torch.arange(R * M, device=arg.device).view(R, M, 1)
    keys = (groups * S + arg.long())[live]
    return int(live.sum()), int(torch.unique(keys).numel())


class Report:
    """Per kernel, summed over the launch shapes of one forward (eval
    kernels) or one train step (training kernels): worst error, kernel /
    plain / library ms, the kernel's queued and call ms (``cuda_ms``),
    bytes and operations, and any other count given (``window_ops``: the
    operations of nearest_k's windowed sweep; ``chain_ms``: FPS's measured
    dependent-chain floor)."""

    def __init__(self):
        self.rows = {}

    def add(self, name, err, ms, plain_ms, lib_ms, n_bytes, n_ops, **counts):
        r = self.rows.setdefault(name, dict(err=0.0, ms=0.0, queued_ms=0.0,
                                            call_ms=0.0, plain_ms=0.0,
                                            lib_ms=0.0, bytes=0.0, ops=0.0))
        r["err"] = max(r["err"], err)
        r["ms"] += ms
        r["queued_ms"] += getattr(ms, "queued", ms)
        r["call_ms"] += getattr(ms, "call", ms)
        # a device figure that could not be separated from the host's time
        r["ms_host_bound"] = (r.get("ms_host_bound", False)
                              or not getattr(ms, "covered", True))
        r["plain_ms"] += plain_ms
        r["lib_ms"] = None if lib_ms is None else r["lib_ms"] + lib_ms
        r["bytes"] += n_bytes
        r["ops"] += n_ops
        for key, n in counts.items():
            r[key] = r.get(key, 0.0) + n

    def row(self, name):
        """The JSON fields of kernel ``name``: its times, error and
        bounds."""
        r = self.rows[name]
        b_ms, b_by = bound_ms(r["bytes"], r["ops"])
        out = {"max_abs_err": r["err"], "ms": r["ms"],
               "queued_ms": r["queued_ms"], "call_ms": r["call_ms"],
               "ms_host_bound": r["ms_host_bound"],
               "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": r["lib_ms"]}
        if "window_ops" in r:
            out["window_bound_ms"], out["window_bound_by"] = bound_ms(
                r["bytes"], r["window_ops"])
        if "chain_ms" in r:  # FPS: the measured dependent-chain floor
            out["chain_floor_ms"] = r["chain_ms"]
        if "lib_bwd_ms" in r:  # a backward: the library's backward alone
            out["library_backward_ms"] = r["lib_bwd_ms"]
            out["reached_slots"], out["slots"] = r["reached"], r["slots"]
        return out


def check_nearest_k(report, c, x, k, r, coords, label, sweep):
    """nearest_k, exact: d², ids and coordinates equal the plain version's in
    every slot, through the form the wrapper chooses and through both forms
    (each timed, into ``sweep``). Its time as
    the path calls it (with ``coords`` or not), the plain version's and
    cdist+topk's; the brute bound (M·N evaluations) and the windows' (the
    evaluations inside the depth windows of these inputs)."""
    import torch

    from tpu3d_torch.ops import nearest_k
    from tpu3d_torch.ops.grouping import (_radius2, depth_sort,
                                          depth_windows, launch_nearest_k,
                                          nearest_k_plain, nearest_k_route)

    b, m, n = c.shape[0], c.shape[1], x.shape[1]
    r2 = _radius2(r)
    got = nearest_k(c, x, k, max_radius=r, with_coords=True)
    ref = nearest_k_plain(c, x, k, max_radius=r, with_coords=True)
    torch.cuda.synchronize()
    for what, g, w in zip(("d²", "ids", "coordinates"), got, ref):
        check(torch.equal(g, w), f"nearest_k {what} differ at {label}")
    lo, hi = depth_windows(depth_sort(x)[0], c, r)
    window = int((hi - lo).sum())
    hits = int((ref[1] < n).sum())
    ms = cuda_ms(lambda: nearest_k(c, x, k, max_radius=r,
                                   with_coords=coords), 10)
    pms = cuda_ms(lambda: nearest_k_plain(c, x, k, max_radius=r,
                                          with_coords=coords), 3)
    lms = cuda_ms(lambda: torch.topk(torch.cdist(c, x), min(k, n), dim=2,
                                     largest=False), 3)
    sort_ms = cuda_ms(lambda: depth_sort(x), 10)  # the windowed form's
    times = {}
    for windowed in (True, False):
        form = "windowed" if windowed else "brute"
        g = launch_nearest_k(c, x, k, r2, windowed, True)
        check(all(torch.equal(a, w) for a, w in zip(g, ref)),
              f"nearest_k differs at {label}, {form}")
        times[form] = cuda_ms(
            lambda: launch_nearest_k(c, x, k, r2, windowed), 10)
    chosen = "windowed" if nearest_k_route(b, m, n, r2) else "brute"
    best = min(times, key=times.get)
    # per evaluation 3 sub, 3 mul, 2 add, radius compare
    nbytes = b * (m + n) * 12 + b * m * k * (20 if coords else 8)
    report.add("nearest_k", 0.0, ms, pms, lms, nbytes, b * m * n * 9,
               window_ops=window * 9)
    sweep.append({"level": label, "B": b, "M": m, "N": n, "k": k, "r": r,
                  "coords": coords, "chosen": chosen, "ms": ms,
                  "queued_ms": ms.queued, "call_ms": ms.call,
                  "covered": ms.covered,
                  "plain_ms": pms, "library_ms": lms,
                  "sort_ms": sort_ms, "window_points": window / (b * m),
                  "hits": hits / (b * m),
                  "best": best, "sweep_ms": times})
    print(f"nearest_k {label} B={b} M={m} N={n} k={k} r={r}"
          f"{' with coordinates' if coords else ''}: {ms:.4f} ms (queued "
          f"{ms.queued:.4f}, call {ms.call:.4f}) {chosen}, best {best} "
          f"{times[best]:.4f}, depth "
          f"sort {sort_ms:.4f}; plain {pms:.3f} ms, cdist+topk {lms:.3f} ms; "
          f"d², ids and coordinates "
          f"equal at every form; {window / (b * m):.1f} points per window, "
          f"{hits / (b * m):.2f} hits per center")


NK_LEVELS = ("RPN SA_0", "RPN SA_1", "RPN SA_2", "RPN SA_3", "RCNN SA_0",
             "RCNN SA_1")


def nearest_k_kernels(report, calls, path, sweep):
    """Phase 3 for nearest_k at the six levels of one path: ``calls`` as
    ``record_nearest_k`` records them, or (centers, pts, k, radius)."""
    check(len(calls) == len(NK_LEVELS),
          f"{path}: {len(calls)} nearest_k calls, expected {len(NK_LEVELS)}")
    for level, call in zip(NK_LEVELS, calls):
        c, x, k, r = call[:4]
        coords = call[4] if len(call) > 4 else level == "RPN SA_0"
        check_nearest_k(report, c, x, k, r, coords, f"{path}, {level}",
                        sweep)


def audit_nearest_k(calls, launches, label):
    """Every nearest_k call of one run of a path (``record_nearest_k``)
    against the plain version on its inputs: d², ids and, where the path
    takes them, coordinates equal. One counted launch per call."""
    import torch

    from tpu3d_torch.ops.grouping import nearest_k_plain

    check(len(calls) == launches["nearest_k"],
          f"{label}: {len(calls)} nearest_k calls, "
          f"{launches['nearest_k']} launches")
    for i, (c, x, k, r, coords, out) in enumerate(calls):
        ref = nearest_k_plain(c, x, k, max_radius=r, with_coords=coords)
        for g, w in zip(out, ref):
            check(torch.equal(g, w), f"{label}: nearest_k call {i} (B="
                  f"{c.shape[0]} M={c.shape[1]} N={x.shape[1]}) differs "
                  f"from the plain version")
    print(f"{label}: its {len(calls)} nearest_k calls equal the plain "
          f"version's to the bit")


def audit_fps(calls, launches, label):
    """Every furthest_point_sample call of one run of a path
    (``record_fps``: the RCNN's SA levels and the split route's FPS)
    against the plain version on its inputs, the picks equal. One counted
    launch of fps or fps_long per call."""
    import torch

    from tpu3d_torch.ops.sampling import furthest_point_sample_plain

    check(len(calls) == launches["fps"] + launches["fps_long"],
          f"{label}: {len(calls)} fps calls, {launches['fps']} + "
          f"{launches['fps_long']} launches")
    for i, (xyz, npoint, out) in enumerate(calls):
        check(torch.equal(out, furthest_point_sample_plain(xyz, npoint)),
              f"{label}: fps call {i} (R={xyz.shape[0]} N={xyz.shape[1]} "
              f"npoint={npoint}) differs from the plain version")
    print(f"{label}: its {len(calls)} fps calls equal the plain version's "
          f"picks")


def rpn_kernels(report, cfg, pts, path, fps3nn=True):
    """Phase 3 for the RPN's kernels, at its four SA / FP levels: FPS+3NN
    (unless ``fps3nn`` is False) and the interpolation."""
    import torch

    from tpu3d_torch.ops import (furthest_point_sample_with_3nn,
                                 gather_points, interpolation_weights,
                                 three_interpolate)
    from tpu3d_torch.ops.interpolate import three_interpolate_plain
    from tpu3d_torch.ops.sampling import furthest_point_sample_with_3nn_plain

    sa = cfg.RPN.SA_CONFIG
    B = pts.shape[0]
    levels, caches = [pts], []
    for npoint in sa.NPOINTS:
        idx, d2, nn_idx = furthest_point_sample_with_3nn(levels[-1], npoint)
        caches.append((d2, nn_idx))
        levels.append(gather_points(levels[-1], idx))
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    # FPS + 3NN, exact: same picks, same neighbours, same d² bits
    for k, npoint in enumerate(sa.NPOINTS if fps3nn else ()):
        x = levels[k]
        n = x.shape[1]
        got = furthest_point_sample_with_3nn(x, npoint)
        ref = furthest_point_sample_with_3nn_plain(x, npoint)
        torch.cuda.synchronize()
        check(torch.equal(got[0], ref[0]), f"fps3nn picks differ at N={n}")
        check(torch.equal(got[2], ref[2]), f"fps3nn nn_idx differ at N={n}")
        err = (got[1] - ref[1]).abs().max().item()
        check(err == 0.0, f"fps3nn nn_d2 differ by {err} at N={n}")
        ms = cuda_ms(lambda: furthest_point_sample_with_3nn(x, npoint), 10)
        pms = cuda_ms(lambda: furthest_point_sample_with_3nn_plain(x, npoint),
                      2)
        # FPS: per (pick, point) 3 sub, 3 mul, 2 add, min, compare; 3-NN:
        # per (point, pick) 8 for d² and 8 for the insertion network
        ops = B * (npoint - 1) * n * 10 + B * n * npoint * 16
        nbytes = B * n * 12 + B * npoint * 4 + B * n * 24
        report.add("fps3nn", err, ms, pms, None, nbytes, ops)
        print(f"fps3nn {path} N={n} npoint={npoint}: {ms:.3f} ms, plain "
              f"{pms:.3f} ms, max_abs_err {err}")

    # three-point interpolation at FP_3 .. FP_0; the plain version sums in
    # the kernel's order, so they agree to the last bit (tolerance 1e-6)
    fp_known_c = [cfg.RPN.FP_MLPS[i + 1][-1] if i + 1 < len(cfg.RPN.FP_MLPS)
                  else sum(m[-1] for m in sa.MLPS[i])
                  for i in range(len(cfg.RPN.FP_MLPS))]
    for i in range(len(cfg.RPN.FP_MLPS) - 1, -1, -1):
        d2, nn_idx = caches[i]
        n, m, ch = levels[i + 1].shape[1], levels[i].shape[1], fp_known_c[i]
        feats = torch.randn(B, n, ch, generator=gen).to(pts.device)
        w = interpolation_weights(torch.sqrt(d2.clamp(min=0.0)))
        got = three_interpolate(feats, nn_idx, w)
        ref = three_interpolate_plain(feats, nn_idx, w)
        err = (got - ref).abs().max().item()
        check(err <= 1e-6, f"three_interpolate differs by {err} at M={m}")
        ms = cuda_ms(lambda: three_interpolate(feats, nn_idx, w), 20)
        pms = cuda_ms(lambda: three_interpolate_plain(feats, nn_idx, w), 5)

        def library():
            g = torch.gather(feats, 1, nn_idx.reshape(B, m * 3, 1).long()
                             .expand(-1, -1, ch)).reshape(B, m, 3, ch)
            return (g * w[..., None]).sum(2)

        lms = cuda_ms(library, 5)
        nbytes = B * n * ch * 4 + B * m * 3 * 8 + B * m * ch * 4
        report.add("three_interpolate", err, ms, pms, lms, nbytes,
                   B * m * ch * 5)
        print(f"three_interpolate {path} N={n} M={m} C={ch}: {ms:.3f} ms, "
              f"plain {pms:.3f} ms, gather+sum {lms:.3f} ms, max_abs_err "
              f"{err}")


def fps_minimal_pick(R, device):
    """us of one minimal pick of fps.cu on R rows: rows of 32 points (one
    per lane, one warp argmax per pick), timed at 32 picks and at 2, the
    difference over the 30 picks between (picks equal the plain
    version's)."""
    import torch

    from tpu3d_torch.ops import furthest_point_sample
    from tpu3d_torch.ops.sampling import furthest_point_sample_plain

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    x = torch.rand(R, 32, 3, generator=gen, device=device) * 5.0
    check(torch.equal(furthest_point_sample(x, 32),
                      furthest_point_sample_plain(x, 32)),
          "fps picks differ at the minimal pick's rows")
    t32 = cuda_ms(lambda: furthest_point_sample(x, 32), 20)
    t2 = cuda_ms(lambda: furthest_point_sample(x, 2), 20)
    us = (t32 - t2) / 30 * 1e3
    print(f"fps minimal pick, {R} rows of 32 points: {t32:.4f} ms at 32 "
          f"picks, {t2:.4f} at 2, so {us:.4f} us per pick")
    return us


def rcnn_kernels(report, net, xyz, features, path):
    """Phase 3 for the RCNN's kernels on pooled ROIs (``xyz``): FPS at each
    single-scale level (SA_0 and SA_1; the GroupAll has no kernel), with
    its dependent-chain floor (the minimal pick, ``fps_minimal_pick``, on
    as many rows, times the level's picks), and, given the ``features``,
    the fused SA op there."""
    import torch
    import torch.nn.functional as F

    from tpu3d_torch.ops import (furthest_point_sample,
                                 fused_gathered_mlp_pool, gather_points,
                                 group_points)
    from tpu3d_torch.ops.fused_sa import fused_gathered_mlp_pool_plain
    from tpu3d_torch.ops.sampling import furthest_point_sample_plain

    R = xyz.shape[0]
    print(f"RCNN input, {path}: {R} ROIs of {xyz.shape[1]} points")
    pick_us = fps_minimal_pick(R, xyz.device)
    for k in range(net.n_sa):
        sa = getattr(net, f"sa_{k}")
        if sa.npoint is None:
            break
        n, npoint = xyz.shape[1], sa.npoint
        # FPS, exact: the same picks
        got = furthest_point_sample(xyz, npoint)
        ref = furthest_point_sample_plain(xyz, npoint)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"fps picks differ at RCNN SA_{k}")
        ms = cuda_ms(lambda: furthest_point_sample(xyz, npoint), 10)
        pms = cuda_ms(lambda: furthest_point_sample_plain(xyz, npoint), 2)
        ops = R * (npoint - 1) * n * 10
        nbytes = R * n * 12 + R * npoint * 4
        chain = pick_us * (npoint - 1) / 1e3
        report.add("fps", 0.0, ms, pms, None, nbytes, ops, chain_ms=chain)
        print(f"fps {path} RCNN SA_{k} R={R} N={n} npoint={npoint}: "
              f"{ms:.4f} ms ({ms / (npoint - 1) * 1e3:.3f} us per pick), "
              f"plain {pms:.3f} ms, chain floor {chain:.4f} ms, picks equal")
        if features is None:
            xyz = gather_points(xyz, got)
            continue

        # the fused gather + MLP + max-pool: f32 sums in another order,
        # tolerance 1e-4 of the largest value
        with torch.no_grad():
            new_xyz, pre, idx, center = sa.group_inputs(xyz, features)
            mlp = sa.mlp_0
            w1 = mlp.dense_1.weight.T.contiguous()
            w2 = mlp.dense_2.weight.T.contiguous()
            b1, b2 = mlp.dense_1.bias, mlp.dense_2.bias
            args = (pre, idx, center, w1, b1, w2, b2)
            got = fused_gathered_mlp_pool(*args)
            ref = fused_gathered_mlp_pool_plain(*args)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            check(err <= 1e-4 * scale,
                  f"fused_sa differs by {err} (max |value| {scale}) at "
                  f"RCNN SA_{k}")
            ms = cuda_ms(lambda: fused_gathered_mlp_pool(*args), 10)
            pms = cuda_ms(lambda: fused_gathered_mlp_pool_plain(*args), 3)

            def library():
                x = torch.relu(group_points(pre, idx) - center[:, :, None])
                x = torch.relu(F.linear(x, mlp.dense_1.weight, b1))
                return torch.relu(F.linear(x, mlp.dense_2.weight, b2)).amax(2)

            lms = cuda_ms(library, 3)
        M, S = idx.shape[1], idx.shape[2]
        c1, c2, c3 = w1.shape[0], w1.shape[1], w2.shape[1]
        # per slot: the two layers' multiply-adds, then sub + ReLU on C1,
        # bias + ReLU on C2, bias + ReLU + max on C3
        ops = R * M * S * (2 * (c1 * c2 + c2 * c3) + 2 * c1 + 2 * c2 + 3 * c3)
        nbytes = 4 * (pre.numel() + idx.numel() + center.numel() + w1.numel()
                      + w2.numel() + c2 + c3 + R * M * c3)
        report.add("fused_sa", err, ms, pms, lms, nbytes, ops)
        print(f"fused_sa RCNN SA_{k} R={R} N={n} M={M} S={S} "
              f"C={c1}->{c2}->{c3}: {ms:.3f} ms, plain {pms:.3f} ms, "
              f"group+linear+amax {lms:.3f} ms, max_abs_err {err:.3e} "
              f"(max |value| {scale:.3e}), "
              f"{ops / ms / 1e9:.1f} TFLOP/s")
        with torch.no_grad():
            features = got
        xyz = new_xyz


def double_kernels(report, extra, eval_pts, train_pts, npoint):
    """Phase 3 for configs/double.yaml's SA_0 (32768 points, ``npoint``
    picks), each bit for bit against its plain version: the split route's
    long-row FPS and three_nn at the train batch, and the fused route's
    FPS+3NN at the eval batch (kept apart in ``extra``: the fps3nn row of
    ``report`` is default.yaml's)."""
    import torch

    from tpu3d_torch.ops import (furthest_point_sample,
                                 furthest_point_sample_with_3nn, fused_route,
                                 gather_points, three_nn, three_nn_plain)
    from tpu3d_torch.ops.sampling import (
        furthest_point_sample_plain, furthest_point_sample_with_3nn_plain)

    B, n = train_pts.shape[:2]
    check(not fused_route(B, n, npoint), "double train SA_0 should split")
    got = furthest_point_sample(train_pts, npoint)
    ref = furthest_point_sample_plain(train_pts, npoint)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), f"fps_long picks differ at N={n}")
    ms = cuda_ms(lambda: furthest_point_sample(train_pts, npoint), 5)
    pms = cuda_ms(lambda: furthest_point_sample_plain(train_pts, npoint), 1)
    report.add("fps_long", 0.0, ms, pms, None,
               B * n * 12 + B * npoint * 4, B * (npoint - 1) * n * 10)
    print(f"fps_long B={B} N={n} npoint={npoint}: {ms:.3f} ms "
          f"({ms / (npoint - 1) * 1e3:.2f} us per pick), plain {pms:.3f} ms,"
          f" picks equal")

    known = gather_points(train_pts, got)
    got = three_nn(train_pts, known)
    ref = three_nn_plain(train_pts, known)
    torch.cuda.synchronize()
    check(torch.equal(got[1], ref[1]), f"three_nn ids differ at N={n}")
    check(torch.equal(got[0], ref[0]), f"three_nn d² differ at N={n}")
    del got, ref
    ms = cuda_ms(lambda: three_nn(train_pts, known), 10)
    pms = cuda_ms(lambda: three_nn_plain(train_pts, known), 1)
    lms = cuda_ms(lambda: torch.topk(torch.cdist(train_pts, known), 3, dim=2,
                                     largest=False), 2)
    torch.cuda.empty_cache()
    # per pair 3 sub, 3 mul, 2 add and a compare with the third nearest
    report.add("three_nn", 0.0, ms, pms, lms,
               B * n * 12 + B * npoint * 12 + B * n * 24,
               B * n * npoint * 9)
    print(f"three_nn B={B} M={n} N={npoint}: {ms:.3f} ms, plain {pms:.3f} "
          f"ms, cdist+topk {lms:.3f} ms, d² and ids equal")

    b = eval_pts.shape[0]
    check(fused_route(b, n, npoint), "double eval SA_0 should be fused")
    got = furthest_point_sample_with_3nn(eval_pts, npoint)
    ref = furthest_point_sample_with_3nn_plain(eval_pts, npoint)
    torch.cuda.synchronize()
    for name, g, r in zip(("picks", "nn_d2", "nn_idx"), got, ref):
        check(torch.equal(g, r), f"fps3nn {name} differ at N={n}")
    ms = cuda_ms(lambda: furthest_point_sample_with_3nn(eval_pts, npoint), 5)
    pms = cuda_ms(lambda: furthest_point_sample_with_3nn_plain(eval_pts,
                                                               npoint), 1)
    extra.add("fps3nn", 0.0, ms, pms, None,
              b * n * 12 + b * npoint * 4 + b * n * 24,
              b * (npoint - 1) * n * 10 + b * n * npoint * 16)
    print(f"fps3nn B={b} N={n} npoint={npoint}: {ms:.3f} ms, plain "
          f"{pms:.3f} ms, picks, nn_d2 and nn_idx equal")


def launch_picks(xyz, npoint, geometry):
    """The pick loop alone (the fps_long entry of csrc/fps3nn.cu) on
    ``geometry`` (k, threads, ppt), at any N: -> (B, npoint) picks."""
    import torch

    from tpu3d_torch.ops import _build

    B, N, _ = xyz.shape
    idx = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    _build.launch("fps_long", xyz.data_ptr(), B, N, npoint, *geometry,
                  idx.data_ptr())
    return idx


def fps_neighbours(N, geometry):
    """The chosen geometry and its neighbours: k and threads each halved,
    kept or doubled, with the fewest points per thread that cover N."""
    from tpu3d_torch.ops.sampling import FPS_PPT, FPS_PPT_THREADS, card_takes

    k, t, _ = geometry
    out = [geometry]
    for kk in (k // 2, k, 2 * k):
        for tt in (t // 2, t, 2 * t):
            if not 1 <= kk <= 16 or tt < 32:
                continue
            ppt = next((p for p in FPS_PPT if kk * tt * p >= N), None)
            if ppt is None or tt > FPS_PPT_THREADS[ppt]:
                continue
            g = (kk, tt, ppt)
            if g not in out and card_takes(g):
                out.append(g)
    return out


def fps_levels(pts, npoints):
    """The RPN's FPS levels of a batch: -> [(cloud, npoint)], each level's
    cloud the picks of the one before (either route of
    furthest_point_sample_with_3nn)."""
    from tpu3d_torch.ops import furthest_point_sample_with_3nn, gather_points

    levels, x = [], pts
    for npoint in npoints:
        levels.append((x, npoint))
        x = gather_points(x, furthest_point_sample_with_3nn(x, npoint)[0])
    return levels


def fps_pick_loop(paths):
    """Phase 3 for FPS's pick loop (csrc/fps3nn.cu) at every level it serves
    on each path of ``paths`` ({label: (points, npoints)}): the levels on
    the fused FPS+3NN route and the long-row FPS. Per level: the geometry
    card_geometry chooses, the picks alone on it (the fps_long entry) in us
    per pick, bit for bit against the plain picks, and, on the fused route,
    the 3-NN pass as the fused entry's time less the picks'; at the levels
    of 4096 points or more also the chosen geometry's neighbours (the
    sweep). Then the dependent-chain floor: default eval SA_0's cluster and
    CTA size with one point per thread (N = k · threads, every point
    picked), the cost of a pick's exchange alone. -> (levels, floor) for
    the JSON line."""
    import torch

    from tpu3d_torch.ops import furthest_point_sample_with_3nn, fused_route
    from tpu3d_torch.ops.sampling import (card_geometry,
                                          furthest_point_sample_plain)

    rows = []
    for label, (pts, npoints) in paths.items():
        for x, npoint in fps_levels(pts, npoints):
            B, N, _ = x.shape
            fused = fused_route(B, N, npoint)
            if not fused and N <= 2048:
                continue  # the split route's FPS is fps.cu
            ref = furthest_point_sample_plain(x, npoint)
            geom = card_geometry(B, N)
            sweep = []
            for g in (fps_neighbours(N, geom) if N >= 4096 else [geom]):
                got = launch_picks(x, npoint, g)
                torch.cuda.synchronize()
                check(torch.equal(got, ref), f"FPS picks differ at {label} "
                      f"N={N} on geometry {g}")
                ms = cuda_ms(lambda: launch_picks(x, npoint, g), 3)
                sweep.append({"geometry": list(g), "ms": ms,
                              "us_per_pick": ms / max(npoint - 1, 1) * 1e3})
            picks_ms = sweep[0]["ms"]
            row = {"path": label, "B": B, "N": N, "npoint": npoint,
                   "route": "fused" if fused else "split (fps_long)",
                   "geometry": list(geom), "picks_ms": picks_ms,
                   "us_per_pick": sweep[0]["us_per_pick"],
                   "sweep": sweep[1:]}
            if fused:
                f_ms = cuda_ms(
                    lambda: furthest_point_sample_with_3nn(x, npoint), 5)
                row.update(fused_ms=f_ms, three_nn_ms=f_ms - picks_ms)
            rows.append(row)
            best = min(sweep, key=lambda r: r["ms"])
            print(f"FPS pick loop {label} B={B} N={N} npoint={npoint}: "
                  f"(k, threads, ppt) = {geom}, picks {picks_ms:.3f} ms "
                  f"({row['us_per_pick']:.3f} us per pick)"
                  + (f", FPS+3NN {row['fused_ms']:.3f} ms, so 3-NN "
                     f"{row['three_nn_ms']:.3f} ms" if fused else "")
                  + f"; sweep: " + ", ".join(
                      f"{tuple(r['geometry'])} {r['us_per_pick']:.3f}"
                      for r in sweep) + f" us per pick (best "
                  f"{tuple(best['geometry'])}); picks equal")
    eval_pts, eval_npoints = next(iter(paths.values()))
    B, N, _ = eval_pts.shape
    k, threads, _ = card_geometry(B, N)
    n = k * threads
    gen = torch.Generator(device=eval_pts.device).manual_seed(SEED + 8)
    x = torch.rand(B, n, 3, generator=gen, device=eval_pts.device) * 40.0
    got = launch_picks(x, n, (k, threads, 1))
    torch.cuda.synchronize()
    check(torch.equal(got, furthest_point_sample_plain(x, n)),
          "FPS picks differ at the floor's geometry")
    ms = cuda_ms(lambda: launch_picks(x, n, (k, threads, 1)), 3)
    us = ms / (n - 1) * 1e3
    floor = {"geometry": [k, threads, 1], "B": B, "N": n, "npoint": n,
             "us_per_pick": us,
             "ms_at_npoint": us * (eval_npoints[0] - 1) / 1e3}
    print(f"FPS dependent-chain floor (measured): (k, threads, ppt) = "
          f"({k}, {threads}, 1), B={B}, {n} points all picked: {us:.3f} us "
          f"per pick, {floor['ms_at_npoint']:.3f} ms for "
          f"{eval_npoints[0] - 1} picks")
    return rows, floor


def compare_split_on_cpu(pts, npoint):
    """Scene 0 of the double train batch: the card's split route (run on
    the whole batch, as the train step does) against the CPU plain route,
    picks, nn ids and nn_d2 bit for bit."""
    import torch

    from tpu3d_torch.ops.sampling import fps_then_three_nn

    got = fps_then_three_nn(pts, npoint)
    t0 = time.perf_counter()
    ref = fps_then_three_nn(pts[:1].cpu(), npoint)
    cpu_s = time.perf_counter() - t0
    differ = {name: int((g[:1].cpu() != r).sum())
              for name, g, r in zip(("picks", "nn_d2", "nn_idx"), got, ref)}
    check(not any(differ.values()), f"double SA_0 split route differs "
          f"between the card and the CPU, entries: {differ}")
    print(f"double SA_0 split route, card (B={pts.shape[0]}) vs CPU plain on "
          f"scene 0: picks, nn_d2 and nn_idx equal; CPU {cpu_s:.1f} s")


def drive(infer, pts, expect_kernels, label):
    """One run of a path with every count set to 0 just before it and read
    just after, its nearest_k and fps calls recorded and held to the plain
    versions; then its ms per batch (host clock, median of 5)."""
    import torch

    from tpu3d_torch.ops import _build
    from tpu3d_torch.tools.kernel_bench import record_fps, record_nearest_k

    infer(pts)  # warm-up: allocator and library handles
    torch.cuda.synchronize()
    _build.reset_launches()
    with record_nearest_k() as nk_calls, record_fps() as fps_calls:
        out = infer(pts)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    audit_nearest_k(nk_calls, launches, label)
    audit_fps(fps_calls, launches, label)
    del nk_calls, fps_calls
    for name in expect_kernels:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the {label} path")
    ms = wall_ms(lambda: infer(pts), 5)
    print(f"{label} path: {ms:.1f} ms/batch (host clock, median of 5; "
          f"{ms / pts.shape[0]:.1f} ms/scene), launches {launches}")
    return out, launches, ms


def check_outputs(out, expect):
    import torch

    for key, shape in expect.items():
        check(tuple(out[key].shape) == shape,
              f"{key} has shape {tuple(out[key].shape)}, expected {shape}")
        if out[key].is_floating_point():
            check(bool(torch.isfinite(out[key]).all()), f"{key} not finite")


def compare_rcnn_on_cpu(cfg, model, cpu_model, out):
    """Scene 0's RCNN stage on the CPU plain path, fed the card's rois,
    backbone outputs and raw scores, against the card's. A point on a
    box face can flip between the two devices' sin/cos; such ROIs are
    counted and left out of the comparison of the refinement outputs."""
    import torch

    from tpu3d_torch.tools.eval_rcnn import rcnn_decode_and_nms

    args = (out["backbone_xyz"][:1], out["backbone_features"][:1],
            out["rpn_scores_raw"][:1], out["rois"][:1])
    t0 = time.perf_counter()
    ref = cpu_model.rcnn_stage(*(a.cpu() for a in args))
    ref_pool = cpu_model.pool_rois(*(a.cpu() for a in args))
    cpu_s = time.perf_counter() - t0
    got = model.rcnn_stage(*args)
    got_pool = model.pool_rois(*args)
    check(torch.equal(got["pooled_empty_flag"].cpu(),
                      ref["pooled_empty_flag"]),
          "pooled empty flags differ between the card and the CPU")
    # pooled coordinates in each ROI's frame: the same points give the same
    # values up to the rounding of the canonical rotation
    pool_err = (got_pool[0].cpu() - ref_pool[0]).abs().amax(dim=(1, 2))
    same = pool_err <= 1e-4
    flips = int((~same).sum())
    print(f"RCNN stage, card vs CPU on scene 0: {flips} of {same.numel()} "
          f"ROIs pool another point set")
    check(flips <= max(1, same.numel() // 50),
          f"{flips} ROIs pool other points on the card than on the CPU")
    for key in ("rcnn_cls", "rcnn_reg"):
        a, b = got[key].cpu()[same], ref[key][same]
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        print(f"{key}: card vs CPU max abs err {err:.3e} (max |value| "
              f"{scale:.3e})")
        # f32 sums in another order on the two devices; tolerance 1e-4
        # relative to the largest value
        check(err <= 1e-4 * max(scale, 1.0), f"{key} differs by {err}")
    if flips == 0:
        # the decode, score threshold and rotated NMS of the card's
        # refinement outputs, on both devices
        m = args[3].shape[1]
        dec = [rcnn_decode_and_nms(cfg, args[3].to(dev),
                                   got["rcnn_cls"].reshape(1, m).to(dev),
                                   got["rcnn_reg"].reshape(1, m, -1).to(dev),
                                   out["roi_valid"][:1].to(dev))
               for dev in (DEVICE, "cpu")]
        check(torch.equal(dec[0]["final_mask"].cpu(), dec[1]["final_mask"]),
              "final NMS keeps differ between the card and the CPU")
        err = (dec[0]["final_boxes"].cpu() - dec[1]["final_boxes"]).abs()
        print(f"final NMS, card vs CPU on the card's outputs: keeps equal "
              f"({int(dec[1]['final_mask'].sum())}), final_boxes max abs err "
              f"{err.max().item():.3e}")
        check(err.max().item() <= 1e-4, "final boxes differ")
    print(f"CPU plain path: {cpu_s:.1f} s for scene 0's RCNN stage")


def interp_bwd_kernels(report, cfg, pts):
    """Phase 3 for the interpolation's backward, at the train step's four
    FP levels (B=16): two calls give the same bits; d_features equals the
    CPU plain version (index_add_, which adds in the kernel's ascending
    key order) bit for bit; d_features and d_weight are within 1e-5 of the
    largest value of the card's plain version (index_add_ with atomics, in
    another order); the time is that of the main path's form, which wants
    no d_weight."""
    import torch

    from tpu3d_torch.ops import (furthest_point_sample_with_3nn,
                                 gather_points, interpolation_weights)
    from tpu3d_torch.ops.interpolate import (three_interpolate_backward,
                                             three_interpolate_backward_plain)

    sa = cfg.RPN.SA_CONFIG
    B = pts.shape[0]
    levels, caches = [pts], []
    for npoint in sa.NPOINTS:
        idx, d2, nn_idx = furthest_point_sample_with_3nn(levels[-1], npoint)
        caches.append((d2, nn_idx))
        levels.append(gather_points(levels[-1], idx))
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    fp_known_c = [cfg.RPN.FP_MLPS[i + 1][-1] if i + 1 < len(cfg.RPN.FP_MLPS)
                  else sum(m[-1] for m in sa.MLPS[i])
                  for i in range(len(cfg.RPN.FP_MLPS))]
    for i in range(len(cfg.RPN.FP_MLPS) - 1, -1, -1):
        d2, nn_idx = caches[i]
        n, m, ch = levels[i + 1].shape[1], levels[i].shape[1], fp_known_c[i]
        feats = torch.randn(B, n, ch, generator=gen).to(pts.device)
        grad = torch.randn(B, m, ch, generator=gen).to(pts.device)
        w = interpolation_weights(torch.sqrt(d2.clamp(min=0.0)))
        args = (feats, nn_idx, w, grad)
        got = three_interpolate_backward(*args)
        again = three_interpolate_backward(*args)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"three_interpolate_bwd differs between two calls at M={m}")
        del again
        cpu = three_interpolate_backward_plain(
            *(a.cpu() for a in args), need_weight=False)[0]
        check(torch.equal(got[0].cpu(), cpu), f"three_interpolate_bwd "
              f"d_features differs from the CPU plain version at M={m}")
        del cpu
        ref = three_interpolate_backward_plain(*args)
        err = 0.0
        for name, a, b in zip(("d_features", "d_weight"), got, ref):
            e = (a - b).abs().max().item()
            scale = b.abs().max().item()
            check(e <= 1e-5 * scale, f"three_interpolate_bwd {name} differs "
                  f"by {e} (max |value| {scale}) at M={m}")
            err = max(err, e)
        ms = cuda_ms(lambda: three_interpolate_backward(*args, False), 20)
        pms = cuda_ms(lambda: three_interpolate_backward_plain(*args, False),
                      5)
        rows = (nn_idx.long() + n * torch.arange(B, device=pts.device)
                [:, None, None]).reshape(-1)
        contrib = (w[..., None] * grad[:, :, None, :]).reshape(-1, ch)
        lms = cuda_ms(lambda: feats.new_zeros(B * n, ch).index_add_(
            0, rows, contrib), 5)
        # the main path's form: read g, idx and w, write d_features; a
        # multiply and an add per (row, neighbour, channel)
        nbytes = B * m * ch * 4 + B * m * 3 * 8 + B * n * ch * 4
        report.add("three_interpolate_bwd", err, ms, pms, lms, nbytes,
                   B * m * 3 * ch * 2)
        print(f"three_interpolate_bwd N={n} M={m} C={ch}: {ms:.4f} ms, "
              f"plain {pms:.3f} ms, index_add_ {lms:.3f} ms, max_abs_err "
              f"{err:.3e}; two calls equal, d_features equal to the CPU's")


def library_backward_ms(forward, grad):
    """Device ms of autograd's backward alone through ``forward``'s graph
    (the cuBLAS chain), the forward run once outside the timed window and
    its graph kept (``retain_graph``)."""
    import torch

    out = forward()
    inputs = _graph_leaves(out)
    return cuda_ms(lambda: torch.autograd.grad(out, inputs, grad,
                                               retain_graph=True), 3)


def _graph_leaves(out):
    """The leaf tensors that require a gradient in ``out``'s graph."""
    seen, stack, leaves = set(), [out.grad_fn], []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if hasattr(fn, "variable"):
            leaves.append(fn.variable)
        stack.extend(f for f, _ in fn.next_functions)
    return leaves


def bwd_ops(hit, nnz, c1, c2):
    """Operations of the gather backward: d_a1 and dW2 over the ``nnz``
    non-zero pooled gradients; layer 1's recompute, dW1, d_a0 and the ReLU
    masks over the ``hit`` slots they reach."""
    return 3 * 2 * hit * c1 * c2 + 2 * 2 * nnz * c2 + hit * (2 * c1 + 2 * c2)


def fused_train_kernels(report, full_spread, model, target):
    """Phase 3 for the fused SA op's training kernels, on the rows the
    train step's proposal target layer sampled, at RCNN SA_0 and SA_1.
    Forward: out equal to the eval kernel's to the bit, ppre within 1e-4
    of the largest value, argmax equal to the plain version's but at
    near-ties (f32 sums in another order may pick another slot whose value
    is the max within that tolerance; at most 1 in 1000). Backward: the six
    gradients within 1e-4 of each one's largest value, both routed by the
    plain version's argmax (the seeded routing); then the backward again
    under full spread (every channel live at a slot drawn uniformly over S)
    against its routed plain version, its time summed per step into
    ``full_spread``."""
    import torch
    import torch.nn.functional as F

    from tpu3d_torch.ops import fused_gathered_mlp_pool, group_points
    from tpu3d_torch.ops.fused_sa import (
        BWD_TILE, _bwd_blocks, block_runs, fused_gathered_mlp_pool_backward,
        fused_gathered_mlp_pool_backward_plain,
        fused_gathered_mlp_pool_backward_routed_plain,
        fused_gathered_mlp_pool_train, fused_gathered_mlp_pool_train_plain,
        pack_tiles, reached_slots)

    net = model.rcnn_net
    xyz, rest = target["sampled_pts"], target["pts_feature"]
    with torch.no_grad():
        features = net.point_features(xyz, rest)
    R = xyz.shape[0]
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    cuda_gen = torch.Generator(device=xyz.device).manual_seed(SEED + 7)
    for k in range(net.n_sa):
        sa = getattr(net, f"sa_{k}")
        if sa.npoint is None:
            break
        with torch.no_grad():
            new_xyz, pre, idx, center = sa.group_inputs(xyz, features)
            mlp = sa.mlp_0
            w1 = mlp.dense_1.weight.T.contiguous()
            w2 = mlp.dense_2.weight.T.contiguous()
            b1, b2 = mlp.dense_1.bias.detach(), mlp.dense_2.bias.detach()
            args = (pre, idx, center, w1, b1, w2, b2)
            out, arg, ppre = fused_gathered_mlp_pool_train(*args)
            evl = fused_gathered_mlp_pool(*args)
            torch.cuda.synchronize()
            check(torch.equal(out, evl), f"fused_sa_train out differs from "
                  f"the eval kernel's at RCNN SA_{k}")
            r_out, r_arg, r_ppre = fused_gathered_mlp_pool_train_plain(*args)
            scale = r_out.abs().max().item()
            err = (out - r_out).abs().max().item()
            check(err <= 1e-4 * scale, f"fused_sa_train out differs by {err}")
            perr = (ppre - r_ppre).abs().max().item()
            check(perr <= 1e-4 * max(scale, r_ppre.abs().max().item()),
                  f"fused_sa_train ppre differs by {perr}")
            flips = int((arg != r_arg).sum())
            check(flips <= arg.numel() // 1000,
                  f"fused_sa_train argmax differs in {flips} channels")
            ms = cuda_ms(lambda: fused_gathered_mlp_pool_train(*args), 5)
            pms = cuda_ms(lambda: fused_gathered_mlp_pool_train_plain(*args),
                          2)

        def library_forward():  # the cuBLAS chain, recording for autograd
            leaves = [t.detach().requires_grad_() for t in
                      (pre, center, mlp.dense_1.weight, b1,
                       mlp.dense_2.weight, b2)]
            x = torch.relu(group_points(leaves[0], idx)
                           - leaves[1][:, :, None])
            x = torch.relu(F.linear(x, leaves[2], leaves[3]))
            return torch.relu(F.linear(x, leaves[4], leaves[5])).amax(2)

        lms = cuda_ms(library_forward, 2)
        M, S = idx.shape[1], idx.shape[2]
        c1, c2, c3 = w1.shape[0], w1.shape[1], w2.shape[1]
        ops = R * M * S * (2 * (c1 * c2 + c2 * c3) + 2 * c1 + 2 * c2
                           + 5 * c3)
        nbytes = 4 * (pre.numel() + idx.numel() + center.numel()
                      + w1.numel() + w2.numel() + c2 + c3 + 3 * R * M * c3)
        report.add("fused_sa_train", max(err, perr), ms, pms, lms, nbytes,
                   ops)
        print(f"fused_sa_train RCNN SA_{k} R={R} M={M} S={S} "
              f"C={c1}->{c2}->{c3}: {ms:.3f} ms, plain {pms:.3f} ms, cuBLAS "
              f"chain under autograd {lms:.3f} ms, out "
              f"equal to eval, max_abs_err {err:.3e} / ppre {perr:.3e} (max "
              f"|value| {scale:.3e}), argmax flips {flips} of "
              f"{arg.numel()}, {ops / ms / 1e9:.1f} TFLOP/s")

        # the backward, routed by the plain version's argmax on both sides
        grad = torch.randn(out.shape, generator=gen).to(out.device)
        got = fused_gathered_mlp_pool_backward(*args, grad, r_arg, r_ppre)
        ref = fused_gathered_mlp_pool_backward_plain(*args, grad)
        torch.cuda.synchronize()
        berr = 0.0
        for name, a, b in zip(("d_pre", "d_center", "dW1", "db1", "dW2",
                               "db2"), got, ref):
            e = (a - b).abs().max().item()
            sc = b.abs().max().item()
            print(f"  fused_sa_bwd SA_{k} {name}: max_abs_err {e:.3e} (max "
                  f"|value| {sc:.3e})")
            check(e <= 1e-4 * sc, f"fused_sa_bwd {name} differs by {e} at "
                  f"RCNN SA_{k}")
            berr = max(berr, e)
        del got, ref
        ms = cuda_ms(lambda: fused_gathered_mlp_pool_backward(
            *args, grad, r_arg, r_ppre), 5)
        pms = cuda_ms(lambda: fused_gathered_mlp_pool_backward_plain(
            *args, grad), 2)

        def library():
            leaves = [t.detach().requires_grad_() for t in
                      (pre, center, mlp.dense_1.weight, b1,
                       mlp.dense_2.weight, b2)]
            x = torch.relu(group_points(leaves[0], idx)
                           - leaves[1][:, :, None])
            x = torch.relu(F.linear(x, leaves[2], leaves[3]))
            o = torch.relu(F.linear(x, leaves[4], leaves[5])).amax(2)
            torch.autograd.grad(o, leaves, grad)

        lms = cuda_ms(library, 2)
        lbms = library_backward_ms(library_forward, grad)
        nnz, hit = routed_slots(r_arg, grad, r_ppre, S)
        ops = bwd_ops(hit, nnz, c1, c2)
        nbytes = 4 * (2 * pre.numel() + idx.numel() + 2 * center.numel()
                      + w1.numel() + w2.numel() + c2 + 2 * R * M * c3
                      + w1.numel() + w2.numel() + c2 + c3)
        report.add("fused_sa_bwd", berr, ms, pms, lms, nbytes, ops,
                   lib_bwd_ms=lbms, reached=hit, slots=R * M * S)
        counts = reached_slots(torch.where(r_ppre > 0, grad, 0.0), r_arg,
                               S).sum(dim=1).tolist()
        runs = block_runs(counts, _bwd_blocks(R * M, c1, c2, c3))
        tiles = sum(len(pack_tiles([counts[g] for g in run]))
                    for run in runs)
        print(f"fused_sa_bwd RCNN SA_{k}, seeded routing: {ms:.3f} ms, plain "
              f"{pms:.3f} ms, autograd of the cuBLAS chain {lms:.3f} ms "
              f"(forward and backward; its backward alone {lbms:.3f} ms), "
              f"bound {bound_ms(nbytes, ops)[0]:.4f} "
              f"ms, {ops / ms / 1e9:.2f} TFLOP/s over the reached slots; "
              f"{nnz} non-zero pooled gradients reach {hit} of {R * M * S} "
              f"slots ({100 * hit / (R * M * S):.2f}%) in {tiles} tiles of "
              f"up to {BWD_TILE} rows on {len(runs)} blocks")

        # full spread: every channel live at a slot drawn uniformly over S,
        # on the same pre, idx and weights; against the routed plain
        # version, and the bound counts every slot
        full_arg = torch.randint(0, S, r_arg.shape, generator=cuda_gen,
                                 device=r_arg.device, dtype=torch.int32)
        ones = torch.ones_like(r_ppre)
        got = fused_gathered_mlp_pool_backward(*args, grad, full_arg, ones)
        ref = fused_gathered_mlp_pool_backward_routed_plain(*args, grad,
                                                            full_arg, ones)
        torch.cuda.synchronize()
        ferr = 0.0
        for name, a, b in zip(("d_pre", "d_center", "dW1", "db1", "dW2",
                               "db2"), got, ref):
            e = (a - b).abs().max().item()
            sc = b.abs().max().item()
            check(e <= 1e-4 * sc, f"fused_sa_bwd {name} differs by {e} under "
                  f"full spread at RCNN SA_{k}")
            ferr = max(ferr, e / sc)
        del got, ref
        fms = cuda_ms(lambda: fused_gathered_mlp_pool_backward(
            *args, grad, full_arg, ones), 5)
        fnnz, fhit = routed_slots(full_arg, grad, ones, S)
        f_bound = bound_ms(nbytes, bwd_ops(R * M * S, fnnz, c1, c2))[0]
        full = full_spread.setdefault("fused_sa_bwd", dict(
            ms=0.0, bound_ms=0.0, reached=0, slots=0, max_rel_err=0.0))
        full["ms"] += fms
        full["bound_ms"] += f_bound
        full["reached"] += fhit
        full["slots"] += R * M * S
        full["max_rel_err"] = max(full["max_rel_err"], ferr)
        print(f"fused_sa_bwd RCNN SA_{k}, full spread: {fms:.3f} ms, bound "
              f"{f_bound:.3f} ms (every slot), "
              f"{bwd_ops(fhit, fnnz, c1, c2) / fms / 1e9:.2f} TFLOP/s over "
              f"the {fhit} reached of {R * M * S} slots; gradients within "
              f"{ferr:.2e} of each largest value of the routed plain version")
        del full_arg, ones
        # the train forward's output feeds the next level, as in the step
        with torch.no_grad():
            features = out
        xyz = new_xyz
        del args, pre, center, r_out, r_arg, r_ppre, grad
        torch.cuda.empty_cache()


def train_weights(model, seed):
    """Seeded weights for a model that trains: seeded_state_dict's, with
    the biases it leaves at 0 drawn small, so that weight decay moves every
    parameter even where the step's gradient is 0 (the RCNN's reg head when
    no sampled ROI is foreground)."""
    import numpy as np
    import torch

    from tpu3d_torch.weights import seeded_state_dict

    state = seeded_state_dict(model, seed)
    rng = np.random.default_rng(seed + 1)
    for name, v in state.items():
        if name.endswith(".bias") and not v.any():
            state[name] = torch.as_tensor(rng.normal(0.0, 0.01, v.shape),
                                          dtype=v.dtype)
    return state


def drive_train(cfg, model, batch, gen, expect_kernels, label, steps):
    """One warm-up step, then ``steps`` timed ones, the counts set to 0 just
    before the first timed step and read just after it, that step's
    nearest_k and fps calls recorded and held to the plain versions:
    launches per step, the metrics of the last step, ms per step (host
    clock, median)."""
    import contextlib

    import torch

    from tpu3d_torch.ops import _build
    from tpu3d_torch.parallel import create_train_state, make_train_step
    from tpu3d_torch.tools.kernel_bench import record_fps, record_nearest_k

    state = create_train_state(cfg, model, steps_per_epoch=100,
                               total_epochs=10)
    step = make_train_step(cfg, model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step(state, batch, gen, 0.9)
    torch.cuda.synchronize()
    times, launches = [], None
    for i in range(steps):
        if i == 0:
            _build.reset_launches()
        t0 = time.perf_counter()
        with (record_nearest_k() if i == 0
              else contextlib.nullcontext()) as calls, \
                (record_fps() if i == 0
                 else contextlib.nullcontext()) as fcalls:
            tb = step(state, batch, gen, 0.9)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches = dict(_build.LAUNCHES)
            nk_calls, fps_calls = calls, fcalls
    audit_nearest_k(nk_calls, launches, label)
    audit_fps(fps_calls, launches, label)
    del nk_calls, fps_calls
    for name in expect_kernels:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the {label} path")
    loss, gnorm = float(tb["loss"]), float(tb["grad_norm"])
    check(math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0,
          f"{label}: loss {loss}, grad_norm {gnorm}")
    after = model.state_dict()
    params = dict(model.named_parameters())
    trained = {id(p) for p in state.optimizer.params}
    same = [k for k, p in params.items()
            if id(p) in trained and torch.equal(before[k], after[k])]
    check(not same, f"{label}: parameters unchanged: {same[:5]}")
    zero = [k for k, p in params.items()
            if id(p) in trained and p.grad is not None and not p.grad.any()]
    stats = [k for k in after if k.endswith((".mean", ".var"))]
    moved = sum(not torch.equal(before[k], after[k]) for k in stats)
    ms = statistics.median(times)
    print(f"{label}: {ms:.1f} ms/step (host clock, median of {steps}; "
          f"{ms / batch['pts_input'].shape[0]:.1f} ms/scene), loss {loss:.4f},"
          f" grad_norm {gnorm:.4f}, {len(trained)} parameters all changed "
          f"({len(zero)} with a zero gradient in the last step), running "
          f"statistics moved {moved}/{len(stats)}, launches per step "
          f"{launches}")
    return tb, launches, ms


def check_bn_running_stats(cfg, model, batch, gen):
    """One more train step of an RCNN with BatchNorm: each RCNN SA level's
    running statistics after it equal m·old + (1 − m)·(the batch statistics
    that fused_bn_mlp_pool returned in that step), to the bit, and moved."""
    import torch

    from tpu3d_torch.models import pointnet2
    from tpu3d_torch.parallel import create_train_state, make_train_step

    state = create_train_state(cfg, model, steps_per_epoch=100,
                               total_epochs=10)
    keys = [f"rcnn_net.sa_{k}.mlp_0.bn_{i}.{leaf}" for k in range(2)
            for i in range(3) for leaf in ("mean", "var")]
    before = {k: model.state_dict()[k].clone() for k in keys}
    returned, op = [], pointnet2.fused_bn_mlp_pool

    def recording(*args):
        res = op(*args)
        if args[5] is None:  # training: (pooled, (means, vars))
            returned.append(res[1])
        return res

    pointnet2.fused_bn_mlp_pool = recording
    try:
        make_train_step(cfg, model)(state, batch, gen, 0.9)
    finally:
        pointnet2.fused_bn_mlp_pool = op
    check(len(returned) == 2, f"fused_bn_mlp_pool trained {len(returned)} "
          f"levels, expected RCNN SA_0 and SA_1")
    after = model.state_dict()
    for k, (means, vars_) in enumerate(returned):
        for i in range(3):
            for leaf, value in (("mean", means[i]), ("var", vars_[i])):
                key = f"rcnn_net.sa_{k}.mlp_0.bn_{i}.{leaf}"
                want = 0.9 * before[key] + (1 - 0.9) * value
                check(torch.equal(after[key], want),
                      f"{key} is not the momentum update of the batch "
                      f"statistics")
                check(not torch.equal(after[key], before[key]),
                      f"{key} did not move")
    print(f"BatchNorm RCNN running statistics: the {len(keys)} of RCNN SA_0 "
          f"and SA_1 equal 0.9·old + 0.1·(the op's batch statistics) to the "
          f"bit, all moved")


NUDGES = 4  # independent nudges of the weights behind the RPN's noise floor


def compare_train_on_cpu(cfg, model, target, batch, rpn=True,
                         rcnn_floor=False):
    """Scene 0's training on the CPU plain path against the card's, with
    dropout 0 and the card model's weights.

    The RCNN loss and every rcnn_net gradient on the card's sampled targets
    of scene 0: the loss within 1e-5 relative, each gradient within 1e-3 of
    the largest (the fused kernels route a channel's gradient by an argmax
    that near-ties may move). The RPN's train-mode loss and gradients of
    scene 0: the loss within 1e-5 relative; the gradients against a noise
    floor, since the batch-statistics BatchNorm of SA_0 sees slabs padded
    with far points (a center without neighbours groups point 0), where
    E[x²] − mean² loses float32 digits on any device: the card's largest
    gradient error must be at most 10 times the change that perturbing
    every weight by about one float32 rounding makes on the CPU (plus
    1e-5 of the largest gradient), the largest change over ``NUDGES``
    independent perturbations, each printed, and the margin to that bound.
    (The weights are the card model's after its timed steps, which the
    card's atomics move by a rounding from run to run, and one
    perturbation's change swings with them.) The perturbation moves no FPS
    pick nor neighbour, which depend on the coordinates alone. ``rpn``
    False leaves out the RPN half. ``rcnn_floor`` holds the RCNN's loss and
    gradients to such a floor too, for an RCNN with batch-statistics
    BatchNorm: its gradient bound as the RPN's, its loss within 10 times
    the largest loss change over the perturbations plus 1e-6 relative."""
    import torch

    from tpu3d_torch.models import PointRCNN
    from tpu3d_torch.models.train_functions import (
        generate_rpn_labels_device, get_rcnn_loss, get_rpn_loss)

    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    rows = slice(0, int(cfg.RCNN.ROI_PER_IMAGE))
    sub = {k: v[rows] for k, v in target.items()}
    pts0 = batch["pts_input"][:1].cpu()
    labels = generate_rpn_labels_device(pts0, batch["gt_boxes3d"][:1].cpu())

    def rcnn_grads(m, dev, dtype):
        t = {k: v.to(dev) for k, v in sub.items()}
        out = m.rcnn_net(t["sampled_pts"], t["pts_feature"], train=True)
        return get_rcnn_loss(cfg, dict(out, **t))[0], m.rcnn_net

    def rpn_grads(m, dev, dtype):
        out = m.rpn(pts0.to(dev, dtype), True, 0.9)
        cls, reg = (t.to(dev) for t in labels)
        return get_rpn_loss(cfg, out["rpn_cls"], out["rpn_reg"], cls,
                            reg.to(dtype))[0], m.rpn

    def run(fn, dev, dtype, weights=state):
        m = PointRCNN(nodp, mode="TRAIN", device=dev).to(dtype)
        m.load_state_dict(weights)
        t0 = time.perf_counter()
        loss, net = fn(m, dev, dtype)
        loss.backward()
        grads = {n: p.grad.detach().cpu().double()
                 for n, p in net.named_parameters()}
        return float(loss.detach()), grads, time.perf_counter() - t0

    def worst(a, b):
        return max(((a[n] - g).abs().max().item(), n) for n, g in b.items())

    def nudged(i):
        gen = torch.Generator().manual_seed(SEED + 3 + i)
        return {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
                if v.is_floating_point() else v for k, v in state.items()}

    nodp = copy.deepcopy(cfg)
    nodp.RPN.DP_RATIO = 0.0
    f32 = torch.float32
    loss, grads, _ = run(rcnn_grads, DEVICE, f32)
    ref_loss, ref, cpu_s = run(rcnn_grads, "cpu", f32)
    top = max(g.abs().max().item() for g in ref.values())
    err = worst(grads, ref)
    bound, loss_bound, floor_note = 1e-3 * top, 1e-5 * abs(ref_loss), ""
    if rcnn_floor:
        runs = [run(rcnn_grads, "cpu", f32, nudged(i)) for i in range(NUDGES)]
        floors = [worst(r[1], ref) for r in runs]
        floor = max(floors)
        loss_floor = max(abs(r[0] - ref_loss) for r in runs)
        bound = 10 * floor[0] + 1e-5 * top
        loss_bound = 10 * loss_floor + 1e-6 * abs(ref_loss)
        floor_note = (f"; noise floors of {NUDGES} nudges "
                      f"{', '.join(f'{f[0]:.3e}' for f in floors)} ({floor[1]})"
                      f", loss floor {loss_floor:.3e}; bounds {bound:.3e} "
                      f"(margin {bound / max(err[0], 1e-30):.1f}x) and "
                      f"{loss_bound:.3e}")
    print(f"RCNN train on scene 0, card vs CPU: loss {loss:.6f} vs "
          f"{ref_loss:.6f}; largest gradient error {err[0]:.3e} ({err[1]}) "
          f"of the largest gradient {top:.3e}; CPU {cpu_s:.1f} s{floor_note}")
    check(abs(loss - ref_loss) <= loss_bound, "RCNN train loss differs")
    check(err[0] <= bound, "RCNN gradients differ")
    if not rpn:
        return

    loss, grads, _ = run(rpn_grads, DEVICE, f32)
    ref_loss, ref, cpu_s = run(rpn_grads, "cpu", f32)
    floors = [worst(run(rpn_grads, "cpu", f32, nudged(i))[1], ref)
              for i in range(NUDGES)]
    top = max(g.abs().max().item() for g in ref.values())
    err, floor = worst(grads, ref), max(floors)
    bound = 10 * floor[0] + 1e-5 * top
    print(f"RPN train on scene 0, card vs CPU: loss {loss:.6f} vs "
          f"{ref_loss:.6f}; largest gradient error {err[0]:.3e} ({err[1]}); "
          f"noise floors of {NUDGES} nudges "
          f"{', '.join(f'{f[0]:.3e}' for f in floors)}, floor {floor[0]:.3e} "
          f"({floor[1]}); bound {bound:.3e}, margin {bound / max(err[0], 1e-30):.1f}x; "
          f"largest gradient {top:.3e}; CPU {cpu_s:.1f} s")
    check(abs(loss - ref_loss) <= 1e-5 * abs(ref_loss),
          "RPN train loss differs")
    check(err[0] <= bound, "RPN gradients differ")


def slab_levels(model, xyz, rest):
    """The RCNN levels of ``model`` that take the slab route, fed pooled
    points ``xyz`` / ``rest`` through the levels before them as the model
    runs them at eval: [(k, x0 (R, M, S, 128) the grouped slab, the level's
    SharedMLP)]."""
    import torch

    from tpu3d_torch.ops import group_points, sa_route

    net = model.rcnn_net
    levels = []
    with torch.no_grad():
        features = net.point_features(xyz, rest)
        for k in range(net.n_sa):
            sa = getattr(net, f"sa_{k}")
            if sa.npoint is None:
                break
            shape = (xyz.shape[0], sa.npoint, sa.nsample, sa.mlp[0])
            if sa_route(shape, sa.mlp, xyz.shape[1], sa.mlp_0.bn) == "slab":
                _, pre, idx, center = sa.group_inputs(xyz, features)
                levels.append((k, group_points(pre, idx)
                               - center[:, :, None, :], sa.mlp_0))
            xyz, features = sa(xyz, features)
    return levels


def dense_weights(mlp):
    """A SharedMLP's layers 1-2 as the fused ops take them: (w1 (C1, C2),
    b1, w2 (C2, C3), b2), the biases None with BatchNorm."""
    return (mlp.dense_1.weight.detach().T.contiguous(),
            None if mlp.bn else mlp.dense_1.bias.detach(),
            mlp.dense_2.weight.detach().T.contiguous(),
            None if mlp.bn else mlp.dense_2.bias.detach())


def slab_eval_kernel(x0, mlp, label):
    """The slab eval kernel at one level, without BatchNorm
    (fused_sa_slab) or with it (fused_sa_slab_bn, its packs folded from the
    level's running statistics), against its plain version: within 1e-4 of
    the largest value (f32 sums in another order). The library is the
    cuBLAS chain of the same layers on the same slab. -> (err, ms,
    plain_ms, library_ms, bytes, operations)."""
    import torch
    import torch.nn.functional as F

    from tpu3d_torch.ops import fused_bn_mlp_pool, fused_mlp_pool
    from tpu3d_torch.ops.fused_sa import (bn_packs, fused_sa_slab_plain,
                                          nobn_packs)

    w1, b1, w2, b2 = dense_weights(mlp)
    R, M, S, c1 = x0.shape
    c2, c3 = w1.shape[1], w2.shape[1]
    with torch.no_grad():
        if mlp.bn:
            name = "fused_sa_slab_bn"
            bns = [getattr(mlp, f"bn_{i}") for i in range(3)]
            packs = bn_packs([bn.affine() for bn in bns])

            def kernel():
                return fused_bn_mlp_pool(
                    x0, w1, w2, [bn.scale for bn in bns],
                    [bn.bias for bn in bns], [(bn.mean, bn.var) for bn in bns])
        else:
            name = "fused_sa_slab"
            packs = nobn_packs(c1, b1, b2)

            def kernel():
                return fused_mlp_pool(x0, w1, b1, w2, b2)
        m0, a0, m1, a1, m2, a2 = packs.split([c1, c1, c2, c2, c3, c3])
        got = kernel()
        ref = fused_sa_slab_plain(x0, packs, w1, w2)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        check(err <= 1e-4 * scale, f"{name} differs by {err} (max |value| "
              f"{scale}) at {label}")
        del got, ref
        ms = cuda_ms(kernel, 10)
        pms = cuda_ms(lambda: fused_sa_slab_plain(x0, packs, w1, w2), 3)

        def library():
            x = torch.relu(torch.addcmul(a0, x0, m0))
            x = torch.relu(torch.addcmul(a1, F.linear(x, mlp.dense_1.weight),
                                         m1))
            return torch.relu(torch.addcmul(
                a2, F.linear(x, mlp.dense_2.weight), m2)).amax(2)

        lms = cuda_ms(library, 3)
    slots = R * M * S
    # per slot: the two layers' multiply-adds, then on each layer's
    # channels the affine (multiply, add) and the ReLU, and the max on C3
    ops = slots * (2 * (c1 * c2 + c2 * c3) + 3 * (c1 + c2 + c3) + c3)
    nbytes = 4 * (x0.numel() + w1.numel() + w2.numel() + packs.numel()
                  + R * M * c3)
    print(f"{name} {label} R={R} M={M} S={S} C={c1}->{c2}->{c3}: "
          f"{ms:.3f} ms, bound {bound_ms(nbytes, ops)[0]:.3f} ms, plain "
          f"{pms:.3f} ms, cuBLAS chain {lms:.3f} ms, max_abs_err {err:.3e} "
          f"(max |value| {scale:.3e}), {ops / ms / 1e9:.1f} TFLOP/s")
    return name, (err, ms, pms, lms, nbytes, ops)


def slab_train_kernels(x0, mlp, label, gen):
    """The slab form's training forward and backward at one level, on the
    rows a train step's proposal target layer sampled, against their plain
    versions. Forward: out equal to the eval kernel's to the bit, ppre
    within 1e-4 of the largest value, argmax equal to the plain version's at
    every channel whose plain max has no near-tie (another slot's value
    within that tolerance but not equal to it). Backward: the five
    gradients within 1e-4 of each one's largest value, both routed by the
    plain version's argmax and ppre. The library is the cuBLAS chain under
    autograd (its forward, then its forward and backward). -> {kernel:
    (err, ms, plain_ms, library_ms, bytes, operations)}."""
    import torch
    import torch.nn.functional as F

    from tpu3d_torch.ops import fused_mlp_pool
    from tpu3d_torch.ops.fused_sa import (
        fused_mlp_pool_backward, fused_mlp_pool_backward_plain,
        fused_mlp_pool_backward_routed_plain, fused_mlp_pool_train,
        fused_mlp_pool_train_plain)

    w1, b1, w2, b2 = args = dense_weights(mlp)
    R, M, S, c1 = x0.shape
    c2, c3 = w1.shape[1], w2.shape[1]
    slots = R * M * S
    rows = {}

    def library_forward(leaves):
        x = torch.relu(leaves[0])
        x = torch.relu(F.linear(x, leaves[1], leaves[2]))
        return torch.relu(F.linear(x, leaves[3], leaves[4])).amax(2)

    weights = (x0, mlp.dense_1.weight.detach(), b1,
               mlp.dense_2.weight.detach(), b2)
    with torch.no_grad():
        out, arg, ppre = fused_mlp_pool_train(x0, *args)
        check(torch.equal(out, fused_mlp_pool(x0, *args)),
              f"fused_sa_slab_train out differs from the eval kernel's at "
              f"{label}")
        r_out, r_arg, r_ppre = fused_mlp_pool_train_plain(x0, *args)
        torch.cuda.synchronize()
        scale = r_out.abs().max().item()
        err = (out - r_out).abs().max().item()
        check(err <= 1e-4 * scale, f"fused_sa_slab_train out differs by {err}")
        perr = (ppre - r_ppre).abs().max().item()
        check(perr <= 1e-4 * max(scale, r_ppre.abs().max().item()),
              f"fused_sa_slab_train ppre differs by {perr}")
        a2 = torch.relu(torch.relu(torch.relu(x0) @ w1 + b1) @ w2 + b2)
        top = r_out[:, :, None, :]
        near = ((a2 >= top - 1e-4 * scale) & (a2 != top)).any(dim=2)
        del a2
        flips = arg != r_arg
        check(not bool((flips & ~near).any()),
              f"fused_sa_slab_train argmax differs in "
              f"{int((flips & ~near).sum())} channels without a near-tie")
        ms = cuda_ms(lambda: fused_mlp_pool_train(x0, *args), 10)
        pms = cuda_ms(lambda: fused_mlp_pool_train_plain(x0, *args), 3)
    lms = cuda_ms(lambda: library_forward(
        [t.detach().requires_grad_() for t in weights]), 3)
    ops = slots * (2 * (c1 * c2 + c2 * c3) + 3 * (c1 + c2 + c3) + 3 * c3)
    nbytes = 4 * (x0.numel() + w1.numel() + w2.numel() + 2 * (c1 + c2 + c3)
                  + 3 * R * M * c3)
    rows["fused_sa_slab_train"] = (max(err, perr), ms, pms, lms, nbytes, ops,
                                   {})
    print(f"fused_sa_slab_train {label} R={R} M={M} S={S} "
          f"C={c1}->{c2}->{c3}: {ms:.3f} ms, bound "
          f"{bound_ms(nbytes, ops)[0]:.3f} ms, plain {pms:.3f} ms, cuBLAS "
          f"chain under autograd {lms:.3f} ms, out equal to eval, "
          f"max_abs_err {err:.3e} / ppre {perr:.3e}, argmax flips "
          f"{int(flips.sum())} of {arg.numel()} (near-ties "
          f"{int(near.sum())}), {ops / ms / 1e9:.1f} TFLOP/s")

    grad = torch.randn(out.shape, generator=gen).to(out.device)
    got = fused_mlp_pool_backward(x0, *args, grad, r_arg, r_ppre)
    ref = fused_mlp_pool_backward_plain(x0, *args, grad, r_arg, r_ppre)
    torch.cuda.synchronize()
    berr = 0.0
    for name, a, b in zip(("d_x0", "dW1", "db1", "dW2", "db2"), got, ref):
        e = (a - b).abs().max().item()
        sc = b.abs().max().item()
        print(f"  fused_sa_slab_bwd {label} {name}: max_abs_err {e:.3e} (max "
              f"|value| {sc:.3e})")
        check(e <= 1e-4 * sc, f"fused_sa_slab_bwd {name} differs by {e} at "
              f"{label}")
        berr = max(berr, e)
    del got, ref
    ms = cuda_ms(lambda: fused_mlp_pool_backward(x0, *args, grad, r_arg,
                                                 r_ppre), 10)
    pms = cuda_ms(lambda: fused_mlp_pool_backward_plain(x0, *args, grad,
                                                        r_arg, r_ppre), 3)

    def library():
        leaves = [t.detach().requires_grad_() for t in weights]
        torch.autograd.grad(library_forward(leaves), leaves, grad)

    lms = cuda_ms(library, 3)
    lbms = library_backward_ms(
        lambda: library_forward([t.detach().requires_grad_()
                                 for t in weights]), grad)
    nnz, hit = routed_slots(r_arg, grad, r_ppre, S)
    # d_a1 and dW2 over the non-zero pooled gradients; layer 1's recompute,
    # dW1, d_a0 and the ReLU masks over the slots they reach
    ops = bwd_ops(hit, nnz, c1, c2)
    # read x0's reached rows, W1, b1, W2, dval and argmax; write d_x0 (every
    # row), dW1, db1 and dW2
    nbytes = 4 * (hit * c1 + x0.numel() + 2 * w1.numel() + 2 * w2.numel()
                  + 2 * c2 + 2 * R * M * c3)
    rows["fused_sa_slab_bwd"] = (berr, ms, pms, lms, nbytes, ops,
                                 dict(lib_bwd_ms=lbms, reached=hit,
                                      slots=slots))
    print(f"fused_sa_slab_bwd {label}: {ms:.3f} ms, bound "
          f"{bound_ms(nbytes, ops)[0]:.4f} ms, plain {pms:.3f} ms, "
          f"autograd of the cuBLAS chain {lms:.3f} ms (forward and "
          f"backward; its backward alone {lbms:.3f} ms), "
          f"{ops / ms / 1e9:.1f} TFLOP/s, {nnz} non-zero pooled "
          f"gradients routed to {hit} of {slots} slots "
          f"({100 * hit / slots:.2f}%)")
    # full spread: every channel live at a slot drawn uniformly over S,
    # against the routed plain version
    full_arg = torch.randint(0, S, r_arg.shape, generator=torch.Generator(
        device=x0.device).manual_seed(SEED + 8), device=x0.device,
        dtype=torch.int32)
    ones = torch.ones_like(r_ppre)
    got = fused_mlp_pool_backward(x0, *args, grad, full_arg, ones)
    ref = fused_mlp_pool_backward_routed_plain(x0, *args, grad, full_arg,
                                               ones)
    torch.cuda.synchronize()
    for name, a, b in zip(("d_x0", "dW1", "db1", "dW2", "db2"), got, ref):
        e = (a - b).abs().max().item()
        sc = b.abs().max().item()
        check(e <= 1e-4 * sc, f"fused_sa_slab_bwd {name} differs by {e} "
              f"under full spread at {label}")
    fms = cuda_ms(lambda: fused_mlp_pool_backward(x0, *args, grad, full_arg,
                                                  ones), 5)
    print(f"fused_sa_slab_bwd {label}, full spread: {fms:.3f} ms, gradients "
          f"within 1e-4 of the routed plain version's largest values")
    return rows


def routed_plain(leaves, arg, eps):
    """The BatchNorm chain in training, plain and differentiable by
    autograd, on leaves (x0, w1, w2, gammas, betas), its max-pool routed
    through the slots ``arg`` (R, M, C3) -> (out, means, vars)."""
    import torch

    from tpu3d_torch.ops import fused_sa as fs

    x, means, vars_ = leaves[0], [], []
    for i in range(3):
        y, mean, var = fs._bn_train(x, leaves[3 + i], leaves[6 + i], eps)
        means.append(mean.detach())
        vars_.append(var.detach())
        x = torch.relu(y) @ leaves[1 + i] if i < 2 else torch.relu(y)
    out = torch.gather(x, 2, arg.long()[:, :, None, :])[:, :, 0]
    return out, means, vars_


def slots_off(a, b, tol):
    """The number of slots (rows of the last axis) where a and b differ by
    more than tol in some channel."""
    return int(((a - b).abs() > tol).any(dim=-1).sum())


def bn_train_kernels(report, model, target, label):
    """Phase 3 for the BatchNorm chain's seven training kernels, at RCNN
    SA_0 and SA_1 of ``model`` (an RCNN with BatchNorm), on the slabs
    grouped from the rows a train step's proposal target layer sampled
    (each level's input from the levels before it at eval). Each entry is
    driven as the training op drives it and held against its plain piece
    on the same inputs: the plain pieces' own x1, x2, d_y1 and d_y0 and the
    packs of their statistics. Each statistics pass's Σx² within 1e-5
    relative and Σx within 1e-5·√(n·Σx²) per channel (f32 layers summed in
    another order, the sums in f64), the slab it writes (x1, x2) within
    1e-4 of its largest value; the final pass, a reduction over the same
    stored x2 rounded as the plain piece rounds it, equal to the bit; each
    wave's two reductions and its weight gradient within 1e-3 of each one's
    largest value (f32 sums of n products in another order), the slab it
    writes and d_x0 within 1e-4. Every pass reads the
    same stored x1 and x2 on both sides and rounds its elementwise forms
    step by step as the plain pieces do, so no ReLU mask flips between the
    two and no noise floor is needed. Then the whole op, forward and backward
    through the seven kernels, against autograd of its plain version in
    f64 (in f32, BatchNorm's backward cancels where a channel's mean
    outweighs its spread, differently in the kernels' x̂ form and in
    autograd of E[x²] − mean²; the plain f32 autograd's own error against
    it is printed), routed by the kernels' argmax (a near-tie may pick
    another slot in f32 sums of another order, which moves a whole
    channel's gradient), on the first ``BN_CHECK_ROWS`` rows (the plain
    chain under autograd keeps several slabs; the statistics are then those
    rows' on both sides): the output and the statistics within 1e-4 of
    each largest value, d_x0 beyond 1e-4 of its largest value in at most 1
    slot in 10^4, the other gradients within 1e-2 (an f32 x1 at y1 ≈ 0
    takes the other sign of the f64 one; one such layer-1 mask flip at a
    slot the pooled gradient reaches moves dW1 by some 0.5% of its largest
    value, and a 128-row sample holds a few); and through autograd equal to
    its passes composed directly, to the bit. Library: torch.var_mean for
    the depth-0 statistics (one call on the same input), none for the other
    passes, and, printed for the level, the cuBLAS chain with
    batch-statistics BatchNorm (F.batch_norm) under autograd, forward and
    backward. -> {level: that chain's ms}."""
    import torch
    import torch.nn.functional as F

    from tpu3d_torch.ops import fused_bn_mlp_pool
    from tpu3d_torch.ops import fused_sa as fs

    levels = slab_levels(model, target["sampled_pts"], target["pts_feature"])
    check([k for k, _, _ in levels] == [0, 1],
          f"{label}: the slab route at RCNN SA_{[k for k, _, _ in levels]}")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 5)
    eps = 1e-5
    library = {}
    for k, x0, mlp in levels:
        where = f"{label}, RCNN SA_{k}"
        R, M, S, c1 = x0.shape
        n = R * M * S
        w1 = mlp.dense_1.weight.detach().T.contiguous()
        w2 = mlp.dense_2.weight.detach().T.contiguous()
        c2, c3 = w1.shape[1], w2.shape[1]
        bns = [getattr(mlp, f"bn_{i}") for i in range(3)]
        gammas = [bn.scale.detach() for bn in bns]
        betas = [bn.bias.detach() for bn in bns]
        widths = (c1, c2, c3)
        layers = [x0.new_zeros(7, c) for c in widths]
        wbytes = 4 * (w1.numel() + w2.numel() + 7 * sum(widths))
        slab = 4 * x0.numel()
        l1, l2 = 2 * c1 * c2, 2 * c2 * c3  # one slot's layer products
        rows = {}

        def add(name, err, ms, pms, lms, nbytes, ops, what):
            b_ms, b_by = bound_ms(nbytes, ops)
            report.add(name, err, ms, pms, lms, nbytes, ops)
            print(f"{name} {where} R={R} M={M} S={S} C={c1}->{c2}->{c3}: "
                  f"{ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), plain "
                  f"{pms:.3f} ms, library "
                  f"{'none' if lms is None else f'{lms:.3f} ms'}, {what}, "
                  f"{ops / ms / 1e9:.1f} TFLOP/s, "
                  f"{nbytes / ms / 1e9:.1f} GB/s")

        with torch.no_grad():
            # the forward passes, each fed the plain pieces' own slabs and
            # statistics: stats0 of x0, stats1 writing x1 from x0, stats2
            # writing x2 from x1, the final reduction over x2
            means, vars_, slabs = [], [], [x0]
            for depth in range(3):
                name = fs.STATS_KERNELS[depth]
                args = ((x0,) if depth == 0 else
                        (slabs[-1], layers[depth - 1][fs.MUL].contiguous(),
                         layers[depth - 1][fs.ADD].contiguous(),
                         (w1, w2)[depth - 1]))
                got = fs.fused_sa_bn_stats(depth, *args)
                want = fs.fused_sa_bn_stats_plain(depth, *args)
                yerr = 0.0
                if depth:
                    (got, y), (want, wy) = got, want
                    yerr = (y - wy).abs().max().item()
                    ysc = wy.abs().max().item()
                    check(yerr <= 1e-4 * ysc, f"{name} x{depth} differs by "
                          f"{yerr} (max |value| {ysc}) at {where}")
                    slabs.append(wy)
                    del y
                torch.cuda.synchronize()
                q_err = ((got[1] - want[1]).abs() / want[1]).max().item()
                s_err = ((got[0] - want[0]).abs()
                         / (n * want[1]).sqrt()).max().item()
                check(q_err <= 1e-5 and s_err <= 1e-5,
                      f"{name} differs at {where}: Σx² by {q_err} relative, "
                      f"Σx by {s_err} of √(n·Σx²)")
                mean, var = fs._mean_var(got, n, x0.dtype)
                pmean, pvar = fs._mean_var(want, n, x0.dtype)
                err = max((mean - pmean).abs().max().item(),
                          (var - pvar).abs().max().item(), yerr)
                ms = cuda_ms(lambda: fs.fused_sa_bn_stats(depth, *args), 5)
                pms = cuda_ms(lambda: fs.fused_sa_bn_stats_plain(
                    depth, *args), 2)
                lms = (cuda_ms(lambda: torch.var_mean(
                    x0, dim=(0, 1, 2), correction=0), 3) if depth == 0
                    else None)
                # per slot: depth 0 a sum and a sum of squares of C1
                # values; depth 1 / 2 the affine and ReLU of the layer
                # before, its product, and the sums of the C_depth outputs;
                # read the slab before, write x_depth
                cin = widths[max(depth - 1, 0)]
                ops = n * ((0, l1, l2)[depth] + 3 * widths[depth]
                           + (3 * cin if depth else 0))
                nbytes = 4 * n * (cin + (widths[depth] if depth else 0))
                add(name, err, ms, pms, lms, nbytes + wbytes
                    + 16 * widths[depth], ops,
                    f"mean/var/x{depth} max_abs_err {err:.3e}, Σx² "
                    f"{q_err:.2e} relative, Σx {s_err:.2e} of √(n·Σx²)")
                means.append(mean)
                vars_.append(var)
                layers[depth] = fs._layer_pack(mean, var, gammas[depth],
                                               betas[depth], eps, n)
                del got, want
            x1, x2 = slabs[1], slabs[2]
            m2, a2 = (layers[2][fs.MUL].contiguous(),
                      layers[2][fs.ADD].contiguous())
            out, arg, at = fs.fused_sa_bn_final(x2, m2, a2)
            r_out, r_arg, r_at = fs.fused_sa_bn_final_plain(x2, m2, a2)
            torch.cuda.synchronize()
            # a reduction over the same stored x2, rounded as the plain
            # piece rounds it: equal to the bit
            check(torch.equal(out, r_out) and torch.equal(arg, r_arg)
                  and torch.equal(at, r_at), f"fused_sa_bn_final differs "
                  f"from its plain piece at {where}")
            ms = cuda_ms(lambda: fs.fused_sa_bn_final(x2, m2, a2), 5)
            pms = cuda_ms(lambda: fs.fused_sa_bn_final_plain(x2, m2, a2), 2)
            add("fused_sa_bn_final", 0.0, ms, pms, None,
                4 * n * c3 + 8 * c3 + 12 * R * M * c3, n * (3 * c3 + 1),
                "out, argmax and x2 there equal to the plain piece's")

            grad = torch.randn(out.shape, generator=gen).to(out.device)
            d_y2 = torch.where(out > 0, grad, 0.0)
            r2 = layers[2][fs.R_INV]
            layers[2] = fs._layer_pack(
                means[2], vars_[2], gammas[2], betas[2], eps, n,
                d_y2.sum(dim=(0, 1)),
                (d_y2 * (at * r2 - means[2] * r2)).sum(dim=(0, 1)))
            dval = (d_y2 * layers[2][fs.MUL]).contiguous()
            # every wave reads the same stored x1 and x2 on both sides and
            # rounds its elementwise forms as the plain pieces do, so no
            # ReLU mask flips between them and no noise floor is needed
            pk = fs._pack(layers)
            wave_cases = []
            got = fs.fused_sa_bn_wave1(x2, x1, pk, w2, dval, arg)
            want = fs.fused_sa_bn_wave1_plain(x2, x1, pk, w2, dval, arg)
            wave_cases.append(("fused_sa_bn_wave1", got, want,
                               ("sums", "dW2", "d_y1"), (
                                   lambda pk=pk: fs.fused_sa_bn_wave1(
                                       x2, x1, pk, w2, dval, arg),
                                   lambda pk=pk: fs.fused_sa_bn_wave1_plain(
                                       x2, x1, pk, w2, dval, arg))))
            d_y1 = want[2]
            d_beta, d_gamma = want[0].to(x0.dtype)
            layers[1] = fs._layer_pack(means[1], vars_[1], gammas[1],
                                       betas[1], eps, n, d_beta, d_gamma)
            pk = fs._pack(layers)
            got = fs.fused_sa_bn_wave2(d_y1, x1, x0, pk, w1)
            want = fs.fused_sa_bn_wave2_plain(d_y1, x1, x0, pk, w1)
            wave_cases.append(("fused_sa_bn_wave2", got, want,
                               ("sums", "dW1", "d_y0"), (
                                   lambda pk=pk: fs.fused_sa_bn_wave2(
                                       d_y1, x1, x0, pk, w1),
                                   lambda pk=pk: fs.fused_sa_bn_wave2_plain(
                                       d_y1, x1, x0, pk, w1))))
            d_y0 = want[2]
            d_beta, d_gamma = want[0].to(x0.dtype)
            layers[0] = fs._layer_pack(means[0], vars_[0], gammas[0],
                                       betas[0], eps, n, d_beta, d_gamma)
            pk = fs._pack(layers)
            got = (fs.fused_sa_bn_apply(d_y0.clone(), x0, pk),)
            want = (fs.fused_sa_bn_apply_plain(d_y0, x0, pk),)
            scratch = torch.empty_like(d_y0)
            wave_cases.append(("fused_sa_bn_apply", got, want, ("d_x0",), (
                lambda pk=pk: fs.fused_sa_bn_apply(scratch, x0, pk),
                lambda pk=pk: fs.fused_sa_bn_apply_plain(d_y0, x0, pk))))
            torch.cuda.synchronize()
            # per slot: wave 1 two products of layer 2 (d_y1 and dW2) and
            # the elementwise d_x2, mask, x̂1 and sums; wave 2 two of layer
            # 1; apply the elementwise d_x0. Each input slab read once,
            # each output slab written once
            ops = {"fused_sa_bn_wave1": n * (2 * l2 + 6 * c3 + 8 * c2),
                   "fused_sa_bn_wave2": n * (2 * l1 + 6 * c2 + 8 * c1),
                   "fused_sa_bn_apply": n * 6 * c1}
            nbytes = {"fused_sa_bn_wave1": 4 * n * (c3 + 2 * c2)
                      + 8 * R * M * c3 + 4 * c2 * c3 + 16 * c2,
                      "fused_sa_bn_wave2": 4 * n * (2 * c2 + 2 * c1)
                      + 4 * c1 * c2 + 16 * c1,
                      "fused_sa_bn_apply": 4 * n * 3 * c1}
            for name, got, want, parts, (kernel, plain) in wave_cases:
                errs, worst = [], 0.0
                for part, a, b in zip(parts, got, want):
                    e = (a - b).abs().max().item()
                    sc = b.abs().max().item()
                    # the reductions and weight gradients sum n products
                    # in f32 in another order (8.4 M at SA_0: dW2 1.4e-4 of
                    # its largest value on the card): 1e-3; the slabs 1e-4
                    tol = 1e-3 if part in ("sums", "dW1", "dW2") else 1e-4
                    check(e <= tol * sc, f"{name} {part} differs by {e} "
                          f"(max |value| {sc}) at {where}")
                    errs.append(f"{part} {e:.3e} of {sc:.3e}")
                    worst = max(worst, e)
                ms = cuda_ms(kernel, 3)
                pms = cuda_ms(plain, 2)
                add(name, worst, ms, pms, None, nbytes[name] + wbytes,
                    ops[name], "max_abs_err " + ", ".join(errs))
            del wave_cases, got, want, scratch, d_y0, d_y1, slabs, x1, x2
            del out, arg, at, r_out, r_arg, r_at, dval
            torch.cuda.empty_cache()

        # the whole op through its seven kernels, on the first
        # BN_CHECK_ROWS rows: against the training forward and backward
        # composed directly (the autograd Function's wiring, to the bit),
        # and against autograd of the plain chain routed by its argmax, in
        # f64
        sub = x0[:BN_CHECK_ROWS].contiguous()
        g = torch.randn(sub.shape[0], M, c3, generator=gen).to(sub.device)
        leaves = [t.detach().clone().requires_grad_() for t in
                  (sub, w1, w2, *gammas, *betas)]
        ref_leaves = [t.detach().clone().requires_grad_() for t in leaves]
        o, (ms_, vs_) = fused_bn_mlp_pool(leaves[0], leaves[1], leaves[2],
                                          leaves[3:6], leaves[6:9])
        grads = torch.autograd.grad(o, leaves, g)
        with torch.no_grad():
            d_o, d_arg, d_x2, d_ms, d_vs, saved = fs.fused_bn_mlp_pool_train(
                sub, w1, w2, gammas, betas)
            d_g = fs.fused_bn_mlp_pool_backward(
                sub, w1, w2, gammas, betas, d_ms, d_vs, d_o, d_arg, d_x2,
                saved, g)
            del saved
        ours = (o.detach(), *ms_, *vs_, *grads)
        direct = (d_o, *d_ms, *d_vs, d_g[0], d_g[1], d_g[2], *d_g[3],
                  *d_g[4])
        check(all(torch.equal(a, b) for a, b in zip(ours, direct)),
              f"fused_bn_mlp_pool through autograd differs from its forward "
              f"and backward composed directly at {where}")
        # the reference in f64: BatchNorm's backward in f32 cancels where a
        # channel's mean outweighs its spread, and the plain chain's f32
        # autograd (E[x²] − mean² differentiated term by term) cancels
        # otherwise than the kernels' x̂ form; its own error is printed
        ref64 = [t.detach().double().requires_grad_() for t in ref_leaves]
        r_o, r_ms, r_vs = routed_plain(ref64, d_arg, eps)
        r_grads = torch.autograd.grad(r_o, ref64, g.double())
        p_o, _, _ = routed_plain(ref_leaves, d_arg, eps)
        p_grads = torch.autograd.grad(p_o, ref_leaves, g)
        names = ("out", "mean0", "mean1", "mean2", "var0", "var1", "var2",
                 "d_x0", "d_w1", "d_w2", "d_gamma0", "d_gamma1", "d_gamma2",
                 "d_beta0", "d_beta1", "d_beta2")
        rows, plain = [], {}
        for part, a, b in zip(names[7:], p_grads, r_grads):
            plain[part] = ((a - b.float()).abs().max().item()
                           / b.abs().max().item())
        for part, a, b in zip(names, ours, (r_o.detach(), *r_ms, *r_vs,
                                            *r_grads)):
            b = b.float()
            sc = b.abs().max().item()
            rows.append((part, (a - b).abs().max().item() / sc,
                         slots_off(a, b, 1e-4 * sc) if part == "d_x0" else 0))
        print(f"fused_bn_mlp_pool forward and backward on the first "
              f"{BN_CHECK_ROWS} rows at {where}: through autograd equal to "
              f"its passes composed directly; against autograd of the plain "
              f"chain in f64, largest error / largest value (and the plain "
              f"chain's own f32 autograd): " + ", ".join(
                  f"{part} {rel:.2e}" + (f" ({plain[part]:.2e})"
                                         if part in plain else "")
                  + (f", {off} slots beyond 1e-4" if part == "d_x0" else "")
                  for part, rel, off in rows))
        for part, rel, off in rows:
            if part == "d_x0":
                check(off <= BN_CHECK_ROWS * M * S // 10000,
                      f"fused_bn_mlp_pool d_x0 differs in {off} slots on "
                      f"{BN_CHECK_ROWS} rows at {where}")
            else:
                tol = 1e-4 if part == "out" or part[:1] in "mv" else 1e-2
                check(rel <= tol, f"fused_bn_mlp_pool {part} differs by "
                      f"{rel:.3e} of its largest value on {BN_CHECK_ROWS} "
                      f"rows at {where}")
        del leaves, ref_leaves, o, grads, r_o, r_grads, sub, ours, direct, d_g
        del ref64, p_o, p_grads
        torch.cuda.empty_cache()

        def library_train():  # cuBLAS with batch-statistics BatchNorm
            ls = [t.detach().requires_grad_() for t in
                  (x0, mlp.dense_1.weight, mlp.dense_2.weight, *gammas,
                   *betas)]
            x = ls[0].view(-1, c1)
            for i, w in enumerate((ls[1], ls[2], None)):
                x = torch.relu(F.batch_norm(x, None, None, ls[3 + i],
                                            ls[6 + i], training=True,
                                            eps=eps))
                if w is not None:
                    x = F.linear(x, w)
            o = x.view(R, M, S, c3).amax(2)
            torch.autograd.grad(o, ls, grad_all)

        grad_all = torch.randn(R, M, c3, generator=gen).to(x0.device)
        library[k] = cuda_ms(library_train, 2)
        print(f"cuBLAS chain with batch-statistics BatchNorm under autograd, "
              f"forward and backward, at {where}: {library[k]:.3f} ms")
        torch.cuda.empty_cache()
    return library


# the widened shapes of the fused kernels: (R, M, S, C1, C2, C3) with S 8,
# 24 and 128 slots and widths 256, 384 and 512 (tests/test_torch_fused_sa_
# wide.py holds the same against tpu3d on the CPU), and one with many
# groups of 128 slots
WIDE_SHAPES = [(2, 16, 8, 256, 384, 512), (2, 16, 24, 384, 512, 256),
               (1, 2, 128, 512, 256, 384), (64, 4, 128, 256, 384, 256)]
# the widened configuration: default.yaml with the RCNN's SA_0 at 128 slots
# and its MLPs at widths 256 / 384, set in memory
WIDE_NSAMPLE0 = 128
WIDE_MLPS = [[256, 384, 256], [256, 256, 384]]
WIDE_BATCH = 2


def wide_kernels():
    """Every fused entry at WIDE_SHAPES against its plain version on the
    card: outputs within 1e-4 of their largest value, the training
    forwards' outputs equal to the eval kernels', argmax equal but at
    near-ties (at most 1 in 1000 channels); the two backwards' gradients
    within 1e-4 of each largest value under the plain forward's own routing
    and with every channel live at a uniform slot (against the routed plain
    versions); the BatchNorm chain's passes on the plain pieces' slabs, as
    bn_train_kernels holds them. -> {entry: the largest error relative to
    its largest value}."""
    import torch

    from tpu3d_torch.ops import (fused_bn_mlp_pool, fused_gathered_mlp_pool,
                                 fused_mlp_pool)
    from tpu3d_torch.ops import fused_sa as fs

    worst = {}

    def near(name, a, b, what):
        e = (a - b).abs().max().item()
        sc = b.abs().max().item()
        check(e <= 1e-4 * sc, f"{name} {what} differs by {e} (max |value| "
              f"{sc}) at the widened shape {shape}")
        worst[name] = max(worst.get(name, 0.0), e / max(sc, 1e-30))

    def flips(name, a, b):
        n = int((a != b).sum())
        check(n <= a.numel() // 1000, f"{name} argmax differs in {n} "
              f"channels at the widened shape {shape}")

    for shape in WIDE_SHAPES:
        R, M, S, c1, c2, c3 = shape
        g = torch.Generator(device=DEVICE).manual_seed(S + c1 + c3)

        def randn(*size, scale=1.0):
            return torch.randn(*size, generator=g, device=DEVICE) * scale

        w1, w2 = randn(c1, c2, scale=c1 ** -0.5), randn(c2, c3,
                                                        scale=c2 ** -0.5)
        b1, b2 = randn(c2, scale=0.1), randn(c3, scale=0.1)
        grad = randn(R, M, c3)
        full = torch.randint(0, S, (R, M, c3), generator=g, device=DEVICE,
                             dtype=torch.int32)
        ones = torch.ones(R, M, c3, device=DEVICE)
        with torch.no_grad():
            # the gather form over 128 source points per row
            pre = randn(R, 128, c1)
            idx = torch.randint(0, 128, (R, M, S), generator=g,
                                device=DEVICE, dtype=torch.int32)
            args = (pre, idx, randn(R, M, c1), w1, b1, w2, b2)
            ref = fs.fused_gathered_mlp_pool_train_plain(*args)
            near("fused_sa", fused_gathered_mlp_pool(*args), ref[0], "out")
            out, arg, ppre = fs.fused_gathered_mlp_pool_train(*args)
            check(torch.equal(out, fused_gathered_mlp_pool(*args)),
                  f"fused_sa_train out differs from the eval kernel's at "
                  f"{shape}")
            near("fused_sa_train", out, ref[0], "out")
            near("fused_sa_train", ppre, ref[2], "ppre")
            flips("fused_sa_train", arg, ref[1])
        got = fs.fused_gathered_mlp_pool_backward(*args, grad, ref[1], ref[2])
        want = fs.fused_gathered_mlp_pool_backward_plain(*args, grad)
        for part, a, b in zip(("d_pre", "d_center", "dW1", "db1", "dW2",
                               "db2"), got, want):
            near("fused_sa_bwd", a, b, part)
        got = fs.fused_gathered_mlp_pool_backward(*args, grad, full, ones)
        want = fs.fused_gathered_mlp_pool_backward_routed_plain(
            *args, grad, full, ones)
        for part, a, b in zip(("d_pre", "d_center", "dW1", "db1", "dW2",
                               "db2"), got, want):
            near("fused_sa_bwd", a, b, part + " (full spread)")
        del args, pre, got, want
        with torch.no_grad():
            # the slab form, whose groups repeat their first h slots
            x0 = randn(R, M, S, c1)
            h = torch.randint(1, S + 1, (R, M, 1), generator=g,
                              device=DEVICE)
            slots = torch.arange(S, device=DEVICE) % h
            x0 = torch.gather(x0, 2, slots[..., None].expand(
                -1, -1, -1, c1)).contiguous()
            ref = fs.fused_mlp_pool_train_plain(x0, w1, b1, w2, b2)
            near("fused_sa_slab", fused_mlp_pool(x0, w1, b1, w2, b2),
                 ref[0], "out")
            out, arg, ppre = fs.fused_mlp_pool_train(x0, w1, b1, w2, b2)
            check(torch.equal(out, fused_mlp_pool(x0, w1, b1, w2, b2)),
                  f"fused_sa_slab_train out differs from the eval kernel's "
                  f"at {shape}")
            near("fused_sa_slab_train", out, ref[0], "out")
            near("fused_sa_slab_train", ppre, ref[2], "ppre")
            flips("fused_sa_slab_train", arg, ref[1])
            for routing, (a_, p_) in (("seeded", ref[1:]),
                                      ("full spread", (full, ones))):
                got = fs.fused_mlp_pool_backward(x0, w1, b1, w2, b2, grad,
                                                 a_, p_)
                want = fs.fused_mlp_pool_backward_routed_plain(
                    x0, w1, b1, w2, b2, grad, a_, p_)
                for part, a, b in zip(("d_x0", "dW1", "db1", "dW2", "db2"),
                                      got, want):
                    near("fused_sa_slab_bwd", a, b, f"{part} ({routing})")
            # the BatchNorm chain: eval, then the seven training passes
            gammas = [1 + randn(c, scale=0.2) for c in (c1, c2, c3)]
            betas = [randn(c, scale=0.2) for c in (c1, c2, c3)]
            stats = [(randn(c, scale=0.3), 0.5 + torch.rand(
                c, generator=g, device=DEVICE)) for c in (c1, c2, c3)]
            packs = fs.bn_packs([fs._bn_affine(m, v, ga, be, 1e-5)[:2]
                                 for (m, v), ga, be in
                                 zip(stats, gammas, betas)])
            near("fused_sa_slab_bn", fused_bn_mlp_pool(
                x0, w1, w2, gammas, betas, stats),
                fs.fused_sa_slab_plain(x0, packs, w1, w2), "out")
            n = R * M * S
            out, arg, at, means, vars_ = fs.fused_bn_mlp_pool_train_plain(
                x0, w1, w2, gammas, betas)
            layers = [fs._layer_pack(m, v, ga, be, 1e-5, n) for m, v, ga, be
                      in zip(means, vars_, gammas, betas)]
            slabs = [x0]
            for depth in range(3):
                name = fs.STATS_KERNELS[depth]
                a = ((x0,) if depth == 0 else
                     (slabs[-1], layers[depth - 1][fs.MUL].contiguous(),
                      layers[depth - 1][fs.ADD].contiguous(),
                      (w1, w2)[depth - 1]))
                got = fs.fused_sa_bn_stats(depth, *a)
                want = fs.fused_sa_bn_stats_plain(depth, *a)
                if depth:
                    near(name, got[1], want[1], f"x{depth}")
                    slabs.append(want[1])
                    got, want = got[0], want[0]
                near(name, got[1], want[1], "Σx²")
                near(name, got[0], want[0], "Σx")
            x1, x2 = slabs[1], slabs[2]
            m2 = layers[2][fs.MUL].contiguous()
            a2 = layers[2][fs.ADD].contiguous()
            got = fs.fused_sa_bn_final(x2, m2, a2)
            want = fs.fused_sa_bn_final_plain(x2, m2, a2)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"fused_sa_bn_final differs from its plain piece at "
                  f"{shape}")
            worst["fused_sa_bn_final"] = 0.0
            d_y2 = torch.where(out > 0, grad, 0.0)
            r2 = layers[2][fs.R_INV]
            layers[2] = fs._layer_pack(
                means[2], vars_[2], gammas[2], betas[2], 1e-5, n,
                d_y2.sum(dim=(0, 1)),
                (d_y2 * (at * r2 - means[2] * r2)).sum(dim=(0, 1)))
            for layer in (1, 0):  # non-zero ca, cb
                layers[layer][5:] = randn(2, layers[layer].shape[1],
                                          scale=0.3)
            pk = fs._pack(layers)
            dval = (d_y2 * layers[2][fs.MUL]).contiguous()
            got = fs.fused_sa_bn_wave1(x2, x1, pk, w2, dval, arg)
            want = fs.fused_sa_bn_wave1_plain(x2, x1, pk, w2, dval, arg)
            for part, a, b in zip(("sums", "dW2", "d_y1"), got, want):
                near("fused_sa_bn_wave1", a, b, part)
            got = fs.fused_sa_bn_wave2(want[2], x1, x0, pk, w1)
            want = fs.fused_sa_bn_wave2_plain(want[2], x1, x0, pk, w1)
            for part, a, b in zip(("sums", "dW1", "d_y0"), got, want):
                near("fused_sa_bn_wave2", a, b, part)
            near("fused_sa_bn_apply",
                 fs.fused_sa_bn_apply(want[2].clone(), x0, pk),
                 fs.fused_sa_bn_apply_plain(want[2], x0, pk), "d_x0")
        del x0, slabs, x1, x2, got, want
        torch.cuda.empty_cache()
        print(f"widened shape R={R} M={M} S={S} C={c1}->{c2}->{c3}: every "
              f"fused entry within its bound of its plain version")
    return worst


def widened_config(cfg, bn):
    """default.yaml's config with the RCNN's SA_0 at WIDE_NSAMPLE0 slots
    and its first two MLPs at WIDE_MLPS, and RCNN.USE_BN = bn, in
    memory."""
    wcfg = copy.deepcopy(cfg)
    sa = wcfg.RCNN.SA_CONFIG
    sa.NSAMPLE = [WIDE_NSAMPLE0, *sa.NSAMPLE[1:]]
    sa.MLPS = [list(m) for m in WIDE_MLPS] + [list(sa.MLPS[2])]
    wcfg.RCNN.USE_BN = bn
    return wcfg


def widened_paths(cfg, pts, batch):
    """The widened configuration's joint eval path and joint train step at
    B=WIDE_BATCH, without and with BatchNorm: sa_route must fuse both RCNN
    SA levels (the gather route without BatchNorm, the slab route with it)
    and each path must launch the fused kernels of both levels, once per
    level: fused_sa at eval and fused_sa_train / fused_sa_bwd in the step
    without BatchNorm, fused_sa_slab_bn and the seven training entries with
    it. -> {label: (ms, launches, peak GiB)}."""
    import torch

    from tpu3d_torch.models import PointRCNN
    from tpu3d_torch.ops import sa_route
    from tpu3d_torch.tools.eval_rcnn import make_infer_step
    from tpu3d_torch.weights import seeded_state_dict

    runs = {}
    for bn in (False, True):
        wcfg = widened_config(cfg, bn)
        sa = wcfg.RCNN.SA_CONFIG
        rows = WIDE_BATCH * wcfg.TEST.RPN_POST_NMS_TOP_N
        n, routes = wcfg.RCNN.NUM_POINTS, []
        for k in range(2):
            routes.append(sa_route((rows, sa.NPOINTS[k], sa.NSAMPLE[k],
                                    sa.MLPS[k][0]), sa.MLPS[k], n, bn))
            n = sa.NPOINTS[k]
        want = "slab" if bn else "gather"
        check(routes == [want, want], f"the widened config with USE_BN {bn} "
              f"routes its RCNN SA levels {routes}, expected {want} at both")
        name = "BatchNorm " if bn else ""
        model = PointRCNN(wcfg, mode="TEST", device=DEVICE)
        model.load_state_dict(seeded_state_dict(model, SEED))
        fused = {"fused_sa_slab_bn": 2} if bn else {"fused_sa": 2}
        torch.cuda.reset_peak_memory_stats()
        out, launches, ms = drive(make_infer_step(model, wcfg),
                                  pts[:WIDE_BATCH], tuple(fused),
                                  f"widened {name}joint")
        for k, v in fused.items():
            check(launches[k] == v, f"widened {name}eval launched {k} "
                  f"{launches[k]} times, expected {v}")
        # the joint path's shapes and finite values; the RPN's rois are
        # default.yaml's, so some are valid; the random widened RCNN may
        # score every box under the threshold, so the final boxes are
        # counted, not required
        post = wcfg.TEST.RPN_POST_NMS_TOP_N
        check_outputs(out, {
            "final_boxes": (WIDE_BATCH, 100, 7),
            "final_scores": (WIDE_BATCH, 100),
            "pred_boxes3d": (WIDE_BATCH, post, 7),
            "rois": (WIDE_BATCH, post, 7), "roi_valid": (WIDE_BATCH, post)})
        check(int(out["roi_valid"].sum()) > 0, f"widened {name}eval: no "
              f"valid roi")
        n_final = int(out["final_mask"].sum())
        runs[f"widened {name}eval B={WIDE_BATCH}"] = (
            ms, launches, torch.cuda.max_memory_allocated() / 2**30)
        del model, out
        tmodel = PointRCNN(wcfg, mode="TRAIN", device=DEVICE)
        tmodel.load_state_dict(train_weights(tmodel, SEED))
        fused = ({k: 2 for k in BN_TRAIN_KERNELS} if bn
                 else {"fused_sa_train": 2, "fused_sa_bwd": 2})
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
        tb = {k: v[:WIDE_BATCH] for k, v in batch.items()}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, launches, ms = drive_train(wcfg, tmodel, tb, gen, tuple(fused),
                                      f"widened {name}joint train step", 2)
        for k, v in fused.items():
            check(launches[k] == v, f"widened {name}train step launched {k} "
                  f"{launches[k]} times, expected {v}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs[f"widened {name}train B={WIDE_BATCH}"] = (ms, launches, peak)
        print(f"widened {name}config (RCNN SA_0 NSAMPLE {WIDE_NSAMPLE0}, "
              f"MLPs {WIDE_MLPS}): eval {runs[f'widened {name}eval B={WIDE_BATCH}'][0]:.1f} "
              f"ms/batch ({n_final} final boxes), train {ms:.1f} ms/step, "
              f"peak device memory {peak:.2f} GiB; routes {routes}, fused "
              f"launches as expected")
        del tmodel
        torch.cuda.empty_cache()
    return runs


def pooled_inputs(model, pts):
    """The RCNN's pooled ROIs (xyz, rest) of the joint eval forward."""
    import torch

    with torch.no_grad():
        out = model({"pts_input": pts})
        xyz, rest, _, _ = model.pool_rois(
            out["backbone_xyz"], out["backbone_features"],
            out["rpn_cls"][..., 0], out["rois"])
    return xyz, rest


def sampled_targets(model, batch, state, gen):
    """The targets the train step's RCNN sees, from one train-mode forward;
    the running statistics it moved are restored from ``state``."""
    import torch

    with torch.no_grad():
        out = model({"pts_input": batch["pts_input"],
                     "gt_boxes3d": batch["gt_boxes3d"]}, train=True,
                    bn_momentum=0.9, generator=gen)
    model.load_state_dict(state)
    return {k: out[k] for k in (
        "sampled_pts", "pts_feature", "cls_label", "reg_valid_mask",
        "gt_of_rois", "gt_iou", "roi_boxes3d")}


def check_joint_outputs(cfg, out, batch, label):
    """The joint eval path's outputs: shapes, finite values, some valid rois
    and some final boxes."""
    post, n = cfg.TEST.RPN_POST_NMS_TOP_N, cfg.RPN.NUM_POINTS
    check_outputs(out, {
        "final_boxes": (batch, 100, 7), "final_scores": (batch, 100),
        "final_mask": (batch, 100), "pred_boxes3d": (batch, post, 7),
        "norm_scores": (batch, post), "raw_scores": (batch, post),
        "rois": (batch, post, 7), "roi_scores_raw": (batch, post),
        "roi_valid": (batch, post), "seg_result": (batch, n)})
    n_valid = int(out["roi_valid"].sum())
    n_final = int(out["final_mask"].sum())
    check(n_valid > 0, f"{label} eval: no valid roi")
    check(n_final > 0, f"{label} eval: no final box")
    print(f"{label} joint path: B={batch} N={n} NPOINTS="
          f"{list(cfg.RPN.SA_CONFIG.NPOINTS)} pre/post NMS "
          f"{cfg.TEST.RPN_PRE_NMS_TOP_N}/{post}, RCNN {cfg.RCNN.NUM_POINTS} "
          f"points per ROI, NPOINTS {list(cfg.RCNN.SA_CONFIG.NPOINTS)}: "
          f"valid rois {n_valid}/{batch * post}, final boxes "
          f"{n_final}/{batch * 100}")


def check_launches(launches, expect, label):
    """Exact launch counts of one forward or step: ``expect``'s, and 0 for
    every other kernel."""
    for name, n in launches.items():
        check(n == expect.get(name, 0), f"{label}: {name} launched {n} "
              f"times, expected {expect.get(name, 0)}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from tpu3d_torch.config import cfg_from_file, fresh_cfg
    from tpu3d_torch.datasets import random_scenes, train_batch
    from tpu3d_torch.models import PointRCNN
    from tpu3d_torch.ops import _build
    from tpu3d_torch.ops import furthest_point_sample_with_3nn, gather_points
    from tpu3d_torch.tools.kernel_bench import (dense_inputs, fps_pyramid,
                                                record_nearest_k)
    from tpu3d_torch.tools.eval_rcnn import (make_infer_step,
                                             make_rpn_infer_step)

    phases = Phases()
    from tpu3d_torch.tools.train_rcnn import configure_mode
    from tpu3d_torch.weights import seeded_state_dict

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"tf32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn tf32 {torch.backends.cudnn.allow_tf32}")
    phases.done("1 (card)")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(logs) or 'nothing (already built)'}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Function properties for" in line:  # the (mangled) kernel
                print(f"  ptxas {name}: {line.split(' for ')[-1][:72]}")
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    for name in _build.KERNELS:
        _build.kernel(name)
    phases.done("2 (build)")

    # configs/default.yaml as shipped runs the joint path; the RPN-only
    # path is the same model with RCNN off and the RPN's weights
    cfg = cfg_from_file(str(ROOT / "configs" / "default.yaml"), fresh_cfg())
    check(cfg.RCNN.ENABLED, "default.yaml should enable the RCNN stage")
    rpn_cfg = copy.deepcopy(cfg)
    rpn_cfg.RCNN.ENABLED = False
    B, N = BATCH, cfg.RPN.NUM_POINTS
    dev = torch.device(DEVICE)
    pts = torch.from_numpy(random_scenes(B, N, SEED)).to(dev)
    model = PointRCNN(cfg, mode="TEST", device=dev)
    state = seeded_state_dict(model, SEED)
    model.load_state_dict(state)
    rpn_model = PointRCNN(rpn_cfg, mode="TEST", device=dev)
    rpn_state = {k: v for k, v in state.items() if k.startswith("rpn.")}
    rpn_model.load_state_dict(rpn_state)

    # the train step: the same config in joint mode (as shipped), B=16
    # scenes with their gt boxes, on the model in TRAIN mode
    train_model = PointRCNN(cfg, mode="TRAIN", device=dev)
    train_state = train_weights(train_model, SEED)
    train_model.load_state_dict(train_state)
    tb_np = train_batch(TRAIN_BATCH, N, SEED)
    tbatch = {k: torch.from_numpy(v).to(dev) for k, v in tb_np.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # the targets the step's RCNN sees and the step's nearest_k calls, for
    # phase 3; the eval forward's nearest_k calls and pooled ROIs
    with record_nearest_k() as train_nk:
        target = sampled_targets(train_model, tbatch, train_state, gen)
    with record_nearest_k() as eval_nk:
        eval_xyz, eval_rest = pooled_inputs(model, pts)

    # configs/double.yaml: default.yaml at 32768 points per scene, so the
    # same parameter tree and seeded weights; eval at B=4, train at B=16
    dcfg = cfg_from_file(str(ROOT / "configs" / "double.yaml"), fresh_cfg())
    DN = dcfg.RPN.NUM_POINTS
    check(DN == 32768 and dcfg.RCNN.ENABLED,
          "double.yaml should run 32768 points per scene, RCNN on")
    dpts = torch.from_numpy(random_scenes(DOUBLE_BATCH, DN, SEED)).to(dev)
    dtbatch = {k: torch.from_numpy(v).to(dev)
               for k, v in train_batch(TRAIN_BATCH, DN, SEED).items()}
    sa0 = dcfg.RPN.SA_CONFIG.NPOINTS[0]

    # configs/quickstart.yaml and configs/smoke.yaml as shipped, each with
    # its own seeded weights: eval and train batches, and the targets of
    # the train step's RCNN
    side = {}
    for name, eval_b, train_b in (
            ("quickstart", QUICK_EVAL_BATCH, QUICK_TRAIN_BATCH),
            ("smoke", SMOKE_BATCH, SMOKE_BATCH)):
        c = cfg_from_file(str(ROOT / "configs" / f"{name}.yaml"), fresh_cfg())
        m = PointRCNN(c, mode="TEST", device=dev)
        m.load_state_dict(seeded_state_dict(m, SEED))
        tm = PointRCNN(c, mode="TRAIN", device=dev)
        ts = train_weights(tm, SEED)
        tm.load_state_dict(ts)
        n = c.RPN.NUM_POINTS
        tb = {k: torch.from_numpy(v).to(dev)
              for k, v in train_batch(train_b, n, SEED).items()}
        side[name] = dict(
            cfg=c, model=m, train_model=tm, tbatch=tb,
            pts=torch.from_numpy(random_scenes(eval_b, n, SEED)).to(dev),
            target=sampled_targets(tm, tb, ts, gen))
    q, sm = side["quickstart"], side["smoke"]

    # default.yaml with RCNN.USE_BN true (no file in configs/ sets it): the
    # RCNN's BatchNorm parameters and statistics seeded away from 0 and 1,
    # eval on the default scenes
    bcfg = copy.deepcopy(cfg)
    bcfg.RCNN.USE_BN = True
    bmodel = PointRCNN(bcfg, mode="TEST", device=dev)
    bstate = seeded_state_dict(bmodel, SEED)
    bmodel.load_state_dict(bstate)
    check(any(".bn_" in k for k in bstate if k.startswith("rcnn_net.sa_0")),
          "the BatchNorm RCNN has no BatchNorm in its SA levels")
    # the same config in training, its own generator so that the draws of
    # the earlier phases stay as they were: the train step at B=16 on the
    # default batch, and the targets its RCNN sees, for phase 3
    btrain_model = PointRCNN(bcfg, mode="TRAIN", device=dev)
    btrain_state = train_weights(btrain_model, SEED)
    btrain_model.load_state_dict(btrain_state)
    btbatch = tbatch
    bgen = torch.Generator(device=dev).manual_seed(SEED + 6)
    btarget = sampled_targets(btrain_model, btbatch, btrain_state, bgen)
    phases.done("setup")

    # 3. each kernel against its plain version, at its path's shapes
    report, double_report = Report(), Report()
    train_report, dense_report = Report(), Report()
    rpn_kernels(report, cfg, pts, "default.yaml eval B=2")
    with torch.no_grad():
        eval_features = model.rcnn_net.point_features(eval_xyz, eval_rest)
    rcnn_kernels(report, model.rcnn_net, eval_xyz, eval_features,
                 "default.yaml eval B=2")
    del eval_xyz, eval_rest, eval_features
    # the train step's shapes of the eval kernels (B=16, 1024 ROIs)
    rpn_kernels(train_report, cfg, tbatch["pts_input"],
                "default.yaml train B=16", fps3nn=False)
    rcnn_kernels(train_report, train_model.rcnn_net, target["sampled_pts"],
                 None, "default.yaml train B=16")
    # nearest_k at the six levels of the eval forward and of the train
    # step, on the dense box, and at double.yaml's SA_0 (eval B=4)
    nk_sweep = []
    nearest_k_kernels(report, eval_nk, "default.yaml eval B=2", nk_sweep)
    nearest_k_kernels(train_report, train_nk, "default.yaml train B=16",
                      nk_sweep)
    nearest_k_kernels(dense_report, dense_inputs(
        torch.Generator(device=dev).manual_seed(SEED)), "dense box",
        nk_sweep)
    dsa = dcfg.RPN.SA_CONFIG
    check_nearest_k(double_report, fps_pyramid(dpts, (sa0,))[1], dpts,
                    max(dsa.NSAMPLE[0]), max(dsa.RADIUS[0]), True,
                    "double.yaml eval B=4, RPN SA_0", nk_sweep)
    del eval_nk, train_nk
    torch.cuda.empty_cache()
    interp_bwd_kernels(report, cfg, tbatch["pts_input"])
    full_spread = {}
    fused_train_kernels(report, full_spread, train_model, target)
    torch.cuda.empty_cache()
    double_kernels(report, double_report, dpts,
                   dtbatch["pts_input"][..., :3].contiguous(), sa0)
    torch.cuda.empty_cache()
    # FPS's pick loop at every level it serves on each path: its launch
    # geometry and the sweep around it, the 3-NN pass, the latency floor
    fps_rows, fps_floor = fps_pick_loop({
        path: (p["pts_input"][..., :3].contiguous() if isinstance(p, dict)
               else p, c.RPN.SA_CONFIG.NPOINTS)
        for path, p, c in (
            ("default.yaml eval B=2", pts, cfg),
            ("default.yaml train B=16", tbatch, cfg),
            ("double.yaml eval B=4", dpts, dcfg),
            ("double.yaml train B=16", dtbatch, dcfg),
            (QUICK_PATH["eval"], q["pts"], q["cfg"]),
            (QUICK_PATH["train"], q["tbatch"], q["cfg"]),
            (SMOKE_PATH["eval"], sm["pts"], sm["cfg"]),
            (SMOKE_PATH["train"], sm["tbatch"], sm["cfg"]))})
    torch.cuda.empty_cache()
    # the slab form: the eval kernel at RCNN SA_1 of quickstart.yaml's and
    # smoke.yaml's eval forward, the training kernels at RCNN SA_1 of their
    # train steps' sampled rows (smoke's kept apart in smoke_report), the
    # eval kernel with BatchNorm packs at RCNN SA_0 and SA_1 of the
    # BatchNorm RCNN's eval forward
    smoke_report = Report()
    slab_gen = torch.Generator(device="cpu").manual_seed(SEED + 4)
    slab_cases = (
        (QUICK_PATH["eval"], q["model"], pooled_inputs(q["model"], q["pts"]),
         report, [1], False),
        (SMOKE_PATH["eval"], sm["model"], pooled_inputs(sm["model"],
                                                        sm["pts"]),
         smoke_report, [1], False),
        (QUICK_PATH["train"], q["train_model"],
         (q["target"]["sampled_pts"], q["target"]["pts_feature"]), report,
         [1], True),
        (SMOKE_PATH["train"], sm["train_model"],
         (sm["target"]["sampled_pts"], sm["target"]["pts_feature"]),
         smoke_report, [1], True),
        (BN_PATH, bmodel, pooled_inputs(bmodel, pts), report, [0, 1], False))
    for path, mdl, inputs, into, expect_levels, train in slab_cases:
        levels = slab_levels(mdl, *inputs)
        check([k for k, _, _ in levels] == expect_levels,
              f"{path}: the slab route at RCNN SA_"
              f"{[k for k, _, _ in levels]}, expected {expect_levels}")
        for k, x0, mlp in levels:
            label = f"{path}, RCNN SA_{k}"
            if train:
                for name, (*row, counts) in slab_train_kernels(
                        x0, mlp, label, slab_gen).items():
                    into.add(name, *row, **counts)
            else:
                name, row = slab_eval_kernel(x0, mlp, label)
                into.add(name, *row)
        del levels
        torch.cuda.empty_cache()
    # the BatchNorm chain's training kernels at RCNN SA_0 and SA_1 of the
    # BatchNorm RCNN's train step (B=16)
    bn_library = bn_train_kernels(report, btrain_model, btarget,
                                  BN_TRAIN_PATH)
    torch.cuda.empty_cache()
    # every fused entry at the widened shapes
    wide_worst = wide_kernels()
    torch.cuda.empty_cache()
    phases.done("3 (kernels against plain)")

    # 4. both paths at full width
    post = cfg.TEST.RPN_POST_NMS_TOP_N
    feat_c = cfg.RPN.FP_MLPS[0][-1]
    rpn_out, _, rpn_path_ms = drive(
        make_rpn_infer_step(rpn_model, rpn_cfg), pts,
        ("fps3nn", "nearest_k", "three_interpolate"), "RPN-only")
    check_outputs(rpn_out, {
        "rois": (B, post, 7), "roi_scores_raw": (B, post),
        "roi_valid": (B, post), "seg_result": (B, N),
        "rpn_scores_raw": (B, N), "backbone_xyz": (B, N, 3),
        "backbone_features": (B, N, feat_c)})

    torch.cuda.reset_peak_memory_stats()
    out, launches, path_ms = drive(make_infer_step(model, cfg), pts,
                                   EVAL_KERNELS, "joint")
    check_joint_outputs(cfg, out, B, "default")
    kernels_ms = sum(report.rows[k]["ms"] for k in EVAL_KERNELS)
    print(f"joint path {path_ms:.1f} ms/batch, RPN-only path "
          f"{rpn_path_ms:.1f} ms/batch; the five kernels {kernels_ms:.1f} ms "
          f"of device time per joint forward; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    phases.done("4 (eval paths)")

    # 5. the train step at full width, joint mode, then rpn mode
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tb, train_launches, step_ms = drive_train(
        cfg, train_model, tbatch, gen, TRAIN_KERNELS, "joint train step", 5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"joint train step: B={TRAIN_BATCH} N={N} TRAIN pre/post NMS "
          f"{cfg.TRAIN.RPN_PRE_NMS_TOP_N}/{cfg.TRAIN.RPN_POST_NMS_TOP_N}, "
          f"{cfg.RCNN.ROI_PER_IMAGE} ROIs of {cfg.RCNN.NUM_POINTS} points "
          f"per scene: {step_ms:.1f} ms/step, peak device memory "
          f"{peak:.2f} GiB; rpn_loss {float(tb['rpn_loss']):.4f}, rcnn_loss "
          f"{float(tb['rcnn_loss']):.4f}, sampled fg {int(tb['rcnn_cls_fg'])}"
          f" / bg {int(tb['rcnn_cls_bg'])}")
    rpn_train_cfg = configure_mode(copy.deepcopy(cfg), "rpn")
    rpn_train_model = PointRCNN(rpn_train_cfg, mode="TRAIN", device=dev)
    rpn_train_model.load_state_dict(
        {k: v for k, v in train_state.items() if k.startswith("rpn.")})
    drive_train(rpn_train_cfg, rpn_train_model, tbatch, gen,
                RPN_TRAIN_KERNELS, "rpn-mode train step", 1)
    del rpn_train_model
    torch.cuda.empty_cache()
    phases.done("5 (train steps)")

    # 6. scene 0 through the plain path on the CPU
    cpu_model = PointRCNN(cfg, mode="TEST", device="cpu")
    cpu_model.load_state_dict(state)
    x_cpu = pts[:1].cpu()
    mismatches, x_gpu = 0, pts[:1]
    for npoint in cfg.RPN.SA_CONFIG.NPOINTS:
        i_cpu = furthest_point_sample_with_3nn(x_cpu, npoint)[0]
        i_gpu = furthest_point_sample_with_3nn(x_gpu, npoint)[0]
        mismatches += int((i_cpu != i_gpu.cpu()).sum())
        x_cpu, x_gpu = gather_points(x_cpu, i_cpu), gather_points(x_gpu, i_gpu)
    print(f"FPS picks, CUDA kernel vs plain CPU path on scene 0: "
          f"{mismatches} mismatches")
    check(mismatches == 0, "FPS picks differ between the card and the CPU")
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = cpu_model.rpn(pts[:1].cpu())
    cpu_s = time.perf_counter() - t0
    with torch.no_grad():
        got = model.rpn(pts[:1])
    for key in ("rpn_cls", "rpn_reg", "backbone_features"):
        a, b = got[key].cpu(), ref[key]
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        print(f"{key}: card vs CPU max abs err {err:.3e} (max |value| "
              f"{scale:.3e})")
        # f32 sums in another order on the two devices; tolerance 1e-4
        # relative to the largest value
        check(err <= 1e-4 * max(scale, 1.0), f"{key} differs by {err}")
    print(f"CPU plain path: {cpu_s:.1f} s for scene 0's RPN")
    with torch.no_grad():
        joint = model({"pts_input": pts})
    joint["rpn_scores_raw"] = joint["rpn_cls"][..., 0]
    compare_rcnn_on_cpu(cfg, model, cpu_model, joint)
    compare_train_on_cpu(cfg, train_model, target, tbatch)
    del model, rpn_model, train_model, cpu_model, joint, target, tbatch
    torch.cuda.empty_cache()
    phases.done("6 (card against CPU)")

    # 7. configs/double.yaml: the joint eval path at B=4, the joint train
    # step at B=16, and scene 0's split route against the CPU
    dmodel = PointRCNN(dcfg, mode="TEST", device=dev)
    dmodel.load_state_dict(state)
    torch.cuda.reset_peak_memory_stats()
    dout, dlaunches, dpath_ms = drive(make_infer_step(dmodel, dcfg), dpts,
                                      EVAL_KERNELS, "double joint")
    n_levels = len(dcfg.RPN.SA_CONFIG.NPOINTS)
    check(dlaunches["fps3nn"] == n_levels,
          f"double eval launched fps3nn {dlaunches['fps3nn']} times, "
          f"expected once per RPN level ({n_levels})")
    check(dlaunches["three_nn"] == 0 and dlaunches["fps_long"] == 0,
          "double eval should take the fused route at every level")
    check_joint_outputs(dcfg, dout, DOUBLE_BATCH, "double")
    print(f"double joint path: {dpath_ms:.1f} ms/batch, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del dmodel, dout
    torch.cuda.empty_cache()

    dtrain_model = PointRCNN(dcfg, mode="TRAIN", device=dev)
    dtrain_model.load_state_dict(train_state)
    torch.cuda.reset_peak_memory_stats()
    dtb, dtrain_launches, dstep_ms = drive_train(
        dcfg, dtrain_model, dtbatch, gen, DOUBLE_TRAIN_KERNELS,
        "double joint train step", 3)
    dpeak = torch.cuda.max_memory_allocated() / 2**30
    check(dtrain_launches["three_nn"] == 1 and dtrain_launches["fps_long"] == 1,
          "the double train step should launch three_nn and fps_long once "
          "(SA_0's split route)")
    print(f"double joint train step: B={TRAIN_BATCH} N={DN}: {dstep_ms:.1f} "
          f"ms/step, peak device memory {dpeak:.2f} GiB; rpn_loss "
          f"{float(dtb['rpn_loss']):.4f}, rcnn_loss "
          f"{float(dtb['rcnn_loss']):.4f}")
    del dtrain_model
    torch.cuda.empty_cache()
    compare_split_on_cpu(dtbatch["pts_input"][..., :3].contiguous(), sa0)
    phases.done("7 (double.yaml)")

    # 8. configs/quickstart.yaml: the joint eval path at B=8 and the joint
    # train step at B=4, then scene 0 against the CPU plain path
    qcfg = q["cfg"]
    torch.cuda.reset_peak_memory_stats()
    qout, qlaunches, qpath_ms = drive(make_infer_step(q["model"], qcfg),
                                      q["pts"], tuple(QUICK_EVAL),
                                      "quickstart joint")
    check_launches(qlaunches, QUICK_EVAL, "quickstart eval")
    check_joint_outputs(qcfg, qout, QUICK_EVAL_BATCH, "quickstart")
    print(f"quickstart joint path: B={QUICK_EVAL_BATCH} {qpath_ms:.1f} "
          f"ms/batch, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    _, qtrain_launches, qstep_ms = drive_train(
        qcfg, q["train_model"], q["tbatch"], gen, tuple(QUICK_TRAIN),
        "quickstart joint train step", 5)
    check_launches(qtrain_launches, QUICK_TRAIN, "quickstart train step")
    print(f"quickstart joint train step: B={QUICK_TRAIN_BATCH} "
          f"{qstep_ms:.1f} ms/step, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    qcpu = PointRCNN(qcfg, mode="TEST", device="cpu")
    qcpu.load_state_dict({k: v.cpu() for k, v in
                          q["model"].state_dict().items()})
    with torch.no_grad():
        joint = q["model"]({"pts_input": q["pts"]})
    joint["rpn_scores_raw"] = joint["rpn_cls"][..., 0]
    compare_rcnn_on_cpu(qcfg, q["model"], qcpu, joint)
    compare_train_on_cpu(qcfg, q["train_model"], q["target"], q["tbatch"],
                         rpn=False)
    del qcpu, joint, qout, side, q
    torch.cuda.empty_cache()
    phases.done("8 (quickstart.yaml)")

    # 9. configs/smoke.yaml: the joint eval path and the joint train step,
    # both at B=2
    scfg = sm["cfg"]
    sout, slaunches, spath_ms = drive(make_infer_step(sm["model"], scfg),
                                      sm["pts"], tuple(SMOKE_EVAL),
                                      "smoke joint")
    check_launches(slaunches, SMOKE_EVAL, "smoke eval")
    check_joint_outputs(scfg, sout, SMOKE_BATCH, "smoke")
    _, strain_launches, sstep_ms = drive_train(
        scfg, sm["train_model"], sm["tbatch"], gen, tuple(SMOKE_TRAIN),
        "smoke joint train step", 3)
    check_launches(strain_launches, SMOKE_TRAIN, "smoke train step")
    print(f"smoke joint path: B={SMOKE_BATCH} {spath_ms:.1f} ms/batch; "
          f"joint train step: B={SMOKE_BATCH} {sstep_ms:.1f} ms/step")
    del sm, sout
    phases.done("9 (smoke.yaml)")

    # 10. default.yaml with RCNN.USE_BN true: the joint eval path at B=2,
    # then scene 0's RCNN stage and final boxes against the CPU plain path
    torch.cuda.reset_peak_memory_stats()
    bout, blaunches, bpath_ms = drive(make_infer_step(bmodel, bcfg), pts,
                                      tuple(BN_EVAL), "BatchNorm RCNN joint")
    check_launches(blaunches, BN_EVAL, "BatchNorm RCNN eval")
    check_joint_outputs(bcfg, bout, BN_BATCH, "BatchNorm RCNN")
    print(f"BatchNorm RCNN joint path: B={BN_BATCH} {bpath_ms:.1f} ms/batch, "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    bcpu = PointRCNN(bcfg, mode="TEST", device="cpu")
    bcpu.load_state_dict(bstate)
    with torch.no_grad():
        joint = bmodel({"pts_input": pts})
    joint["rpn_scores_raw"] = joint["rpn_cls"][..., 0]
    compare_rcnn_on_cpu(bcfg, bmodel, bcpu, joint)
    del bmodel, bcpu, joint, bout
    torch.cuda.empty_cache()
    phases.done("10 (BatchNorm RCNN)")

    # 11. default.yaml with RCNN.USE_BN true in training: the joint train
    # step at B=16, whose RCNN SA levels run the BatchNorm chain's seven
    # training kernels in place of the gather form's training pair; its
    # running statistics; scene 0's RCNN training against the CPU
    bn_train = {k: v for k, v in train_launches.items()
                if v and k not in ("fused_sa_train", "fused_sa_bwd")}
    bn_train.update({k: 2 for k in BN_TRAIN_KERNELS})
    torch.cuda.reset_peak_memory_stats()
    btb, btrain_launches, bstep_ms = drive_train(
        bcfg, btrain_model, btbatch, bgen, tuple(bn_train),
        "BatchNorm RCNN joint train step", 3)
    bpeak = torch.cuda.max_memory_allocated() / 2**30
    check_launches(btrain_launches, bn_train, "BatchNorm RCNN train step")
    print(f"BatchNorm RCNN joint train step: B={TRAIN_BATCH} N={N}: "
          f"{bstep_ms:.1f} ms/step, peak device memory {bpeak:.2f} GiB; "
          f"rpn_loss {float(btb['rpn_loss']):.4f}, rcnn_loss "
          f"{float(btb['rcnn_loss']):.4f}; launches as expected: "
          f"{bn_train}")
    check_bn_running_stats(bcfg, btrain_model, btbatch, bgen)
    compare_train_on_cpu(bcfg, btrain_model, btarget, btbatch, rpn=False,
                         rcnn_floor=True)
    del btrain_model, btarget, btbatch
    torch.cuda.empty_cache()
    phases.done("11 (BatchNorm RCNN training)")

    # 12. the widened configuration (RCNN SA_0 at 128 slots, MLPs 256 /
    # 384), without and with BatchNorm: eval and a train step at B=2
    wbatch = {k: torch.from_numpy(v).to(dev)
              for k, v in train_batch(WIDE_BATCH, N, SEED).items()}
    wide_runs = widened_paths(cfg, pts, wbatch)
    del wbatch
    torch.cuda.empty_cache()
    phases.done("12 (widened configuration)")

    # 13. kernels line and result line: launches from the path each kernel
    # was timed at (per forward or per train step), and on the other paths
    runs = {"default.yaml eval B=2": launches,
            "default.yaml train B=16": train_launches,
            "double.yaml eval B=4": dlaunches,
            "double.yaml train B=16": dtrain_launches,
            QUICK_PATH["eval"]: qlaunches, QUICK_PATH["train"]: qtrain_launches,
            SMOKE_PATH["eval"]: slaunches, SMOKE_PATH["train"]: strain_launches,
            BN_PATH: blaunches, BN_TRAIN_PATH: btrain_launches}
    kernels = []
    for name in report.rows:
        slab_mode = ("train" if name in ("fused_sa_slab_train",
                                         "fused_sa_slab_bwd") else "eval")
        path = ("double.yaml train B=16" if name in ("three_nn", "fps_long")
                else BN_PATH if name == "fused_sa_slab_bn"
                else BN_TRAIN_PATH if name in BN_TRAIN_KERNELS
                else QUICK_PATH[slab_mode] if name.startswith("fused_sa_slab")
                else "default.yaml eval B=2" if name in EVAL_KERNELS
                else "default.yaml train B=16")
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": runs[path][name],
            "path": path, "train_launches": train_launches[name],
            "double_eval_launches": dlaunches[name],
            "double_train_launches": dtrain_launches[name],
            "quickstart_eval_launches": qlaunches[name],
            "quickstart_train_launches": qtrain_launches[name],
            "smoke_eval_launches": slaunches[name],
            "smoke_train_launches": strain_launches[name],
            "bn_eval_launches": blaunches[name],
            "bn_train_launches": btrain_launches[name],
            **report.row(name), "status": "ported"}
        # the same kernel at another path's shapes: double.yaml's SA_0, the
        # smoke slab, the train step's shapes of the eval kernels, and the
        # dense box at the eval shapes (launches of the path it stands for)
        for extra, at, where, inputs in (
                (double_report, "at_32768", "double.yaml eval B=4", None),
                (smoke_report, "at_smoke", SMOKE_PATH[slab_mode], None),
                (train_report, "at_train", "default.yaml train B=16", None),
                (dense_report, "at_dense", "default.yaml eval B=2",
                 "the dense box")):
            if name in extra.rows:
                row[at] = {"path": where, "launches": runs[where][name],
                           **extra.row(name)}
                if inputs:
                    row[at]["inputs"] = inputs
        kernels.append(row)
    check(len(kernels) == len(SOURCES), f"kernels timed: {len(kernels)}")
    print(json.dumps({"kernels": kernels, "not_ported": [
        {"replaces": rep, "status": st} for rep, st in NOT_PORTED],
        "fused_sa_bwd_full_spread": {
            "path": "default.yaml train B=16", "what": "every channel live "
            "at a slot drawn uniformly over S; bound over every slot",
            **full_spread["fused_sa_bwd"]},
        "fps_pick_loop": fps_rows, "fps_floor": fps_floor,
        "nearest_k_levels": nk_sweep,
        "bn_train_chain_library_ms": {
            "path": BN_TRAIN_PATH, "what": "cuBLAS chain with "
            "batch-statistics BatchNorm under autograd, forward and backward",
            **{f"RCNN SA_{k}": ms for k, ms in bn_library.items()}},
        "bn_train_step": {"path": BN_TRAIN_PATH, "ms": bstep_ms,
                          "peak_gib": bpeak},
        "widened_shapes": {"shapes": WIDE_SHAPES,
                           "max_rel_err": wide_worst},
        "widened_config": {
            "rcnn_sa0_nsample": WIDE_NSAMPLE0, "rcnn_mlps": WIDE_MLPS,
            **{label: {"ms": ms, "peak_gib": peak, "launches": {
                k: v for k, v in launches.items() if k.startswith("fused")
                and v}} for label, (ms, launches, peak) in
               wide_runs.items()}}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
