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
   its path gives it, with its time (CUDA events, median of repeats), the
   plain version's time, the time of one library call that computes the
   same function where there is one, and the least time the card could
   take for the same work. The eval kernels take the eval paths' inputs
   (the RPN's levels, and the RCNN's pooled ROIs of the joint forward, at
   B=2); the training kernels the train step's (B=16: the interpolation's
   backward at the four FP levels, the fused SA op's training forward and
   backward on the 1024 rows the proposal target layer samples); and
   configs/double.yaml's SA_0 at 32768 points: the train route's long-row
   FPS (fps_long) and standalone three_nn at B=16, the eval route's
   FPS+3NN at B=4, each bit for bit;
4. both eval paths at configs/default.yaml's full width (B=2 scenes of
   16384 points, NPOINTS 4096/1024/256/64, TEST pre/post-NMS 9000/100),
   with seeded weights and planted-cluster scenes, each with every launch
   count set to 0 just before it and read just after: the RPN-only path
   (make_rpn_infer_step, RCNN off) must launch its three kernels, the joint
   path (make_infer_step, as shipped: 200 ROIs of 512 points, RCNN SA
   128/32/GroupAll, score threshold and rotated final NMS) all five; shapes,
   finite values, some valid rois and some final boxes; ms per batch;
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
   of scene 0 with dropout 0, each against the CPU plain path;
7. configs/double.yaml as shipped (32768 points per scene, the RPN's
   widths of default.yaml): the joint eval path at B=4, which must launch
   the five eval kernels (fps3nn once per RPN level, SA_0's through its
   long-row FPS) and neither three_nn nor fps_long; then the joint train
   step at B=16 (1 warm-up, 3 timed), whose SA_0 takes the split route and
   must launch three_nn and fps_long once per step beside the seven kernels
   of phase 5; then scene 0's SA_0 split route on the card against the CPU
   plain route, bit for bit;
8. one JSON line of the kernels, then the result line.

Needs one CUDA card; the kernels have no CPU mode. Imports nothing of JAX
or of tpu3d.
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
DEVICE = "cuda"  # the card

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
}
# the kernels of each path whose launches are counted
EVAL_KERNELS = ("fps3nn", "nearest_k", "three_interpolate", "fps", "fused_sa")
TRAIN_KERNELS = ("fps3nn", "nearest_k", "three_interpolate",
                 "three_interpolate_bwd", "fps", "fused_sa_train",
                 "fused_sa_bwd")
RPN_TRAIN_KERNELS = ("fps3nn", "nearest_k", "three_interpolate",
                     "three_interpolate_bwd")
DOUBLE_TRAIN_KERNELS = TRAIN_KERNELS + ("three_nn", "fps_long")
# every other function of tpu3d that reaches pl.pallas_call, with its status
NOT_PORTED = [
    ("tpu3d/ops/fused_sa.py:575/594/604 _nobn_{fwd,eval,bwd}_kernel",
     "to port next: reached by configs/quickstart.yaml and configs/smoke.yaml"
     " at RCNN SA_1 (too few source points for the gather kernel)"),
    ("tpu3d/ops/fused_sa.py:158-291 BN chain kernels",
     "to port after it: reached only by an RCNN with USE_BN: true, which no "
     "file in configs/ sets"),
]


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs, after one warm-up,
    from CUDA events around each run."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


class Report:
    """Per kernel, summed over the launch shapes of one forward (eval
    kernels) or one train step (training kernels): worst error, kernel /
    plain / library ms, bytes and operations."""

    def __init__(self):
        self.rows = {}

    def add(self, name, err, ms, plain_ms, lib_ms, n_bytes, n_ops):
        r = self.rows.setdefault(name, dict(err=0.0, ms=0.0, plain_ms=0.0,
                                            lib_ms=0.0, bytes=0.0, ops=0.0))
        r["err"] = max(r["err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["lib_ms"] = None if lib_ms is None else r["lib_ms"] + lib_ms
        r["bytes"] += n_bytes
        r["ops"] += n_ops


def check_nearest_k(report, c, x, k, r, label):
    """nearest_k, exact: same d² and ids in every slot."""
    import torch

    from tpu3d_torch.ops import nearest_k
    from tpu3d_torch.ops.grouping import nearest_k_plain

    b, m, n = c.shape[0], c.shape[1], x.shape[1]
    got = nearest_k(c, x, k, max_radius=r)
    ref = nearest_k_plain(c, x, k, max_radius=r)
    torch.cuda.synchronize()
    check(torch.equal(got[1], ref[1]), f"nearest_k ids differ at {label}")
    check(torch.equal(got[0], ref[0]), f"nearest_k d² differ at {label}")
    live = torch.isfinite(ref[0])  # slots past the in-radius hits are inf
    err = (got[0] - ref[0])[live].abs().max().item() if live.any() else 0.0
    ms = cuda_ms(lambda: nearest_k(c, x, k, max_radius=r), 10)
    pms = cuda_ms(lambda: nearest_k_plain(c, x, k, max_radius=r), 3)
    lms = cuda_ms(lambda: torch.topk(torch.cdist(c, x), min(k, n), dim=2,
                                     largest=False), 3)
    ops = b * m * n * 9  # 3 sub, 3 mul, 2 add, radius compare
    nbytes = b * (m + n) * 12 + b * m * k * 8
    report.add("nearest_k", err, ms, pms, lms, nbytes, ops)
    print(f"nearest_k {label} B={b} M={m} N={n} k={k} r={r}: {ms:.3f} ms, "
          f"plain {pms:.3f} ms, cdist+topk {lms:.3f} ms, max_abs_err {err}, "
          f"in-radius slots {int(live.sum())}")


def rpn_kernels(report, cfg, pts):
    """Phase 3 for the RPN's kernels, at its four SA / FP levels."""
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
    for k, npoint in enumerate(sa.NPOINTS):
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
        print(f"fps3nn N={n} npoint={npoint}: {ms:.3f} ms, plain "
              f"{pms:.3f} ms, max_abs_err {err}")

    for k, npoint in enumerate(sa.NPOINTS):
        check_nearest_k(report, levels[k + 1], levels[k], max(sa.NSAMPLE[k]),
                        max(sa.RADIUS[k]), f"RPN SA_{k}")

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
        print(f"three_interpolate N={n} M={m} C={ch}: {ms:.3f} ms, plain "
              f"{pms:.3f} ms, gather+sum {lms:.3f} ms, max_abs_err {err}")


def rcnn_kernels(report, model, pts):
    """Phase 3 for the RCNN's kernels, on the pooled ROIs of the joint
    forward: FPS, the ball query's nearest-k and the fused SA op at each
    single-scale level (SA_0 and SA_1; the GroupAll has no kernel)."""
    import torch
    import torch.nn.functional as F

    from tpu3d_torch.ops import (furthest_point_sample,
                                 fused_gathered_mlp_pool, gather_points,
                                 group_points)
    from tpu3d_torch.ops.fused_sa import fused_gathered_mlp_pool_plain
    from tpu3d_torch.ops.sampling import furthest_point_sample_plain

    out = model({"pts_input": pts})
    xyz, rest, empty, _ = model.pool_rois(
        out["backbone_xyz"], out["backbone_features"], out["rpn_cls"][..., 0],
        out["rois"])
    net = model.rcnn_net
    with torch.no_grad():
        features = net.point_features(xyz, rest)
    R = xyz.shape[0]
    print(f"RCNN input: {R} pooled ROIs of {xyz.shape[1]} points "
          f"({int(empty.sum())} empty), features {tuple(features.shape)}")
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
        report.add("fps", 0.0, ms, pms, None, nbytes, ops)
        print(f"fps RCNN SA_{k} R={R} N={n} npoint={npoint}: {ms:.3f} ms, "
              f"plain {pms:.3f} ms, picks equal")

        # the ball query's nearest-k, exact
        new_xyz = gather_points(xyz, got)
        check_nearest_k(report, new_xyz, xyz, sa.nsample, sa.radius,
                        f"RCNN SA_{k}")

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
    just after; then its ms per batch (host clock, median of 5)."""
    import torch

    from tpu3d_torch.ops import _build

    infer(pts)  # warm-up: allocator and library handles
    torch.cuda.synchronize()
    _build.reset_launches()
    out = infer(pts)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
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
    FP levels (B=16): d_features and d_weight against the plain version,
    within 1e-5 of the largest value (atomics add in another order); the
    time is that of the main path's form, which wants no d_weight."""
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
        print(f"three_interpolate_bwd N={n} M={m} C={ch}: {ms:.3f} ms, "
              f"plain {pms:.3f} ms, index_add_ {lms:.3f} ms, max_abs_err "
              f"{err:.3e}")


def fused_train_kernels(report, model, target):
    """Phase 3 for the fused SA op's training kernels, on the rows the
    train step's proposal target layer sampled, at RCNN SA_0 and SA_1.
    Forward: out equal to the eval kernel's to the bit, ppre within 1e-4
    of the largest value, argmax equal to the plain version's but at
    near-ties (f32 sums in another order may pick another slot whose value
    is the max within that tolerance; at most 1 in 1000). Backward: the six
    gradients within 1e-4 of each one's largest value, both routed by the
    plain version's argmax."""
    import torch
    import torch.nn.functional as F

    from tpu3d_torch.ops import fused_gathered_mlp_pool, group_points
    from tpu3d_torch.ops.fused_sa import (
        fused_gathered_mlp_pool_backward,
        fused_gathered_mlp_pool_backward_plain, fused_gathered_mlp_pool_train,
        fused_gathered_mlp_pool_train_plain)

    net = model.rcnn_net
    xyz, rest = target["sampled_pts"], target["pts_feature"]
    with torch.no_grad():
        features = net.point_features(xyz, rest)
    R = xyz.shape[0]
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
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
        nnz = int((torch.where(r_ppre > 0, grad, 0.0) != 0).sum())
        # recomputed layer 1, d_a0 and dW1 in full; d_a1 and dW2 over the
        # non-zero pooled gradients only; ReLU masks and sums on the slab
        ops = (3 * 2 * R * M * S * c1 * c2 + 2 * 2 * nnz * c2
               + R * M * S * (2 * c1 + 2 * c2))
        nbytes = 4 * (2 * pre.numel() + idx.numel() + 2 * center.numel()
                      + w1.numel() + w2.numel() + c2 + 2 * R * M * c3
                      + w1.numel() + w2.numel() + c2 + c3)
        report.add("fused_sa_bwd", berr, ms, pms, lms, nbytes, ops)
        print(f"fused_sa_bwd RCNN SA_{k}: {ms:.3f} ms, plain {pms:.3f} ms, "
              f"autograd of the cuBLAS chain {lms:.3f} ms (forward and "
              f"backward), {ops / ms / 1e9:.1f} TFLOP/s, {nnz} non-zero "
              f"pooled gradients")
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
    before the first timed step and read just after it: launches per step,
    the metrics of the last step, ms per step (host clock, median)."""
    import torch

    from tpu3d_torch.ops import _build
    from tpu3d_torch.parallel import create_train_state, make_train_step

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
        tb = step(state, batch, gen, 0.9)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches = dict(_build.LAUNCHES)
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


def compare_train_on_cpu(cfg, model, target, batch):
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
    1e-5 of the largest gradient). The perturbation moves no FPS pick nor
    neighbour, which depend on the coordinates alone."""
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
        return float(loss), grads, time.perf_counter() - t0

    def worst(a, b):
        return max(((a[n] - g).abs().max().item(), n) for n, g in b.items())

    nodp = copy.deepcopy(cfg)
    nodp.RPN.DP_RATIO = 0.0
    f32 = torch.float32
    loss, grads, _ = run(rcnn_grads, DEVICE, f32)
    ref_loss, ref, cpu_s = run(rcnn_grads, "cpu", f32)
    top = max(g.abs().max().item() for g in ref.values())
    err = worst(grads, ref)
    print(f"RCNN train on scene 0, card vs CPU: loss {loss:.6f} vs "
          f"{ref_loss:.6f}; largest gradient error {err[0]:.3e} ({err[1]}) "
          f"of the largest gradient {top:.3e}; CPU {cpu_s:.1f} s")
    check(abs(loss - ref_loss) <= 1e-5 * abs(ref_loss),
          "RCNN train loss differs")
    check(err[0] <= 1e-3 * top, "RCNN gradients differ")

    loss, grads, _ = run(rpn_grads, DEVICE, f32)
    ref_loss, ref, cpu_s = run(rpn_grads, "cpu", f32)
    gen = torch.Generator().manual_seed(SEED + 3)
    nudged = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
              if v.is_floating_point() else v for k, v in state.items()}
    _, ref2, _ = run(rpn_grads, "cpu", f32, nudged)
    top = max(g.abs().max().item() for g in ref.values())
    err, floor = worst(grads, ref), worst(ref2, ref)
    print(f"RPN train on scene 0, card vs CPU: loss {loss:.6f} vs "
          f"{ref_loss:.6f}; largest gradient error {err[0]:.3e} ({err[1]}), "
          f"noise floor {floor[0]:.3e} ({floor[1]}), of the largest gradient "
          f"{top:.3e}; CPU {cpu_s:.1f} s")
    check(abs(loss - ref_loss) <= 1e-5 * abs(ref_loss),
          "RPN train loss differs")
    check(err[0] <= 10 * floor[0] + 1e-5 * top, "RPN gradients differ")


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
    with torch.no_grad():  # the targets the step's RCNN sees, for phase 3
        target_out = train_model(
            {"pts_input": tbatch["pts_input"],
             "gt_boxes3d": tbatch["gt_boxes3d"]}, train=True,
            bn_momentum=0.9, generator=gen)
    target = {k: target_out[k] for k in (
        "sampled_pts", "pts_feature", "cls_label", "reg_valid_mask",
        "gt_of_rois", "gt_iou", "roi_boxes3d")}
    del target_out
    train_model.load_state_dict(train_state)  # undo the statistics' update

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
    phases.done("setup")

    # 3. each kernel against its plain version, at its path's shapes
    report, double_report = Report(), Report()
    rpn_kernels(report, cfg, pts)
    rcnn_kernels(report, model, pts)
    interp_bwd_kernels(report, cfg, tbatch["pts_input"])
    fused_train_kernels(report, train_model, target)
    torch.cuda.empty_cache()
    double_kernels(report, double_report, dpts,
                   dtbatch["pts_input"][..., :3].contiguous(), sa0)
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
    check_outputs(out, {
        "final_boxes": (B, 100, 7), "final_scores": (B, 100),
        "final_mask": (B, 100), "pred_boxes3d": (B, post, 7),
        "norm_scores": (B, post), "raw_scores": (B, post),
        "rois": (B, post, 7), "roi_scores_raw": (B, post),
        "roi_valid": (B, post), "seg_result": (B, N)})
    n_valid = int(out["roi_valid"].sum())
    n_final = int(out["final_mask"].sum())
    check(n_valid > 0, "no valid roi")
    check(n_final > 0, "no final box")
    print(f"joint path: B={B} N={N} NPOINTS={list(cfg.RPN.SA_CONFIG.NPOINTS)} "
          f"pre/post NMS {cfg.TEST.RPN_PRE_NMS_TOP_N}/{post}, RCNN "
          f"{cfg.RCNN.NUM_POINTS} points per ROI: valid rois "
          f"{n_valid}/{B * post}, final boxes {n_final}/{B * 100}")
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
    dpost = dcfg.TEST.RPN_POST_NMS_TOP_N
    check_outputs(dout, {
        "final_boxes": (DOUBLE_BATCH, 100, 7),
        "final_scores": (DOUBLE_BATCH, 100),
        "final_mask": (DOUBLE_BATCH, 100),
        "pred_boxes3d": (DOUBLE_BATCH, dpost, 7),
        "rois": (DOUBLE_BATCH, dpost, 7), "roi_valid": (DOUBLE_BATCH, dpost),
        "seg_result": (DOUBLE_BATCH, DN)})
    n_valid = int(dout["roi_valid"].sum())
    n_final = int(dout["final_mask"].sum())
    check(n_valid > 0, "double eval: no valid roi")
    check(n_final > 0, "double eval: no final box")
    print(f"double joint path: B={DOUBLE_BATCH} N={DN}: {dpath_ms:.1f} "
          f"ms/batch, valid rois {n_valid}/{DOUBLE_BATCH * dpost}, final "
          f"boxes {n_final}/{DOUBLE_BATCH * 100}, peak device memory "
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

    # 8. kernels line and result line: launches from the path each kernel
    # was timed at (per forward or per train step), and on both double paths
    runs = {"default.yaml eval B=2": launches,
            "default.yaml train B=16": train_launches,
            "double.yaml train B=16": dtrain_launches}
    kernels = []
    for name, r in report.rows.items():
        b_ms, b_by = bound_ms(r["bytes"], r["ops"])
        path = ("double.yaml train B=16" if name in ("three_nn", "fps_long")
                else "default.yaml eval B=2" if name in EVAL_KERNELS
                else "default.yaml train B=16")
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": runs[path][name],
            "path": path, "train_launches": train_launches[name],
            "double_eval_launches": dlaunches[name],
            "double_train_launches": dtrain_launches[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": r["lib_ms"],
            "status": "ported"}
        if name in double_report.rows:  # fps3nn at double eval's SA_0
            d = double_report.rows[name]
            d_ms, d_by = bound_ms(d["bytes"], d["ops"])
            row["at_32768"] = {
                "path": "double.yaml eval B=4, SA_0",
                "launches": dlaunches[name], "max_abs_err": d["err"],
                "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d_ms,
                "bound_by": d_by, "library_ms": d["lib_ms"]}
        kernels.append(row)
    check(len(kernels) == len(SOURCES), f"kernels timed: {len(kernels)}")
    print(json.dumps({"kernels": kernels, "not_ported": [
        {"replaces": rep, "status": st} for rep, st in NOT_PORTED]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
