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
   backward on the 1024 rows the proposal target layer samples);
   configs/double.yaml's SA_0 at 32768 points: the train route's long-row
   FPS (fps_long) and standalone three_nn at B=16, the eval route's
   FPS+3NN at B=4, each bit for bit; the slab form of the fused SA op at
   the RCNN's SA_1: its eval kernel (fused_sa_slab) on the pooled ROIs of
   configs/quickstart.yaml's eval (B=8) and of configs/smoke.yaml's (B=2),
   its training forward and backward (fused_sa_slab_train,
   fused_sa_slab_bwd) on the rows that the train steps' proposal target
   layer samples (quickstart B=4, smoke B=2); and the same eval kernel with
   BatchNorm packs (fused_sa_slab_bn) at the RCNN's SA_0 and SA_1 of
   default.yaml with RCNN.USE_BN true (eval, B=2);
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
11. one JSON line of the kernels, then the result line.

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
}
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
# every other function of tpu3d that reaches pl.pallas_call, with its status
NOT_PORTED = [
    ("tpu3d/ops/fused_sa.py:158 _stats0_kernel, :164 _fwd_stats1_kernel, "
     ":171 _fwd_stats2_kernel, :178 _fwd_final_kernel, :255 "
     "_bwd_wave1_kernel, :272 _bwd_wave2_kernel, :291 _bwd_apply_kernel",
     "to port next: the BatchNorm chain's training (batch statistics), "
     "reached only by an RCNN with USE_BN: true in training"),
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
        nnz, hit = routed_slots(r_arg, grad, r_ppre, S)
        # d_a1 and dW2 over the non-zero pooled gradients; layer 1's
        # recompute, dW1, d_a0 and the ReLU masks over the slots they reach
        ops = 3 * 2 * hit * c1 * c2 + 2 * 2 * nnz * c2 + hit * (2 * c1 + 2 * c2)
        nbytes = 4 * (2 * pre.numel() + idx.numel() + 2 * center.numel()
                      + w1.numel() + w2.numel() + c2 + 2 * R * M * c3
                      + w1.numel() + w2.numel() + c2 + c3)
        report.add("fused_sa_bwd", berr, ms, pms, lms, nbytes, ops)
        print(f"fused_sa_bwd RCNN SA_{k}: {ms:.3f} ms, plain {pms:.3f} ms, "
              f"autograd of the cuBLAS chain {lms:.3f} ms (forward and "
              f"backward), {ops / ms / 1e9:.1f} TFLOP/s, {nnz} non-zero "
              f"pooled gradients routed to {hit} of {R * M * S} slots")
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


NUDGES = 4  # independent nudges of the weights behind the RPN's noise floor


def compare_train_on_cpu(cfg, model, target, batch, rpn=True):
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
    False leaves out the RPN half."""
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
    if not rpn:
        return

    loss, grads, _ = run(rpn_grads, DEVICE, f32)
    ref_loss, ref, cpu_s = run(rpn_grads, "cpu", f32)
    floors = []
    for i in range(NUDGES):
        gen = torch.Generator().manual_seed(SEED + 3 + i)
        nudged = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
                  if v.is_floating_point() else v for k, v in state.items()}
        floors.append(worst(run(rpn_grads, "cpu", f32, nudged)[1], ref))
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
            affines = [getattr(mlp, f"bn_{i}").affine() for i in range(3)]
            packs = bn_packs(affines)

            def kernel():
                return fused_bn_mlp_pool(x0, w1, w2, affines)
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
    from tpu3d_torch.ops.fused_sa import (fused_mlp_pool_backward,
                                          fused_mlp_pool_backward_plain,
                                          fused_mlp_pool_train,
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
    rows["fused_sa_slab_train"] = (max(err, perr), ms, pms, lms, nbytes, ops)
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
    nnz, hit = routed_slots(r_arg, grad, r_ppre, S)
    # d_a1 and dW2 over the non-zero pooled gradients; layer 1's recompute,
    # dW1, d_a0 and the ReLU masks over the slots they reach
    ops = 3 * 2 * hit * c1 * c2 + 2 * 2 * nnz * c2 + hit * (2 * c1 + 2 * c2)
    # read x0, W1, b1, W2, dval and argmax; write d_x0, dW1, db1 and dW2
    nbytes = 4 * (2 * x0.numel() + 2 * w1.numel() + 2 * w2.numel() + 2 * c2
                  + 2 * R * M * c3)
    rows["fused_sa_slab_bwd"] = (berr, ms, pms, lms, nbytes, ops)
    print(f"fused_sa_slab_bwd {label}: {ms:.3f} ms, bound "
          f"{bound_ms(nbytes, ops)[0]:.3f} ms, plain {pms:.3f} ms, "
          f"autograd of the cuBLAS chain {lms:.3f} ms (forward and "
          f"backward), {ops / ms / 1e9:.1f} TFLOP/s, {nnz} non-zero pooled "
          f"gradients routed to {hit} of {slots} slots")
    return rows


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
    # the targets the step's RCNN sees, for phase 3
    target = sampled_targets(train_model, tbatch, train_state, gen)

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
                for name, row in slab_train_kernels(x0, mlp, label,
                                                    slab_gen).items():
                    into.add(name, *row)
            else:
                name, row = slab_eval_kernel(x0, mlp, label)
                into.add(name, *row)
        del levels
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

    # 11. kernels line and result line: launches from the path each kernel
    # was timed at (per forward or per train step), and on the other paths
    runs = {"default.yaml eval B=2": launches,
            "default.yaml train B=16": train_launches,
            "double.yaml eval B=4": dlaunches,
            "double.yaml train B=16": dtrain_launches,
            QUICK_PATH["eval"]: qlaunches, QUICK_PATH["train"]: qtrain_launches,
            SMOKE_PATH["eval"]: slaunches, SMOKE_PATH["train"]: strain_launches,
            BN_PATH: blaunches}
    kernels = []
    for name, r in report.rows.items():
        b_ms, b_by = bound_ms(r["bytes"], r["ops"])
        slab_mode = ("train" if name in ("fused_sa_slab_train",
                                         "fused_sa_slab_bwd") else "eval")
        path = ("double.yaml train B=16" if name in ("three_nn", "fps_long")
                else BN_PATH if name == "fused_sa_slab_bn"
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
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": r["lib_ms"],
            "status": "ported"}
        for extra, at, where in (
                (double_report, "at_32768", "double.yaml eval B=4"),
                (smoke_report, "at_smoke", SMOKE_PATH[slab_mode])):
            if name in extra.rows:
                d = extra.rows[name]
                d_ms, d_by = bound_ms(d["bytes"], d["ops"])
                row[at] = {
                    "path": where, "launches": runs[where][name],
                    "max_abs_err": d["err"], "ms": d["ms"],
                    "plain_ms": d["plain_ms"], "bound_ms": d_ms,
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
