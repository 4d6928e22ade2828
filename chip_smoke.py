#!/usr/bin/env python3
"""Drive tpu3d_torch's eval paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit code
and no result line:

1. the card's name and power limit, as nvidia-smi gives them;
2. build every CUDA kernel from tpu3d_torch/csrc (one nvcc per source, all
   at once) and print the build time and ptxas's registers and spills;
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it (inputs made from the seeded scenes: the RPN's
   levels, and the RCNN's pooled ROIs of the joint forward), with its time
   (CUDA events, median of repeats), the plain version's time, the time of
   one library call that computes the same function where there is one,
   and the least time the card could take for the same work;
4. both eval paths at configs/default.yaml's full width (B=2 scenes of
   16384 points, NPOINTS 4096/1024/256/64, TEST pre/post-NMS 9000/100),
   with seeded weights and planted-cluster scenes, each with every launch
   count set to 0 just before it and read just after: the RPN-only path
   (make_rpn_infer_step, RCNN off) must launch its three kernels, the joint
   path (make_infer_step, as shipped: 200 ROIs of 512 points, RCNN SA
   128/32/GroupAll, score threshold and rotated final NMS) all five; shapes,
   finite values, some valid rois and some final boxes; ms per batch;
5. scene 0 through the plain path on the CPU: the RPN's FPS picks of every
   level must be equal and rpn_cls / rpn_reg close; then the RCNN stage,
   fed the card's rois, backbone outputs and scores: the pooled points, the
   refinement outputs and the final boxes must agree with the card's;
6. one JSON line of the kernels, then the result line.

Needs one CUDA card; the kernels have no CPU mode. Imports nothing of JAX
or of tpu3d.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0  # scenes, weights and interpolation features
BATCH = 2

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
}
# every other function of tpu3d that reaches pl.pallas_call, with its status
NOT_PORTED = [
    ("tpu3d/ops/fused_sa.py:752 _nobn2_fwd_kernel, :782 _nobn2_bwd_kernel",
     "training slice"),
    ("tpu3d/ops/interpolate.py:276 _ti_bwd_kernel", "training slice"),
    ("tpu3d/ops/fused_sa.py:575/594/604 _nobn_{fwd,eval,bwd}_kernel",
     "after training: unreached by shipped configs"),
    ("tpu3d/ops/fused_sa.py:158-291 BN chain kernels",
     "after training: unreached by shipped configs"),
    ("tpu3d/ops/interpolate.py:62 _three_nn_pallas",
     "after training: unreached on the main path (FP uses the FPS cache)"),
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


class Report:
    """Per kernel, summed over the launch shapes of one forward: worst
    error, kernel / plain / library ms, bytes and operations."""

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
               for dev in ("cuda", "cpu")]
        check(torch.equal(dec[0]["final_mask"].cpu(), dec[1]["final_mask"]),
              "final NMS keeps differ between the card and the CPU")
        err = (dec[0]["final_boxes"].cpu() - dec[1]["final_boxes"]).abs()
        print(f"final NMS, card vs CPU on the card's outputs: keeps equal "
              f"({int(dec[1]['final_mask'].sum())}), final_boxes max abs err "
              f"{err.max().item():.3e}")
        check(err.max().item() <= 1e-4, "final boxes differ")
    print(f"CPU plain path: {cpu_s:.1f} s for scene 0's RCNN stage")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from tpu3d_torch.config import cfg_from_file, fresh_cfg
    from tpu3d_torch.datasets import random_scenes
    from tpu3d_torch.models import PointRCNN
    from tpu3d_torch.ops import _build
    from tpu3d_torch.ops import furthest_point_sample_with_3nn, gather_points
    from tpu3d_torch.tools.eval_rcnn import (make_infer_step,
                                             make_rpn_infer_step)
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

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(logs) or 'nothing (already built)'}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    for name in _build.KERNELS:
        _build.kernel(name)

    # configs/default.yaml as shipped runs the joint path; the RPN-only
    # path is the same model with RCNN off and the RPN's weights
    cfg = cfg_from_file(str(ROOT / "configs" / "default.yaml"), fresh_cfg())
    check(cfg.RCNN.ENABLED, "default.yaml should enable the RCNN stage")
    rpn_cfg = copy.deepcopy(cfg)
    rpn_cfg.RCNN.ENABLED = False
    B, N = BATCH, cfg.RPN.NUM_POINTS
    dev = torch.device("cuda")
    pts = torch.from_numpy(random_scenes(B, N, SEED)).to(dev)
    model = PointRCNN(cfg, mode="TEST", device=dev)
    state = seeded_state_dict(model, SEED)
    model.load_state_dict(state)
    rpn_model = PointRCNN(rpn_cfg, mode="TEST", device=dev)
    rpn_state = {k: v for k, v in state.items() if k.startswith("rpn.")}
    rpn_model.load_state_dict(rpn_state)

    # 3. each kernel against its plain version, at the main path's shapes
    report = Report()
    rpn_kernels(report, cfg, pts)
    rcnn_kernels(report, model, pts)

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
                                   tuple(SOURCES), "joint")
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
    kernels_ms = sum(r["ms"] for r in report.rows.values())
    print(f"joint path {path_ms:.1f} ms/batch, RPN-only path "
          f"{rpn_path_ms:.1f} ms/batch; the five kernels {kernels_ms:.1f} ms "
          f"of device time per joint forward; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 5. scene 0 through the plain path on the CPU
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

    # 6. kernels line and result line
    kernels = []
    for name, r in report.rows.items():
        b_ms, b_by = bound_ms(r["bytes"], r["ops"])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": launches[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": r["lib_ms"],
            "status": "ported"})
    print(json.dumps({"kernels": kernels, "not_ported": [
        {"replaces": rep, "status": st} for rep, st in NOT_PORTED]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
