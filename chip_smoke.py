#!/usr/bin/env python3
"""Drive tpu3d_torch's RPN-only eval path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit code
and no result line:

1. the card's name and power limit, as nvidia-smi gives them;
2. build every CUDA kernel from tpu3d_torch/csrc (one nvcc per source, all
   at once) and print the build time;
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it (inputs made from the seeded scenes), with its
   time (CUDA events, median of repeats), the plain version's time, the
   time of one library call that computes the same function where there is
   one, and the least time the card could take for the same work;
4. the main path at configs/default.yaml's full width (16384 points,
   NPOINTS 4096/1024/256/64, TEST pre/post-NMS 9000/100) through
   make_rpn_infer_step, with seeded weights and planted-cluster scenes:
   shapes, finite values, some valid rois, and every kernel's launch count
   above 0 in that one run (counts reset just before it);
5. scene 0 through the plain path on the CPU: the FPS picks of every level
   must be equal, and rpn_cls / rpn_reg close;
6. one JSON line of the kernels, then the result line.

Needs one CUDA card; the kernels have no CPU mode. Imports nothing of JAX
or of tpu3d.
"""

from __future__ import annotations

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

# every function of tpu3d that reaches pl.pallas_call, with this slice's
# status for the ones the port has not taken over yet
NOT_PORTED = [
    ("tpu3d/ops/sampling.py:73 _fps_pallas", "RCNN stage, next slice"),
    ("tpu3d/ops/fused_sa.py:771 _nobn2_eval_kernel", "RCNN stage, next slice"),
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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    from tpu3d_torch.ops import (furthest_point_sample_with_3nn,
                                 gather_points, interpolation_weights,
                                 nearest_k, three_interpolate)
    from tpu3d_torch.ops.grouping import nearest_k_plain
    from tpu3d_torch.ops.interpolate import three_interpolate_plain
    from tpu3d_torch.ops.sampling import furthest_point_sample_with_3nn_plain
    from tpu3d_torch.tools.eval_rcnn import make_rpn_infer_step
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

    cfg = cfg_from_file(str(ROOT / "configs" / "default.yaml"), fresh_cfg())
    cfg.RCNN.ENABLED = False
    sa = cfg.RPN.SA_CONFIG
    B, N = BATCH, cfg.RPN.NUM_POINTS
    dev = torch.device("cuda")
    pts = torch.from_numpy(random_scenes(B, N, SEED)).to(dev)

    # 3. each kernel against its plain version, at the main path's shapes
    levels = [pts]
    caches = []
    for npoint in sa.NPOINTS:
        idx, d2, nn_idx = furthest_point_sample_with_3nn(levels[-1], npoint)
        caches.append((d2, nn_idx))
        levels.append(gather_points(levels[-1], idx))
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    report = {}

    def add(name, err, ms, plain_ms, lib_ms, n_bytes, n_ops):
        r = report.setdefault(name, dict(err=0.0, ms=0.0, plain_ms=0.0,
                                         lib_ms=0.0, bytes=0.0, ops=0.0))
        r["err"] = max(r["err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["lib_ms"] = None if lib_ms is None else r["lib_ms"] + lib_ms
        r["bytes"] += n_bytes
        r["ops"] += n_ops

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
        add("fps3nn", err, ms, pms, None, nbytes, ops)
        print(f"fps3nn N={n} npoint={npoint}: {ms:.3f} ms, plain "
              f"{pms:.3f} ms, max_abs_err {err}")

    # nearest-k, exact: same d² and ids in every slot
    for k, npoint in enumerate(sa.NPOINTS):
        x, c = levels[k], levels[k + 1]
        n, kk, r = x.shape[1], max(sa.NSAMPLE[k]), max(sa.RADIUS[k])
        got = nearest_k(c, x, kk, max_radius=r)
        ref = nearest_k_plain(c, x, kk, max_radius=r)
        torch.cuda.synchronize()
        check(torch.equal(got[1], ref[1]),
              f"nearest_k ids differ at M={npoint}")
        check(torch.equal(got[0], ref[0]),
              f"nearest_k d² differ at M={npoint}")
        live = torch.isfinite(ref[0])  # slots past the in-radius hits are inf
        err = (got[0] - ref[0])[live].abs().max().item()
        ms = cuda_ms(lambda: nearest_k(c, x, kk, max_radius=r), 10)
        pms = cuda_ms(lambda: nearest_k_plain(c, x, kk, max_radius=r), 3)
        lms = cuda_ms(lambda: torch.topk(torch.cdist(c, x), kk, dim=2,
                                         largest=False), 3)
        ops = B * npoint * n * 9  # 3 sub, 3 mul, 2 add, radius compare
        nbytes = B * (npoint + n) * 12 + B * npoint * kk * 8
        add("nearest_k", err, ms, pms, lms, nbytes, ops)
        print(f"nearest_k M={npoint} N={n} k={kk} r={r}: {ms:.3f} ms, plain "
              f"{pms:.3f} ms, cdist+topk {lms:.3f} ms, max_abs_err {err}, "
              f"in-radius slots {int(live.sum())}")

    # three-point interpolation at FP_3 .. FP_0; the plain version sums in
    # the kernel's order, so they agree to the last bit (tolerance 1e-6)
    fp_known_c = [cfg.RPN.FP_MLPS[i + 1][-1] if i + 1 < len(cfg.RPN.FP_MLPS)
                  else sum(m[-1] for m in sa.MLPS[i])
                  for i in range(len(cfg.RPN.FP_MLPS))]
    for i in range(len(cfg.RPN.FP_MLPS) - 1, -1, -1):
        d2, nn_idx = caches[i]
        n, m, ch = levels[i + 1].shape[1], levels[i].shape[1], fp_known_c[i]
        feats = torch.randn(B, n, ch, generator=gen).to(dev)
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
        add("three_interpolate", err, ms, pms, lms, nbytes, B * m * ch * 5)
        print(f"three_interpolate N={n} M={m} C={ch}: {ms:.3f} ms, plain "
              f"{pms:.3f} ms, gather+sum {lms:.3f} ms, max_abs_err {err}")

    # 4. the main path at full width
    model = PointRCNN(cfg, mode="TEST", device=dev)
    state = seeded_state_dict(model, SEED)
    model.load_state_dict(state)
    infer = make_rpn_infer_step(model, cfg)
    infer(pts)  # warm-up: allocator and library handles
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = infer(pts)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_build.LAUNCHES)
    post = cfg.TEST.RPN_POST_NMS_TOP_N
    feat_c = cfg.RPN.FP_MLPS[0][-1]
    expect = {"rois": (B, post, 7), "roi_scores_raw": (B, post),
              "roi_valid": (B, post), "seg_result": (B, N),
              "rpn_scores_raw": (B, N), "backbone_xyz": (B, N, 3),
              "backbone_features": (B, N, feat_c)}
    for key, shape in expect.items():
        check(tuple(out[key].shape) == shape,
              f"{key} has shape {tuple(out[key].shape)}, expected {shape}")
        if out[key].is_floating_point():
            check(bool(torch.isfinite(out[key]).all()), f"{key} not finite")
    n_valid = int(out["roi_valid"].sum())
    check(n_valid > 0, "no valid roi")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    print(f"main path: B={B} N={N} NPOINTS={list(sa.NPOINTS)} pre/post NMS "
          f"{cfg.TEST.RPN_PRE_NMS_TOP_N}/{post}: first timed run "
          f"{first_ms:.1f} ms, valid rois {n_valid}/{B * post}, "
          f"launches {launches}")
    ms_path = []
    ms_rpn = []
    for _ in range(5):
        t0 = time.perf_counter()
        infer(pts)
        torch.cuda.synchronize()
        ms_path.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        with torch.no_grad():
            model.rpn(pts)
        torch.cuda.synchronize()
        ms_rpn.append((time.perf_counter() - t0) * 1e3)
    path_ms, rpn_ms = statistics.median(ms_path), statistics.median(ms_rpn)
    kernels_ms = sum(r["ms"] for r in report.values())
    print(f"main path: {path_ms:.1f} ms/batch (host clock, median of 5; "
          f"{path_ms / B:.1f} ms/scene); RPN network alone {rpn_ms:.1f} ms, "
          f"proposal layer {path_ms - rpn_ms:.1f} ms; the three kernels "
          f"{kernels_ms:.1f} ms of device time per forward")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB")

    # 5. scene 0 through the plain path on the CPU
    cpu_model = PointRCNN(cfg, mode="TEST", device="cpu")
    cpu_model.load_state_dict(state)
    x_cpu = pts[:1].cpu()
    mismatches, x_gpu = 0, pts[:1]
    for npoint in sa.NPOINTS:
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
    print(f"CPU plain path: {cpu_s:.1f} s for one scene")

    # 6. kernels line and result line
    sources = {"fps3nn": ("tpu3d_torch/csrc/fps3nn.cu",
                          "tpu3d/ops/sampling.py:176"),
               "nearest_k": ("tpu3d_torch/csrc/nearest_k.cu",
                             "tpu3d/ops/grouping.py:80"),
               "three_interpolate": ("tpu3d_torch/csrc/three_interpolate.cu",
                                     "tpu3d/ops/interpolate.py:262")}
    kernels = []
    for name, r in report.items():
        b_ms, b_by = bound_ms(r["bytes"], r["ops"])
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
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
