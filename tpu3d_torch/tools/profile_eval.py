"""Where the joint eval step spends its time on the card.

    python -m tpu3d_torch.tools.profile_eval [--cfg_file configs/default.yaml]
        [--batch 2]

Runs a config as shipped (the joint path; configs/default.yaml unless
``--cfg_file`` names another, e.g. configs/double.yaml with ``--batch 4``)
at full width with seeded weights on planted-cluster scenes. For each stage of the step (the
RPN network, the proposal layer, ROI pooling with the canonical transform,
the RCNN network, the decode with the final rotated NMS), each fed the
previous stage's outputs, it prints the wall time (host clock around work
that ends in a synchronize, median of ``REPS``, no profiler), the summed
time of the kernels it runs and its top kernels (torch.profiler over
``REPS`` more runs), the device's idle share of the step, and, last, one
JSON line of the same numbers. The RPN-only step is the first two stages.
It runs the eval numerics contract the eval CLI runs (``precision.resolve``:
bf16 on the card, f32 under ``TPU3D_F32_EVAL=1``), named in its output.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..config import cfg_from_file, fresh_cfg
from ..datasets import random_scenes
from ..models import PointRCNN
from ..models.proposal import proposal_layer
from ..precision import resolve
from ..weights import seeded_state_dict
from .eval_rcnn import rcnn_decode_and_nms

ROOT = Path(__file__).resolve().parents[2]
SEED, REPS = 0, 5


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg_file", default=str(ROOT / "configs" /
                                              "default.yaml"))
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()
    cfg = cfg_from_file(args.cfg_file, fresh_cfg())
    model = PointRCNN(cfg, mode="TEST")
    model.load_state_dict(seeded_state_dict(model, SEED))
    pts = random_scenes(args.batch, cfg.RPN.NUM_POINTS, SEED)
    pts = torch.from_numpy(pts).cuda()
    prec = resolve(pts.device, cfg)

    with torch.no_grad():
        rpn_out = model.rpn(pts, precision=prec)
        scores = rpn_out["rpn_cls"][:, :, 0]
        rois, _, roi_valid = proposal_layer(
            scores, rpn_out["rpn_reg"], rpn_out["backbone_xyz"], cfg, "TEST")
        xyz, rest, _, _ = model.pool_rois(
            rpn_out["backbone_xyz"], rpn_out["backbone_features"], scores,
            rois, precision=prec)
        rcnn_out = model.rcnn_net(xyz, rest, precision=prec)
    b, m = rois.shape[:2]

    stages = {
        "rpn_network": lambda: model.rpn(pts, precision=prec),
        "proposal_layer": lambda: proposal_layer(
            scores, rpn_out["rpn_reg"], rpn_out["backbone_xyz"], cfg, "TEST"),
        "roi_pool": lambda: model.pool_rois(
            rpn_out["backbone_xyz"], rpn_out["backbone_features"], scores,
            rois, precision=prec),
        "rcnn_network": lambda: model.rcnn_net(xyz, rest, precision=prec),
        "final_nms": lambda: rcnn_decode_and_nms(
            cfg, rois, rcnn_out["rcnn_cls"].reshape(b, m),
            rcnn_out["rcnn_reg"].reshape(b, m, -1), roi_valid),
    }
    wall, device, top = {}, {}, {}
    for name, fn in stages.items():
        with torch.no_grad():
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            times = []
            for _ in range(REPS):  # host clock, no profiler
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            wall[name] = statistics.median(times)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(REPS):
                    fn()
                torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        device[name] = sum(e.self_device_time_total
                           for e in kernels) / 1e3 / REPS
        top[name] = [{"name": e.key[:80], "calls": e.count // REPS,
                      "ms": e.self_device_time_total / 1e3 / REPS}
                     for e in sorted(kernels,
                                     key=lambda e: -e.self_device_time_total)
                     [:8]]

    step_wall, step_device = sum(wall.values()), sum(device.values())
    print(f"card: {torch.cuda.get_device_name(0)}; {args.cfg_file}, batch "
          f"{args.batch}, median of {REPS} runs per stage; {prec}")
    print(f"step: {step_wall:.2f} ms wall, {step_device:.2f} ms of kernels, "
          f"device idle {100 * (1 - step_device / step_wall):.1f}%")
    for name in stages:
        print(f"stage {name}: {wall[name]:.2f} ms wall, {device[name]:.2f} "
              f"ms of kernels")
        for t in top[name]:
            print(f"  {t['ms']:8.3f} ms {t['calls']:5d} calls  {t['name']}")
    print(json.dumps({"cfg_file": args.cfg_file, "batch": args.batch,
                      "precision": str(prec),
                      "wall_ms": wall, "kernel_ms": device,
                      "device_idle_share": 1 - step_device / step_wall,
                      "top_kernels": top}))


if __name__ == "__main__":
    main()
