"""Where the RPN-only eval step spends its time on the card.

    python -m tpu3d_torch.tools.profile_rpn

Runs configs/default.yaml at full width (RCNN off) with seeded weights on
planted-cluster scenes. For each stage (the RPN network, then the proposal
layer on its outputs) it prints the wall time (host clock around work that
ends in a synchronize, median of ``REPS``, no profiler), the summed time
of the kernels it runs and its top kernels (torch.profiler over ``REPS``
more runs), the device's idle share of the step, and, last, one JSON line
of the same numbers. Needs a CUDA device.
"""

from __future__ import annotations

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
from ..weights import seeded_state_dict

ROOT = Path(__file__).resolve().parents[2]
BATCH, SEED, REPS = 2, 0, 5


def main() -> None:
    cfg = cfg_from_file(str(ROOT / "configs" / "default.yaml"), fresh_cfg())
    cfg.RCNN.ENABLED = False
    model = PointRCNN(cfg, mode="TEST")
    model.load_state_dict(seeded_state_dict(model, SEED))
    pts = random_scenes(BATCH, cfg.RPN.NUM_POINTS, SEED)
    pts = torch.from_numpy(pts).cuda()

    with torch.no_grad():
        rpn_out = model.rpn(pts)

    @torch.no_grad()
    def rpn():
        model.rpn(pts)

    @torch.no_grad()
    def proposals():
        proposal_layer(rpn_out["rpn_cls"][:, :, 0], rpn_out["rpn_reg"],
                       rpn_out["backbone_xyz"], cfg, "TEST")

    stages = {"rpn_network": rpn, "proposal_layer": proposals}
    wall, device, top = {}, {}, {}
    for name, fn in stages.items():
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
    print(f"card: {torch.cuda.get_device_name(0)}; batch {BATCH}, "
          f"median of {REPS} steps")
    print(f"step: {step_wall:.2f} ms wall, {step_device:.2f} ms of kernels, "
          f"device idle {100 * (1 - step_device / step_wall):.1f}%")
    for name in stages:
        print(f"stage {name}: {wall[name]:.2f} ms wall, {device[name]:.2f} "
              f"ms of kernels")
        for t in top[name]:
            print(f"  {t['ms']:8.3f} ms {t['calls']:5d} calls  {t['name']}")
    print(json.dumps({"wall_ms": wall, "kernel_ms": device,
                      "device_idle_share": 1 - step_device / step_wall,
                      "top_kernels": top}))


if __name__ == "__main__":
    main()
