"""Where the joint train step spends its time on the card.

    python -m tpu3d_torch.tools.profile_train [--batch 16] [--reps 3]

Runs configs/default.yaml as shipped (joint mode) at full width with
seeded weights on a training batch of planted-cluster scenes, and splits
the step into its stages, each fed the previous stage's outputs: the RPN
labels, the RPN forward (train mode), the proposal layer (TRAIN
pre/post-NMS 9000/512), the proposal target layer, the RCNN forward, the
loss, the backward and the optimizer update. For each stage it prints the
wall time (host clock around the stage, which ends in a synchronize;
median over ``--reps`` steps, no profiler) and the time of the kernels it
runs (torch.profiler over ``--reps`` more steps: a stage's kernels are
those launched from inside its range, the backward's from the autograd
engine's threads while it runs), then the device's idle share of the step
and one JSON line of the same numbers. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from ..config import cfg_from_file, fresh_cfg
from ..datasets import train_batch
from ..models import PointRCNN
from ..models.point_rcnn import rcnn_extra_features
from ..models.proposal import proposal_layer
from ..models.proposal_target import proposal_target_layer
from ..models.train_functions import generate_rpn_labels_device, model_loss
from ..parallel import create_train_state
from ..weights import seeded_state_dict

ROOT = Path(__file__).resolve().parents[2]
SEED = 0
STAGES = ("rpn_labels", "rpn_forward", "proposal_layer", "proposal_target",
          "rcnn_forward", "loss", "backward", "optimizer")


def train_step_by_stage(cfg, model, state, batch, gen, stage) -> None:
    """One joint train step (``make_train_step``'s, RPN not fixed), with
    each stage run inside ``stage(name)``."""
    pts, gt = batch["pts_input"], batch["gt_boxes3d"]
    for p in state.optimizer.params:
        p.grad = None
    with stage("rpn_labels"):
        cls_l, reg_l = generate_rpn_labels_device(pts, gt)
    with stage("rpn_forward"):
        out = dict(model.rpn(pts, True, 0.9, gen))
    with stage("proposal_layer"), torch.no_grad():
        xyz = out["backbone_xyz"]
        scores = out["rpn_cls"][:, :, 0]
        rois, _, roi_valid = proposal_layer(
            scores, out["rpn_reg"], xyz, cfg, "TRAIN")
    with stage("proposal_target"), torch.no_grad():
        extra, _ = rcnn_extra_features(cfg, scores, xyz)
        target = proposal_target_layer(
            gen, rois, roi_valid, gt, xyz,
            torch.cat([extra, out["backbone_features"]], -1), cfg,
            aug_data=cfg.AUG_DATA)
    with stage("rcnn_forward"):
        out.update(target)
        out.update(model.rcnn_net(target["sampled_pts"],
                                  target["pts_feature"], True, 0.9, gen))
    with stage("loss"):
        loss, _ = model_loss(cfg, out, {"rpn_cls_label": cls_l,
                                        "rpn_reg_label": reg_l})
    with stage("backward"):
        loss.backward()
    with stage("optimizer"):
        state.apply_gradients()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    cfg = cfg_from_file(str(ROOT / "configs" / "default.yaml"), fresh_cfg())
    model = PointRCNN(cfg, mode="TRAIN")
    model.load_state_dict(seeded_state_dict(model, SEED))
    state = create_train_state(cfg, model, steps_per_epoch=100,
                               total_epochs=10)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             train_batch(args.batch, cfg.RPN.NUM_POINTS, SEED).items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    walls = defaultdict(list)

    @contextlib.contextmanager
    def timed(name):
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        walls[name].append((time.perf_counter() - t0) * 1e3)

    def ranged(name):
        return record_function(f"stage:{name}")

    for _ in range(2):  # warm-up: allocator, library handles
        train_step_by_stage(cfg, model, state, batch, gen,
                            lambda name: contextlib.nullcontext())
    torch.cuda.synchronize()
    walls.clear()
    for _ in range(args.reps):
        train_step_by_stage(cfg, model, state, batch, gen, timed)
    wall = {name: statistics.median(walls[name]) for name in STAGES}

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            train_step_by_stage(cfg, model, state, batch, gen, ranged)
        torch.cuda.synchronize()
    # host-side events carry the kernels they launched (and their
    # children's); the stage ranges also show on the device's timeline,
    # as annotations, which are left out
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    windows = [(e.time_range.start, e.time_range.end, e.name[6:])
               for e in host if e.name.startswith("stage:")]
    kernel = defaultdict(float)
    by_name = defaultdict(float)
    for e in host:
        if e.name.startswith("stage:"):
            kernel[e.name[6:]] += e.device_time_total
        elif e.cpu_parent is None:  # ops of other threads: the backward's
            for t0, t1, name in windows:
                if t0 <= e.time_range.start < t1:
                    kernel[name] += e.device_time_total
                    break
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.name.startswith(
                "stage:"):
            by_name[e.name[:80]] += e.device_time_total
    kernel = {name: kernel[name] / 1e3 / args.reps for name in STAGES}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]

    step_wall, step_kernel = sum(wall.values()), sum(kernel.values())
    print(f"card: {torch.cuda.get_device_name(0)}; batch {args.batch}, "
          f"median of {args.reps} steps per stage")
    print(f"step: {step_wall:.2f} ms wall, {step_kernel:.2f} ms of kernels, "
          f"device idle {100 * (1 - step_kernel / step_wall):.1f}%")
    for name in STAGES:
        print(f"stage {name}: {wall[name]:.2f} ms wall, {kernel[name]:.2f} "
              f"ms of kernels")
    print("top kernels over the step:")
    for name, us in top:
        print(f"  {us / 1e3 / args.reps:8.3f} ms  {name}")
    print(json.dumps({
        "batch": args.batch, "wall_ms": wall, "kernel_ms": kernel,
        "device_idle_share": 1 - step_kernel / step_wall,
        "top_kernels_ms": {n: us / 1e3 / args.reps for n, us in top}}))


if __name__ == "__main__":
    main()
