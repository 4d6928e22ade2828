"""Where the joint train step spends its time on the card.

    python -m tpu3d_torch.tools.profile_train
        [--cfg_file configs/default.yaml] [--batch 16] [--reps 3]

Runs a config as shipped (joint mode; configs/default.yaml unless
``--cfg_file`` names another, e.g. configs/double.yaml) at full width with
seeded weights on a training batch of planted-cluster scenes, and splits
the step into its stages, each fed the previous stage's outputs: the RPN
labels, the RPN forward (train mode), the proposal layer (TRAIN
pre/post-NMS 9000/512), the proposal target layer, the RCNN forward, the
loss, the backward and the optimizer update. For each stage it prints the
wall time (host clock around the stage, which ends in a synchronize;
median over ``--reps`` steps, no profiler) and the time of the kernels it
runs (torch.profiler over ``--reps`` more steps, each stage ending in a
synchronize inside its range), then the device's idle share of the step
and one JSON line of the same numbers. Needs a CUDA device.

A kernel belongs to the stage whose range holds its launch: the host-side
launch call (``cudaLaunchKernel``, ``cuLaunchKernel``, ...) that shares
its correlation id, or, where the trace has none, the kernel's own start
on the device, which the stage's closing synchronize keeps inside the
range. This counts the port's kernels, which are launched through ctypes
from outside any torch op, as well as torch's own; the profiler's own
attribution (a kernel to the op that launched it, ``device_time_total``
of the stage's range and of the backward's ops) is printed beside it, and
so is the device time it links to no op, by kernel (a kernel that the
port launches outside any torch op, and outside an autograd Function, is
linked to none).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time
from bisect import bisect_right
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
from ..precision import resolve
from ..weights import seeded_state_dict
from .parse_trace import kernel_base, port_kernel_sources

ROOT = Path(__file__).resolve().parents[2]
SEED = 0
STAGES = ("rpn_labels", "rpn_forward", "proposal_layer", "proposal_target",
          "rcnn_forward", "loss", "backward", "optimizer")


def train_step_by_stage(cfg, model, state, batch, gen, stage,
                        precision=None) -> None:
    """One joint train step (``make_train_step``'s, RPN not fixed), with
    each stage run inside ``stage(name)``, under the training contract
    ``precision`` (default: ``precision.resolve``'s for the model's device,
    resolved once here, as ``make_train_step`` resolves it)."""
    pts, gt = batch["pts_input"], batch["gt_boxes3d"]
    prec = precision or resolve(pts.device, cfg, train=True)
    for p in state.optimizer.params:
        p.grad = None
    with stage("rpn_labels"):
        cls_l, reg_l = generate_rpn_labels_device(pts, gt)
    with stage("rpn_forward"):
        out = dict(model.rpn(pts, True, 0.9, gen, prec))
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
            aug_data=cfg.AUG_DATA, roi_bf16=prec.roi_bf16)
    with stage("rcnn_forward"):
        out.update(target)
        out.update(model.rcnn_net(target["sampled_pts"],
                                  target["pts_feature"].to(pts.dtype), True,
                                  0.9, gen, prec))
    with stage("loss"):
        loss, _ = model_loss(cfg, out, {"rpn_cls_label": cls_l,
                                        "rpn_reg_label": reg_l})
    with stage("backward"):
        loss.backward()
    with stage("optimizer"):
        state.apply_gradients()


def attribute(kernels, launches, windows):
    """Device time per stage: ``kernels`` [(correlation id, device start,
    duration)], ``launches`` {correlation id: host start of the launch
    call}, ``windows`` [(start, end, stage)] on the host clock, disjoint,
    each closed by a synchronize, all in us. A kernel goes to the window
    that holds its launch call, else its device start. -> ({stage: us},
    {"launch": us, "device start": us, "outside": us})."""
    windows = sorted(windows)
    starts = [w[0] for w in windows]
    per_stage = defaultdict(float)
    how = {"launch": 0.0, "device start": 0.0, "outside": 0.0}
    for corr, start, dur in kernels:
        t = launches.get(corr)
        key = "launch" if t is not None else "device start"
        t = start if t is None else t
        i = bisect_right(starts, t) - 1
        if i >= 0 and t < windows[i][1]:
            per_stage[windows[i][2]] += dur
            how[key] += dur
        else:
            how["outside"] += dur
    return dict(per_stage), how


def port_kernel_names() -> set[str]:
    """The names of the port's CUDA kernels (``__global__`` functions in
    ``csrc/``'s sources and shared headers), to tell its ctypes launches
    apart in a trace."""
    return set(port_kernel_sources())


def is_port_kernel(name: str, names: set[str]) -> bool:
    """Whether a trace's kernel name (``(anonymous namespace)::gather_kernel
    <float4, 2>(...)``, maybe after ``void``, or mangled) is one of
    ``names`` outside torch's namespaces."""
    base, torch_own = kernel_base(name)
    return not torch_own and base in names


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg_file", default=str(ROOT / "configs" /
                                              "default.yaml"))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    cfg = cfg_from_file(args.cfg_file, fresh_cfg())
    model = PointRCNN(cfg, mode="TRAIN")
    model.load_state_dict(seeded_state_dict(model, SEED))
    state = create_train_state(cfg, model, steps_per_epoch=100,
                               total_epochs=10)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             train_batch(args.batch, cfg.RPN.NUM_POINTS, SEED).items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    prec = resolve("cuda", cfg, train=True)

    walls = defaultdict(list)

    @contextlib.contextmanager
    def timed(name):
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        walls[name].append((time.perf_counter() - t0) * 1e3)

    @contextlib.contextmanager
    def ranged(name):
        # the synchronize inside the range keeps the stage's kernels in it
        with record_function(f"stage:{name}"):
            yield
            torch.cuda.synchronize()

    for _ in range(2):  # warm-up: allocator, library handles
        train_step_by_stage(cfg, model, state, batch, gen,
                            lambda name: contextlib.nullcontext(), prec)
    torch.cuda.synchronize()
    walls.clear()
    for _ in range(args.reps):
        train_step_by_stage(cfg, model, state, batch, gen, timed, prec)
    wall = {name: statistics.median(walls[name]) for name in STAGES}

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            train_step_by_stage(cfg, model, state, batch, gen, ranged, prec)
        torch.cuda.synchronize()
    # the profiler's own attribution: host-side events carry the kernels
    # they launched (and their children's); the stage ranges also show on
    # the device's timeline, as annotations, which are left out
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    windows = [(e.time_range.start, e.time_range.end, e.name[6:])
               for e in host if e.name.startswith("stage:")]
    linked = defaultdict(float)
    for e in host:
        if e.name.startswith("stage:"):
            linked[e.name[6:]] += e.device_time_total
        elif e.cpu_parent is None:  # ops of other threads: the backward's
            for t0, t1, name in windows:
                if t0 <= e.time_range.start < t1:
                    linked[name] += e.device_time_total
                    break
    # the device's work: kernels, copies and sets, not the annotations of
    # ranges (the stages', the optimizer's) on its timeline
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith("stage:")
              and not getattr(e, "is_user_annotation", False)]
    launches = {e.id: e.time_range.start for e in host
                if "Launch" in e.name and e.id > 0}
    by_stage, how = attribute(
        [(e.id, e.time_range.start, e.time_range.elapsed_us())
         for e in device], launches, windows)
    names = port_kernel_names()
    by_name = defaultdict(float)
    for e in device:
        by_name[e.name] += e.time_range.elapsed_us()
    linked_by_name = defaultdict(float)  # the kernels an op carries
    for e in host:
        for k in e.kernels:
            linked_by_name[k.name] += k.duration
    unlinked = {name: us - linked_by_name.get(name, 0.0)
                for name, us in by_name.items()}
    port = {"device": 0.0, "linked": 0.0, "by_launch": 0.0}
    for name, us in by_name.items():
        if is_port_kernel(name, names):
            port["device"] += us
            port["linked"] += min(us, linked_by_name.get(name, 0.0))
    port["by_launch"] = sum(
        e.time_range.elapsed_us() for e in device
        if e.id in launches and is_port_kernel(e.name, names))
    kernel = {name: by_stage.get(name, 0.0) / 1e3 / args.reps
              for name in STAGES}
    linked = {name: linked[name] / 1e3 / args.reps for name in STAGES}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    top_unlinked = sorted(((n, us) for n, us in unlinked.items() if us > 0),
                          key=lambda kv: -kv[1])[:8]
    total = sum(by_name.values()) / 1e3 / args.reps

    step_wall, step_kernel = sum(wall.values()), sum(kernel.values())
    print(f"card: {torch.cuda.get_device_name(0)}; {args.cfg_file}, batch "
          f"{args.batch}, median of {args.reps} steps per stage")
    print(f"step: {step_wall:.2f} ms wall, {step_kernel:.2f} ms of kernels, "
          f"device idle {100 * (1 - step_kernel / step_wall):.1f}%")
    for name in STAGES:
        print(f"stage {name}: {wall[name]:.2f} ms wall, {kernel[name]:.2f} "
              f"ms of kernels (the profiler's own attribution "
              f"{linked[name]:.2f})")
    per_step = {k: v / 1e3 / args.reps for k, v in how.items()}
    port = {k: v / 1e3 / args.reps for k, v in port.items()}
    print(f"device time per step: {total:.2f} ms in the trace; attributed "
          f"by the launch call {per_step['launch']:.2f}, by the device start "
          f"{per_step['device start']:.2f}, outside every stage "
          f"{per_step['outside']:.2f}; the profiler's own attribution "
          f"{sum(linked.values()):.2f}. The port's kernels "
          f"{port['device']:.3f} ms, {port['by_launch']:.3f} of them found "
          f"by their launch call; the profiler links {port['linked']:.3f} "
          f"to an op")
    print("top kernels over the step:")
    for name, us in top:
        print(f"  {us / 1e3 / args.reps:8.3f} ms  {name[:80]}")
    print("device time the profiler links to no op, by kernel:")
    for name, us in top_unlinked:
        print(f"  {us / 1e3 / args.reps:8.3f} ms  {name[:80]}")
    print(json.dumps({
        "cfg_file": args.cfg_file, "batch": args.batch, "wall_ms": wall,
        "kernel_ms": kernel, "kernel_ms_profiler_links": linked,
        "device_ms_in_trace": total, "attributed_ms": per_step,
        "port_kernels_ms": port,
        "device_idle_share": 1 - step_kernel / step_wall,
        "top_kernels_ms": {n[:80]: us / 1e3 / args.reps for n, us in top},
        "unlinked_kernels_ms": {n[:80]: us / 1e3 / args.reps
                                for n, us in top_unlinked}}))


if __name__ == "__main__":
    main()
