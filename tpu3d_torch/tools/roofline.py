"""MFU accounting for the two headline programs on the card: default.yaml's
joint eval batch and its train step (counterpart of
``tpu3d/tools/roofline.py``).

- **Analytic matmul FLOPs**: a walk over the config's layer specs (the
  RPN's SA / FP / head towers, the RCNN stack) that follows the model's
  channel propagation, tpu3d's functions copied as plain Python on the
  port's config, so they give tpu3d's numbers to the float. This is the
  MFU numerator: matmul FLOPs only, counted once for a forward and three
  times for a train step (the backward's dx and dw products each equal the
  forward's).
- **Counted FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` over one
  eval batch and one train step of the port, the counterpart of XLA's
  ``cost_analysis()``. Like the Pallas custom calls there, the port's
  hand-written kernels count zero: they launch through ctypes, outside any
  aten op, and so do the fused SA ops' autograd Functions, forward and
  backward. So this is a cross-check of the part torch runs (the RPN's
  SharedMLPs, the heads, the RCNN's xyz block), not the numerator.
  tpu3d's ``bytes accessed`` has no counterpart here: the HBM fields are
  dropped.
- **Neighbor FLOPs**: the neighbour kernels (FPS with its 3-NN pass, the
  nearest-k sweeps), ~10 per (pick, point) and ~8 per (center, point),
  reported apart; they are not matmul work.

MFU = the ideal time of the analytic matmul FLOPs / the measured time,
where each product counts against the peak of the type it runs in, as
tpu3d intends (its roofline divides by its chip's bf16 peak): products in
bf16 over 989 TFLOP/s, products in float32 over 67 TFLOP/s on an H100 SXM
(TF32 is off, ``tpu3d_torch/__init__.py``), the ideal time the sum of the
two shares. Which products run in bf16 follows the eval numerics contract
(``precision.resolve`` for the device, the config and
``TPU3D_F32_EVAL``): under the accelerator's contract the RCNN levels on a
fused route run their two Dense layers in the bf16 kernels; under
``BF16_INFERENCE`` every Dense is bf16; the f32 contract is float32
throughout. The train step follows the training contract
(``TRAIN.BF16_MATMULS``: every Dense but the heads and the scene-frame
pre-grouped layers 0 in bf16, forward and backward; ``TRAIN.
BF16_ACTIVATIONS`` alone: the fused RCNN levels' layers 1-2). Each output line carries the card's name and power
limit as nvidia-smi gives them, and the split
(``bf16_matmul_tflop_per_step``) and the contract.

Keys renamed from tpu3d's output, where they named a TPU part or XLA:
``vpu_neighbor_gflop_per_step`` -> ``neighbor_gflop_per_step`` (and
``program_flops``' ``vpu_neighbor_flops`` -> ``neighbor_flops``,
``neighbor_vpu_flops`` -> ``neighbor_flops``);
``xla_visible_tflop_per_step`` -> ``counted_tflop_per_step``. Dropped:
``xla_bytes_accessed_gb``, ``hbm_gbs_estimate``,
``hbm_util_pct_estimate``. Added: ``card``.

    python -m tpu3d_torch.tools.roofline --eval-ms 70.3 --train-ms 240.4
        [--cfg_file configs/default.yaml] [--eval-batch 8]
        [--train-batch 16] [--skip-counted] [--device cuda]

The times are the caller's measurements of one eval batch and one train
step at those batches (``chip_smoke.py`` phase 17 measures and passes
them).
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

from ..models.bbox_codec import reg_channels
from ..ops.fused_sa import sa_route
from ..precision import Precision, resolve

ROOT = Path(__file__).resolve().parents[2]
H100_PEAK_F32_TFLOPS = 67.0
H100_PEAK_BF16_TFLOPS = 989.0
SEED = 0


# ---------------------------------------------------------------- analytic

def _tower(n_rows: int, chans: list[int]) -> float:
    """FLOPs of a pointwise Dense tower applied to n_rows rows:
    sum over consecutive (cin, cout) of 2 * n_rows * cin * cout."""
    return sum(2.0 * n_rows * a * b for a, b in zip(chans[:-1], chans[1:]))


def backbone_matmul_flops(cfg, batch: int) -> dict:
    """Matmul FLOPs (forward, one batch) of the RPN backbone + heads,
    following Pointnet2MSG's channel propagation."""
    r = cfg.RPN
    n_levels = len(r.SA_CONFIG.NPOINTS)
    counts = [cfg.RPN.NUM_POINTS] + list(r.SA_CONFIG.NPOINTS)
    c_in = 1 if r.USE_INTENSITY else 0
    feat_ch = [c_in]
    sa = 0.0
    for k in range(n_levels):
        m = r.SA_CONFIG.NPOINTS[k]
        out_ch = 0
        for j, spec in enumerate(r.SA_CONFIG.MLPS[k]):
            s = r.SA_CONFIG.NSAMPLE[k][j]
            chans = [feat_ch[k] + 3] + list(spec)  # use_xyz concat
            sa += batch * _tower(m * s, chans)
            out_ch += spec[-1]
        feat_ch.append(out_ch)

    fp = 0.0
    fp_out = {}
    for i in range(len(r.FP_MLPS) - 1, -1, -1):
        upper_ch = fp_out.get(i + 1, feat_ch[i + 1])
        skip_ch = feat_ch[i]
        chans = [upper_ch + skip_ch] + list(r.FP_MLPS[i])
        fp += batch * _tower(counts[i], chans)
        fp_out[i] = r.FP_MLPS[i][-1]

    n_pts = cfg.RPN.NUM_POINTS
    c0 = fp_out[0]
    n_reg = reg_channels(r.LOC_SCOPE, r.LOC_BIN_SIZE, r.NUM_HEAD_BIN,
                         r.LOC_XZ_FINE)
    heads = batch * (_tower(n_pts, [c0] + list(r.CLS_FC) + [1])
                     + _tower(n_pts, [c0] + list(r.REG_FC) + [n_reg]))
    return {"sa": sa, "fp": fp, "heads": heads, "backbone_out_ch": c0}


def rcnn_matmul_flops(cfg, batch: int, rois: int) -> dict:
    """Matmul FLOPs (forward) of the RCNN refinement stack for
    batch*rois ROIs of cfg.RCNN.NUM_POINTS canonical points."""
    c = cfg.RCNN
    n = batch * rois
    k = c.NUM_POINTS
    n_ext = int(c.USE_INTENSITY) + int(c.USE_MASK) + int(c.USE_DEPTH)
    rpn_ch = cfg.RPN.FP_MLPS[0][-1]  # backbone per-point feature width
    up = 0.0
    if c.USE_RPN_FEATURES:
        up += _tower(n * k, [3 + n_ext] + list(c.XYZ_UP_LAYER))
        up += _tower(n * k, [c.XYZ_UP_LAYER[-1] + rpn_ch,
                             c.XYZ_UP_LAYER[-1]])
    feat_ch = c.XYZ_UP_LAYER[-1] if c.USE_RPN_FEATURES else n_ext
    sa = 0.0
    pts = k
    for i, spec in enumerate(c.SA_CONFIG.NPOINTS):
        m = spec if spec != -1 else 1
        s = c.SA_CONFIG.NSAMPLE[i] if spec != -1 else pts
        chans = [feat_ch + 3] + list(c.SA_CONFIG.MLPS[i])
        sa += _tower(n * m * s, chans)
        feat_ch = c.SA_CONFIG.MLPS[i][-1]
        pts = m
    n_reg = reg_channels(c.LOC_SCOPE, c.LOC_BIN_SIZE, c.NUM_HEAD_BIN,
                         True, c.LOC_Y_BY_BIN, c.LOC_Y_SCOPE,
                         c.LOC_Y_BIN_SIZE)
    heads = (_tower(n, [feat_ch] + list(c.CLS_FC) + [1])
             + _tower(n, [feat_ch] + list(c.REG_FC) + [n_reg]))
    return {"xyz_up": up, "sa": sa, "heads": heads}


def neighbor_flops(cfg, batch: int, rois: int) -> float:
    """Analytic FLOPs of the neighbour kernels (not matmul work): FPS with
    its 3-NN pass ~10 per (pick, point); nearest-k ~8 per (center,
    point)."""
    r = cfg.RPN
    total = 0.0
    n = cfg.RPN.NUM_POINTS
    for k, m in enumerate(r.SA_CONFIG.NPOINTS):
        total += batch * (10.0 * m * n + 8.0 * m * n)  # FPS+3NN, nearest-k
        n = m
    c = cfg.RCNN
    pts = c.NUM_POINTS
    for spec in c.SA_CONFIG.NPOINTS:
        m = spec if spec != -1 else 1
        total += batch * rois * (10.0 * m * pts + 8.0 * m * pts)
        pts = m
    return total


def _f32_share_of_bf16_training(cfg, batch: int) -> float:
    """Forward matmul FLOPs that stay f32 under bf16 Dense training: the
    heads (``head_dtype``) and layer 0 of each scene-frame pre-grouped RPN
    level (``first_f32``: the levels with features)."""
    r = cfg.RPN
    rois = cfg.RCNN.ROI_PER_IMAGE
    heads = backbone_matmul_flops(cfg, batch)["heads"]
    if cfg.RCNN.ENABLED:
        heads += rcnn_matmul_flops(cfg, batch, rois)["heads"]
    feat = 1 if r.USE_INTENSITY else 0
    layer0 = 0.0
    for k, m in enumerate(r.SA_CONFIG.NPOINTS):
        for j, spec in enumerate(r.SA_CONFIG.MLPS[k]):
            if feat:
                s = r.SA_CONFIG.NSAMPLE[k][j]
                layer0 += batch * _tower(m * s, [feat + 3, spec[0]])
        feat = sum(spec[-1] for spec in r.SA_CONFIG.MLPS[k])
    return heads + layer0


def bf16_matmul_flops(cfg, mode: str, batch: int,
                      precision: Precision) -> float:
    """The part of ``program_flops``' total matmul FLOPs whose products run
    in bf16 under ``precision``: under a bf16 Dense dtype all of them (at
    eval, ``BF16_INFERENCE``) or all but the heads' and the scene-frame
    pre-grouped layers 0 (in training, ``TRAIN.BF16_MATMULS``, forward and
    backward alike); with the set-abstraction casts alone, layers 1 and 2
    of each RCNN level that ``sa_route`` fuses (the bf16 kernels, in
    training their forward and backward); none under the f32 contract."""
    train = mode == "train"
    mult = 3.0 if train else 1.0
    if precision.dense_dtype is not None:
        total = program_flops(cfg, mode, batch)["total_matmul_flops"]
        if train:
            total -= mult * _f32_share_of_bf16_training(cfg, batch)
        return total
    if not (precision.sa_bf16 and cfg.RCNN.ENABLED):
        return 0.0
    c = cfg.RCNN
    n = batch * (c.ROI_PER_IMAGE if train else cfg.TEST.RPN_POST_NMS_TOP_N)
    pts, total = c.NUM_POINTS, 0.0
    for i, spec in enumerate(c.SA_CONFIG.NPOINTS):
        if spec == -1:
            break
        s, mlp = c.SA_CONFIG.NSAMPLE[i], list(c.SA_CONFIG.MLPS[i])
        if sa_route((n, spec, s, mlp[0]), mlp, pts, c.USE_BN) != "plain":
            total += mult * _tower(n * spec * s, mlp)
        pts = spec
    return total


def program_flops(cfg, mode: str, batch: int) -> dict:
    """Total analytic matmul FLOPs for one eval batch or one train step."""
    rois = (cfg.RCNN.ROI_PER_IMAGE if mode == "train"
            else cfg.TEST.RPN_POST_NMS_TOP_N)
    bb = backbone_matmul_flops(cfg, batch)
    rc = (rcnn_matmul_flops(cfg, batch, rois)
          if cfg.RCNN.ENABLED else {"xyz_up": 0, "sa": 0, "heads": 0})
    fwd = bb["sa"] + bb["fp"] + bb["heads"] + rc["xyz_up"] + rc["sa"] \
        + rc["heads"]
    mult = 3.0 if mode == "train" else 1.0  # bwd: dx + dw each == fwd
    return {
        "fwd_matmul_flops": fwd,
        "total_matmul_flops": fwd * mult,
        # no train multiplier: the neighbour kernels have no backward pass
        "neighbor_flops": neighbor_flops(cfg, batch, rois),
        "breakdown_fwd": {"rpn_sa": bb["sa"], "rpn_fp": bb["fp"],
                          "rpn_heads": bb["heads"], "rcnn_xyz_up": rc["xyz_up"],
                          "rcnn_sa": rc["sa"], "rcnn_heads": rc["heads"]},
    }


# ------------------------------------------------------------- counted

def _counted(fn) -> dict:
    """FlopCounterMode's total over ``fn()``, which ends in a read of its
    result."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return {"counted_flops": float(counter.get_total_flops())}


def counted_flops_eval(cfg, batch: int, device="cuda") -> dict:
    """FLOPs torch's own ops run in one joint eval batch (the infer step
    on planted-cluster scenes, seeded weights) -> {"counted_flops"}."""
    import torch

    from ..datasets import random_scenes
    from ..device import resolve_device
    from ..models import PointRCNN
    from ..tools.eval_rcnn import make_infer_step
    from ..weights import seeded_state_dict

    dev = resolve_device(device)
    model = PointRCNN(cfg, mode="TEST", device=dev)
    model.load_state_dict(seeded_state_dict(model, SEED))
    pts = torch.from_numpy(random_scenes(batch, cfg.RPN.NUM_POINTS,
                                         SEED)).to(dev)
    infer = make_infer_step(model, cfg)
    with torch.no_grad():
        return _counted(lambda: infer(pts)["final_scores"].sum().item())


def counted_flops_train(cfg, batch: int, device="cuda") -> dict:
    """FLOPs torch's own ops run in one joint train step (forward,
    backward, the update; planted-cluster scenes with their gt boxes,
    seeded weights) -> {"counted_flops"}."""
    import torch

    from ..datasets import train_batch
    from ..device import resolve_device
    from ..models import PointRCNN
    from ..parallel import create_train_state, make_train_step
    from ..weights import seeded_state_dict

    dev = resolve_device(device)
    model = PointRCNN(cfg, mode="TRAIN", device=dev)
    model.load_state_dict(seeded_state_dict(model, SEED))
    state = create_train_state(cfg, model, steps_per_epoch=100,
                               total_epochs=200)
    data = {k: torch.from_numpy(v).to(dev) for k, v in
            train_batch(batch, cfg.RPN.NUM_POINTS, SEED).items()}
    step = make_train_step(cfg, model)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return _counted(lambda: step(state, data, gen, 0.9)["loss"].item())


# ----------------------------------------------------------------- report

def card_name(device="cuda") -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    device type off a card."""
    import torch

    if torch.device(device).type != "cuda":
        return torch.device(device).type
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def derived(name: str, step_ms: float, flops: dict, counted: dict,
            card: str, bf16_flops: float = 0.0) -> dict:
    """One program's row: ``bf16_flops`` of its matmul FLOPs against the
    bf16 peak, the rest against the float32 one."""
    t = step_ms / 1e3
    total = flops["total_matmul_flops"]
    achieved_tflops = total / t / 1e12
    ideal_s = (bf16_flops / (H100_PEAK_BF16_TFLOPS * 1e12)
               + (total - bf16_flops) / (H100_PEAK_F32_TFLOPS * 1e12))
    mfu = ideal_s / t
    return {
        "program": name,
        "step_ms": step_ms,
        "matmul_tflop_per_step": total / 1e12,
        "bf16_matmul_tflop_per_step": bf16_flops / 1e12,
        "achieved_matmul_tflops": round(achieved_tflops, 2),
        "mfu_pct": round(100 * mfu, 2),
        "neighbor_gflop_per_step": round(flops["neighbor_flops"] / 1e9, 2),
        "counted_tflop_per_step": round(counted["counted_flops"] / 1e12, 4),
        "card": card,
    }


def default_cfg(cfg_file: str):
    """``cfg_file`` with tpu3d's roofline settings: joint, the RPN trained,
    no GT augmentation, TEST pre/post-NMS 9000/100 at 0.8."""
    from ..config import cfg_from_file, fresh_cfg

    cfg = cfg_from_file(cfg_file, fresh_cfg())
    cfg.RPN.ENABLED = cfg.RCNN.ENABLED = True
    cfg.RPN.USE_INTENSITY = False
    cfg.RPN.FIXED = False
    cfg.GT_AUG_ENABLED = False
    cfg.TEST.RPN_PRE_NMS_TOP_N = 9000
    cfg.TEST.RPN_POST_NMS_TOP_N = 100
    cfg.TEST.RPN_NMS_THRESH = 0.8
    cfg.RPN.LOC_XZ_FINE = True
    cfg.RPN.LOSS_CLS = "SigmoidFocalLoss"
    return cfg


def report(cfg, eval_ms: float, train_ms: float, eval_batch: int = 8,
           train_batch: int = 16, counted: bool = True, device="cuda",
           precision: Precision | None = None,
           train_precision: Precision | None = None) -> list[dict]:
    """The two programs' rows and the forward breakdown, as ``main``
    prints them; the eval row under ``precision``, the train row under
    ``train_precision`` (default: the contracts ``precision.resolve``
    gives the device and config, which the eval CLI's batches and the
    training CLI's steps ran under)."""
    card = card_name(device)
    if precision is None:
        precision = resolve(device, cfg)
    if train_precision is None:
        train_precision = resolve(device, cfg, train=True)
    fl_e = program_flops(cfg, "eval", eval_batch)
    fl_t = program_flops(cfg, "train", train_batch)
    zero = {"counted_flops": 0.0}
    c_e = counted_flops_eval(cfg, eval_batch, device) if counted else zero
    c_t = counted_flops_train(cfg, train_batch, device) if counted else zero
    eval_row = derived(f"eval_batch{eval_batch}", eval_ms, fl_e, c_e, card,
                       bf16_matmul_flops(cfg, "eval", eval_batch, precision))
    eval_row["precision"] = str(precision)
    train_row = derived(f"train_step_batch{train_batch}", train_ms, fl_t,
                        c_t, card, bf16_matmul_flops(cfg, "train",
                                                     train_batch,
                                                     train_precision))
    train_row["precision"] = str(train_precision)
    return [eval_row, train_row,
            {"breakdown_fwd_eval": fl_e["breakdown_fwd"],
             "breakdown_fwd_train": fl_t["breakdown_fwd"]}]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg_file", default=str(ROOT / "configs" /
                                              "default.yaml"))
    ap.add_argument("--eval-ms", type=float, required=True,
                    help="measured ms of one eval batch")
    ap.add_argument("--train-ms", type=float, required=True,
                    help="measured ms of one train step")
    ap.add_argument("--eval-batch", type=int, default=8)
    ap.add_argument("--train-batch", type=int, default=16)
    ap.add_argument("--skip-counted", action="store_true",
                    help="analytic FLOPs only (no FlopCounterMode run)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = report(default_cfg(args.cfg_file), args.eval_ms, args.train_ms,
                  args.eval_batch, args.train_batch, not args.skip_counted,
                  args.device)
    for row in rows:
        print(json.dumps(row))
    return rows


if __name__ == "__main__":
    main()
