"""The optimizer, its schedules and the train step, on one GPU or over a
data-parallel mesh of them (counterpart of
``tpu3d/parallel/train_state.py``, which builds them from optax).

- ``adam_onecycle``: optax's ``cosine_onecycle_schedule`` for the learning
  rate (cosine from peak/div to peak over int(T·pct) steps, then down to
  peak/(div·1e4)), the fastai momentum counter-cycle for Adam's b1, b2 =
  0.99, and decoupled weight decay on every parameter (AdamW);
- ``adam`` / ``sgd``: step decay with optional linear warm-up, and L2
  weight decay added to the clipped gradient;
- before every update the gradients are clipped by their global norm as
  optax clips them: g·max/‖g‖ when ‖g‖ >= max (``clip_grad_norm_`` would
  divide by ‖g‖ + 1e-6);
- the schedules are read at the optimizer's own count of updates done
  before this one (``TrainState.opt_count``, optax's ``count``), as
  optax's ``inject_hyperparams`` reads them, and Adam's bias correction
  takes the current b1. The count equals the global step except after a
  checkpoint's structure fallback, which restores the step and starts the
  optimizer's state, count included, afresh, as tpu3d does.

The update itself is PyTorch's AdamW / Adam / SGD with each step's lr and
betas written into the parameter group.

Over a mesh (``parallel.mesh``) the step is tpu3d's sharded one, the step
of the global batch: each rank runs its rows under ``use_mesh`` (BatchNorm
statistics, loss normalizers and random draws of the global batch), its
loss is its share of the global loss, and the gradients are summed over
the ranks in one collective before the clip, so the parameters stay equal
on every rank.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..models.train_functions import (generate_rpn_labels_device,
                                      get_rcnn_loss, get_rpn_loss,
                                      model_loss)
from ..ops.rotated_iou import boxes_iou3d
from .mesh import (Mesh, reduce_metrics, replicate, sum_gradients,
                   use_mesh)


@functools.cache
def _cosf():
    """The C library's single-precision ``cosf``."""
    fn = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return fn


def _cos32(x: np.float32) -> np.float32:
    return np.float32(_cosf()(float(x)))


def _fma32(a, b, c) -> np.float32:
    """a·b + c with one rounding to float32 (the f32 product is exact in
    float64)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _recip32(n: int) -> np.float32:
    return np.float32(1) / np.float32(n)


def _onecycle(transition_steps: int, peak: float, pct_start: float,
              div_factor: float, final_div_factor: float = 1e4):
    """optax's ``cosine_onecycle_schedule``: cosine interpolation between
    the accumulated values [peak/div, peak, peak/(div·final_div)] at the
    boundaries [0, int(pct·T), T], the last value after T; in float32, as
    tpu3d's jitted train step computes it on the CPU (see
    ``make_momentum_schedule``)."""
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    values = np.cumprod(np.stack((peak / div_factor, div_factor,
                                  1.0 / (div_factor * final_div_factor))))

    def sched(count: int) -> np.float32:
        for k in range(2):
            if bounds[k] <= count < bounds[k + 1]:
                pct = (np.float32(count - bounds[k])
                       * _recip32(bounds[k + 1] - bounds[k]))
                half = np.float32((values[k] - values[k + 1]) / 2.0)
                return _fma32(half, _cos32(np.float32(np.pi) * pct)
                              + np.float32(1), np.float32(values[k + 1]))
        return np.float32(values[-1] if count >= bounds[-1] else 0.0)

    return sched


def make_lr_schedule(cfg, steps_per_epoch: int, total_epochs: int):
    """The learning rate at each update count (tpu3d's
    ``make_lr_schedule``)."""
    train = cfg.TRAIN
    total_steps = max(1, steps_per_epoch * total_epochs)
    if train.OPTIMIZER == "adam_onecycle":
        # both onecycle phases need at least one step, or the schedule
        # divides by zero: widen tiny step counts (smoke runs) until they
        # have; pct is clamped so that the loop ends
        pct = min(max(float(train.PCT_START), 0.01), 0.99)
        while (int(total_steps * pct) < 1
               or total_steps - int(total_steps * pct) < 1):
            total_steps += 1
        return _onecycle(total_steps, train.LR, pct, train.DIV_FACTOR, 1e4)
    boundaries = {e * steps_per_epoch: train.LR_DECAY
                  for e in train.DECAY_STEP_LIST}

    def sched(step: int) -> float:
        lr = train.LR
        for threshold, scale in boundaries.items():
            if step >= threshold:
                lr = lr * scale
        lr = max(lr, train.LR_CLIP)
        if train.LR_WARMUP and train.WARMUP_EPOCH > 0:
            warm_steps = train.WARMUP_EPOCH * steps_per_epoch
            if step < warm_steps:
                frac = min(max(step / max(warm_steps, 1), 0.0), 1.0)
                lr = train.WARMUP_MIN + (train.LR - train.WARMUP_MIN) * frac
        return lr

    return sched


def make_momentum_schedule(cfg, steps_per_epoch: int, total_epochs: int):
    """Adam's b1 at each update count: fastai's one-cycle momentum
    MOMS[0] -> MOMS[1] -> MOMS[0], cosine; the constant TRAIN.MOMENTUM for
    the other optimizers (tpu3d's ``make_momentum_schedule``).

    The one-cycle schedules are float32, each step as tpu3d computes it in
    its jitted train step on the CPU, so that the port's learning rate and
    b1, and the values it writes into a checkpoint, equal tpu3d's bit for
    bit at every count: XLA multiplies by the f32 reciprocal of a constant
    divisor (with π folded into it where the divisor is a scalar), fuses
    the closing a·b + c into one rounding, and takes cos from the C
    library's ``cosf``. ``tests/test_torch_checkpoint.py`` holds every count
    of several runs against optax's jitted schedules."""
    train = cfg.TRAIN
    if train.OPTIMIZER != "adam_onecycle":
        return lambda step: train.MOMENTUM
    total_steps = max(1, steps_per_epoch * total_epochs)
    up = int(total_steps * train.PCT_START)
    hi, lo = train.MOMS
    amp, lo32 = np.float32(0.5 * (hi - lo)), np.float32(lo)
    pi_up = np.float32(np.pi) * _recip32(max(up, 1))
    pi_down = np.float32(np.pi) * _recip32(max(total_steps - up, 1))

    def sched(step: int) -> np.float32:
        if step < up:
            return _fma32(amp, np.float32(1)
                          + _cos32(pi_up * np.float32(step)), lo32)
        return _fma32(amp, np.float32(1)
                      - _cos32(pi_down * np.float32(step - up)), lo32)

    return sched


class Optimizer:
    """Clip by global norm, then the configured update (tpu3d's
    ``make_optimizer``), over ``params``: the reference's create_optimizer
    (train_rcnn.py:96-116) branch by branch."""

    def __init__(self, cfg, params, steps_per_epoch: int, total_epochs: int):
        train = cfg.TRAIN
        self.params = [p for p in params]
        self.max_norm = float(train.GRAD_NORM_CLIP)
        self.lr = make_lr_schedule(cfg, steps_per_epoch, total_epochs)
        self.b1 = make_momentum_schedule(cfg, steps_per_epoch, total_epochs)
        self.kind = train.OPTIMIZER
        wd = float(train.WEIGHT_DECAY)
        lr0 = float(self.lr(0))
        if self.kind == "adam_onecycle":
            # b2 = 0.99 as the reference's Adam; decoupled decay on every
            # parameter (its OptimWrapper's true_wd with bn_wd=True)
            self.opt = torch.optim.AdamW(self.params, lr=lr0,
                                         betas=(float(self.b1(0)), 0.99),
                                         eps=1e-8,
                                         weight_decay=wd)
        elif self.kind == "adam":
            self.opt = torch.optim.Adam(self.params, lr=lr0, eps=1e-8,
                                        weight_decay=wd)
        elif self.kind == "sgd":
            self.opt = torch.optim.SGD(self.params, lr=lr0,
                                       momentum=float(train.MOMENTUM),
                                       weight_decay=wd)
        else:
            raise NotImplementedError(f"TRAIN.OPTIMIZER={self.kind!r}")

    def step(self, count: int) -> torch.Tensor:
        """Clip the parameters' ``.grad`` and update them, with the
        schedules read at ``count`` updates done -> the global norm of the
        gradients before the clip (0-dim tensor). A parameter without a
        gradient (the fixed RPN in rcnn mode) gets a zero one first, as
        optax sees it, so weight decay still reaches it."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum((torch.sum(g * g) for g in grads),
                              torch.zeros((), device=self.params[0].device)))
        keep = norm < self.max_norm
        with torch.no_grad():
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.max_norm))
        group = self.opt.param_groups[0]
        group["lr"] = float(self.lr(count))
        if self.kind == "adam_onecycle":
            group["betas"] = (float(self.b1(count)), 0.99)
        self.opt.step()
        return norm


def make_optimizer(cfg, steps_per_epoch: int, total_epochs: int,
                   params) -> Optimizer:
    """tpu3d's ``make_optimizer`` (train_state.py:107-135): the clip by
    global norm, then ``TRAIN.OPTIMIZER``'s update with its schedules, over
    ``params`` (an optax chain needs them only at ``init``; a torch
    optimizer holds them from the start)."""
    return Optimizer(cfg, params, steps_per_epoch, total_epochs)


@dataclass
class TrainState:
    """The optimizer, the global count of updates done (``step``) and the
    count of updates its state has taken (``opt_count``, the counterpart of
    optax's ``count``), at which the schedules are read."""
    optimizer: Optimizer
    step: int = 0
    opt_count: int = 0

    def apply_gradients(self) -> torch.Tensor:
        """One clipped update from the parameters' ``.grad`` -> the global
        gradient norm."""
        norm = self.optimizer.step(self.opt_count)
        self.step += 1
        self.opt_count += 1
        return norm


def create_train_state(cfg, model: torch.nn.Module, steps_per_epoch: int,
                       total_epochs: int,
                       mesh: Mesh | None = None) -> TrainState:
    """A fresh ``TrainState`` over every parameter of the model, in every
    mode, as tpu3d's optimizer holds the whole tree: with ``RPN.FIXED`` the
    RPN gets zero gradients, so only weight decay moves its parameters, and
    its BatchNorm statistics stay as loaded (it runs in eval mode). With a
    ``mesh``, the model's parameters and buffers are first broadcast from
    its first rank (``replicate``)."""
    if mesh is not None:
        replicate(mesh, model)
    return TrainState(optimizer=make_optimizer(
        cfg, steps_per_epoch, total_epochs, model.parameters()))


def bn_momentum_at_epoch(cfg, epoch: int) -> float:
    """flax-convention BN momentum following the reference's
    BNMomentumScheduler (train_utils.py:24-45): PyTorch momentum
    BN_MOMENTUM·BN_DECAY^k (clipped at BNM_CLIP), k the decay steps passed."""
    train = cfg.TRAIN
    k = sum(1 for e in train.BN_DECAY_STEP_LIST if epoch >= e)
    torch_m = max(train.BN_MOMENTUM * train.BN_DECAY ** k, train.BNM_CLIP)
    return 1.0 - torch_m


def make_train_step(cfg, model: torch.nn.Module, mesh: Mesh | None = None):
    """The twin of tpu3d's ``make_train_step``: returns
    ``train_step(state, batch, generator, bn_momentum) -> metrics``.

    ``batch`` holds ``pts_input`` (B, N, 3) and ``gt_boxes3d`` (B, G, 7),
    zero-padded, on the model's device, and may hold ``rpn_intensity``
    (B, N), which goes to the model (``RCNN.USE_INTENSITY`` with a model
    built for it; tpu3d's step passes the model only the first two, its
    loader makes no intensity); the RPN labels are made there from
    the gt boxes unless the batch carries ``rpn_cls_label`` /
    ``rpn_reg_label``. In RCNN-offline mode (``RPN.ENABLED`` False) it holds
    the loader's pooled points (B, R, K, C), run as (B·R, K, C), and the
    RCNN's labels (``cls_label``, ``reg_valid_mask``, ``roi_boxes3d``,
    ``gt_boxes3d_ct``; tpu3d: train_state.py:166-175). One step: the
    train-mode forward (dropout and the proposal target layer draw from
    ``generator``, a ``torch.Generator`` on the model's device),
    ``model_loss``, the backward and one clipped update of ``state``. The
    metrics are tpu3d's tb dict (0-dim tensors, left on the device) with
    ``grad_norm``.

    With a ``mesh`` (``parallel.make_mesh``), ``batch`` holds this rank's
    rows of the global batch (``shard_batch``), and ``generator`` is seeded
    alike on every rank: the step is the global batch's (see the module's
    docstring), the metrics are the global batch's on every rank, and the
    gradients are summed over the mesh's group before the clip. Without a
    group, or at a mesh of one rank without one, the step runs as without
    a mesh; a mesh of one rank with a group runs the gradients' collective
    alone, which leaves them as they are.
    """
    offline = not cfg.RPN.ENABLED
    rpn_trains = cfg.RPN.ENABLED and not cfg.RPN.FIXED

    def train_step(state: TrainState, batch: dict,
                   generator: torch.Generator | None,
                   bn_momentum: float) -> dict:
        pts = batch["pts_input"]
        if offline:
            inputs = {"pts_input": pts.reshape(-1, *pts.shape[-2:])}
        else:
            inputs = {"pts_input": pts, "gt_boxes3d": batch["gt_boxes3d"]}
            if "rpn_intensity" in batch:
                inputs["rpn_intensity"] = batch["rpn_intensity"]
        if rpn_trains and "rpn_cls_label" not in batch:
            cls_l, reg_l = generate_rpn_labels_device(pts[..., :3],
                                                      batch["gt_boxes3d"])
            batch = dict(batch, rpn_cls_label=cls_l, rpn_reg_label=reg_l)
        for p in state.optimizer.params:
            p.grad = None
        with use_mesh(mesh):
            out = model(inputs, train=True, bn_momentum=bn_momentum,
                        generator=generator)
            loss, tb = model_loss(cfg, out, batch)
            loss.backward()
        sum_gradients(state.optimizer.params, mesh)
        tb = reduce_metrics({k: v.detach() if torch.is_tensor(v) else v
                             for k, v in tb.items()}, mesh)
        tb["grad_norm"] = state.apply_gradients()
        return tb

    return train_step


def make_eval_step(cfg, model: torch.nn.Module):
    """The twin of tpu3d's ``make_eval_step``: ``eval_step(state, batch)``
    -> the eval-mode forward's output dict (the parameters live in
    ``model``; ``state`` is there for the same call)."""
    def eval_step(state: TrainState, batch: dict) -> dict:
        return model({"pts_input": batch["pts_input"]}, train=False)

    return eval_step


def make_eval_loss_step(cfg, model: torch.nn.Module,
                        mesh: Mesh | None = None):
    """The validation pass of ``--train_with_eval`` (tpu3d's
    ``make_eval_loss_step``; reference: train_utils.py:140-168
    Trainer.eval_epoch): ``eval_step(state, batch) -> metrics``.

    The forward is the eval-mode one (running BatchNorm statistics, no
    dropout); the RPN loss comes from the batch's labels while the RPN
    trains, and where the two-stage path runs, the proposal recall: per
    scene, the gt boxes (non-zero rows of ``gt_boxes3d``) that some valid
    roi overlaps by 3D IoU above 0.7 (``recalled_cnt``) out of ``gt_cnt``.
    In RCNN-offline mode the batch is the offline EVAL loader's (pooled
    points (B, M, K, C), ``gt_iou``, ``roi_valid``, ``roi_boxes3d``,
    ``gt_boxes3d_ct``) and the loss is the RCNN's, with labels from each
    roi's IoU to its gt (tpu3d: train_state.py:225-250). The metrics are
    0-dim tensors on the model's device; the caller averages them over the
    val loader. With a ``mesh``, ``batch`` holds this rank's rows and the
    metrics are the global batch's, on every rank."""
    offline = not cfg.RPN.ENABLED

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict:
        with use_mesh(mesh):
            return reduce_metrics(eval_metrics(batch), mesh)

    def eval_metrics(batch: dict) -> dict:
        pts = batch["pts_input"]
        if offline:
            pts = pts.reshape(-1, *pts.shape[-2:])
        out = model({"pts_input": pts}, train=False)
        tb = {}
        loss = torch.zeros((), device=pts.device)
        if offline:
            # labels from the saved proposals' IoU (reference
            # eval_rcnn.py:361-366): fg above CLS_FG, bg below CLS_BG; the
            # reg loss on valid rois whose IoU clears REG_FG_THRESH, toward
            # the loader's canonical matched gt
            gt_iou = batch["gt_iou"].reshape(-1)
            valid = batch["roi_valid"].reshape(-1)
            r = cfg.RCNN
            cls_label = torch.where(
                gt_iou > r.CLS_FG_THRESH, 1,
                torch.where(gt_iou < r.CLS_BG_THRESH, 0, -1))
            ret = dict(out, cls_label=torch.where(valid, cls_label, -1),
                       reg_valid_mask=((gt_iou > r.REG_FG_THRESH)
                                       & valid).to(torch.int32),
                       roi_boxes3d=batch["roi_boxes3d"].reshape(-1, 7),
                       gt_of_rois=batch["gt_boxes3d_ct"].reshape(-1, 7))
            rcnn_loss, tb_rcnn = get_rcnn_loss(cfg, ret)
            loss = loss + rcnn_loss
            tb.update(tb_rcnn)
        elif not cfg.RPN.FIXED:
            rpn_loss, tb_rpn = get_rpn_loss(
                cfg, out["rpn_cls"], out["rpn_reg"], batch["rpn_cls_label"],
                batch["rpn_reg_label"])
            loss = loss + rpn_loss
            tb.update(tb_rpn)
        if cfg.RPN.ENABLED and cfg.RCNN.ENABLED and "rois" in out:
            gt = batch["gt_boxes3d"]
            gt_valid = gt.abs().sum(dim=-1) > 0
            recalled = []
            for rois, valid, gt_b, gt_v in zip(out["rois"], out["roi_valid"],
                                               gt, gt_valid):
                iou = torch.where(valid[:, None], boxes_iou3d(rois, gt_b),
                                  0.0)
                recalled.append(torch.sum((iou.amax(dim=0) > 0.7) & gt_v))
            tb["recalled_cnt"] = torch.stack(recalled).sum()
            tb["gt_cnt"] = gt_valid.sum()
        tb["loss"] = loss
        return tb

    return eval_step
