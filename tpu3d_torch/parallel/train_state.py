"""The optimizer, its schedules and the train step on one GPU (counterpart
of ``tpu3d/parallel/train_state.py``, which builds them from optax).

- ``adam_onecycle``: optax's ``cosine_onecycle_schedule`` for the learning
  rate (cosine from peak/div to peak over int(T·pct) steps, then down to
  peak/(div·1e4)), the fastai momentum counter-cycle for Adam's b1, b2 =
  0.99, and decoupled weight decay on every parameter (AdamW);
- ``adam`` / ``sgd``: step decay with optional linear warm-up, and L2
  weight decay added to the clipped gradient;
- before every update the gradients are clipped by their global norm as
  optax clips them: g·max/‖g‖ when ‖g‖ >= max (``clip_grad_norm_`` would
  divide by ‖g‖ + 1e-6);
- the schedules are read at the count of updates done before this one, as
  optax's ``inject_hyperparams`` reads them, and Adam's bias correction
  takes the current b1.

The update itself is PyTorch's AdamW / Adam / SGD with each step's lr and
betas written into the parameter group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models.train_functions import generate_rpn_labels_device, model_loss


def _onecycle(transition_steps: int, peak: float, pct_start: float,
              div_factor: float, final_div_factor: float = 1e4):
    """optax's ``cosine_onecycle_schedule``: cosine interpolation between
    the accumulated values [peak/div, peak, peak/(div·final_div)] at the
    boundaries [0, int(pct·T), T], the last value after T."""
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    values = [peak / div_factor]
    for scale in (div_factor, 1.0 / (div_factor * final_div_factor)):
        values.append(values[-1] * scale)

    def sched(count: int) -> float:
        for k in range(2):
            if bounds[k] <= count < bounds[k + 1]:
                pct = (count - bounds[k]) / (bounds[k + 1] - bounds[k])
                start, end = values[k], values[k + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct)
                                                    + 1)
        return values[-1] if count >= bounds[-1] else 0.0

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
    the other optimizers (tpu3d's ``make_momentum_schedule``)."""
    train = cfg.TRAIN
    if train.OPTIMIZER != "adam_onecycle":
        return lambda step: train.MOMENTUM
    total_steps = max(1, steps_per_epoch * total_epochs)
    up = int(total_steps * train.PCT_START)
    hi, lo = train.MOMS

    def sched(step: int) -> float:
        if step < up:
            return 0.5 * (hi - lo) * (1 + math.cos(math.pi * step
                                                   / max(up, 1))) + lo
        t = (step - up) / max(total_steps - up, 1)
        return 0.5 * (hi - lo) * (1 - math.cos(math.pi * t)) + lo

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
        lr0 = self.lr(0)
        if self.kind == "adam_onecycle":
            # b2 = 0.99 as the reference's Adam; decoupled decay on every
            # parameter (its OptimWrapper's true_wd with bn_wd=True)
            self.opt = torch.optim.AdamW(self.params, lr=lr0,
                                         betas=(self.b1(0), 0.99), eps=1e-8,
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
        gradient is left as it is."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.sqrt(sum((torch.sum(g * g) for g in grads),
                              torch.zeros((), device=self.params[0].device)))
        keep = norm < self.max_norm
        with torch.no_grad():
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.max_norm))
        group = self.opt.param_groups[0]
        group["lr"] = self.lr(count)
        if self.kind == "adam_onecycle":
            group["betas"] = (self.b1(count), 0.99)
        self.opt.step()
        return norm


@dataclass
class TrainState:
    """The optimizer and the count of updates done."""
    optimizer: Optimizer
    step: int = 0

    def apply_gradients(self) -> torch.Tensor:
        """One clipped update from the parameters' ``.grad`` -> the global
        gradient norm."""
        norm = self.optimizer.step(self.step)
        self.step += 1
        return norm


def trainable_parameters(cfg, model: torch.nn.Module):
    """The parameters the configured mode trains: all, but the RPN's when
    ``RPN.FIXED`` (its parameters and statistics stay as loaded)."""
    return [p for name, p in model.named_parameters()
            if not (cfg.RPN.FIXED and name.startswith("rpn."))]


def create_train_state(cfg, model: torch.nn.Module, steps_per_epoch: int,
                       total_epochs: int) -> TrainState:
    """A fresh ``TrainState`` over the model's trainable parameters."""
    return TrainState(optimizer=Optimizer(
        cfg, trainable_parameters(cfg, model), steps_per_epoch,
        total_epochs))


def bn_momentum_at_epoch(cfg, epoch: int) -> float:
    """flax-convention BN momentum following the reference's
    BNMomentumScheduler (train_utils.py:24-45): PyTorch momentum
    BN_MOMENTUM·BN_DECAY^k (clipped at BNM_CLIP), k the decay steps passed."""
    train = cfg.TRAIN
    k = sum(1 for e in train.BN_DECAY_STEP_LIST if epoch >= e)
    torch_m = max(train.BN_MOMENTUM * train.BN_DECAY ** k, train.BNM_CLIP)
    return 1.0 - torch_m


def make_train_step(cfg, model: torch.nn.Module):
    """The twin of tpu3d's ``make_train_step``: returns
    ``train_step(state, batch, generator, bn_momentum) -> metrics``.

    ``batch`` holds ``pts_input`` (B, N, 3) and ``gt_boxes3d`` (B, G, 7),
    zero-padded, on the model's device; the RPN labels are made there from
    the gt boxes unless the batch carries ``rpn_cls_label`` /
    ``rpn_reg_label``. One step: the train-mode forward (dropout and the
    proposal target layer draw from ``generator``, a ``torch.Generator`` on
    the model's device), ``model_loss``, the backward and one clipped
    update of ``state``. The metrics are tpu3d's tb dict (0-dim tensors,
    left on the device) with ``grad_norm``.
    """
    if not cfg.RPN.ENABLED:
        raise NotImplementedError("RCNN-offline training is not ported yet")
    rpn_trains = not cfg.RPN.FIXED

    def train_step(state: TrainState, batch: dict,
                   generator: torch.Generator | None,
                   bn_momentum: float) -> dict:
        pts = batch["pts_input"]
        if rpn_trains and "rpn_cls_label" not in batch:
            cls_l, reg_l = generate_rpn_labels_device(pts[..., :3],
                                                      batch["gt_boxes3d"])
            batch = dict(batch, rpn_cls_label=cls_l, rpn_reg_label=reg_l)
        for p in state.optimizer.params:
            p.grad = None
        out = model({"pts_input": pts, "gt_boxes3d": batch["gt_boxes3d"]},
                    train=True, bn_momentum=bn_momentum, generator=generator)
        loss, tb = model_loss(cfg, out, batch)
        loss.backward()
        tb = {k: v.detach() if torch.is_tensor(v) else v
              for k, v in tb.items()}
        tb["grad_norm"] = state.apply_gradients()
        return tb

    return train_step
