"""RPN: PointNet++ backbone plus per-point classification and
bin-regression heads (counterpart of ``tpu3d/models/rpn.py``)."""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config.config import as_attrdict
from ..parallel.mesh import draw_rows
from ..precision import F32, Precision, linear, promote_f32
from .bbox_codec import reg_channels
from .pointnet2 import BatchNorm, Pointnet2MSG, running_stats_frozen


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax's ``Dropout`` in training: keep each element with probability
    1 − rate, scaled by 1/(1 − rate), the mask drawn from ``generator``
    (``F.dropout`` takes none). Under a data-parallel mesh the mask is this
    rank's rows of the global batch's, drawn whole on every rank."""
    if rate == 0.0:
        return x
    keep = draw_rows(lambda shape: torch.rand(
        shape, generator=generator, device=x.device, dtype=x.dtype),
        x.shape) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class HeadMLP(nn.Module):
    """Conv1d tower: hidden Dense(+BN)+ReLU layers with dropout after the
    first (in training only), then a linear output layer. ``dtype``: the
    Dense compute dtype (bf16 under ``BF16_INFERENCE``); the output is
    promoted to f32, as tpu3d's heads promote theirs."""

    def __init__(self, in_channels: int, hidden, out_channels: int,
                 use_bn: bool = True, dp_ratio: float = 0.0, device=None):
        super().__init__()
        self.n = len(hidden)
        self.use_bn = use_bn
        self.dp_ratio = float(dp_ratio)
        for i, ch in enumerate(hidden):
            self.add_module(f"dense_{i}", nn.Linear(
                in_channels, ch, bias=not use_bn, device=device))
            if use_bn:
                self.add_module(f"bn_{i}", BatchNorm(ch, device=device))
            in_channels = ch
        self.out = nn.Linear(in_channels, out_channels, device=device)

    def forward(self, x: torch.Tensor, train: bool = False,
                bn_momentum: float = 0.9,
                generator: torch.Generator | None = None,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        for i in range(self.n):
            dense = getattr(self, f"dense_{i}")
            x = linear(x, dense.weight, dense.bias, dtype)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x, train, bn_momentum)
            x = torch.relu(x)
            if i == 0 and train:
                x = dropout(x, self.dp_ratio, generator)
        return promote_f32(linear(x, self.out.weight, self.out.bias, dtype))


class RPN(nn.Module):
    """cfg-driven RPN. Input (B, N, 3 [+ intensity]); outputs per-point cls
    logits (B, N, 1), reg (B, N, C), backbone xyz/features."""

    def __init__(self, cfg, device=None):
        super().__init__()
        c = as_attrdict(cfg)
        sa = c.RPN.SA_CONFIG
        self.backbone = Pointnet2MSG(
            npoints=sa.NPOINTS, radii=sa.RADIUS, nsamples=sa.NSAMPLE,
            sa_mlps=sa.MLPS, fp_mlps=c.RPN.FP_MLPS,
            input_channels=int(c.RPN.USE_INTENSITY), bn=c.RPN.USE_BN,
            device=device)
        feat_c = c.RPN.FP_MLPS[0][-1]
        self.cls_head = HeadMLP(feat_c, c.RPN.CLS_FC, 1, use_bn=c.RPN.USE_BN,
                                dp_ratio=c.RPN.DP_RATIO, device=device)
        n_reg = reg_channels(c.RPN.LOC_SCOPE, c.RPN.LOC_BIN_SIZE,
                             c.RPN.NUM_HEAD_BIN, c.RPN.LOC_XZ_FINE)
        self.reg_head = HeadMLP(feat_c, c.RPN.REG_FC, n_reg,
                                use_bn=c.RPN.USE_BN, dp_ratio=c.RPN.DP_RATIO,
                                device=device)
        # TRAIN.REMAT: the backbone recomputed in the backward (tpu3d:
        # models/rpn.py:84-88, nn.remat of Pointnet2MSG alone)
        self.remat = bool(c.get("TRAIN", {}).get("REMAT", False))

    def forward(self, pts_input: torch.Tensor, train: bool = False,
                bn_momentum: float = 0.9,
                generator: torch.Generator | None = None,
                precision: Precision = F32) -> dict:
        """In training, BatchNorm takes the batch's statistics and the heads
        draw their dropout masks from ``generator`` (cls head first).
        ``precision``: the numerics contract (tpu3d: models/rpn.py:70-81),
        the backbone's Dense layers in its ``dense_dtype``, the heads' in
        its ``head_dtype`` (f32 in training). With ``TRAIN.REMAT`` a
        training forward that records gradients keeps none of the
        backbone's activations: ``torch.utils.checkpoint`` recomputes them
        in the backward, with the same rounding points, routes and
        fixed-order sums, so with the same bits, and its BatchNorm layers'
        running statistics frozen (``running_stats_frozen``), so they take
        the step's one update."""
        args = (pts_input, train, bn_momentum, precision)
        if train and self.remat and torch.is_grad_enabled():
            backbone_xyz, backbone_features = checkpoint(
                self.backbone, *args, use_reentrant=False,
                context_fn=lambda: (contextlib.nullcontext(),
                                    running_stats_frozen()))
        else:
            backbone_xyz, backbone_features = self.backbone(*args)
        dt = precision.head_dtype
        return {
            "rpn_cls": self.cls_head(backbone_features, train, bn_momentum,
                                     generator, dt),
            "rpn_reg": self.reg_head(backbone_features, train, bn_momentum,
                                     generator, dt),
            "backbone_xyz": backbone_xyz,
            "backbone_features": backbone_features,
        }
