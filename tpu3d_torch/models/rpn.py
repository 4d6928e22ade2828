"""RPN: PointNet++ backbone plus per-point classification and
bin-regression heads (counterpart of ``tpu3d/models/rpn.py``)."""

from __future__ import annotations

import torch
from torch import nn

from ..config.config import as_attrdict
from ..parallel.mesh import draw_rows
from .bbox_codec import reg_channels
from .pointnet2 import BatchNorm, Pointnet2MSG


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
    first (in training only), then a linear output layer."""

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
                generator: torch.Generator | None = None) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x, train, bn_momentum)
            x = torch.relu(x)
            if i == 0 and train:
                x = dropout(x, self.dp_ratio, generator)
        return self.out(x)


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

    def forward(self, pts_input: torch.Tensor, train: bool = False,
                bn_momentum: float = 0.9,
                generator: torch.Generator | None = None) -> dict:
        """In training, BatchNorm takes the batch's statistics and the heads
        draw their dropout masks from ``generator`` (cls head first)."""
        backbone_xyz, backbone_features = self.backbone(
            pts_input, train, bn_momentum)
        return {
            "rpn_cls": self.cls_head(backbone_features, train, bn_momentum,
                                     generator),
            "rpn_reg": self.reg_head(backbone_features, train, bn_momentum,
                                     generator),
            "backbone_xyz": backbone_xyz,
            "backbone_features": backbone_features,
        }
