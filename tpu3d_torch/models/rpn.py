"""RPN in eval mode: PointNet++ backbone plus per-point classification and
bin-regression heads (counterpart of ``tpu3d/models/rpn.py``)."""

from __future__ import annotations

import torch
from torch import nn

from ..config.config import as_attrdict
from .bbox_codec import reg_channels
from .pointnet2 import BatchNorm, Pointnet2MSG


class HeadMLP(nn.Module):
    """Conv1d tower in eval mode: hidden Dense(+BN)+ReLU layers, then a
    linear output layer. Dropout is the identity in eval and is left out."""

    def __init__(self, in_channels: int, hidden, out_channels: int,
                 use_bn: bool = True, device=None):
        super().__init__()
        self.n = len(hidden)
        self.use_bn = use_bn
        for i, ch in enumerate(hidden):
            self.add_module(f"dense_{i}", nn.Linear(
                in_channels, ch, bias=not use_bn, device=device))
            if use_bn:
                self.add_module(f"bn_{i}", BatchNorm(ch, device=device))
            in_channels = ch
        self.out = nn.Linear(in_channels, out_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x)
            x = torch.relu(x)
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
                                device=device)
        n_reg = reg_channels(c.RPN.LOC_SCOPE, c.RPN.LOC_BIN_SIZE,
                             c.RPN.NUM_HEAD_BIN, c.RPN.LOC_XZ_FINE)
        self.reg_head = HeadMLP(feat_c, c.RPN.REG_FC, n_reg,
                                use_bn=c.RPN.USE_BN, device=device)

    def forward(self, pts_input: torch.Tensor) -> dict:
        backbone_xyz, backbone_features = self.backbone(pts_input)
        return {
            "rpn_cls": self.cls_head(backbone_features),
            "rpn_reg": self.reg_head(backbone_features),
            "backbone_xyz": backbone_xyz,
            "backbone_features": backbone_features,
        }
