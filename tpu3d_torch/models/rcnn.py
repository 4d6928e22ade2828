"""RCNN refinement head in eval mode (counterpart of
``tpu3d/models/rcnn.py``; reference: lib/net/rcnn_net.py).

Input is each ROI's pooled points in the ROI's canonical frame: xyz
(R, K, 3) and the rest (R, K, C_extra + C_rpn), where the first C_extra
channels (intensity, seg mask, depth, as the config enables them) join xyz
in the "xyz block". The xyz block goes up through ``xyz_up``, is joined
with the RPN features and goes down through ``merge_down``; then three
single-scale SA levels, the last a GroupAll, and the cls / reg heads.
Submodules carry the flax names (``rcnn_net.sa_0.mlp_0.dense_1`` ...).
"""

from __future__ import annotations

import torch
from torch import nn

from .bbox_codec import reg_channels
from .pointnet2 import PointnetSAModule, SharedMLP
from .rpn import HeadMLP


class RCNNNet(nn.Module):
    def __init__(self, cfg, num_classes: int = 2, device=None):
        super().__init__()
        c = cfg.RCNN
        self.use_rpn_features = bool(c.USE_RPN_FEATURES)
        self.n_ext = int(c.USE_INTENSITY) + int(c.USE_MASK) + int(c.USE_DEPTH)
        rpn_c = cfg.RPN.FP_MLPS[0][-1]
        if self.use_rpn_features:
            up = c.XYZ_UP_LAYER
            self.xyz_up = SharedMLP(3 + self.n_ext, up, bn=c.USE_BN,
                                    device=device)
            self.merge_down = SharedMLP(up[-1] + rpn_c, [up[-1]],
                                        bn=c.USE_BN, device=device)
            channel_in = up[-1]
        else:
            channel_in = self.n_ext + rpn_c
        sa = c.SA_CONFIG
        self.n_sa = len(sa.NPOINTS)
        for k in range(self.n_sa):
            npoint = None if sa.NPOINTS[k] == -1 else int(sa.NPOINTS[k])
            self.add_module(f"sa_{k}", PointnetSAModule(
                npoint, sa.RADIUS[k], sa.NSAMPLE[k], sa.MLPS[k], channel_in,
                bn=c.USE_BN, device=device))
            channel_in = sa.MLPS[k][-1]
        cls_c = 1 if num_classes == 2 else num_classes
        self.cls_head = HeadMLP(channel_in, c.CLS_FC, cls_c, use_bn=c.USE_BN,
                                device=device)
        n_reg = reg_channels(c.LOC_SCOPE, c.LOC_BIN_SIZE, c.NUM_HEAD_BIN,
                             get_xz_fine=True, get_y_by_bin=c.LOC_Y_BY_BIN,
                             loc_y_scope=c.LOC_Y_SCOPE,
                             loc_y_bin_size=c.LOC_Y_BIN_SIZE)
        self.reg_head = HeadMLP(channel_in, c.REG_FC, n_reg, use_bn=c.USE_BN,
                                device=device)

    def point_features(self, xyz: torch.Tensor,
                       rest: torch.Tensor) -> torch.Tensor:
        """(R, K, 3), (R, K, C) -> the SA levels' input features (R, K, C')."""
        if not self.use_rpn_features:
            return rest
        xyz_feature = self.xyz_up(torch.cat([xyz, rest[..., :self.n_ext]], -1))
        return self.merge_down(
            torch.cat([xyz_feature, rest[..., self.n_ext:]], dim=-1))

    def forward(self, xyz: torch.Tensor, rest: torch.Tensor) -> dict:
        """xyz (R, K, 3), rest (R, K, C) -> rcnn_cls (R, 1), rcnn_reg
        (R, C_reg)."""
        features = self.point_features(xyz, rest)
        for k in range(self.n_sa):
            xyz, features = getattr(self, f"sa_{k}")(xyz, features)
        feat = features[:, 0, :]  # the final GroupAll leaves one group
        return {"rcnn_cls": self.cls_head(feat),
                "rcnn_reg": self.reg_head(feat)}
