"""PointRCNN in eval mode (counterpart of ``tpu3d/models/point_rcnn.py``).

Two branches, as in the JAX package. With ``RCNN.ENABLED`` (the joint mode
of configs/default.yaml): the RPN forward, proposal decode and
distance-banded NMS, then ROI pooling of the backbone points and features,
the canonical transform and the RCNN refinement. Without it: the RPN-only
branch, which ends at the proposals and the per-point segmentation mask.
RCNN-offline mode and training are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config.config import as_attrdict
from ..device import resolve_device
from ..ops.box_geometry import rotate_points_along_y
from ..ops.roipool import roipool3d
from .proposal import proposal_layer
from .rcnn import RCNNNet
from .rpn import RPN


def rcnn_extra_features(cfg, rpn_scores_raw: torch.Tensor,
                        backbone_xyz: torch.Tensor):
    """[seg_mask, depth] per point, as the config enables them (reference:
    rcnn_net.py:156-166) -> ((B, N, C_extra), (B, N) f32 seg mask). The
    intensity channel is not ported (``RCNN.USE_INTENSITY`` is False in
    every shipped config)."""
    seg_mask = (torch.sigmoid(rpn_scores_raw) > cfg.RPN.SCORE_THRESH).to(
        backbone_xyz.dtype)
    extras = []
    if cfg.RCNN.USE_MASK:
        extras.append(seg_mask[..., None])
    if cfg.RCNN.USE_DEPTH:
        depth = torch.linalg.norm(backbone_xyz, dim=2) / 70.0 - 0.5
        extras.append(depth[..., None])
    return torch.cat(extras, dim=-1), seg_mask


class PointRCNN(nn.Module):
    """The detector on ``device`` (default ``cuda``; raises without a card
    unless the caller passes ``device="cpu"``)."""

    def __init__(self, cfg, mode: str = "TEST", device=None):
        super().__init__()
        c = as_attrdict(cfg)
        if not c.RPN.ENABLED:
            raise NotImplementedError(
                "RCNN-offline mode (RPN.ENABLED False) is not ported yet")
        if mode == "TRAIN":
            raise NotImplementedError("training is not ported yet")
        if c.RCNN.ENABLED and c.RCNN.USE_INTENSITY:
            raise NotImplementedError(
                "RCNN.USE_INTENSITY needs the loader's intensity channel, "
                "which is not ported yet")
        self.cfg = c
        self.mode = mode
        dev = resolve_device(device)
        self.rpn = RPN(c, device=dev)
        if c.RCNN.ENABLED:
            self.rcnn_net = RCNNNet(c, device=dev)
        self.eval()

    @torch.no_grad()
    def pool_rois(self, backbone_xyz, backbone_features, rpn_scores_raw,
                  rois):
        """ROI pooling and the canonical transform (reference:
        rcnn_net.py:146-152) -> (xyz (B·M, K, 3) in each ROI's frame, rest
        (B·M, K, C_extra + C_rpn), empty (B, M), seg mask (B, N))."""
        c = self.cfg
        extra, seg_mask = rcnn_extra_features(c, rpn_scores_raw, backbone_xyz)
        pts_feature = torch.cat([extra, backbone_features], dim=-1)
        pooled_xyz, pooled_feats, empty = roipool3d(
            backbone_xyz, pts_feature, rois, float(c.RCNN.POOL_EXTRA_WIDTH),
            int(c.RCNN.NUM_POINTS))
        pooled_xyz = rotate_points_along_y(
            pooled_xyz - rois[..., None, 0:3], rois[..., 6][..., None])
        k = pooled_xyz.shape[2]
        return (pooled_xyz.reshape(-1, k, 3).contiguous(),
                pooled_feats.reshape(-1, k, pooled_feats.shape[3]), empty,
                seg_mask)

    @torch.no_grad()
    def rcnn_stage(self, backbone_xyz, backbone_features, rpn_scores_raw,
                   rois) -> dict:
        """The joint branch after the proposal layer: (B, N, 3), (B, N, C),
        (B, N) raw RPN scores, (B, M, 7) rois -> rcnn_cls (B·M, 1),
        rcnn_reg (B·M, C_reg), pooled_empty_flag (B, M) and seg_result
        (B, N) f32."""
        xyz, rest, empty, seg_mask = self.pool_rois(
            backbone_xyz, backbone_features, rpn_scores_raw, rois)
        out = self.rcnn_net(xyz, rest)
        out["pooled_empty_flag"] = empty
        out["seg_result"] = seg_mask
        return out

    @torch.no_grad()
    def forward(self, input_dict: dict) -> dict:
        c = self.cfg
        output = dict(self.rpn(input_dict["pts_input"]))
        rpn_scores_raw = output["rpn_cls"][:, :, 0]
        rois, roi_scores_raw, roi_valid = proposal_layer(
            rpn_scores_raw, output["rpn_reg"], output["backbone_xyz"], c,
            self.mode)
        output["rois"] = rois
        output["roi_scores_raw"] = roi_scores_raw
        output["roi_valid"] = roi_valid
        if not c.RCNN.ENABLED:
            output["seg_result"] = (torch.sigmoid(rpn_scores_raw)
                                    > c.RPN.SCORE_THRESH)
            return output
        output.update(self.rcnn_stage(
            output["backbone_xyz"], output["backbone_features"],
            rpn_scores_raw, rois))
        return output
