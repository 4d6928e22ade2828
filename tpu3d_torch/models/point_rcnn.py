"""PointRCNN, at eval and in training (counterpart of
``tpu3d/models/point_rcnn.py``).

Three branches, as in the JAX package. With ``RCNN.ENABLED`` (the joint
mode of configs/default.yaml): the RPN forward, proposal decode and
distance-banded NMS, then, at eval, ROI pooling of the backbone points and
features with the canonical transform, or, in training, the proposal
target layer (ROI sampling, jitter, pooling, augmentation, labels); then
the RCNN refinement on the detached RPN outputs. Without it: the RPN-only
branch, which ends at the proposals and the per-point segmentation mask
at eval and at the RPN's outputs in training. With ``RPN.ENABLED`` False
(RCNN-offline mode): the RCNN alone, on the pooled canonical points the
loader builds from dumped RPN features. With ``RPN.FIXED`` the RPN runs in
eval mode and its outputs are detached.

``RCNN.USE_INTENSITY`` in the joint path, as tpu3d runs it: an
``rpn_intensity`` (B, N) in the inputs is the first of the extra channels
(``PointRCNN(..., intensity_input=True)``); without one the RCNN's xyz
block still takes ``n_ext`` channels, so the first RPN feature joins it
and ``merge_down`` reads the other C_rpn - 1 (tpu3d: rcnn.py:51-54).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config.config import as_attrdict
from ..device import resolve_device
from ..ops.box_geometry import rotate_points_along_y
from ..ops.roipool import roipool3d
from .proposal import proposal_layer
from .proposal_target import proposal_target_layer
from .rcnn import RCNNNet
from .rpn import RPN


def rcnn_extra_features(cfg, rpn_scores_raw: torch.Tensor,
                        backbone_xyz: torch.Tensor,
                        rpn_intensity: torch.Tensor | None = None):
    """[intensity, seg_mask, depth] per point, as the config enables them
    and the caller gives ``rpn_intensity`` (B, N) (reference:
    proposal_target_layer.py:20-29, rcnn_net.py:156-166) -> ((B, N,
    C_extra), (B, N) f32 seg mask)."""
    seg_mask = (torch.sigmoid(rpn_scores_raw) > cfg.RPN.SCORE_THRESH).to(
        backbone_xyz.dtype)
    extras = []
    if cfg.RCNN.USE_INTENSITY and rpn_intensity is not None:
        extras.append(rpn_intensity[..., None].to(backbone_xyz.dtype))
    if cfg.RCNN.USE_MASK:
        extras.append(seg_mask[..., None])
    if cfg.RCNN.USE_DEPTH:
        depth = torch.linalg.norm(backbone_xyz, dim=2) / 70.0 - 0.5
        extras.append(depth[..., None])
    return torch.cat(extras, dim=-1), seg_mask


def rcnn_rest_channels(cfg, intensity_input: bool) -> int:
    """The width of the joint path's pooled ``rest``: the extra channels
    ``rcnn_extra_features`` gives, then the RPN's features."""
    c = cfg.RCNN
    n = int(c.USE_MASK) + int(c.USE_DEPTH)
    n += int(c.USE_INTENSITY and intensity_input)
    return n + cfg.RPN.FP_MLPS[0][-1]


class PointRCNN(nn.Module):
    """The detector on ``device`` (default ``cuda``; raises without a card
    unless the caller passes ``device="cpu"``). ``mode`` picks the proposal
    layer's settings (``cfg.TRAIN`` or ``cfg.TEST``). With ``RPN.ENABLED``
    False it holds ``rcnn_net`` alone, as tpu3d's parameter tree does.
    ``intensity_input``: whether the joint path's inputs carry
    ``rpn_intensity`` under ``RCNN.USE_INTENSITY``, which sizes the RCNN as
    tpu3d's tree is sized by the inputs it was initialised on."""

    def __init__(self, cfg, mode: str = "TEST", device=None,
                 intensity_input: bool = False):
        super().__init__()
        c = as_attrdict(cfg)
        if not (c.RPN.ENABLED or c.RCNN.ENABLED):
            raise ValueError("PointRCNN needs RPN.ENABLED or RCNN.ENABLED")
        self.cfg = c
        self.mode = mode
        self.intensity_input = bool(intensity_input and c.RPN.ENABLED
                                    and c.RCNN.USE_INTENSITY)
        dev = resolve_device(device)
        if c.RPN.ENABLED:
            self.rpn = RPN(c, device=dev)
        if c.RCNN.ENABLED:
            rest = (rcnn_rest_channels(c, self.intensity_input)
                    if c.RPN.ENABLED else None)
            self.rcnn_net = RCNNNet(c, device=dev, rest_channels=rest)

    def rpn_intensity(self, t: torch.Tensor | None):
        """The inputs' ``rpn_intensity`` ``t`` where the RCNN reads it
        (``RCNN.USE_INTENSITY``), else None; raises where its presence
        differs from the width the model was built for."""
        if not self.cfg.RCNN.USE_INTENSITY:
            return None
        if (t is not None) != self.intensity_input:
            raise ValueError(
                f"the RCNN was built with intensity_input="
                f"{self.intensity_input}, and the inputs "
                f"{'carry' if t is not None else 'lack'} rpn_intensity")
        return t

    @torch.no_grad()
    def pool_rois(self, backbone_xyz, backbone_features, rpn_scores_raw,
                  rois, rpn_intensity=None):
        """ROI pooling and the canonical transform (reference:
        rcnn_net.py:146-152) -> (xyz (B·M, K, 3) in each ROI's frame, rest
        (B·M, K, C_extra + C_rpn), empty (B, M), seg mask (B, N))."""
        c = self.cfg
        extra, seg_mask = rcnn_extra_features(c, rpn_scores_raw, backbone_xyz,
                                              rpn_intensity)
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
                   rois, rpn_intensity=None) -> dict:
        """The joint branch after the proposal layer: (B, N, 3), (B, N, C),
        (B, N) raw RPN scores, (B, M, 7) rois and, for a model built with
        ``intensity_input``, (B, N) ``rpn_intensity`` -> rcnn_cls (B·M, 1),
        rcnn_reg (B·M, C_reg), pooled_empty_flag (B, M) and seg_result
        (B, N) f32."""
        xyz, rest, empty, seg_mask = self.pool_rois(
            backbone_xyz, backbone_features, rpn_scores_raw, rois,
            self.rpn_intensity(rpn_intensity))
        out = self.rcnn_net(xyz, rest)
        out["pooled_empty_flag"] = empty
        out["seg_result"] = seg_mask
        return out

    def forward(self, input_dict: dict, train: bool = False,
                bn_momentum: float = 0.9,
                generator: torch.Generator | None = None) -> dict:
        """``input_dict["pts_input"]`` (B, N, 3) -> the output dict; with
        ``RCNN.USE_INTENSITY`` and ``intensity_input`` also
        ``input_dict["rpn_intensity"]`` (B, N). In
        training (``train``) also ``input_dict["gt_boxes3d"]`` (B, G, 7),
        zero-padded; BatchNorm takes the batch's statistics and updates its
        running ones with ``bn_momentum`` (flax's convention), and dropout
        and the proposal target layer draw from ``generator``.
        RCNN-offline (``RPN.ENABLED`` False): ``pts_input`` is the loader's
        pooled canonical points, (B·M, K, 3 + C_extra + C_rpn), and the
        output holds ``rcnn_cls`` and ``rcnn_reg`` (tpu3d:
        point_rcnn.py:152-157)."""
        if not self.cfg.RPN.ENABLED:
            pts = input_dict["pts_input"]
            with torch.set_grad_enabled(train and torch.is_grad_enabled()):
                return dict(self.rcnn_net(pts[..., :3].contiguous(),
                                          pts[..., 3:], train, bn_momentum,
                                          generator))
        if train:
            return self._forward_train(input_dict, bn_momentum, generator)
        return self._forward_eval(input_dict)

    def _forward_train(self, input_dict, bn_momentum, generator) -> dict:
        c = self.cfg
        pts = input_dict["pts_input"]
        if c.RPN.FIXED:
            with torch.no_grad():
                output = dict(self.rpn(pts))
        else:
            output = dict(self.rpn(pts, True, bn_momentum, generator))
        if not c.RCNN.ENABLED:
            return output
        # the RCNN's inputs carry no gradient back into the RPN, as in the
        # reference's no_grad blocks
        with torch.no_grad():
            xyz = output["backbone_xyz"]
            scores = output["rpn_cls"][:, :, 0]
            rois, roi_scores_raw, roi_valid = proposal_layer(
                scores, output["rpn_reg"], xyz, c, self.mode)
            extra, seg_mask = rcnn_extra_features(
                c, scores, xyz,
                self.rpn_intensity(input_dict.get("rpn_intensity")))
            pts_feature = torch.cat(
                [extra, output["backbone_features"]], dim=-1)
            target = proposal_target_layer(
                generator, rois, roi_valid, input_dict["gt_boxes3d"], xyz,
                pts_feature, c, aug_data=c.AUG_DATA)
        output.update(target)
        output.update({"rois": rois, "roi_scores_raw": roi_scores_raw,
                       "roi_valid": roi_valid, "seg_result": seg_mask})
        output.update(self.rcnn_net(target["sampled_pts"],
                                    target["pts_feature"], True, bn_momentum,
                                    generator))
        return output

    @torch.no_grad()
    def _forward_eval(self, input_dict: dict) -> dict:
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
            rpn_scores_raw, rois, input_dict.get("rpn_intensity")))
        return output
