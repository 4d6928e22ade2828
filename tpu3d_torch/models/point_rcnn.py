"""PointRCNN in eval mode (counterpart of ``tpu3d/models/point_rcnn.py``).

This slice ports the RPN-only eval branch (``RCNN.ENABLED: False``): the
RPN forward, proposal decode and distance-banded NMS, and the per-point
segmentation mask. The joint branch (ROI pooling and RCNN refinement) is the
next slice of the port.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config.config import as_attrdict
from ..device import resolve_device
from .proposal import proposal_layer
from .rpn import RPN


class PointRCNN(nn.Module):
    """The detector on ``device`` (default ``cuda``; raises without a card
    unless the caller passes ``device="cpu"``)."""

    def __init__(self, cfg, mode: str = "TEST", device=None):
        super().__init__()
        c = as_attrdict(cfg)
        if not c.RPN.ENABLED:
            raise NotImplementedError(
                "RCNN-offline mode (RPN.ENABLED False) comes with the RCNN "
                "stage, the next slice of the port")
        if c.RCNN.ENABLED:
            raise NotImplementedError(
                "the joint PointRCNN branch (ROI pooling + RCNN refinement) "
                "is the next slice of the port; set RCNN.ENABLED False for "
                "the RPN-only eval path")
        if mode == "TRAIN":
            raise NotImplementedError("training is not ported yet")
        self.cfg = c
        self.mode = mode
        self.rpn = RPN(c, device=resolve_device(device))
        self.eval()

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
        output["seg_result"] = torch.sigmoid(rpn_scores_raw) > c.RPN.SCORE_THRESH
        return output
