"""Eval programs of the port (counterpart of ``tpu3d/tools/eval_rcnn.py``).

This slice ports the RPN-only eval step. The dataset loader, the file
output and the recall tables come with later slices.
"""

from __future__ import annotations

import torch


def make_rpn_infer_step(model, cfg):
    """The twin of ``rpn_infer`` in ``eval_one_epoch_rpn``: one RPN-only eval
    forward of a ``PointRCNN(mode="TEST")`` with ``RCNN.ENABLED`` False.

    Returns ``infer(pts_input)`` -> dict with ``rois``, ``roi_scores_raw``,
    ``roi_valid``, ``seg_result``, ``rpn_scores_raw``, ``backbone_xyz`` and
    ``backbone_features``, on the model's device.
    """
    if cfg.RCNN.ENABLED:
        raise NotImplementedError(
            "make_rpn_infer_step runs the RPN-only eval path; the joint "
            "step comes with the RCNN stage")

    def infer(pts_input: torch.Tensor) -> dict:
        out = model({"pts_input": pts_input})
        out["rpn_scores_raw"] = out["rpn_cls"][:, :, 0]
        return {k: out[k] for k in (
            "rois", "roi_scores_raw", "roi_valid", "seg_result",
            "rpn_scores_raw", "backbone_xyz", "backbone_features")}

    return infer
