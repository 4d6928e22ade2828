"""Eval programs of the port (counterpart of ``tpu3d/tools/eval_rcnn.py``).

The joint eval step (points to final boxes) and the RPN-only one. The
dataset loader, the file output and the recall tables come with later
slices.
"""

from __future__ import annotations

import torch

from ..models.bbox_codec import decode_bbox_target
from ..ops.nms import nms_bev
from ..ops.rotated_iou import boxes3d_to_bev5


def rcnn_decode_and_nms(cfg, rois, rcnn_cls, rcnn_reg, roi_valid,
                        max_final: int = 100) -> dict:
    """The RCNN eval tail: bin decode relative to each roi, the sigmoid
    score threshold, then per scene the rotated BEV NMS, into fixed-size
    final boxes (reference: eval_rcnn.py:311-324 decode, :615-636 NMS).

    rois (B, M, 7), rcnn_cls (B, M) raw, rcnn_reg (B, M, C), roi_valid
    (B, M) -> final_boxes (B, max_final, 7), final_scores (B, max_final)
    raw, final_mask (B, max_final), pred_boxes3d (B, M, 7), norm_scores,
    raw_scores. Slots past the keeps hold the boxes and scores of roi 0,
    with the mask False, as in the JAX package.
    """
    b, m = rois.shape[0], rois.shape[1]
    r = cfg.RCNN
    pred_boxes3d = decode_bbox_target(
        rois.reshape(-1, 7), rcnn_reg.reshape(b * m, -1),
        anchor_size=cfg.CLS_MEAN_SIZE[0], loc_scope=r.LOC_SCOPE,
        loc_bin_size=r.LOC_BIN_SIZE, num_head_bin=r.NUM_HEAD_BIN,
        get_xz_fine=True, get_y_by_bin=r.LOC_Y_BY_BIN,
        loc_y_scope=r.LOC_Y_SCOPE, loc_y_bin_size=r.LOC_Y_BIN_SIZE,
        get_ry_fine=True).reshape(b, m, 7)
    norm_scores = torch.sigmoid(rcnn_cls)
    keep_scores = (norm_scores > r.SCORE_THRESH) & roi_valid
    finals = []
    for boxes, raw, valid in zip(pred_boxes3d, rcnn_cls, keep_scores):
        idx, mask = nms_bev(boxes3d_to_bev5(boxes), raw, r.NMS_THRESH,
                            max_final, valid=valid, rotated=True)
        idx = idx.long()
        finals.append((boxes[idx], raw[idx], mask))
    final_boxes, final_scores, final_mask = (torch.stack(t)
                                             for t in zip(*finals))
    return {"final_boxes": final_boxes, "final_scores": final_scores,
            "final_mask": final_mask, "pred_boxes3d": pred_boxes3d,
            "norm_scores": norm_scores, "raw_scores": rcnn_cls}


def make_infer_step(model, cfg, max_final: int = 100):
    """The twin of tpu3d's ``make_infer_step``: one joint eval forward of a
    ``PointRCNN(mode="TEST")`` with ``RCNN.ENABLED``, then the decode, score
    threshold and rotated NMS.

    Returns ``infer(pts_input)`` -> dict with ``final_boxes``,
    ``final_scores``, ``final_mask``, ``pred_boxes3d``, ``norm_scores``,
    ``raw_scores``, ``rois``, ``roi_scores_raw``, ``roi_valid`` and
    ``seg_result``, on the model's device.
    """
    if not cfg.RCNN.ENABLED:
        raise ValueError("make_infer_step runs the joint path; use "
                         "make_rpn_infer_step when RCNN.ENABLED is False")

    def infer(pts_input: torch.Tensor) -> dict:
        out = model({"pts_input": pts_input})
        rois = out["rois"]
        b, m = rois.shape[0], rois.shape[1]
        result = rcnn_decode_and_nms(
            cfg, rois, out["rcnn_cls"].reshape(b, m),
            out["rcnn_reg"].reshape(b, m, -1), out["roi_valid"], max_final)
        result.update({k: out[k] for k in (
            "rois", "roi_scores_raw", "roi_valid", "seg_result")})
        return result

    return infer


def make_rpn_infer_step(model, cfg):
    """The twin of ``rpn_infer`` in ``eval_one_epoch_rpn``: one RPN-only eval
    forward of a ``PointRCNN(mode="TEST")`` with ``RCNN.ENABLED`` False.

    Returns ``infer(pts_input)`` -> dict with ``rois``, ``roi_scores_raw``,
    ``roi_valid``, ``seg_result``, ``rpn_scores_raw``, ``backbone_xyz`` and
    ``backbone_features``, on the model's device.
    """
    if cfg.RCNN.ENABLED:
        raise ValueError("make_rpn_infer_step runs the RPN-only eval path; "
                         "use make_infer_step when RCNN.ENABLED is True")

    def infer(pts_input: torch.Tensor) -> dict:
        out = model({"pts_input": pts_input})
        out["rpn_scores_raw"] = out["rpn_cls"][:, :, 0]
        return {k: out[k] for k in (
            "rois", "roi_scores_raw", "roi_valid", "seg_result",
            "rpn_scores_raw", "backbone_xyz", "backbone_features")}

    return infer
