"""RPN proposal generation: bin decode + distance-banded NMS, fixed shapes
(counterpart of ``tpu3d/models/proposal.py``; reference:
lib/rpn/proposal_layer.py).

Every selection returns padded indices plus a validity mask, as in the JAX
package, so the outputs have the same fixed shapes there and here. The
per-image loop stands in for ``jax.vmap``.
"""

from __future__ import annotations

import torch

from ..ops.nms import nms_blocked_sorted
from .bbox_codec import decode_bbox_target


def _take_top(valid: torch.Tensor, k: int):
    """First-k selection by rank over sorted-order candidates: ((k,)
    positions into the sorted arrays, (k,) validity mask). Slot k of the
    scatter targets takes the candidates past the first k and is dropped."""
    n = valid.shape[0]
    r = torch.cumsum(valid.to(torch.int64), 0) - 1
    pos = torch.where(valid & (r < k), r, k)
    idx = torch.zeros(k + 1, dtype=torch.int64, device=valid.device)
    idx.scatter_(0, pos, torch.arange(n, device=valid.device))
    mask = torch.zeros(k + 1, dtype=torch.bool, device=valid.device)
    mask.scatter_(0, pos, torch.ones_like(valid))
    return idx[:k], mask[:k]


def _band_nms(boxes7, scores, cand_mask, pre_k, post_k, nms_thresh, rotated):
    """Top-pre_k candidates (already score-sorted) -> NMS -> top post_k."""
    sel_idx, sel_mask = _take_top(cand_mask, pre_k)
    cand_boxes = boxes7[sel_idx]
    cand_scores = scores[sel_idx]
    # BEV5 [xc, zc, l, w, ry]
    bev = cand_boxes[:, [0, 2, 5, 4, 6]]
    keep_idx, keep_mask = nms_blocked_sorted(bev, sel_mask, nms_thresh,
                                             post_k, rotated=rotated)
    keep_idx = keep_idx.long()
    out_boxes = torch.where(keep_mask[:, None], cand_boxes[keep_idx], 0.0)
    out_scores = torch.where(keep_mask, cand_scores[keep_idx], 0.0)
    return out_boxes, out_scores, keep_mask


def _sort_by_score(scores, proposals):
    order = torch.argsort(-scores, stable=True)
    return scores[order], proposals[order]


def distance_based_proposal(scores, proposals, mode_cfg, nms_type: str):
    """Single-image distance-banded proposal (reference:
    proposal_layer.py:58-119): 70% of the pre/post-NMS budgets to 0-40 m,
    30% to 40-80 m; an empty far band falls back to the near candidates
    ranked past the near band's pre budget. scores (N,), proposals (N, 7).

    Returns ((post_N, 7) boxes, (post_N,) scores, (post_N,) valid mask).
    """
    pre_tot = int(mode_cfg.RPN_PRE_NMS_TOP_N)
    post_tot = int(mode_cfg.RPN_POST_NMS_TOP_N)
    pre_ks = [int(pre_tot * 0.7), pre_tot - int(pre_tot * 0.7)]
    post_ks = [int(post_tot * 0.7), post_tot - int(post_tot * 0.7)]
    thresh = float(mode_cfg.RPN_NMS_THRESH)
    rotated = nms_type == "rotate"

    s_sorted, p_sorted = _sort_by_score(scores, proposals)
    dist = p_sorted[:, 2]
    near = (dist > 0.0) & (dist <= 40.0)
    far = (dist > 40.0) & (dist <= 80.0)

    near_boxes, near_scores, near_mask = _band_nms(
        p_sorted, s_sorted, near, pre_ks[0], post_ks[0], thresh, rotated)

    near_rank = torch.cumsum(near.to(torch.int64), 0) - 1
    fallback = near & (near_rank >= pre_ks[0])
    far_cand = torch.where(far.any(), far, fallback)
    far_boxes, far_scores, far_mask = _band_nms(
        p_sorted, s_sorted, far_cand, pre_ks[1], post_ks[1], thresh, rotated)

    return (torch.cat([near_boxes, far_boxes]),
            torch.cat([near_scores, far_scores]),
            torch.cat([near_mask, far_mask]))


def score_based_proposal(scores, proposals, mode_cfg, nms_type: str):
    """Plain top-K + NMS proposal (reference: proposal_layer.py:121-142).
    The reference, and the JAX package, always take rotated NMS here."""
    s_sorted, p_sorted = _sort_by_score(scores, proposals)
    valid = torch.ones_like(s_sorted, dtype=torch.bool)
    return _band_nms(p_sorted, s_sorted, valid,
                     int(mode_cfg.RPN_PRE_NMS_TOP_N),
                     int(mode_cfg.RPN_POST_NMS_TOP_N),
                     float(mode_cfg.RPN_NMS_THRESH), rotated=True)


def proposal_layer(rpn_scores, rpn_reg, xyz, cfg, mode: str):
    """Batched proposal generation (reference: proposal_layer.py:15-56).

    :param rpn_scores: (B, N) raw logits
    :param rpn_reg: (B, N, C)
    :param xyz: (B, N, 3) backbone points
    :return: (rois (B, M, 7), roi_scores_raw (B, M), roi_valid (B, M))
    """
    B, N = rpn_scores.shape
    proposals = decode_bbox_target(
        xyz.reshape(-1, 3), rpn_reg.reshape(B * N, -1),
        loc_scope=cfg.RPN.LOC_SCOPE, loc_bin_size=cfg.RPN.LOC_BIN_SIZE,
        num_head_bin=cfg.RPN.NUM_HEAD_BIN, anchor_size=cfg.CLS_MEAN_SIZE[0],
        get_xz_fine=cfg.RPN.LOC_XZ_FINE, get_y_by_bin=False,
        get_ry_fine=False)
    # y to the box bottom (reference: proposal_layer.py:33)
    proposals[:, 1] += proposals[:, 3] / 2
    proposals = proposals.reshape(B, N, 7)

    mode_cfg = cfg[mode]
    # reference quirk: the distance-based switch reads cfg.TEST even in TRAIN
    # mode (proposal_layer.py:46)
    fn = (distance_based_proposal if cfg.TEST.RPN_DISTANCE_BASED_PROPOSE
          else score_based_proposal)
    per_image = [fn(rpn_scores[b], proposals[b], mode_cfg, cfg.RPN.NMS_TYPE)
                 for b in range(B)]
    rois, roi_scores, roi_valid = (torch.stack(t) for t in zip(*per_image))
    return rois, roi_scores, roi_valid
