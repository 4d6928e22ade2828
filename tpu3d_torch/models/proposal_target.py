"""RCNN training targets: ROI sampling, jitter, pooling, augmentation and
canonical labels, in fixed shapes (counterpart of
``tpu3d/models/proposal_target.py``; reference:
lib/rpn/proposal_target_layer.py).

The JAX package's fixed-shape recast is kept: fg/bg sampling by a masked
random ranking into ROI_PER_IMAGE slots, the jitter-until-IoU loop as
ROI_FG_AUG_TIMES candidates made at once with the first above the
threshold taken. The layer is split in two so that it can be held to
tpu3d exactly: ``draw_proposal_target`` draws every random number of one
call from a ``torch.Generator`` (a torch generator cannot give
``jax.random``'s numbers), and ``proposal_target_core`` is deterministic
in those draws. Every random integer is drawn as a uniform u and taken as
floor(u·n), so a test can feed the core the integers of tpu3d's own keys.

ROI pooling runs in f32 (tpu3d's bf16 hi/lo pooled table is a TPU gather
workaround and is not ported).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.box_geometry import rotate_points_along_y
from ..parallel.mesh import draw_rows
from ..ops.roipool import roipool3d
from ..ops.rotated_iou import boxes_iou3d, boxes_iou3d_aligned

# (position, size, angle) jitter ranges of REG_AUG_METHOD "multiple"
# (reference: proposal_target_layer.py:253-258)
JITTER_RANGES = [[0.2, 0.1, np.pi / 12], [0.3, 0.15, np.pi / 12],
                 [0.5, 0.15, np.pi / 9], [0.8, 0.15, np.pi / 6],
                 [1.0, 0.15, np.pi / 3]]


def _randint(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """floor(u·n) in [0, n) for uniforms u in [0, 1) and counts n >= 1."""
    n = n.to(torch.int64)
    k = torch.floor(u * n.to(u.dtype)).to(torch.int64)
    return torch.minimum(k, n - 1)


def draw_proposal_target(generator: torch.Generator | None, batch: int,
                         n_rois: int, cfg, aug_data: bool = True,
                         device=None) -> dict:
    """Every random number of one ``proposal_target_core`` call, drawn from
    ``generator`` on ``device``: uniforms in [0, 1) for the ROI sampler's
    ranking ("perm", (B, M)) and its three integer draws ("fg_fill",
    "hard", "easy", (B, R)); with jitter, per candidate the keep draw
    ("keep", (B, R, T)) and the jitter's own ("range" (B, R, T) and
    "jitter" (B, R, T, 7), or for REG_AUG_METHOD "normal" "jitter_normal"
    (B, R, T, 6) normals and "jitter" (B, R, T, 1)); with the augmentation,
    "rot", "scale" and "flip" (B, R). Under a data-parallel mesh each is
    this rank's B rows of the global batch's draw, drawn whole on every
    rank."""
    c = cfg.RCNN
    R, T = int(c.ROI_PER_IMAGE), int(c.ROI_FG_AUG_TIMES)

    def u(*shape):
        return draw_rows(lambda s: torch.rand(s, generator=generator,
                                              device=device), shape)

    draws = {"perm": u(batch, n_rois), "fg_fill": u(batch, R),
             "hard": u(batch, R), "easy": u(batch, R)}
    if T > 0:
        draws["keep"] = u(batch, R, T)
        if c.REG_AUG_METHOD == "normal":
            draws["jitter_normal"] = draw_rows(lambda s: torch.randn(
                s, generator=generator, device=device), (batch, R, T, 6))
            draws["jitter"] = u(batch, R, T, 1)
        else:
            draws["range"] = u(batch, R, T)
            draws["jitter"] = u(batch, R, T, 7)
    if aug_data:
        for name in ("rot", "scale", "flip"):
            draws[name] = u(batch, R)
    return draws


def sample_roi_indices(max_overlaps, valid_roi, rcnn_cfg, perm_u, fill_u,
                       hard_u, easy_u):
    """Fixed-size fg / easy-bg / hard-bg sampling of one image's ROIs
    (tpu3d's ``_sample_roi_indices``; reference: sample_rois_for_rcnn and
    sample_bg_inds, proposal_target_layer.py:89-211). max_overlaps and
    valid_roi (M,), perm_u (M,) and fill_u, hard_u, easy_u (R,) uniforms ->
    (roi_idx (R,) int64, is_fg (R,) bool)."""
    R = int(rcnn_cfg.ROI_PER_IMAGE)
    fg_per_image = int(np.round(rcnn_cfg.FG_RATIO * R))
    fg_thresh = min(rcnn_cfg.REG_FG_THRESH, rcnn_cfg.CLS_FG_THRESH)
    m = max_overlaps.shape[0]
    fg_mask = (max_overlaps >= fg_thresh) & valid_roi
    easy_mask = (max_overlaps < rcnn_cfg.CLS_BG_THRESH_LO) & valid_roi
    hard_mask = ((max_overlaps >= rcnn_cfg.CLS_BG_THRESH_LO)
                 & (max_overlaps < rcnn_cfg.CLS_BG_THRESH) & valid_roi)
    fg_num, easy_num, hard_num = (x.sum() for x in
                                  (fg_mask, easy_mask, hard_mask))
    bg_num = easy_num + hard_num

    # a random permutation within each pool: rank by the uniform, masked
    def order(mask):
        return torch.argsort(torch.where(mask, perm_u, 2.0), stable=True)

    fg_order, hard_order, easy_order = (order(x) for x in
                                        (fg_mask, hard_mask, easy_mask))
    # fg slots: fg and bg -> min(fg_per_image, fg); fg only -> all R from
    # fg (with replacement); no fg -> 0
    fg_take = torch.where(fg_num > 0,
                          torch.where(bg_num > 0,
                                      torch.clamp(fg_num, max=fg_per_image),
                                      R), 0)
    bg_take = R - fg_take
    slots = torch.arange(R, device=max_overlaps.device)
    fg_fill = _randint(fill_u, torch.clamp(fg_num, min=1))
    fg_pos = torch.where(slots < fg_num, slots, fg_fill)
    fg_idx = fg_order[torch.clamp(fg_pos, 0, m - 1)]
    # bg slots: HARD_BG_RATIO of them from the hard pool (with
    # replacement), the rest from the easy pool; whichever pool is
    # non-empty when the other is
    hard_cnt = torch.where(
        (hard_num > 0) & (easy_num > 0),
        (bg_take.to(torch.float32) * rcnn_cfg.HARD_BG_RATIO).to(torch.int64),
        torch.where(hard_num > 0, bg_take, 0))
    hard_pick = hard_order[_randint(hard_u, torch.clamp(hard_num, min=1))]
    easy_pick = easy_order[_randint(easy_u, torch.clamp(easy_num, min=1))]
    bg_idx = torch.where(slots < hard_cnt, hard_pick, easy_pick)
    is_fg = slots < fg_take
    roi_idx = torch.where(is_fg, fg_idx,
                          bg_idx[torch.clamp(slots - fg_take, 0, R - 1)])
    return roi_idx, is_fg


def jitter_boxes(rois, method: str, jitter, range_u=None, normal=None):
    """The jittered boxes of tpu3d's ``_random_aug_box3d`` (reference:
    proposal_target_layer.py:242-283), one per candidate: rois (..., 7)
    with draws of shape (..., 7) uniforms (and (...,) range uniforms for
    "multiple"), or (..., 1) uniforms and (..., 6) normals for "normal"."""
    if method == "normal":
        scale = rois.new_tensor([0.3, 0.2, 0.3, 0.25, 0.15, 0.5])
        ry_shift = ((jitter - 0.5) / 0.5) * np.pi / 12
        return torch.cat([rois[..., 0:6] + normal * scale,
                          rois[..., 6:7] + ry_shift], dim=-1)
    if method == "single":
        pos_shift = jitter[..., 0:3] - 0.5
        hwl_scale = (jitter[..., 3:6] - 0.5) / (0.5 / 0.15) + 1.0
        angle_rot = (jitter[..., 6:7] - 0.5) / (0.5 / (np.pi / 12))
    elif method == "multiple":
        ranges = rois.new_tensor(JITTER_RANGES)
        row = ranges[_randint(range_u, torch.tensor(
            len(JITTER_RANGES), device=range_u.device))]
        pos_shift = ((jitter[..., 0:3] - 0.5) / 0.5) * row[..., 0:1]
        hwl_scale = ((jitter[..., 3:6] - 0.5) / 0.5) * row[..., 1:2] + 1.0
        angle_rot = ((jitter[..., 6:7] - 0.5) / 0.5) * row[..., 2:3]
    else:
        raise NotImplementedError(method)
    return torch.cat([rois[..., 0:3] + pos_shift, rois[..., 3:6] * hwl_scale,
                      rois[..., 6:7] + angle_rot], dim=-1)


def aug_rois_by_noise(rois, gts, iou_src, pos_thresh: float, method: str,
                      keep_u, jitter, range_u=None, normal=None):
    """tpu3d's parallel recast of aug_roi_by_noise (reference:
    proposal_target_layer.py:213-240): T candidates per ROI, each the ROI
    itself when its keep draw is below 0.2, else jittered; the first whose
    3D IoU with its gt reaches ``pos_thresh`` is taken, else the last.
    rois, gts (K, 7), iou_src (K,), keep_u (K, T) and the jitter draws of
    ``jitter_boxes`` with a T axis -> (boxes (K, 7), iou (K,)); the IoU of
    a kept original stays ``iou_src``, as in the reference."""
    K, T = keep_u.shape
    src = rois[:, None, :].expand(K, T, 7)
    keep = keep_u < 0.2
    cands = torch.where(keep[..., None], src,
                        jitter_boxes(src, method, jitter, range_u, normal))
    ious = boxes_iou3d_aligned(cands, gts[:, None, :].expand(K, T, 7))
    ok = ious >= pos_thresh
    sel = torch.where(ok.any(dim=1), ok.to(torch.int32).argmax(dim=1), T - 1)
    rows = torch.arange(K, device=rois.device)
    out_iou = torch.where(keep[rows, sel], iou_src, ious[rows, sel])
    return cands[rows, sel], out_iou


def roi_data_augmentation(pts, rois, gt_of_rois, aug_rot_range: float,
                          rot_u, scale_u, flip_u):
    """Per-ROI rotation, scaling and flip (tpu3d's
    ``_roi_data_augmentation``; reference: proposal_target_layer.py:285-341).
    pts (..., K, P, 3), rois and gt_of_rois (..., K, 7), uniforms (..., K)
    -> (pts, rois, gt_of_rois). The reference's angle quirk is kept:
    (U − 0.5/0.5)·π/range, i.e. U(−1, 0)·π/range."""
    angles = (rot_u - 0.5 / 0.5) * (np.pi / aug_rot_range)

    def beta_of(boxes):
        return torch.atan2(boxes[..., 2], boxes[..., 0])

    def alpha_of(boxes):
        beta = beta_of(boxes)
        return -torch.sign(beta) * np.pi / 2 + beta + boxes[..., 6]

    gt_alpha, roi_alpha = alpha_of(gt_of_rois), alpha_of(rois)
    pts = rotate_points_along_y(pts, angles[..., None])
    gt_of_rois = rotate_points_along_y(gt_of_rois, angles)
    rois = rotate_points_along_y(rois, angles)

    def with_ry(boxes, alpha):
        beta = beta_of(boxes)
        ry = torch.sign(beta) * np.pi / 2 + alpha - beta
        return torch.cat([boxes[..., :6], ry[..., None]], dim=-1)

    gt_of_rois, rois = with_ry(gt_of_rois, gt_alpha), with_ry(rois, roi_alpha)

    scales = 1 + ((scale_u - 0.5) / 0.5) * 0.05
    pts = pts * scales[..., None, None]

    def scaled(boxes):
        return torch.cat([boxes[..., :6] * scales[..., None],
                          boxes[..., 6:]], dim=-1)

    gt_of_rois, rois = scaled(gt_of_rois), scaled(rois)

    # flip along x; ry -> sign(ry)·π − ry
    flip = torch.sign(flip_u - 0.5)
    pts = torch.cat([pts[..., 0:1] * flip[..., None, None], pts[..., 1:]],
                    dim=-1)

    def flipped(boxes):
        ry = boxes[..., 6]
        ry = torch.where(flip == 1, ry, torch.sign(ry) * np.pi - ry)
        return torch.cat([boxes[..., 0:1] * flip[..., None], boxes[..., 1:6],
                          ry[..., None]], dim=-1)

    return pts, flipped(rois), flipped(gt_of_rois)


def canonicalize_rcnn_targets(sampled_pts, batch_rois, batch_gt_of_rois,
                              batch_roi_iou, empty_flag, rcnn_cfg):
    """Canonical transform and cls/reg label masks, the deterministic tail
    of the layer (tpu3d's ``canonicalize_rcnn_targets``; reference:
    proposal_target_layer.py:45-66). Shapes (B, R, K, 3) / (B, R, 7) /
    (B, R) -> (canonical pts, canonical gt_of_rois, cls_label int32,
    reg_valid_mask int32)."""
    roi_ry = torch.remainder(batch_rois[..., 6], 2 * np.pi)
    roi_center = batch_rois[..., 0:3]
    sampled_pts = sampled_pts - roi_center[:, :, None, :]
    gt = torch.cat([batch_gt_of_rois[..., 0:3] - roi_center,
                    batch_gt_of_rois[..., 3:6],
                    (batch_gt_of_rois[..., 6] - roi_ry)[..., None]], dim=-1)
    sampled_pts = rotate_points_along_y(sampled_pts,
                                        batch_rois[..., 6][..., None])
    gt = rotate_points_along_y(gt, roi_ry)

    valid_mask = ~empty_flag
    reg_valid_mask = ((batch_roi_iou > rcnn_cfg.REG_FG_THRESH)
                      & valid_mask).to(torch.int32)
    cls_label = (batch_roi_iou > rcnn_cfg.CLS_FG_THRESH).to(torch.int32)
    invalid = ((batch_roi_iou > rcnn_cfg.CLS_BG_THRESH)
               & (batch_roi_iou < rcnn_cfg.CLS_FG_THRESH))
    cls_label = torch.where(valid_mask, cls_label, -1)
    cls_label = torch.where(invalid, -1, cls_label).to(torch.int32)
    return sampled_pts, gt, cls_label, reg_valid_mask


def proposal_target_core(draws: dict, roi_boxes3d, roi_valid, gt_boxes3d,
                         rpn_xyz, pts_feature, cfg,
                         aug_data: bool = True) -> dict:
    """The layer on given draws (``draw_proposal_target``'s keys).

    :param roi_boxes3d: (B, M, 7) proposals, roi_valid (B, M)
    :param gt_boxes3d: (B, G, 7) zero-padded gt boxes
    :param rpn_xyz: (B, N, 3), pts_feature (B, N, C) the extra and
        backbone features, already joined
    :return: dict of fixed-shape tensors over B·R rows: sampled_pts
        (B·R, K, 3), pts_feature (B·R, K, C), cls_label (B·R,),
        reg_valid_mask (B·R,), gt_of_rois (B·R, 7), gt_iou (B·R,),
        roi_boxes3d (B·R, 7)
    """
    c = cfg.RCNN
    fg_thresh = min(c.REG_FG_THRESH, c.CLS_FG_THRESH)
    sampled = []
    for b in range(roi_boxes3d.shape[0]):
        rois, valid, gts = roi_boxes3d[b], roi_valid[b], gt_boxes3d[b]
        gt_valid = gts.abs().sum(dim=1) > 0  # zero rows are padding
        iou3d = torch.where(gt_valid[None, :], boxes_iou3d(rois, gts), -1.0)
        max_overlaps, gt_assignment = iou3d.max(dim=1)
        max_overlaps = torch.where(valid, max_overlaps.clamp(min=0.0), 0.0)
        roi_idx, _ = sample_roi_indices(
            max_overlaps, valid, c, draws["perm"][b], draws["fg_fill"][b],
            draws["hard"][b], draws["easy"][b])
        sampled.append((rois[roi_idx], gts[gt_assignment[roi_idx]],
                        max_overlaps[roi_idx]))
    batch_rois, batch_gts, batch_iou = (torch.stack(t) for t in
                                        zip(*sampled))
    B, R = batch_rois.shape[:2]
    if int(c.ROI_FG_AUG_TIMES) > 0:
        flat = {k: draws[k].reshape(B * R, *draws[k].shape[2:])
                for k in ("keep", "jitter", "range", "jitter_normal")
                if k in draws}
        rois, iou = aug_rois_by_noise(
            batch_rois.reshape(-1, 7), batch_gts.reshape(-1, 7),
            batch_iou.reshape(-1), fg_thresh, c.REG_AUG_METHOD, flat["keep"],
            flat["jitter"], flat.get("range"), flat.get("jitter_normal"))
        batch_rois, batch_iou = rois.reshape(B, R, 7), iou.reshape(B, R)

    sampled_pts, sampled_feats, empty_flag = roipool3d(
        rpn_xyz, pts_feature, batch_rois, float(c.POOL_EXTRA_WIDTH),
        int(c.NUM_POINTS))
    if aug_data:
        sampled_pts, batch_rois, batch_gts = roi_data_augmentation(
            sampled_pts, batch_rois, batch_gts, float(cfg.AUG_ROT_RANGE),
            draws["rot"], draws["scale"], draws["flip"])
    sampled_pts, batch_gts, cls_label, reg_valid_mask = \
        canonicalize_rcnn_targets(sampled_pts, batch_rois, batch_gts,
                                  batch_iou, empty_flag, c)
    K = int(c.NUM_POINTS)
    return {
        "sampled_pts": sampled_pts.reshape(-1, K, 3),
        "pts_feature": sampled_feats.reshape(-1, K, sampled_feats.shape[-1]),
        "cls_label": cls_label.reshape(-1),
        "reg_valid_mask": reg_valid_mask.reshape(-1),
        "gt_of_rois": batch_gts.reshape(-1, 7),
        "gt_iou": batch_iou.reshape(-1),
        "roi_boxes3d": batch_rois.reshape(-1, 7),
    }


def proposal_target_layer(generator: torch.Generator | None, roi_boxes3d,
                          roi_valid, gt_boxes3d, rpn_xyz, pts_feature, cfg,
                          aug_data: bool = True) -> dict:
    """Sample ROIs, pool their points and build canonical-frame RCNN
    targets, with every random number drawn from ``generator`` (on the
    tensors' device). See ``proposal_target_core`` for the shapes."""
    draws = draw_proposal_target(generator, roi_boxes3d.shape[0],
                                 roi_boxes3d.shape[1], cfg, aug_data,
                                 roi_boxes3d.device)
    return proposal_target_core(draws, roi_boxes3d, roi_valid, gt_boxes3d,
                                rpn_xyz, pts_feature, cfg, aug_data)
