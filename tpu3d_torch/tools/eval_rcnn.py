"""Inference/eval CLI for PointRCNN — KITTI-format detections + recall
metrics (counterpart of ``tpu3d/tools/eval_rcnn.py``).

Reference parity: pointrcnn/tools/eval_rcnn.py (eval_one_epoch_joint / _rpn
/ _rcnn): the same output layout (final_result/data/*.txt incl. empty files
for undetected frames, reference :638-649), the same decode -> sigmoid
score thresh -> per-scene rotated NMS -> save_kitti_format pipeline (corner
projection, >80%-of-image box drop, alpha from beta + ry; reference
:76-101), the same recall@{0.1..0.9} tables, and the RPN mode's dumps
(``features/%06d{,_xyz,_seg,_intensity,_rawscore}.npy``, ``seg_result/``,
``detections/data/``) that RCNN-offline training and eval read, in tpu3d's
names and layouts, so each package reads the other's.

    python -m tpu3d_torch.tools.eval_rcnn --cfg_file configs/default.yaml \\
        --eval_mode joint --data_root <root> --ckpt <file> [--save_result]

Modes: ``joint`` and ``rcnn`` (the two-stage forward; ``rcnn`` with
``RPN.FIXED``), ``rpn`` (the RPN alone, with ``--save_rpn_feature`` its
dumps) and ``rcnn_offline`` (the RCNN on saved proposals and dumped
features). It runs on the card unless ``--device cpu`` is given; with no
card and no ``--device cpu`` it raises. Batches come through
``BatchLoader`` (no shuffle) and ``device_prefetch``; the weights from a
tpu3d-format checkpoint (``utils/checkpoint.load_checkpoint``).

Under ``torchrun`` (or in a process whose default process group is already
initialised) it runs over tpu3d's data-parallel mesh (``make_mesh`` at
``--batch_size``, tpu3d: tools/eval_rcnn.py:210, :302, :397): each rank
loads and runs the forward on its rows of every batch, and rank 0
gathers every rank's outputs, with the host fields it writes with, and
writes every label file, dump and recall table as one process would; the other ranks write and log nothing,
and ``main`` returns the results on rank 0 (None elsewhere).
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import cfg_from_file, cfg_from_list, fresh_cfg
from ..datasets import (BatchLoader, KittiRCNNDataset, create_synthetic_kitti,
                        device_prefetch)
from ..device import resolve_device
from ..kitti.boxes import corners_from_boxes3d
from ..models import PointRCNN
from ..models.bbox_codec import decode_bbox_target
from ..ops.nms import nms_bev
from ..ops.rotated_iou import boxes3d_to_bev5, boxes_iou3d
from ..parallel import create_train_state, init_distributed, make_mesh
from ..parallel.mesh import lead
from ..precision import Precision, resolve
from ..utils.checkpoint import latest_checkpoint, load_checkpoint
from ..utils.logging import create_logger, null_logger
from ..weights import seeded_state_dict
from .train_rcnn import configure_mode

THRESH_LIST = (0.1, 0.3, 0.5, 0.7, 0.9)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="evaluate PointRCNN (gpu)")
    parser.add_argument("--cfg_file", type=str, default=None)
    parser.add_argument("--eval_mode", type=str, default="rcnn",
                        choices=["rpn", "rcnn", "joint", "rcnn_offline"])
    parser.add_argument("--rcnn_eval_roi_dir", type=str, default=None,
                        help="saved RPN proposals (KITTI label files) for "
                             "rcnn_offline evaluation")
    parser.add_argument("--rcnn_eval_feature_dir", type=str, default=None,
                        help="dumped RPN backbone features for rcnn_offline "
                             "evaluation")
    parser.add_argument("--data_root", type=str, default=None)
    parser.add_argument("--dataset", type=str, default="kitti")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--ckpt_dir", type=str, default=None)
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--test", action="store_true",
                        help="TEST split (no labels)")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--seed", type=int, default=666)
    parser.add_argument("--save_rpn_feature", action="store_true",
                        help="dump per-scene backbone features/xyz/seg for "
                             "offline RCNN training")
    parser.add_argument("--save_result", action="store_true")
    parser.add_argument("--eval_all", action="store_true",
                        help="daemon: repeatedly evaluate new checkpoints in "
                             "--ckpt_dir (reference repeat_eval_ckpt)")
    parser.add_argument("--wait_seconds", type=int, default=30)
    parser.add_argument("--max_waitmins", type=int, default=30)
    parser.add_argument("--device", type=str, default="cuda",
                        help="where to evaluate: cuda (default) or cpu")
    parser.add_argument("--set", dest="set_cfgs", default=None,
                        nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def save_kitti_format(sample_id, calib, bbox3d, kitti_output_dir, scores,
                      img_shape, classes="Car"):
    """Write one frame's detections (reference: eval_rcnn.py:76-101)."""
    if len(bbox3d) == 0:
        with open(os.path.join(kitti_output_dir, "%06d.txt" % sample_id), "w"):
            pass
        return 0
    corners3d = corners_from_boxes3d(bbox3d)
    img_boxes, _ = calib.corners3d_to_img_boxes(corners3d)
    img_boxes[:, 0] = np.clip(img_boxes[:, 0], 0, img_shape[1] - 1)
    img_boxes[:, 1] = np.clip(img_boxes[:, 1], 0, img_shape[0] - 1)
    img_boxes[:, 2] = np.clip(img_boxes[:, 2], 0, img_shape[1] - 1)
    img_boxes[:, 3] = np.clip(img_boxes[:, 3], 0, img_shape[0] - 1)
    w = img_boxes[:, 2] - img_boxes[:, 0]
    h = img_boxes[:, 3] - img_boxes[:, 1]
    valid = (w < img_shape[1] * 0.8) & (h < img_shape[0] * 0.8)

    n = 0
    with open(os.path.join(kitti_output_dir, "%06d.txt" % sample_id), "w") as f:
        for k in range(bbox3d.shape[0]):
            if not valid[k]:
                continue
            x, z, ry = bbox3d[k, 0], bbox3d[k, 2], bbox3d[k, 6]
            beta = np.arctan2(z, x)
            alpha = -np.sign(beta) * np.pi / 2 + beta + ry
            print("%s -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f "
                  "%.4f %.4f %.4f"
                  % (classes, alpha, img_boxes[k, 0], img_boxes[k, 1],
                     img_boxes[k, 2], img_boxes[k, 3], bbox3d[k, 3],
                     bbox3d[k, 4], bbox3d[k, 5], bbox3d[k, 0], bbox3d[k, 1],
                     bbox3d[k, 2], bbox3d[k, 6], scores[k]), file=f)
            n += 1
    return n


def rcnn_decode_and_nms(cfg, rois, rcnn_cls, rcnn_reg, roi_valid,
                        roi_size=None, max_final: int = 100) -> dict:
    """The RCNN eval tail: bin decode relative to each roi, the sigmoid
    score threshold, then per scene the rotated BEV NMS, into fixed-size
    final boxes (reference: eval_rcnn.py:311-324 decode, :615-636 NMS).

    rois (B, M, 7), rcnn_cls (B, M) raw, rcnn_reg (B, M, C), roi_valid
    (B, M), roi_size (B, M, 3) or None -> final_boxes (B, max_final, 7),
    final_scores (B, max_final) raw, final_mask (B, max_final),
    pred_boxes3d (B, M, 7), norm_scores, raw_scores. The size anchor is
    each roi's size with ``RCNN.SIZE_RES_ON_ROI`` and a ``roi_size``, else
    ``CLS_MEAN_SIZE[0]``. Slots past the keeps hold the boxes and scores of
    roi 0, with the mask False, as in the JAX package.
    """
    b, m = rois.shape[0], rois.shape[1]
    r = cfg.RCNN
    anchor = (roi_size.reshape(-1, 3) if (r.SIZE_RES_ON_ROI
                                          and roi_size is not None)
              else cfg.CLS_MEAN_SIZE[0])
    pred_boxes3d = decode_bbox_target(
        rois.reshape(-1, 7), rcnn_reg.reshape(b * m, -1),
        anchor_size=anchor, loc_scope=r.LOC_SCOPE,
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


def _precision(model, cfg, precision: Precision | None) -> Precision:
    """The eval numerics contract of an infer step: ``precision`` where the
    caller gives one, else resolved once from the model's device, the
    config's ``BF16_INFERENCE`` and ``TPU3D_F32_EVAL``."""
    if precision is not None:
        return precision
    return resolve(next(model.parameters()).device, cfg)


def make_infer_step(model, cfg, max_final: int = 100,
                    precision: Precision | None = None):
    """The twin of tpu3d's ``make_infer_step``: one joint eval forward of a
    ``PointRCNN(mode="TEST")`` with ``RCNN.ENABLED``, then the decode, score
    threshold and rotated NMS (f32, as in tpu3d), under the eval numerics
    contract ``precision`` (default: ``precision.resolve``'s for the
    model's device: tpu3d's accelerator contract on the card, f32 on the
    CPU).

    Returns ``infer(pts_input, rpn_intensity=None)`` -> dict with
    ``final_boxes``, ``final_scores``, ``final_mask``, ``pred_boxes3d``,
    ``norm_scores``, ``raw_scores``, ``rois``, ``roi_scores_raw``,
    ``roi_valid`` and ``seg_result``, on the model's device;
    ``rpn_intensity`` (B, N) goes to a model built with
    ``intensity_input``.
    """
    if not cfg.RCNN.ENABLED:
        raise ValueError("make_infer_step runs the joint path; use "
                         "make_rpn_infer_step when RCNN.ENABLED is False")
    prec = _precision(model, cfg, precision)

    def infer(pts_input: torch.Tensor,
              rpn_intensity: torch.Tensor | None = None) -> dict:
        inputs = {"pts_input": pts_input}
        if rpn_intensity is not None:
            inputs["rpn_intensity"] = rpn_intensity
        out = model(inputs, precision=prec)
        rois = out["rois"]
        b, m = rois.shape[0], rois.shape[1]
        result = rcnn_decode_and_nms(
            cfg, rois, out["rcnn_cls"].reshape(b, m),
            out["rcnn_reg"].reshape(b, m, -1), out["roi_valid"],
            max_final=max_final)
        result.update({k: out[k] for k in (
            "rois", "roi_scores_raw", "roi_valid", "seg_result")})
        return result

    return infer


def make_rpn_infer_step(model, cfg, precision: Precision | None = None):
    """The twin of ``rpn_infer`` in ``eval_one_epoch_rpn``: one RPN-only eval
    forward of a ``PointRCNN(mode="TEST")`` with ``RCNN.ENABLED`` False,
    under the eval numerics contract ``precision`` (as
    ``make_infer_step``).

    Returns ``infer(pts_input)`` -> dict with ``rois``, ``roi_scores_raw``,
    ``roi_valid``, ``seg_result``, ``rpn_scores_raw``, ``backbone_xyz`` and
    ``backbone_features``, on the model's device.
    """
    if cfg.RCNN.ENABLED:
        raise ValueError("make_rpn_infer_step runs the RPN-only eval path; "
                         "use make_infer_step when RCNN.ENABLED is True")
    prec = _precision(model, cfg, precision)

    def infer(pts_input: torch.Tensor) -> dict:
        out = model({"pts_input": pts_input}, precision=prec)
        out["rpn_scores_raw"] = out["rpn_cls"][:, :, 0]
        return {k: out[k] for k in (
            "rois", "roi_scores_raw", "roi_valid", "seg_result",
            "rpn_scores_raw", "backbone_xyz", "backbone_features")}

    return infer


def make_offline_infer_step(model, cfg, max_final: int = 100,
                            precision: Precision | None = None):
    """rcnn_offline eval (tpu3d's ``make_offline_infer_step``): the RCNN on
    the loader's pooled canonical points, its rois from the saved proposal
    files (reference: eval_rcnn.py:263-460 eval_one_epoch_rcnn), under the
    eval numerics contract ``precision`` (as ``make_infer_step``).

    Returns ``infer(pts_input (B, M, K, C), roi_boxes3d (B, M, 7),
    roi_valid (B, M), roi_size (B, M, 3))`` -> ``rcnn_decode_and_nms``'s
    dict, on the model's device."""
    prec = _precision(model, cfg, precision)

    def infer(pts_input, roi_boxes3d, roi_valid, roi_size) -> dict:
        b, m, k, c = pts_input.shape
        out = model({"pts_input": pts_input.reshape(-1, k, c)},
                    precision=prec)
        return rcnn_decode_and_nms(
            cfg, roi_boxes3d, out["rcnn_cls"].reshape(b, m),
            out["rcnn_reg"].reshape(b, m, -1), roi_valid, roi_size=roi_size,
            max_final=max_final)

    return infer


def _recall_counts(pred_boxes, gt_boxes, device, thresh_list=THRESH_LIST):
    """gt recall at IoU thresholds (reference: eval_rcnn.py:545-560): the 3D
    IoU in float32 on ``device``."""
    if len(gt_boxes) == 0:
        return np.zeros(len(thresh_list), np.int64), 0
    if len(pred_boxes) == 0:
        return np.zeros(len(thresh_list), np.int64), len(gt_boxes)
    iou = boxes_iou3d(
        torch.as_tensor(np.asarray(pred_boxes, np.float32), device=device),
        torch.as_tensor(np.asarray(gt_boxes, np.float32), device=device))
    gt_max = iou.amax(dim=0).cpu().numpy()
    return np.array([(gt_max > t).sum() for t in thresh_list]), len(gt_boxes)


def save_rpn_features(out, batch, k, features_dir, sample_id):
    """Dump backbone features for offline RCNN training (reference:
    eval_rcnn.py:104-117 save_rpn_features: %06d{,_xyz,_seg,_intensity,
    _rawscore}.npy; features (N, C))."""
    np.save(os.path.join(features_dir, "%06d.npy" % sample_id),
            out["backbone_features"][k])
    np.save(os.path.join(features_dir, "%06d_xyz.npy" % sample_id),
            out["backbone_xyz"][k])
    np.save(os.path.join(features_dir, "%06d_seg.npy" % sample_id),
            out["seg_result"][k])
    np.save(os.path.join(features_dir, "%06d_intensity.npy" % sample_id),
            batch["pts_features"][k][:, 0])
    np.save(os.path.join(features_dir, "%06d_rawscore.npy" % sample_id),
            out["rpn_scores_raw"][k])


def _batches(loader, keys, device):
    """Each loader batch (over a mesh, this rank's rows of it) on the host
    beside its ``keys`` staged onto ``device`` by ``device_prefetch``:
    yields (host batch, device batch)."""
    host = collections.deque()

    def tap():
        for batch in loader:
            host.append(batch)
            yield {k: batch[k] for k in keys if k in batch}

    for staged in device_prefetch(tap(), size=2, keys=keys, device=device):
        yield host.popleft(), staged


def _spread(mesh) -> bool:
    """Whether the eval runs over several ranks."""
    return mesh is not None and mesh.size > 1


def _writes(mesh) -> bool:
    """Whether this rank writes the eval's files: one process, or rank 0
    of the mesh."""
    return not _spread(mesh) or mesh.index == 0


def _to_host(out: dict, batch: dict, keep, mesh=None):
    """The outputs on the host beside the host batch -> (outputs, batch).
    Over a mesh, every rank's rows of both (of the batch, the fields named
    in ``keep``: those the writer reads) are gathered on rank 0 in rank
    order, in one call (-> None on the other ranks)."""
    out = {k: v.cpu().numpy() for k, v in out.items()}
    if not _spread(mesh):
        return out, batch
    part = (out, {k: batch[k] for k in keep if k in batch})
    parts = [None] * mesh.size if mesh.index == 0 else None
    dist.gather_object(part, parts, dst=mesh.ranks[0], group=mesh.group)
    if mesh.index != 0:
        return None
    return tuple({k: np.concatenate([p[i][k] for p in parts])
                  for k in parts[0][i]} for i in (0, 1))


def _gt_boxes(batch, k):
    gt = batch["gt_boxes3d"][k]
    return gt[np.abs(gt).sum(axis=1) > 0]


def _log_recall(logger, label, recall, total_gt):
    for i, t in enumerate(THRESH_LIST):
        logger.info(f"total {label} recall(thresh={t:.3f}): "
                    f"{int(recall[i])} / {total_gt} = "
                    f"{recall[i] / total_gt:.6f}")


def _write_empty_files(dataset, final_output_dir) -> int:
    """Empty label files for frames with no detections (reference
    :638-649)."""
    empty_cnt = 0
    for sid in dataset.image_idx_list:
        cur = os.path.join(final_output_dir, f"{sid}.txt")
        if not os.path.exists(cur):
            open(cur, "w").close()
            empty_cnt += 1
    return empty_cnt


def eval_one_epoch_rpn(args, cfg, model, loader, result_dir, logger,
                       mesh=None):
    """RPN-only eval: per-point seg IoU + proposal recall (+ feature dumps)
    (reference parity: eval_rcnn.py:120-260 eval_one_epoch_rpn)."""
    dataset = loader.dataset
    dev = next(model.parameters()).device
    writes = _writes(mesh)
    if writes and args.save_rpn_feature:
        features_dir = os.path.join(result_dir, "features")
        os.makedirs(features_dir, exist_ok=True)
    if writes and (args.save_result or args.save_rpn_feature):
        # detections/data is the roi producer for offline-RCNN train/eval
        # (reference: eval_rcnn.py:128-132, 221-238)
        kitti_output_dir = os.path.join(result_dir, "detections", "data")
        seg_output_dir = os.path.join(result_dir, "seg_result")
        os.makedirs(kitti_output_dir, exist_ok=True)
        os.makedirs(seg_output_dir, exist_ok=True)

    infer = make_rpn_infer_step(model, cfg)
    total_recall = np.zeros(len(THRESH_LIST), np.int64)
    total_gt = 0
    rpn_iou_sum, n_scenes = 0.0, 0
    keep = ["sample_id", "batch_valid", "rpn_cls_label", "gt_boxes3d"]
    if args.save_rpn_feature:
        keep.append("pts_features")
    if args.save_result or args.save_rpn_feature:
        keep.append("pts_rect")
    for batch, staged in _batches(loader, ("pts_input",), dev):
        got = _to_host(infer(staged["pts_input"]), batch, keep, mesh)
        if got is None:  # rank 0 writes
            continue
        out, batch = got
        for k in range(len(batch["sample_id"])):
            if not batch["batch_valid"][k]:
                continue
            n_scenes += 1
            sample_id = int(batch["sample_id"][k])
            if args.save_rpn_feature:
                save_rpn_features(out, batch, k, features_dir, sample_id)
            if args.save_result or args.save_rpn_feature:
                # proposals as KITTI label files + per-point seg dump
                # (reference: eval_rcnn.py:221-238)
                pred_cls = out["seg_result"][k].astype(np.float32)
                cols = [batch["pts_rect"][k].reshape(-1, 3)]
                if not args.test and "rpn_cls_label" in batch:
                    cols.append(batch["rpn_cls_label"][k].reshape(-1, 1)
                                .astype(np.float32))
                cols.append(pred_cls.reshape(-1, 1))
                np.save(os.path.join(seg_output_dir, "%06d.npy" % sample_id),
                        np.concatenate(cols, axis=1).astype(np.float16))
                valid_k = out["roi_valid"][k]
                save_kitti_format(
                    sample_id, dataset.get_calib(sample_id),
                    out["rois"][k][valid_k], kitti_output_dir,
                    out["roi_scores_raw"][k][valid_k],
                    dataset.get_image_shape(sample_id), classes=cfg.CLASSES)
            if not args.test and "rpn_cls_label" in batch:
                seg = out["seg_result"][k].astype(bool)
                fg = batch["rpn_cls_label"][k] > 0
                union = float(np.sum(seg | fg))
                inter = float(np.sum(seg & fg))
                rpn_iou_sum += inter / max(union, 1.0)
            if not args.test and "gt_boxes3d" in batch:
                rois_k = out["rois"][k][out["roi_valid"][k]]
                rec, n_gt = _recall_counts(rois_k, _gt_boxes(batch, k), dev)
                total_recall += rec
                total_gt += n_gt
    if not writes:
        return None
    if total_gt > 0:
        _log_recall(logger, "roi", total_recall, total_gt)
    avg_iou = rpn_iou_sum / max(n_scenes, 1)
    logger.info(f"average rpn seg iou: {avg_iou:.6f}")
    return {"rpn_iou": avg_iou,
            "recall": {t: float(total_recall[i] / max(total_gt, 1))
                       for i, t in enumerate(THRESH_LIST)}}


def eval_one_epoch_joint(args, cfg, model, loader, result_dir, logger,
                         mesh=None):
    """Joint / rcnn eval: final boxes as KITTI label files (and, with
    ``--save_result``, the rois and the refined boxes before NMS), the
    recall tables and the scenes/s from the second batch on, taken after
    a synchronize (tpu3d: tools/eval_rcnn.py:290 eval_one_epoch_joint)."""
    dataset = loader.dataset
    dev = next(model.parameters()).device
    writes = _writes(mesh)
    final_output_dir = os.path.join(result_dir, "final_result", "data")
    if writes:
        os.makedirs(final_output_dir, exist_ok=True)
    if writes and args.save_result:
        # pre-NMS roi + refined-box label dumps (reference:
        # eval_rcnn.py:474-480, 586-607): roi_result/data feeds offline-RCNN
        roi_output_dir = os.path.join(result_dir, "roi_result", "data")
        refine_output_dir = os.path.join(result_dir, "refine_result", "data")
        os.makedirs(roi_output_dir, exist_ok=True)
        os.makedirs(refine_output_dir, exist_ok=True)

    infer = make_infer_step(model, cfg)
    total_recall = np.zeros(len(THRESH_LIST), np.int64)
    total_roi_recall = np.zeros(len(THRESH_LIST), np.int64)
    total_gt = 0
    final_total = 0
    n_scenes = 0
    t_start, scenes_timed = None, 0
    keep = ("sample_id", "batch_valid", "gt_boxes3d")
    for batch, staged in _batches(loader, ("pts_input",), dev):
        # waits for the card (and, over a mesh, for every rank's rows)
        got = _to_host(infer(staged["pts_input"]), batch, keep, mesh)
        if t_start is None:  # the first batch loads the kernels
            t_start = time.perf_counter()
        if got is None:  # rank 0 writes
            continue
        out, batch = got
        for k in range(len(batch["sample_id"])):
            if not batch["batch_valid"][k]:
                continue
            n_scenes += 1
            scenes_timed += 1
            sample_id = int(batch["sample_id"][k])
            mask = out["final_mask"][k]
            boxes = out["final_boxes"][k][mask]
            scores = out["final_scores"][k][mask]
            calib = dataset.get_calib(sample_id)
            img_shape = dataset.get_image_shape(sample_id)
            valid_k = out["roi_valid"][k]
            if args.save_result:
                save_kitti_format(
                    sample_id, calib, out["rois"][k][valid_k], roi_output_dir,
                    out["roi_scores_raw"][k][valid_k], img_shape,
                    classes=cfg.CLASSES)
                save_kitti_format(
                    sample_id, calib, out["pred_boxes3d"][k][valid_k],
                    refine_output_dir, out["raw_scores"][k][valid_k],
                    img_shape, classes=cfg.CLASSES)
            final_total += save_kitti_format(
                sample_id, calib, boxes, final_output_dir, scores, img_shape,
                classes=cfg.CLASSES)
            if not args.test and "gt_boxes3d" in batch:
                gt = _gt_boxes(batch, k)
                rec, n_gt = _recall_counts(boxes, gt, dev)
                total_recall += rec
                total_gt += n_gt
                roi_rec, _ = _recall_counts(out["rois"][k][valid_k], gt, dev)
                total_roi_recall += roi_rec
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - (t_start or time.perf_counter())
    if not writes:
        return None

    empty_cnt = _write_empty_files(dataset, final_output_dir)
    logger.info(f"final average detections: "
                f"{final_total / max(n_scenes, 1):.3f}")
    if total_gt > 0:
        _log_recall(logger, "bbox", total_recall, total_gt)
        _log_recall(logger, "roi ", total_roi_recall, total_gt)
    scenes_per_sec = (scenes_timed / elapsed) if elapsed > 0 else 0.0
    logger.info(f"inference throughput: {scenes_per_sec:.2f} scenes/s "
                f"({scenes_timed} scenes in {elapsed:.2f}s, after the first "
                f"batch)")
    return {
        "recall": {t: float(total_recall[i] / max(total_gt, 1))
                   for i, t in enumerate(THRESH_LIST)},
        "roi_recall": {t: float(total_roi_recall[i] / max(total_gt, 1))
                       for i, t in enumerate(THRESH_LIST)},
        "avg_detections": final_total / max(n_scenes, 1),
        "scenes_per_sec": scenes_per_sec,
        "final_output_dir": final_output_dir,
        "empty_cnt": empty_cnt,
    }


def eval_one_epoch_rcnn(args, cfg, model, loader, result_dir, logger,
                        mesh=None):
    """rcnn_offline eval: saved proposals + dumped features -> RCNN refinement
    -> KITTI dumps + recall/cls-acc tables (reference parity:
    eval_rcnn.py:263-460 eval_one_epoch_rcnn; batched + fixed-shape here)."""
    dataset = loader.dataset
    dev = next(model.parameters()).device
    writes = _writes(mesh)
    final_output_dir = os.path.join(result_dir, "final_result", "data")
    if writes:
        os.makedirs(final_output_dir, exist_ok=True)
    if writes and args.save_result:
        roi_output_dir = os.path.join(result_dir, "roi_result", "data")
        refine_output_dir = os.path.join(result_dir, "refine_result", "data")
        os.makedirs(roi_output_dir, exist_ok=True)
        os.makedirs(refine_output_dir, exist_ok=True)

    infer = make_offline_infer_step(model, cfg)
    keys = ("pts_input", "roi_boxes3d", "roi_valid", "roi_size")
    total_recall = np.zeros(len(THRESH_LIST), np.int64)
    total_roi_recall = np.zeros(len(THRESH_LIST), np.int64)
    total_gt = 0
    total_cls_acc, total_cls_acc_refined = 0.0, 0.0
    final_total, n_scenes = 0, 0
    keep = ("sample_id", "batch_valid", "roi_valid", "roi_boxes3d",
            "roi_scores", "gt_boxes3d", "gt_iou")
    for batch, staged in _batches(loader, keys, dev):
        got = _to_host(infer(*(staged[k] for k in keys)), batch, keep, mesh)
        if got is None:  # rank 0 writes
            continue
        out, batch = got
        for k in range(len(batch["sample_id"])):
            if not batch["batch_valid"][k]:
                continue
            n_scenes += 1
            sample_id = int(batch["sample_id"][k])
            valid_k = batch["roi_valid"][k]
            calib = dataset.get_calib(sample_id)
            img_shape = dataset.get_image_shape(sample_id)
            if args.save_result:
                save_kitti_format(
                    sample_id, calib, batch["roi_boxes3d"][k][valid_k],
                    roi_output_dir, batch["roi_scores"][k][valid_k],
                    img_shape, classes=cfg.CLASSES)
                save_kitti_format(
                    sample_id, calib, out["pred_boxes3d"][k][valid_k],
                    refine_output_dir, out["raw_scores"][k][valid_k],
                    img_shape, classes=cfg.CLASSES)
            mask = out["final_mask"][k]
            final_total += save_kitti_format(
                sample_id, calib, out["final_boxes"][k][mask],
                final_output_dir, out["final_scores"][k][mask], img_shape,
                classes=cfg.CLASSES)
            if not args.test and "gt_boxes3d" in batch:
                gt = _gt_boxes(batch, k)
                rec, n_gt = _recall_counts(out["pred_boxes3d"][k][valid_k],
                                           gt, dev)
                total_recall += rec
                total_gt += n_gt
                roi_rec, _ = _recall_counts(batch["roi_boxes3d"][k][valid_k],
                                            gt, dev)
                total_roi_recall += roi_rec
                # cls accuracy vs gt_iou (reference :361-372)
                gt_iou = batch["gt_iou"][k][valid_k]
                pred_cls = (out["norm_scores"][k][valid_k]
                            > cfg.RCNN.SCORE_THRESH)
                cls_label = gt_iou > cfg.RCNN.CLS_FG_THRESH
                cls_valid = ((gt_iou >= cfg.RCNN.CLS_FG_THRESH)
                             | (gt_iou <= cfg.RCNN.CLS_BG_THRESH))
                total_cls_acc += (float(((pred_cls == cls_label)
                                         & cls_valid).sum())
                                  / max(float(cls_valid.sum()), 1.0))
                iou_thresh = 0.7 if cfg.CLASSES == "Car" else 0.5
                refined_label = gt_iou >= iou_thresh
                total_cls_acc_refined += (
                    float((pred_cls == refined_label).sum())
                    / max(len(refined_label), 1.0))
    if not writes:
        return None

    _write_empty_files(dataset, final_output_dir)
    logger.info(f"final average detections: "
                f"{final_total / max(n_scenes, 1):.3f}")
    logger.info(f"final average cls acc: "
                f"{total_cls_acc / max(n_scenes, 1):.3f}")
    logger.info(f"final average cls acc refined: "
                f"{total_cls_acc_refined / max(n_scenes, 1):.3f}")
    if total_gt > 0:
        _log_recall(logger, "bbox", total_recall, total_gt)
        _log_recall(logger, "roi ", total_roi_recall, total_gt)
    return {
        "recall": {t: float(total_recall[i] / max(total_gt, 1))
                   for i, t in enumerate(THRESH_LIST)},
        "roi_recall": {t: float(total_roi_recall[i] / max(total_gt, 1))
                       for i, t in enumerate(THRESH_LIST)},
        "rcnn_cls_acc": total_cls_acc / max(n_scenes, 1),
        "rcnn_cls_acc_refined": total_cls_acc_refined / max(n_scenes, 1),
        "avg_detections": final_total / max(n_scenes, 1),
        "final_output_dir": final_output_dir,
    }


EVAL_FNS = {"rpn": eval_one_epoch_rpn, "rcnn": eval_one_epoch_joint,
            "joint": eval_one_epoch_joint,
            "rcnn_offline": eval_one_epoch_rcnn}


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    distributed = init_distributed(dev)
    cfg = fresh_cfg()
    if args.cfg_file:
        cfg_from_file(args.cfg_file, cfg)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs, cfg)
    # eval modes mirror train modes (reference: eval_rcnn.py:878-895)
    if args.eval_mode == "rcnn_offline":
        if not (args.rcnn_eval_roi_dir and args.rcnn_eval_feature_dir):
            raise ValueError("rcnn_offline needs --rcnn_eval_roi_dir and "
                             "--rcnn_eval_feature_dir")
        configure_mode(cfg, "rcnn_offline")
    else:
        configure_mode(cfg, "joint" if args.eval_mode in ("rcnn", "joint")
                       else "rpn")
    if args.eval_mode == "rcnn":
        cfg.RPN.FIXED = True

    # the mesh at the eval batch (tpu3d: tools/eval_rcnn.py:210); ranks
    # outside it have no rows to run
    mesh = make_mesh(batch_size=args.batch_size)
    result_dir = args.output_dir or os.path.join(
        "output", "eval", cfg.TAG, f"eval_{args.dataset}")
    log_file = os.path.join(result_dir, "log_eval.txt")
    logger = null_logger()
    if lead():
        os.makedirs(result_dir, exist_ok=True)
        logger = create_logger(log_file)

    if args.synthetic:
        data_root = os.path.join(result_dir, "synthetic_data")
        if lead() and not os.path.exists(os.path.join(data_root, "KITTI")):
            create_synthetic_kitti(data_root, n_frames=8, image_files=True)
        args.data_root = data_root
    if distributed:  # rank 0's frames are on disk
        dist.barrier()
    if not mesh.member:
        return None
    data_root = args.data_root or os.path.join("multi_data", args.dataset)

    split = "test" if args.test else cfg.TEST.SPLIT
    dataset = KittiRCNNDataset(
        root_dir=data_root, npoints=cfg.RPN.NUM_POINTS, split=split,
        mode="TEST" if args.test else "EVAL", classes=cfg.CLASSES, cfg=cfg,
        random_select=True, logger=logger, seed=args.seed,
        rcnn_eval_roi_dir=args.rcnn_eval_roi_dir,
        rcnn_eval_feature_dir=args.rcnn_eval_feature_dir)
    loader = BatchLoader(dataset, args.batch_size, shuffle=False,
                         num_workers=args.workers, shard=mesh.shard)

    model = PointRCNN(cfg, mode="TEST", device=dev)
    model.load_state_dict(seeded_state_dict(model, args.seed))
    state = create_train_state(cfg, model, 1, 1)
    eval_fn = EVAL_FNS[args.eval_mode]
    try:
        if args.eval_all and args.ckpt_dir:
            return repeat_eval_ckpt(args, cfg, model, state, loader,
                                    result_dir, logger, eval_fn, mesh)
        ckpt = args.ckpt or (latest_checkpoint(args.ckpt_dir)
                             if args.ckpt_dir else None)
        if ckpt:
            state, epoch = load_checkpoint(ckpt, model, state)
            logger.info(f"loaded checkpoint {ckpt} (epoch {epoch})")
        else:
            logger.warning("no checkpoint given — evaluating random weights")
        return eval_fn(args, cfg, model, loader, result_dir, logger, mesh)
    finally:
        loader.close()
        for h in list(logger.handlers):  # a later run logs apart
            if getattr(h, "baseFilename", None) == os.path.abspath(log_file):
                logger.removeHandler(h)
                h.close()


def _agree(value, mesh):
    """Rank 0's ``value`` on every rank of the mesh."""
    if not _spread(mesh):
        return value
    box = [value]
    dist.broadcast_object_list(box, src=mesh.ranks[0], group=mesh.group)
    return box[0]


def repeat_eval_ckpt(args, cfg, model, state, loader, result_dir, logger,
                     eval_fn, mesh=None):
    """Daemon: poll --ckpt_dir for new checkpoints, evaluate each once, record
    evaluated epochs (reference parity: eval_rcnn.py:775-848 repeat_eval_ckpt —
    30 s poll, skip-already-evaluated via a record file, give up after
    max_waitmins with nothing new). -> {epoch: eval_fn's result}. Over a
    mesh, rank 0 polls and decides, and every rank evaluates what it
    chose."""
    writes = _writes(mesh)
    record_file = os.path.join(result_dir, "eval_list_val.txt")
    evaluated = set()
    if writes and os.path.isfile(record_file):
        with open(record_file) as f:
            evaluated = {int(x) for x in f.read().split() if x.strip()}
    idle_start = time.time()
    results = {}
    while True:
        candidates = []
        if writes and os.path.isdir(args.ckpt_dir):
            for fname in os.listdir(args.ckpt_dir):
                m = re.match(r"checkpoint_epoch_(\d+)\.msgpack$", fname)
                if m and int(m.group(1)) not in evaluated:
                    candidates.append((int(m.group(1)),
                                       os.path.join(args.ckpt_dir, fname)))
        candidates = _agree(candidates, mesh)
        if not candidates:
            if _agree(time.time() - idle_start > args.max_waitmins * 60,
                      mesh):
                logger.info("repeat_eval: no new checkpoints, exiting")
                return results
            time.sleep(args.wait_seconds)
            continue
        idle_start = time.time()
        for epoch, path in sorted(candidates):
            logger.info(f"repeat_eval: evaluating epoch {epoch} ({path})")
            state, _ = load_checkpoint(path, model, state)
            epoch_dir = os.path.join(result_dir, f"epoch_{epoch}")
            if writes:
                os.makedirs(epoch_dir, exist_ok=True)
            results[epoch] = eval_fn(args, cfg, model, loader, epoch_dir,
                                     logger, mesh)
            evaluated.add(epoch)
            if writes:
                with open(record_file, "w") as f:
                    f.write("\n".join(str(e) for e in sorted(evaluated)))


if __name__ == "__main__":
    main()
