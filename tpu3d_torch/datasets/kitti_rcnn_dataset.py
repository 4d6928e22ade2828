"""The training/eval input pipeline: KITTI scenes -> fixed-shape device batches.

The port's copy of ``tpu3d/datasets/kitti_rcnn_dataset.py``, held equal to it
sample for sample by ``tests/test_torch_data.py``, the RCNN-offline branches
included (samples from saved proposals and dumped RPN features, with
``RPN.ENABLED`` False).

Reference parity: lib/datasets/kitti_rcnn_dataset.py (the RPN path + jit-RCNN
path). Differences by design (SURVEY.md §7):
- every sample is fixed-shape: npoints points, MAX_GT zero-padded gt boxes —
  no ragged collate;
- the Delaunay `in_hull` per-gt label test becomes the analytic rotated-box
  test (the same math roipool3d_kernel.cu uses);
- randomness flows through an explicit numpy Generator per sample (seeded per
  (epoch, index)), not global state.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from ..kitti import read_label
from ..kitti.boxes import (
    boxes_iou3d_numpy,
    enlarge_box3d,
    points_in_boxes3d,
    rotate_points_along_y,
)
from ..kitti.object3d import objs_to_boxes3d
from ..ops.roipool import roipool3d_numpy
from .kitti_dataset import KittiDataset

MAX_GT = 50  # padded gt box slots per scene


class KittiRCNNDataset(KittiDataset):
    def __init__(self, root_dir, npoints=16384, split="train", classes="Car",
                 mode="TRAIN", cfg=None, random_select=True, logger=None,
                 gt_database_dir=None, rcnn_eval_roi_dir=None,
                 rcnn_eval_feature_dir=None, rcnn_training_roi_dir=None,
                 rcnn_training_feature_dir=None, with_replace=False,
                 npoints_faraway=4000, subsample=-1, shuffle_subsample=None,
                 seed=0, device_rpn_labels=False):
        super().__init__(root_dir=root_dir, split=split, subsample=subsample,
                         shuffle_subsample=shuffle_subsample)
        from ..config import cfg as global_cfg

        self.cfg = cfg if cfg is not None else global_cfg
        # padded roi slots for the offline-RCNN eval path: follow the eval
        # proposal budget so NO saved proposal is silently dropped (the
        # reference refines every saved proposal, eval_rcnn.py:263-460)
        try:
            self.MAX_ROI = int(self.cfg.TEST.RPN_POST_NMS_TOP_N)
        except (AttributeError, KeyError):
            # cfg without a TEST section (unit-test stubs): keep the class
            # default; any other error (malformed value) must surface
            pass
        if classes == "Car":
            self.classes = ("Background", "Car")
            aug_scene_root = os.path.join(root_dir, "KITTI", "aug_scene")
        elif classes == "People":
            self.classes = ("Background", "Pedestrian", "Cyclist")
            aug_scene_root = os.path.join(root_dir, "KITTI", "aug_scene")
        elif classes == "Pedestrian":
            self.classes = ("Background", "Pedestrian")
            aug_scene_root = os.path.join(root_dir, "KITTI", "aug_scene_ped")
        elif classes == "Cyclist":
            self.classes = ("Background", "Cyclist")
            aug_scene_root = os.path.join(root_dir, "KITTI", "aug_scene_cyclist")
        else:
            raise ValueError(f"Invalid classes: {classes}")
        self.num_class = len(self.classes)
        self.npoints = npoints
        self.random_select = random_select
        self.logger = logger
        self.with_replace = with_replace
        self.npoints_faraway = npoints_faraway
        self.seed = seed
        self.epoch = 0
        # skip host-side RPN label generation: the jitted train step derives
        # cls/reg labels on device from gt_boxes3d (make_train_step), saving
        # ~8 MB/step of host->device transfer at default batch 16
        self.device_rpn_labels = bool(device_rpn_labels)
        self.aug_label_dir = os.path.join(aug_scene_root, "training", "aug_label")
        self.aug_pts_dir = os.path.join(aug_scene_root, "training",
                                        "rectified_data")
        self.rcnn_eval_roi_dir = rcnn_eval_roi_dir
        self.rcnn_eval_feature_dir = rcnn_eval_feature_dir
        self.rcnn_training_roi_dir = rcnn_training_roi_dir
        self.rcnn_training_feature_dir = rcnn_training_feature_dir

        assert mode in ("TRAIN", "EVAL", "TEST"), mode
        self.mode = mode

        self.gt_database = None
        if gt_database_dir is not None:
            with open(gt_database_dir, "rb") as f:
                db = pickle.load(f)
            if self.cfg.GT_AUG_HARD_RATIO > 0:
                easy = [o for o in db if o["points"].shape[0] > 100]
                hard = [o for o in db if o["points"].shape[0] <= 100]
                self.gt_database = [easy, hard]
                if logger:
                    logger.info(
                        f"gt_database easy {len(easy)} hard {len(hard)}")
            else:
                self.gt_database = db

        if mode == "TRAIN":
            self.sample_id_list = [
                int(sid) for sid in self.image_idx_list
                if len(self.filtrate_objects(self.get_label(int(sid)))) > 0]
        else:
            self.sample_id_list = [int(sid) for sid in self.image_idx_list]

    # ----- accessors honoring aug-scene id mapping (ids >= 400000 map back
    # via % 200000; offline-augmented labels live under aug_label;
    # reference: kitti_rcnn_dataset.py:120-139)
    def get_label(self, idx):
        if idx < 2000000:
            label_file = os.path.join(self.label_dir, "%06d.txt" % idx)
        else:
            label_file = os.path.join(self.aug_label_dir, "%06d.txt" % idx)
        return read_label(label_file)

    # alias kept for call sites that distinguish objects from anno dicts
    get_label_objects = get_label

    def get_image_shape(self, idx):
        return super().get_image_shape(idx % 200000)

    def get_calib(self, idx):
        return super().get_calib(idx % 200000)

    def get_road_plane(self, idx):
        return super().get_road_plane(idx % 200000)

    def filtrate_objects(self, obj_list):
        """Keep detectable classes (+ similar types in TRAIN) inside the area
        scope (reference: kitti_rcnn_dataset.py:155-176)."""
        cfg = self.cfg
        type_whitelist = list(self.classes)
        if self.mode == "TRAIN" and cfg.INCLUDE_SIMILAR_TYPE:
            if "Car" in self.classes:
                type_whitelist.append("Van")
            if "Pedestrian" in self.classes:
                type_whitelist.append("Person_sitting")
        out = []
        for obj in obj_list:
            if obj.cls_type not in type_whitelist:
                continue
            if (self.mode == "TRAIN" and cfg.PC_REDUCE_BY_RANGE
                    and not self._check_pc_range(obj.t)):
                continue
            out.append(obj)
        return out

    def _check_pc_range(self, xyz):
        x_range, y_range, z_range = self.cfg.PC_AREA_SCOPE
        return (x_range[0] <= xyz[0] <= x_range[1]
                and y_range[0] <= xyz[1] <= y_range[1]
                and z_range[0] <= xyz[2] <= z_range[1])

    def get_valid_flag(self, pts_rect, pts_img, pts_rect_depth, img_shape):
        """In-image + in-area-scope point filter
        (reference: kitti_rcnn_dataset.py:200-222)."""
        flag = ((pts_img[:, 0] >= 0) & (pts_img[:, 0] < img_shape[1])
                & (pts_img[:, 1] >= 0) & (pts_img[:, 1] < img_shape[0])
                & (pts_rect_depth >= 0))
        if self.cfg.PC_REDUCE_BY_RANGE:
            x_range, y_range, z_range = self.cfg.PC_AREA_SCOPE
            flag &= ((pts_rect[:, 0] >= x_range[0]) & (pts_rect[:, 0] <= x_range[1])
                     & (pts_rect[:, 1] >= y_range[0])
                     & (pts_rect[:, 1] <= y_range[1])
                     & (pts_rect[:, 2] >= z_range[0])
                     & (pts_rect[:, 2] <= z_range[1]))
        return flag

    # ----- offline-RCNN support (features dumped by eval_rcnn --save_rpn_feature)
    @staticmethod
    def get_rpn_features(rpn_feature_dir, idx, use_seg_score=False):
        """Load a scene's dumped backbone features (reference parity:
        kitti_rcnn_dataset.py:141-154 get_rpn_features)."""
        xyz = np.load(os.path.join(rpn_feature_dir, "%06d_xyz.npy" % idx))
        features = np.load(os.path.join(rpn_feature_dir, "%06d.npy" % idx))
        intensity = np.load(
            os.path.join(rpn_feature_dir, "%06d_intensity.npy" % idx)).reshape(-1)
        if use_seg_score:
            raw = np.load(
                os.path.join(rpn_feature_dir, "%06d_rawscore.npy" % idx)
            ).reshape(-1)
            seg = 1.0 / (1.0 + np.exp(-raw))
        else:
            seg = np.load(
                os.path.join(rpn_feature_dir, "%06d_seg.npy" % idx)).reshape(-1)
        return xyz, features, intensity, seg

    def get_proposal_from_file(self, index):
        """Offline-RCNN eval sample: saved proposals + dumped RPN features
        (reference parity: kitti_rcnn_dataset.py:811-895)."""
        cfg = self.cfg
        sample_id = int(self.image_idx_list[index])
        proposal_file = os.path.join(self.rcnn_eval_roi_dir,
                                     "%06d.txt" % sample_id)
        roi_objs = read_label(proposal_file)
        rpn_xyz, rpn_features, rpn_intensity, seg_mask = self.get_rpn_features(
            self.rcnn_eval_feature_dir, sample_id,
            use_seg_score=cfg.RCNN.USE_SEG_SCORE)

        roi_boxes3d = objs_to_boxes3d(roi_objs)
        roi_scores = np.array([o.score or 0.0 for o in roi_objs], np.float32)

        pts_extra = self._rcnn_extra_features(rpn_xyz, rpn_intensity, seg_mask)
        pts_feature = np.concatenate(
            [pts_extra, rpn_features], axis=1).astype(np.float32)

        # pad rois to a fixed slot count so eval batches have one shape
        m = int(min(len(roi_boxes3d), self.MAX_ROI))
        roi_valid = np.zeros(self.MAX_ROI, dtype=bool)
        roi_valid[:m] = True
        rois_pad = np.zeros((self.MAX_ROI, 7), np.float32)
        rois_pad[:m] = roi_boxes3d[:m]
        rois_pad[m:, 3:6] = 1.0  # unit boxes keep the pool/IoU math finite
        scores_pad = np.zeros(self.MAX_ROI, np.float32)
        scores_pad[:m] = roi_scores[:m]

        pooled, _empty = roipool3d_numpy(
            rpn_xyz[None].astype(np.float32), pts_feature[None],
            rois_pad[None], cfg.RCNN.POOL_EXTRA_WIDTH,
            int(cfg.RCNN.NUM_POINTS))
        pooled = pooled[0]  # (MAX_ROI, K, 3+C)
        # canonical transform
        pooled[..., 0:3] -= rois_pad[:, None, 0:3]
        pooled[..., 0:3] = rotate_points_along_y(
            pooled[..., 0:3], rois_pad[:, None, 6])

        sample = {"sample_id": sample_id,
                  "pts_input": pooled.astype(np.float32),
                  "roi_boxes3d": rois_pad,
                  "roi_scores": scores_pad,
                  "roi_valid": roi_valid,
                  "roi_size": rois_pad[:, 3:6].copy()}
        if self.mode != "TEST":
            gt_boxes3d = objs_to_boxes3d(
                self.filtrate_objects(self.get_label_objects(sample_id)))
            gt_iou = np.zeros(self.MAX_ROI, np.float32)
            # canonical-frame matched gt per ROI so --train_with_eval can
            # report the real reg loss (reference eval_epoch runs the full
            # loss, train_utils.py:140-168); zeros where no gt matches
            gt_ct = np.zeros((self.MAX_ROI, 7), np.float32)
            if len(gt_boxes3d) and m:
                iou = boxes_iou3d_numpy(rois_pad[:m], gt_boxes3d)
                gt_iou[:m] = iou.max(axis=1)
                gt_of = gt_boxes3d[iou.argmax(axis=1)]  # (m, 7)
                roi_ry = rois_pad[:m, 6] % (2 * np.pi)
                ct = gt_of.copy()
                ct[:, 0:3] -= rois_pad[:m, 0:3]
                ct[:, 0:3] = rotate_points_along_y(ct[:, 0:3], roi_ry)
                ct[:, 6] -= roi_ry
                gt_ct[:m] = ct
            sample["gt_boxes3d"] = self._pad_gt(gt_boxes3d)
            sample["gt_iou"] = gt_iou
            sample["gt_boxes3d_ct"] = gt_ct
        return sample

    # ----- offline-RCNN training (features + rois dumped by an RPN eval run)
    MAX_ROI = 300  # class-level fallback; __init__ overrides from
    # cfg.TEST.RPN_POST_NMS_TOP_N so saved proposals are never truncated

    @staticmethod
    def random_aug_box3d(rng, box3d, reg_aug_method="multiple"):
        """Random shift/scale/rotation of one ROI box (reference parity:
        kitti_rcnn_dataset.py:767-809 random_aug_box3d)."""
        if reg_aug_method == "single":
            pos_shift = rng.random(3) - 0.5
            hwl_scale = (rng.random(3) - 0.5) / (0.5 / 0.15) + 1.0
            angle_rot = (rng.random(1) - 0.5) / (0.5 / (np.pi / 12))
            return np.concatenate([box3d[0:3] + pos_shift,
                                   box3d[3:6] * hwl_scale,
                                   box3d[6:7] + angle_rot])
        if reg_aug_method == "multiple":
            range_config = [[0.2, 0.1, np.pi / 12, 0.7],
                            [0.3, 0.15, np.pi / 12, 0.6],
                            [0.5, 0.15, np.pi / 9, 0.5],
                            [0.8, 0.15, np.pi / 6, 0.3],
                            [1.0, 0.15, np.pi / 3, 0.2]]
            idx = rng.integers(len(range_config))
            pos_shift = ((rng.random(3) - 0.5) / 0.5) * range_config[idx][0]
            hwl_scale = ((rng.random(3) - 0.5) / 0.5) * range_config[idx][1] + 1.0
            angle_rot = ((rng.random(1) - 0.5) / 0.5) * range_config[idx][2]
            return np.concatenate([box3d[0:3] + pos_shift,
                                   box3d[3:6] * hwl_scale,
                                   box3d[6:7] + angle_rot])
        if reg_aug_method == "normal":
            shifts = np.array([rng.normal(0, 0.3), rng.normal(0, 0.2),
                               rng.normal(0, 0.3), rng.normal(0, 0.25),
                               rng.normal(0, 0.15), rng.normal(0, 0.5)])
            ry_shift = ((rng.random() - 0.5) / 0.5) * np.pi / 12
            return np.concatenate([box3d[0:6] + shifts,
                                   box3d[6:7] + ry_shift])
        raise NotImplementedError(reg_aug_method)

    def aug_roi_by_noise_batch(self, rng, roi_boxes3d, gt_boxes3d, aug_times=10):
        """Jitter each ROI until IoU with its gt exceeds the fg threshold or
        ``aug_times`` attempts pass (reference parity:
        kitti_rcnn_dataset.py:1074-1099 aug_roi_by_noise_batch)."""
        cfg = self.cfg
        pos_thresh = min(cfg.RCNN.REG_FG_THRESH, cfg.RCNN.CLS_FG_THRESH)
        out = roi_boxes3d.copy()
        iou_of_rois = np.zeros(len(roi_boxes3d), np.float32)
        for k in range(len(roi_boxes3d)):
            temp_iou, cnt = 0.0, 0
            aug_box3d = roi_boxes3d[k]
            gt_box3d = gt_boxes3d[k].reshape(1, 7)
            while temp_iou < pos_thresh and cnt < aug_times:
                if rng.random() < 0.2:
                    aug_box3d = roi_boxes3d[k]  # keep original with p=0.2
                else:
                    aug_box3d = self.random_aug_box3d(
                        rng, roi_boxes3d[k], cfg.RCNN.REG_AUG_METHOD)
                temp_iou = float(boxes_iou3d_numpy(
                    aug_box3d.reshape(1, 7), gt_box3d)[0, 0])
                cnt += 1
            out[k] = aug_box3d
            iou_of_rois[k] = temp_iou
        return out, iou_of_rois

    def _sample_bg_inds(self, rng, hard_bg_inds, easy_bg_inds, bg_num):
        """HARD_BG_RATIO split between hard/easy background pools (reference:
        kitti_rcnn_dataset.py:1045-1072 sample_bg_inds)."""
        if hard_bg_inds.size > 0 and easy_bg_inds.size > 0:
            hard_num = int(bg_num * self.cfg.RCNN.HARD_BG_RATIO)
            hard = hard_bg_inds[
                np.floor(rng.random(hard_num) * hard_bg_inds.size).astype(int)]
            easy = easy_bg_inds[
                np.floor(rng.random(bg_num - hard_num)
                         * easy_bg_inds.size).astype(int)]
            return np.concatenate([hard, easy])
        pool = hard_bg_inds if hard_bg_inds.size > 0 else easy_bg_inds
        return pool[np.floor(rng.random(bg_num) * pool.size).astype(int)]

    def _rcnn_extra_features(self, rpn_xyz, rpn_intensity, seg_mask):
        """[intensity?, seg_mask, depth?] per point, the extras that sit between
        canonical xyz and the 128-d backbone features (reference:
        kitti_rcnn_dataset.py:981-989)."""
        cfg = self.cfg
        extras = []
        if cfg.RCNN.USE_INTENSITY:
            extras.append(rpn_intensity.reshape(-1, 1))
        extras.append(seg_mask.reshape(-1, 1))
        if cfg.RCNN.USE_DEPTH:
            depth = np.linalg.norm(rpn_xyz, axis=1) / 70.0 - 0.5
            extras.append(depth.reshape(-1, 1))
        return np.concatenate(extras, axis=1).astype(np.float32)

    def get_rcnn_training_sample_batch(self, index):
        """Offline-RCNN training sample: fg/bg-sampled, noise-jittered ROIs
        pooled from dumped RPN features, canonically transformed — fixed shape
        (ROI_PER_IMAGE, NUM_POINTS, 3+ext+C) (reference parity:
        kitti_rcnn_dataset.py:897-1043 get_rcnn_training_sample_batch; the
        jitter-until-IoU and the first-k pooling keep the reference's
        semantics, shapes are fixed by construction)."""
        cfg = self.cfg
        rng = self._rng(index)
        sample_id = int(self.sample_id_list[index])
        rpn_xyz, rpn_features, rpn_intensity, seg_mask = self.get_rpn_features(
            self.rcnn_training_feature_dir, sample_id)

        roi_file = os.path.join(self.rcnn_training_roi_dir,
                                "%06d.txt" % sample_id)
        roi_boxes3d = objs_to_boxes3d(read_label(roi_file))
        gt_boxes3d = objs_to_boxes3d(
            self.filtrate_objects(self.get_label(sample_id)))

        n_roi = int(cfg.RCNN.ROI_PER_IMAGE)
        if len(roi_boxes3d) == 0 or len(gt_boxes3d) == 0:
            # degenerate frame: keep shapes, mark everything invalid
            k = int(cfg.RCNN.NUM_POINTS)
            c = 3 + self._rcnn_extra_features(
                rpn_xyz, rpn_intensity, seg_mask).shape[1] + rpn_features.shape[1]
            return {"sample_id": sample_id,
                    "pts_input": np.zeros((n_roi, k, c), np.float32),
                    "cls_label": np.full(n_roi, -1, np.int32),
                    "reg_valid_mask": np.zeros(n_roi, np.int32),
                    "gt_boxes3d_ct": np.zeros((n_roi, 7), np.float32),
                    "roi_boxes3d": np.zeros((n_roi, 7), np.float32)}

        iou3d = boxes_iou3d_numpy(roi_boxes3d, gt_boxes3d)
        max_overlaps, gt_assignment = iou3d.max(axis=1), iou3d.argmax(axis=1)
        max_iou_of_gt, roi_assignment = iou3d.max(axis=0), iou3d.argmax(axis=0)
        roi_assignment = roi_assignment[max_iou_of_gt > 0].reshape(-1)

        fg_rois_per_image = int(np.round(cfg.RCNN.FG_RATIO * n_roi))
        fg_thresh = min(cfg.RCNN.REG_FG_THRESH, cfg.RCNN.CLS_FG_THRESH)
        # the best roi of each gt counts as fg regardless of threshold
        fg_inds = np.concatenate(
            [np.nonzero(max_overlaps >= fg_thresh)[0], roi_assignment])
        easy_bg_inds = np.nonzero(max_overlaps < cfg.RCNN.CLS_BG_THRESH_LO)[0]
        hard_bg_inds = np.nonzero((max_overlaps < cfg.RCNN.CLS_BG_THRESH)
                                  & (max_overlaps >= cfg.RCNN.CLS_BG_THRESH_LO))[0]

        fg_num, bg_num = fg_inds.size, easy_bg_inds.size + hard_bg_inds.size
        if fg_num > 0 and bg_num > 0:
            fg_this = min(fg_rois_per_image, fg_num)
            fg_inds = fg_inds[rng.permutation(fg_num)[:fg_this]]
            bg_inds = self._sample_bg_inds(rng, hard_bg_inds, easy_bg_inds,
                                           n_roi - fg_this)
        elif fg_num > 0:
            fg_inds = fg_inds[
                np.floor(rng.random(n_roi) * fg_num).astype(int)]
            bg_inds = np.array([], dtype=int)
        else:
            bg_inds = self._sample_bg_inds(rng, hard_bg_inds, easy_bg_inds,
                                           n_roi)
            fg_inds = np.array([], dtype=int)

        # jitter fg rois toward/away from their gt (aug_times=10), bg once
        parts_roi, parts_iou, parts_gt = [], [], []
        for inds, aug_times in ((fg_inds, 10), (bg_inds, 1)):
            if inds.size == 0:
                continue
            rois_src = roi_boxes3d[inds].copy()
            gt_of = gt_boxes3d[gt_assignment[inds]]
            rois_aug, iou_aug = self.aug_roi_by_noise_batch(
                rng, rois_src, gt_of, aug_times=aug_times)
            parts_roi.append(rois_aug)
            parts_iou.append(iou_aug)
            parts_gt.append(gt_of)
        rois = np.concatenate(parts_roi, axis=0).astype(np.float32)
        iou_of_rois = np.concatenate(parts_iou, axis=0).astype(np.float32)
        gt_of_rois = np.concatenate(parts_gt, axis=0).astype(np.float32)

        pts_extra = self._rcnn_extra_features(rpn_xyz, rpn_intensity, seg_mask)
        pts_feature = np.concatenate([pts_extra, rpn_features],
                                     axis=1).astype(np.float32)
        pooled, empty = roipool3d_numpy(
            rpn_xyz[None].astype(np.float32), pts_feature[None], rois[None],
            cfg.RCNN.POOL_EXTRA_WIDTH, int(cfg.RCNN.NUM_POINTS))
        pooled, empty = pooled[0], np.asarray(empty[0])  # (R, K, 3+C), (R,)

        # stage-2 per-roi augmentation (reference :997-1017)
        if cfg.AUG_DATA and self.mode == "TRAIN":
            for k in range(len(rois)):
                pair = np.stack([rois[k], gt_of_rois[k]], axis=0)
                aug_pts, aug_pair, _ = self._stage2_augmentation(
                    rng, pooled[k, :, 0:3].copy(), pair)
                pooled[k, :, 0:3] = aug_pts
                rois[k] = aug_pair[0]
                gt_of_rois[k] = aug_pair[1]

        valid_mask = (~empty).astype(np.int32)
        reg_valid_mask = ((iou_of_rois > cfg.RCNN.REG_FG_THRESH).astype(np.int32)
                          & valid_mask)
        cls_label = (iou_of_rois > cfg.RCNN.CLS_FG_THRESH).astype(np.int32)
        invalid = ((iou_of_rois > cfg.RCNN.CLS_BG_THRESH)
                   & (iou_of_rois < cfg.RCNN.CLS_FG_THRESH))
        cls_label[invalid] = -1
        cls_label[valid_mask == 0] = -1

        # canonical transform (reference :705-725 canonical_transform_batch)
        roi_ry = rois[:, 6] % (2 * np.pi)
        roi_center = rois[:, 0:3]
        pooled[..., 0:3] -= roi_center[:, None, :]
        pooled[..., 0:3] = rotate_points_along_y(pooled[..., 0:3],
                                                 roi_ry[:, None])
        gt_ct = gt_of_rois.copy()
        gt_ct[:, 0:3] -= roi_center
        gt_ct[:, 0:3] = rotate_points_along_y(gt_ct[:, 0:3], roi_ry)
        gt_ct[:, 6] -= roi_ry

        return {"sample_id": sample_id,
                "pts_input": pooled.astype(np.float32),
                "cls_label": cls_label,
                "reg_valid_mask": reg_valid_mask,
                "gt_boxes3d_ct": gt_ct.astype(np.float32),
                "roi_boxes3d": rois}

    def _stage2_augmentation(self, rng, pts, boxes_pair):
        """Per-ROI rotation/scale/flip on (points, [roi, gt]) — the reference's
        data_augmentation(stage=2) (kitti_rcnn_dataset.py:546-591): boxes rotate
        rigidly about the y axis (center orbits, ry shifts by the angle)."""
        cfg = self.cfg
        aug_list = cfg.AUG_METHOD_LIST
        aug_enable = 1 - rng.random(3)
        aug_enable[0] = aug_enable[1] = -1  # mustaug
        aug_method = []
        boxes = boxes_pair.copy()
        if "rotation" in aug_list and aug_enable[0] < cfg.AUG_METHOD_PROB[0]:
            angle = rng.uniform(-np.pi / cfg.AUG_ROT_RANGE,
                                np.pi / cfg.AUG_ROT_RANGE)
            pts = rotate_points_along_y(pts, angle)
            # rotate_box3d_along_y (reference :416-426): orbit the center and
            # recompute ry so the viewing angle alpha is preserved
            old_beta = np.arctan2(boxes[:, 2], boxes[:, 0])
            alpha = -np.sign(old_beta) * np.pi / 2 + old_beta + boxes[:, 6]
            boxes[:, 0:3] = rotate_points_along_y(boxes[:, 0:3], angle)
            new_beta = np.arctan2(boxes[:, 2], boxes[:, 0])
            boxes[:, 6] = np.sign(new_beta) * np.pi / 2 + alpha - new_beta
            aug_method.append(["rotation", float(angle)])
        if "scaling" in aug_list and aug_enable[1] < cfg.AUG_METHOD_PROB[1]:
            scale = rng.uniform(cfg.SCALE_MIN_MAX_RANGE[0],
                                cfg.SCALE_MIN_MAX_RANGE[1])
            pts = pts * scale
            boxes[:, 0:6] *= scale
            aug_method.append(["scaling", float(scale)])
        if "flip" in aug_list and aug_enable[2] < cfg.AUG_METHOD_PROB[2]:
            pts[:, 0] = -pts[:, 0]
            boxes[:, 0] = -boxes[:, 0]
            boxes[:, 6] = np.sign(boxes[:, 6]) * np.pi - boxes[:, 6]
            aug_method.append("flip")
        return pts.astype(np.float32), boxes, aug_method

    def __len__(self):
        return len(self.sample_id_list)

    def _rng(self, index):
        return np.random.default_rng([self.seed, self.epoch, index])

    def __getitem__(self, index):
        """Dispatch mirrors the reference __getitem__
        (kitti_rcnn_dataset.py:238-247): RPN enabled -> rpn sample; RCNN-only
        TRAIN -> offline training batch; RCNN-only EVAL/TEST -> proposals from
        file."""
        if self.cfg.RPN.ENABLED:
            return self.get_rpn_sample(index)
        if self.mode == "TRAIN":
            return self.get_rcnn_training_sample_batch(index)
        return self.get_proposal_from_file(index)

    def _sample_points(self, rng, pts_rect, pts_intensity):
        """Distance-stratified fixed-budget point sampling (reference:
        kitti_rcnn_dataset.py:288-321): at most npoints_faraway points beyond
        40 m, the near budget filled (with replacement when short)."""
        n = len(pts_rect)
        if self.npoints < n:
            depth = pts_rect[:, 2]
            far_idxs = np.where(depth >= 40.0)[0]
            # the reference assumes npoints >> npoints_faraway (16384 vs 4000);
            # cap so small-point-budget configs keep a near majority
            far_cap = min(self.npoints_faraway, self.npoints // 2)
            if len(far_idxs) > far_cap:
                far_idxs = rng.choice(far_idxs, far_cap, replace=False)
            near_idxs = np.where(depth < 40.0)[0]
            need_near = self.npoints - len(far_idxs)
            replace = len(near_idxs) < need_near or self.with_replace
            near_choice = rng.choice(near_idxs, need_near, replace=replace)
            choice = (np.concatenate([near_choice, far_idxs])
                      if len(far_idxs) > 0 else near_choice)
        else:
            choice = np.arange(n, dtype=np.int64)
            if self.npoints > n:
                extra = rng.choice(choice, self.npoints - n,
                                   replace=len(choice) < self.npoints - n)
                choice = np.concatenate([choice, extra])
        rng.shuffle(choice)
        return pts_rect[choice], pts_intensity[choice]

    def get_rpn_sample(self, index):
        cfg = self.cfg
        rng = self._rng(index)
        sample_id = int(self.sample_id_list[index])
        if sample_id < 200000:
            calib = self.get_calib(sample_id)
            img_shape = self.get_image_shape(sample_id)
            pts_lidar = self.get_lidar(sample_id)
            pts_rect = calib.lidar_to_rect(pts_lidar[:, 0:3])
            pts_intensity = pts_lidar[:, 3]
        else:
            calib = self.get_calib(sample_id)
            img_shape = self.get_image_shape(sample_id)
            aug_pts = np.fromfile(
                os.path.join(self.aug_pts_dir, "%06d.bin" % sample_id),
                dtype=np.float32).reshape(-1, 4)
            pts_rect, pts_intensity = aug_pts[:, 0:3], aug_pts[:, 3]

        pts_img, pts_depth = calib.rect_to_img(pts_rect)
        valid = self.get_valid_flag(pts_rect, pts_img, pts_depth, img_shape)
        pts_rect = pts_rect[valid][:, 0:3]
        pts_intensity = pts_intensity[valid]

        gt_aug_flag, extra_gt_boxes3d, extra_gt_obj_list = False, None, None
        if cfg.GT_AUG_ENABLED and self.mode == "TRAIN" and self.gt_database:
            all_gt = [o for o in self.get_label_objects(sample_id)
                      if o.cls_type != "DontCare"]
            all_gt_boxes3d = objs_to_boxes3d(all_gt)
            if rng.random() < cfg.GT_AUG_APPLY_PROB:
                (gt_aug_flag, pts_rect, pts_intensity, extra_gt_boxes3d,
                 extra_gt_obj_list) = self.apply_gt_aug_to_one_scene(
                    rng, sample_id, pts_rect, pts_intensity, all_gt_boxes3d)

        if self.mode == "TRAIN" or self.random_select:
            ret_pts_rect, ret_pts_intensity = self._sample_points(
                rng, pts_rect, pts_intensity)
            ret_pts_intensity = ret_pts_intensity - 0.5
        else:
            ret_pts_rect = pts_rect
            ret_pts_intensity = pts_intensity - 0.5

        pts_features = ret_pts_intensity.reshape(-1, 1).astype(np.float32)
        sample_info = {"sample_id": sample_id}

        if self.mode == "TEST":
            if cfg.RPN.USE_INTENSITY:
                pts_input = np.concatenate([ret_pts_rect, pts_features], axis=1)
            else:
                pts_input = ret_pts_rect
            sample_info["pts_input"] = pts_input.astype(np.float32)
            sample_info["pts_rect"] = ret_pts_rect.astype(np.float32)
            sample_info["pts_features"] = pts_features
            return sample_info

        gt_obj_list = self.filtrate_objects(self.get_label_objects(sample_id))
        if cfg.GT_AUG_ENABLED and self.mode == "TRAIN" and gt_aug_flag:
            gt_obj_list.extend(extra_gt_obj_list)
        gt_boxes3d = objs_to_boxes3d(gt_obj_list)
        gt_alpha = np.array([o.alpha for o in gt_obj_list], dtype=np.float32)

        aug_pts_rect = ret_pts_rect.copy().astype(np.float32)
        aug_gt_boxes3d = gt_boxes3d.copy()
        if cfg.AUG_DATA and self.mode == "TRAIN":
            aug_pts_rect, aug_gt_boxes3d, aug_method = self.data_augmentation(
                rng, aug_pts_rect, aug_gt_boxes3d, gt_alpha)
            sample_info["aug_method"] = aug_method

        if cfg.RPN.USE_INTENSITY:
            pts_input = np.concatenate([aug_pts_rect, pts_features], axis=1)
        else:
            pts_input = aug_pts_rect

        sample_info["pts_input"] = pts_input.astype(np.float32)
        sample_info["pts_rect"] = aug_pts_rect.astype(np.float32)
        sample_info["pts_features"] = pts_features
        sample_info["gt_boxes3d"] = self._pad_gt(aug_gt_boxes3d)
        if not cfg.RPN.FIXED and not self.device_rpn_labels:
            cls_label, reg_label = self.generate_rpn_training_labels(
                aug_pts_rect, aug_gt_boxes3d)
            sample_info["rpn_cls_label"] = cls_label
            sample_info["rpn_reg_label"] = reg_label
        return sample_info

    @staticmethod
    def _pad_gt(gt_boxes3d, max_gt=MAX_GT):
        out = np.zeros((max_gt, 7), dtype=np.float32)
        n = min(len(gt_boxes3d), max_gt)
        out[:n] = gt_boxes3d[:n]
        return out

    def generate_rpn_training_labels(self, pts_rect, gt_boxes3d):
        """Per-point segmentation + box-regression targets (reference:
        kitti_rcnn_dataset.py:384-414, with the analytic in-box test replacing
        Delaunay in_hull). reg target: [dx, dy, dz, h, w, l, ry] with dy to the
        *true* box center (y − h/2)."""
        cls_label = np.zeros(pts_rect.shape[0], dtype=np.int32)
        reg_label = np.zeros((pts_rect.shape[0], 7), dtype=np.float32)
        if len(gt_boxes3d) == 0:
            return cls_label, reg_label
        inside = points_in_boxes3d(pts_rect, gt_boxes3d)  # (N, M)
        extend = enlarge_box3d(gt_boxes3d, extra_width=0.2)
        inside_ext = points_in_boxes3d(pts_rect, extend)
        for k in range(gt_boxes3d.shape[0]):
            fg = inside[:, k]
            cls_label[fg] = 1
            ignore = np.logical_xor(fg, inside_ext[:, k])
            cls_label[ignore] = -1
            center3d = gt_boxes3d[k][0:3].copy()
            center3d[1] -= gt_boxes3d[k][3] / 2
            reg_label[fg, 0:3] = center3d - pts_rect[fg]
            reg_label[fg, 3:7] = gt_boxes3d[k][3:7]
        return cls_label, reg_label

    def apply_gt_aug_to_one_scene(self, rng, sample_id, pts_rect, pts_intensity,
                                  all_gt_boxes3d):
        """Copy-paste GT augmentation onto the road plane with collision checks
        (reference: kitti_rcnn_dataset.py:428-531)."""
        cfg = self.cfg
        assert self.gt_database is not None
        extra_gt_num = (rng.integers(10, cfg.GT_EXTRA_NUM)
                        if cfg.GT_AUG_RAND_NUM else cfg.GT_EXTRA_NUM)
        try_times = 100
        cnt = 0
        cur_gt_boxes3d = all_gt_boxes3d.copy()
        if len(cur_gt_boxes3d) > 0:
            cur_gt_boxes3d[:, 4] += 0.5
            cur_gt_boxes3d[:, 5] += 0.5
        else:
            cur_gt_boxes3d = np.zeros((0, 7), dtype=np.float32)

        extra_gt_obj_list, extra_gt_boxes3d_list = [], []
        new_pts_list, new_pts_intensity_list = [], []
        src_pts_flag = np.ones(pts_rect.shape[0], dtype=bool)
        a, b, c, d = self.get_road_plane(sample_id)

        while try_times > 0:
            if cnt > extra_gt_num:
                break
            try_times -= 1
            if cfg.GT_AUG_HARD_RATIO > 0:
                if rng.random() > cfg.GT_AUG_HARD_RATIO:
                    pool = self.gt_database[0]
                else:
                    pool = self.gt_database[1]
                if len(pool) == 0:
                    continue
                new_gt = pool[rng.integers(0, len(pool))]
            else:
                new_gt = self.gt_database[rng.integers(0, len(self.gt_database))]

            new_box = new_gt["gt_box3d"].copy()
            new_points = new_gt["points"].copy()
            new_intensity = new_gt["intensity"].copy()
            new_obj = new_gt["obj"]
            if cfg.PC_REDUCE_BY_RANGE and not self._check_pc_range(new_box[0:3]):
                continue
            if len(new_points) < 5:
                continue

            cur_height = (-d - a * new_box[0] - c * new_box[2]) / b
            move = new_box[1] - cur_height
            new_box[1] -= move
            new_points[:, 1] -= move

            enlarged = new_box.copy()
            enlarged[4] += 0.5
            enlarged[5] += 0.5
            cnt += 1
            if len(cur_gt_boxes3d) > 0:
                iou = boxes_iou3d_numpy(enlarged.reshape(1, 7), cur_gt_boxes3d)
                if iou.max() >= 1e-8:
                    continue

            remove_box = new_box.copy()
            remove_box[3] += 2.0  # clear points above/below the pasted object
            inside = points_in_boxes3d(pts_rect, remove_box.reshape(1, 7))[:, 0]
            src_pts_flag[inside] = False

            new_pts_list.append(new_points)
            new_pts_intensity_list.append(new_intensity)
            cur_gt_boxes3d = np.concatenate(
                [cur_gt_boxes3d, enlarged.reshape(1, 7)], axis=0)
            extra_gt_boxes3d_list.append(new_box.reshape(1, 7))
            import copy as _copy

            pasted_obj = _copy.deepcopy(new_obj)
            pasted_obj.t[1] -= move
            extra_gt_obj_list.append(pasted_obj)

        if len(new_pts_list) == 0:
            return False, pts_rect, pts_intensity, None, None
        extra_gt_boxes3d = np.concatenate(extra_gt_boxes3d_list, axis=0)
        pts_rect = np.concatenate(
            [pts_rect[src_pts_flag]] + new_pts_list, axis=0)
        pts_intensity = np.concatenate(
            [pts_intensity[src_pts_flag]] + new_pts_intensity_list, axis=0)
        return True, pts_rect, pts_intensity, extra_gt_boxes3d, extra_gt_obj_list

    def data_augmentation(self, rng, pts_rect, gt_boxes3d, gt_alpha,
                          mustaug=False):
        """Global rotation / scaling / flip (reference:
        kitti_rcnn_dataset.py:533-591, stage-1 path)."""
        cfg = self.cfg
        aug_list = cfg.AUG_METHOD_LIST
        aug_enable = 1 - rng.random(3)
        if mustaug:
            aug_enable[0] = -1
            aug_enable[1] = -1
        aug_method = []
        if "rotation" in aug_list and aug_enable[0] < cfg.AUG_METHOD_PROB[0]:
            angle = rng.uniform(-np.pi / cfg.AUG_ROT_RANGE,
                                np.pi / cfg.AUG_ROT_RANGE)
            pts_rect = rotate_points_along_y(pts_rect, angle)
            if len(gt_boxes3d):
                gt_boxes3d = rotate_points_along_y(gt_boxes3d, angle)
                x, z = gt_boxes3d[:, 0], gt_boxes3d[:, 2]
                beta = np.arctan2(z, x)
                gt_boxes3d[:, 6] = np.sign(beta) * np.pi / 2 + gt_alpha - beta
            aug_method.append(["rotation", float(angle)])
        if "scaling" in aug_list and aug_enable[1] < cfg.AUG_METHOD_PROB[1]:
            scale = rng.uniform(cfg.SCALE_MIN_MAX_RANGE[0],
                                cfg.SCALE_MIN_MAX_RANGE[1])
            pts_rect = pts_rect * scale
            if len(gt_boxes3d):
                gt_boxes3d[:, 0:6] = gt_boxes3d[:, 0:6] * scale
            aug_method.append(["scaling", float(scale)])
        if "flip" in aug_list and aug_enable[2] < cfg.AUG_METHOD_PROB[2]:
            pts_rect[:, 0] = -pts_rect[:, 0]
            if len(gt_boxes3d):
                gt_boxes3d[:, 0] = -gt_boxes3d[:, 0]
                gt_boxes3d[:, 6] = (np.sign(gt_boxes3d[:, 6]) * np.pi
                                    - gt_boxes3d[:, 6])
            aug_method.append("flip")
        return pts_rect.astype(np.float32), gt_boxes3d, aug_method

    def collate_batch(self, batch):
        """Stack fixed-shape samples (gt already padded to MAX_GT)."""
        out = {}
        for key in batch[0]:
            vals = [s[key] for s in batch]
            if isinstance(vals[0], np.ndarray):
                out[key] = np.stack(vals, axis=0)
            elif isinstance(vals[0], (int, np.integer)):
                out[key] = np.array(vals, dtype=np.int32)
            elif isinstance(vals[0], (float, np.floating)):
                out[key] = np.array(vals, dtype=np.float32)
            else:
                out[key] = vals
        return out
