"""Offline GT augmentation: augmented scenes baked to disk; the port's copy
of ``tpu3d/tools/generate_aug_scene.py``, on the port's dataset and KITTI
host code.

For each of ``aug_times`` epochs, 10-15 database objects are pasted onto
the road plane of every scene (checked for collisions against the enlarged
existing boxes; the scene's points under a pasted object removed), writing
rectified_data/%06d.bin (rect-frame xyz + intensity) and aug_label/%06d.txt
under ``--save_dir``, the pasted scenes' ids offset by (epoch + 1)·400000,
and the combined {split}_aug.txt id list. The draws come from
``np.random.default_rng(seed)`` in tpu3d's order, so a seed writes tpu3d's
files byte for byte. Host numpy, as in tpu3d.

    python -m tpu3d_torch.tools.generate_aug_scene --root R --save_dir D \
        --gt_database_dir DB.pkl [--aug_times 4]
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from ..config import cfg
from ..datasets.kitti_dataset import KittiDataset
from ..kitti.boxes import (boxes_iou3d_numpy, corners_from_boxes3d,
                           points_in_boxes3d)
from ..kitti.object3d import objs_to_boxes3d

CLASS_MAP = {
    "Car": ("Background", "Car"),
    "People": ("Background", "Pedestrian", "Cyclist"),
    "Pedestrian": ("Background", "Pedestrian"),
    "Cyclist": ("Background", "Cyclist"),
}


def save_extra_objects_kitti(calib, boxes3d, obj_list, img_shape, fp,
                             class_name="Car"):
    """Write pasted objects with regenerated 2D boxes (reference:
    generate_aug_scene.py:41-64 save_kitti_format)."""
    if len(boxes3d) == 0:
        return
    corners3d = corners_from_boxes3d(boxes3d)
    img_boxes, _ = calib.corners3d_to_img_boxes(corners3d)
    img_boxes[:, 0] = np.clip(img_boxes[:, 0], 0, img_shape[1] - 1)
    img_boxes[:, 1] = np.clip(img_boxes[:, 1], 0, img_shape[0] - 1)
    img_boxes[:, 2] = np.clip(img_boxes[:, 2], 0, img_shape[1] - 1)
    img_boxes[:, 3] = np.clip(img_boxes[:, 3], 0, img_shape[0] - 1)
    for k in range(boxes3d.shape[0]):
        x, z, ry = boxes3d[k, 0], boxes3d[k, 2], boxes3d[k, 6]
        beta = np.arctan2(z, x)
        alpha = -np.sign(beta) * np.pi / 2 + beta + ry
        print("%s %.2f %d %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f "
              "%.4f %.4f"
              % (class_name, obj_list[k].truncation, int(obj_list[k].occlusion),
                 alpha, img_boxes[k, 0], img_boxes[k, 1], img_boxes[k, 2],
                 img_boxes[k, 3], boxes3d[k, 3], boxes3d[k, 4], boxes3d[k, 5],
                 boxes3d[k, 0], boxes3d[k, 1], boxes3d[k, 2], boxes3d[k, 6]),
              file=fp)


class AugSceneGenerator(KittiDataset):
    def __init__(self, root_dir, gt_database, split="train", classes="Car",
                 include_similar=False, seed=0):
        super().__init__(root_dir, split=split)
        assert classes in CLASS_MAP
        self.classes = CLASS_MAP[classes]
        self.class_name = classes
        self.include_similar = include_similar
        self.gt_database = gt_database
        self.rng = np.random.default_rng(seed)

    def filtrate_objects(self, obj_list):
        whitelist = list(self.classes)
        if self.include_similar:
            if "Car" in self.classes:
                whitelist.append("Van")
            if "Pedestrian" in self.classes or "Cyclist" in self.classes:
                whitelist.append("Person_sitting")
        return [o for o in obj_list if o.cls_type in whitelist]

    def _check_pc_range(self, xyz):
        x_range, y_range, z_range = cfg.PC_AREA_SCOPE
        return (x_range[0] <= xyz[0] <= x_range[1]
                and y_range[0] <= xyz[1] <= y_range[1]
                and z_range[0] <= xyz[2] <= z_range[1])

    def aug_one_scene(self, sample_id, pts_rect, pts_intensity, all_gt_boxes3d):
        """Paste 10-15 db objects (reference: generate_aug_scene.py:151-234)."""
        extra_gt_num = int(self.rng.integers(10, 15))
        try_times = 50
        cnt = 0
        cur = all_gt_boxes3d.copy().reshape(-1, 7)
        if len(cur):
            cur[:, 4] += 0.5
            cur[:, 5] += 0.5
        extra_objs, extra_boxes = [], []
        new_pts, new_intensity = [], []
        keep = np.ones(pts_rect.shape[0], dtype=bool)
        a, b, c, d = self.get_road_plane(sample_id)

        while try_times > 0:
            try_times -= 1
            new_gt = self.gt_database[
                int(self.rng.integers(0, len(self.gt_database) - 1))]
            box = new_gt["gt_box3d"].copy()
            pts = new_gt["points"].copy()
            inten = new_gt["intensity"].copy()
            if not self._check_pc_range(box[0:3]):
                continue
            if cnt > extra_gt_num:
                break
            if len(pts) < 5:
                continue
            cur_height = (-d - a * box[0] - c * box[2]) / b
            move = box[1] - cur_height
            box[1] -= move
            pts[:, 1] -= move
            cnt += 1
            if len(cur) and boxes_iou3d_numpy(box.reshape(1, 7),
                                              cur).max() >= 1e-8:
                continue
            remove = box.copy()
            remove[3] += 2
            inside = points_in_boxes3d(pts_rect, remove.reshape(1, 7))[:, 0]
            keep[inside] = False
            new_pts.append(pts)
            new_intensity.append(inten)
            enlarged = box.copy()
            enlarged[4] += 0.5
            enlarged[5] += 0.5
            cur = np.concatenate([cur, enlarged.reshape(1, 7)], axis=0)
            extra_boxes.append(box.reshape(1, 7))
            import copy as _copy

            obj = _copy.deepcopy(new_gt["obj"])
            obj.t[1] -= move
            extra_objs.append(obj)

        if not new_pts:
            return False, pts_rect, pts_intensity, None, None
        pts_rect = np.concatenate([pts_rect[keep]] + new_pts, axis=0)
        pts_intensity = np.concatenate([pts_intensity[keep]] + new_intensity,
                                       axis=0)
        return (True, pts_rect, pts_intensity,
                np.concatenate(extra_boxes, axis=0), extra_objs)

    def aug_one_epoch_scene(self, base_id, data_dir, label_dir, split_list):
        for sid in self.image_idx_list:
            sample_id = int(sid)
            pts_lidar = self.get_lidar(sample_id)
            calib = self.get_calib(sample_id)
            pts_rect = calib.lidar_to_rect(pts_lidar[:, 0:3])
            pts_img, depth = calib.rect_to_img(pts_rect)
            img_shape = self.get_image_shape(sample_id)
            valid = ((pts_img[:, 0] >= 0) & (pts_img[:, 0] < img_shape[1])
                     & (pts_img[:, 1] >= 0) & (pts_img[:, 1] < img_shape[0])
                     & (depth >= 0))
            x_range, y_range, z_range = cfg.PC_AREA_SCOPE
            valid &= ((pts_rect[:, 0] >= x_range[0])
                      & (pts_rect[:, 0] <= x_range[1])
                      & (pts_rect[:, 1] >= y_range[0])
                      & (pts_rect[:, 1] <= y_range[1])
                      & (pts_rect[:, 2] >= z_range[0])
                      & (pts_rect[:, 2] <= z_range[1]))
            pts_rect = pts_rect[valid][:, 0:3]
            pts_intensity = pts_lidar[valid][:, 3]

            all_objs = [o for o in self.get_label(sample_id)
                        if o.cls_type != "DontCare"]
            all_gt_boxes3d = objs_to_boxes3d(all_objs)
            obj_list = self.filtrate_objects(self.get_label(sample_id))
            if self.class_name != "Car" and len(obj_list) == 0:
                continue

            aug_flag, pts_rect, pts_intensity, extra_boxes, extra_objs = \
                self.aug_one_scene(sample_id, pts_rect, pts_intensity,
                                   all_gt_boxes3d)
            info = np.concatenate([pts_rect, pts_intensity.reshape(-1, 1)],
                                  axis=1)
            info.astype(np.float32).tofile(
                os.path.join(data_dir, "%06d.bin" % (base_id + sample_id)))
            with open(os.path.join(label_dir,
                                   "%06d.txt" % (base_id + sample_id)),
                      "w") as f:
                for obj in obj_list:
                    print(obj.to_kitti_format(), file=f)
                if aug_flag:
                    save_extra_objects_kitti(calib, extra_boxes, extra_objs,
                                             img_shape, f, self.class_name)
            split_list.append("%06d" % (base_id + sample_id))

    def generate_aug_scene(self, save_dir, aug_times=4):
        data_dir = os.path.join(save_dir, "rectified_data")
        label_dir = os.path.join(save_dir, "aug_label")
        os.makedirs(data_dir, exist_ok=True)
        os.makedirs(label_dir, exist_ok=True)
        split_list = list(self.image_idx_list)
        for epoch in range(aug_times):
            self.aug_one_epoch_scene((epoch + 1) * 400000, data_dir, label_dir,
                                     split_list)
        split_file = os.path.join(save_dir, f"{self.split}_aug.txt")
        with open(split_file, "w") as f:
            f.write("\n".join(split_list))
        return split_file


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--save_dir", type=str, required=True)
    parser.add_argument("--root", type=str, default="../data/")
    parser.add_argument("--class_name", type=str, default="Car")
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("--gt_database_dir", type=str, required=True)
    parser.add_argument("--aug_times", type=int, default=4)
    parser.add_argument("--include_similar", action="store_true")
    args = parser.parse_args(argv)
    with open(args.gt_database_dir, "rb") as f:
        gt_database = pickle.load(f)
    gen = AugSceneGenerator(root_dir=args.root, gt_database=gt_database,
                            split=args.split, classes=args.class_name,
                            include_similar=args.include_similar)
    return gen.generate_aug_scene(args.save_dir, args.aug_times)


if __name__ == "__main__":
    main()
