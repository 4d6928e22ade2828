"""Build the GT-augmentation object database: per-object point patches.

The port's copy of ``tpu3d/tools/generate_gt_database.py``, held equal to it by the port's
tests.

Reference parity: pointrcnn/tools/generate_gt_database.py — crops the points
inside every Easy/Moderate/Hard object of the target class into
{split}_gt_database_3level_{cls}.pkl, each entry {sample_id, cls_type, gt_box3d,
points, intensity, obj}. The point-in-box test is the analytic rotated-box mask
(replacing roipool3d's pts_in_boxes3d_cpu).
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from ..datasets.kitti_dataset import KittiDataset
from ..kitti.boxes import points_in_boxes3d
from ..kitti.object3d import objs_to_boxes3d

CLASS_MAP = {
    "Car": ("Background", "Car"),
    "People": ("Background", "Pedestrian", "Cyclist"),
    "Pedestrian": ("Background", "Pedestrian"),
    "Cyclist": ("Background", "Cyclist"),
}


class GTDatabaseGenerator(KittiDataset):
    def __init__(self, root_dir, split="train", classes="Car", subsample=-1,
                 shuffle_subsample=None):
        super().__init__(root_dir, split=split, subsample=subsample,
                         shuffle_subsample=shuffle_subsample)
        assert classes in CLASS_MAP, f"Invalid classes: {classes}"
        self.classes = CLASS_MAP[classes]

    def filtrate_objects(self, obj_list):
        return [obj for obj in obj_list
                if obj.cls_type in self.classes
                and obj.level_str in ("Easy", "Moderate", "Hard")]

    def generate_gt_database(self, save_dir: str, split_name: str) -> str:
        gt_database = []
        for sample_id in self.image_idx_list:
            sample_id = int(sample_id)
            pts_lidar = self.get_lidar(sample_id)
            calib = self.get_calib(sample_id)
            pts_rect = calib.lidar_to_rect(pts_lidar[:, 0:3])
            pts_intensity = pts_lidar[:, 3]

            obj_list = self.filtrate_objects(self.get_label(sample_id))
            if len(obj_list) == 0:
                continue
            gt_boxes3d = objs_to_boxes3d(obj_list)
            inside = points_in_boxes3d(pts_rect, gt_boxes3d)  # (N, M)
            for k, obj in enumerate(obj_list):
                mask = inside[:, k]
                gt_database.append({
                    "sample_id": sample_id,
                    "cls_type": obj.cls_type,
                    "gt_box3d": gt_boxes3d[k],
                    "points": pts_rect[mask].astype(np.float32),
                    "intensity": pts_intensity[mask].astype(np.float32),
                    "obj": obj,
                })
        os.makedirs(save_dir, exist_ok=True)
        save_file = os.path.join(
            save_dir, f"{split_name}_gt_database_3level_{self.classes[-1]}.pkl")
        with open(save_file, "wb") as f:
            pickle.dump(gt_database, f)
        print(f"saved {len(gt_database)} objects to {save_file}")
        return save_file


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--save_dir", type=str, default="./gt_database")
    parser.add_argument("--root", type=str, default="../data/")
    parser.add_argument("--class_name", type=str, default="Car")
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("--subsample", type=int, default=-1)
    parser.add_argument("--shuffle_subsample", type=str, default=None)
    args = parser.parse_args(argv)
    gen = GTDatabaseGenerator(root_dir=args.root, split=args.split,
                              classes=args.class_name, subsample=args.subsample,
                              shuffle_subsample=args.shuffle_subsample)
    return gen.generate_gt_database(args.save_dir, args.split)


if __name__ == "__main__":
    main()
