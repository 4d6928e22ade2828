"""Base KITTI-format dataset accessors (host numpy).

The port's copy of ``tpu3d/datasets/kitti_dataset.py``, held equal to it by the port's
tests.

Reference parity: lib/datasets/kitti_dataset.py — same directory layout
(KITTI/object/{training,testing}, KITTI/ImageSets/{split}.txt), same subsample /
train_car1 shuffle behavior, same road-plane normalization.
"""

from __future__ import annotations

import os
import random

import numpy as np

from ..kitti import Calibration, get_road_plane, load_velo_scan, read_label


class KittiDataset:
    def __init__(self, root_dir: str, split: str = "train", subsample: int = -1,
                 shuffle_subsample=None):
        self.split = split
        is_test = split == "test"
        self.imageset_dir = os.path.join(
            root_dir, "KITTI", "object", "testing" if is_test else "training")

        if subsample > 0 and split == "train":
            if shuffle_subsample is not None:
                split_dir = os.path.join(
                    root_dir, "KITTI", "ImageSets",
                    f"train_car1_{shuffle_subsample}.txt")
                if not os.path.isfile(split_dir):
                    base = os.path.join(root_dir, "KITTI", "ImageSets",
                                        "train_car1.txt")
                    ids = [x.strip() for x in open(base)]
                    random.shuffle(ids)
                    with open(split_dir, "w") as f:
                        f.write("\n".join(ids) + "\n")
            else:
                split_dir = os.path.join(root_dir, "KITTI", "ImageSets",
                                         "train_car1.txt")
            self.image_idx_list = [x.strip() for x in open(split_dir)][:subsample]
        else:
            split_dir = os.path.join(root_dir, "KITTI", "ImageSets",
                                     split + ".txt")
            self.image_idx_list = [x.strip() for x in open(split_dir)
                                   if x.strip()]
        self.num_sample = len(self.image_idx_list)

        self.image_dir = os.path.join(self.imageset_dir, "image_2")
        self.lidar_dir = os.path.join(self.imageset_dir, "velodyne")
        self.calib_dir = os.path.join(self.imageset_dir, "calib")
        self.label_dir = os.path.join(self.imageset_dir, "label_2")
        self.plane_dir = os.path.join(self.imageset_dir, "planes")

    def get_image_shape(self, idx: int) -> tuple[int, int, int]:
        from PIL import Image

        img_file = os.path.join(self.image_dir, "%06d.png" % idx)
        with Image.open(img_file) as im:
            width, height = im.size
        return height, width, 3

    def get_lidar(self, idx: int) -> np.ndarray:
        return load_velo_scan(os.path.join(self.lidar_dir, "%06d.bin" % idx))

    def get_calib(self, idx: int) -> Calibration:
        return Calibration(os.path.join(self.calib_dir, "%06d.txt" % idx))

    def get_label(self, idx: int):
        return read_label(os.path.join(self.label_dir, "%06d.txt" % idx))

    def get_road_plane(self, idx: int) -> np.ndarray:
        return get_road_plane(os.path.join(self.plane_dir, "%06d.txt" % idx))
