"""Synthetic lidar scenes: uniform clutter with planted car clusters, for
inference and, with their gt boxes, for training; and synthetic KITTI-format
datasets on disk for the loader and the training CLI.

``plant_clusters`` is the port's own copy of ``__graft_entry__.plant_clusters``
and ``create_synthetic_kitti`` of ``tpu3d/datasets/synthetic.py``'s (numpy
only); ``tests/test_torch_data.py`` holds the files it writes byte-equal to
tpu3d's.
"""

from __future__ import annotations

import os

import numpy as np

from ..kitti import Calibration
from ..kitti.boxes import corners_from_boxes3d

# (x, z, ry) of eight car-sized gt boxes spread over the 0-70 m depth range
GT_SITES = [(0, 20, 0.3), (-5, 35, -1.0), (10, 50, 0.8), (-15, 15, 0.0),
            (18, 30, 1.2), (-22, 55, -0.4), (5, 65, 2.0), (-10, 45, 0.5)]


def plant_clusters(pts, gt, rng, k=48):
    """Overwrite the first ``k`` points per gt box with points INSIDE it
    (KITTI box: (x, y, z) = bottom center, y down, ry about y). Uniform
    scenes have ~2 points per car volume; clusters give the detector real
    foreground structure, like lidar returns on a car."""
    out = np.array(pts)
    for b in range(pts.shape[0]):
        i = 0
        for box in gt[b][np.abs(gt[b]).sum(1) > 0]:
            x, y, z, h, w, l, ry = [float(v) for v in box]
            local = rng.uniform([-l / 2, -h, -w / 2], [l / 2, 0, w / 2],
                                size=(k, 3))
            c_, s_ = np.cos(ry), np.sin(ry)
            rot = np.stack([local[:, 0] * c_ + local[:, 2] * s_, local[:, 1],
                            -local[:, 0] * s_ + local[:, 2] * c_], 1)
            out[b, i:i + k] = rot + [x, y, z]
            i += k
    return out.astype(np.float32)


def _gt_boxes(batch: int) -> np.ndarray:
    gt = np.zeros((batch, len(GT_SITES), 7), np.float32)
    for j, (gx, gz, gry) in enumerate(GT_SITES):
        gt[:, j] = [gx, 1.6, gz, 1.5, 1.6, 3.9, gry]
    return gt


def random_scenes(batch: int, n_points: int, seed: int) -> np.ndarray:
    """(B, N, 3) f32 points: uniform over the KITTI front area, with a
    cluster planted in each of eight car-sized gt boxes (GT_SITES)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-30, -1, 0], [30, 3, 70],
                      size=(batch, n_points, 3)).astype(np.float32)
    return plant_clusters(pts, _gt_boxes(batch), rng)


def train_batch(batch: int, n_points: int, seed: int, pad: int = 2) -> dict:
    """A training batch of planted-cluster scenes as numpy: ``pts_input``
    (B, N, 3) f32 and their gt boxes ``gt_boxes3d`` (B, G, 7) f32, zero
    rows for padding. Scene b keeps the first 8 − (b mod 3) of the GT_SITES
    boxes (and a cluster in each), so the scenes hold different numbers of
    boxes, then ``pad`` more zero rows."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-30, -1, 0], [30, 3, 70],
                      size=(batch, n_points, 3)).astype(np.float32)
    gt = np.zeros((batch, len(GT_SITES) + pad, 7), np.float32)
    full = _gt_boxes(batch)
    for b in range(batch):
        n = len(GT_SITES) - b % 3
        gt[b, :n] = full[b, :n]
    return {"pts_input": plant_clusters(pts, gt, rng), "gt_boxes3d": gt}


# ----- synthetic KITTI-format datasets on disk

KITTI_CALIB = """P0: 707.0493 0 604.0814 0 0 707.0493 180.5066 0 0 0 1 0
P1: 707.0493 0 604.0814 -379.7842 0 707.0493 180.5066 0 0 0 1 0
P2: 707.0493 0 604.0814 45.75831 0 707.0493 180.5066 -0.3454157 0 0 1 0.004981016
P3: 707.0493 0 604.0814 -334.1081 0 707.0493 180.5066 2.33966 0 0 1 0.003201153
R0_rect: 0.9999128 0.01009263 -0.008511932 -0.01012729 0.9999406 -0.004037671 0.008470675 0.004080907 0.9999558
Tr_velo_to_cam: 0.006927964 -0.9999722 -0.002757829 -0.02457729 -0.001162982 0.002749836 -0.9999955 -0.06127237 0.9999753 0.006931141 -0.001143899 -0.3321029
Tr_imu_to_velo: 0.9999976 0.0007553071 -0.002035826 -0.8086759 -0.0007854027 0.9998898 -0.01482298 0.3195559 0.002024406 0.01482454 0.9998881 -0.7997231
"""

IMG_SHAPE = (375, 1242)  # (h, w)


def _car_surface_points(rng, box, n):
    """Points on a crude car surface (sides + roof) in rect coords."""
    x, y, z, h, w, l, ry = box
    u = rng.uniform(-0.5, 0.5, n)
    v = rng.uniform(0, 1, n)
    face = rng.integers(0, 5, n)
    lx = np.where(face == 0, u * l, np.where(face == 1, -l / 2,
                  np.where(face == 2, l / 2, u * l)))
    lz = np.where(face == 0, -w / 2, np.where(face <= 2, u * w, w / 2))
    ly = np.where(face == 4, -h, -v * h)
    lx = np.where(face == 4, u * l, lx)
    lz = np.where(face == 4, (v - 0.5) * w, lz)
    c, s = np.cos(ry), np.sin(ry)
    wx = c * lx + s * lz + x
    wz = -s * lx + c * lz + z
    wy = ly + y
    return np.stack([wx, wy, wz], axis=1)


def _project_box2d(calib, box):
    corners = corners_from_boxes3d(box.reshape(1, 7))[0]
    uv = calib.project_rect_to_image(corners)
    x1 = np.clip(uv[:, 0].min(), 0, IMG_SHAPE[1])
    y1 = np.clip(uv[:, 1].min(), 0, IMG_SHAPE[0])
    x2 = np.clip(uv[:, 0].max(), 0, IMG_SHAPE[1])
    y2 = np.clip(uv[:, 1].max(), 0, IMG_SHAPE[0])
    return x1, y1, x2, y2


DEFAULT_CLASS_DIMS = {  # KITTI-like mean (h, w, l) per class
    "Car": (1.52, 1.63, 3.88),
    "Pedestrian": (1.76, 0.66, 0.84),
    "Cyclist": (1.74, 0.60, 1.76),
}


def create_synthetic_kitti(root: str, n_frames: int = 8, cars_per_frame=(2, 5),
                           n_bg_points: int = 14000, pts_per_car: int = 700,
                           seed: int = 0, splits=("train", "val"),
                           image_files: bool = False,
                           car_dims_mean=(1.52, 1.63, 3.88),
                           extra_classes=()) -> str:
    """Build <root>/KITTI/object/training/... + ImageSets. Returns root.

    extra_classes: additional object classes ("Pedestrian", "Cyclist") to
    place per frame (1-2 each, KITTI-like dimensions) — exercises the
    reference's default_cyclist / default_people configurations."""
    rng = np.random.default_rng(seed)
    obj_dir = os.path.join(root, "KITTI", "object", "training")
    for sub in ("velodyne", "calib", "label_2", "planes", "image_2"):
        os.makedirs(os.path.join(obj_dir, sub), exist_ok=True)
    imagesets = os.path.join(root, "KITTI", "ImageSets")
    os.makedirs(imagesets, exist_ok=True)

    names = ["%06d" % i for i in range(n_frames)]
    half = max(1, n_frames // 2)
    split_map = {"train": names[:half], "val": names[half:],
                 "trainval": names, "test": names[half:],
                 "train_car1": names[:half], "smallval": names[half:half + 2]}
    for split in set(list(splits) + ["trainval", "train_car1", "smallval"]):
        with open(os.path.join(imagesets, f"{split}.txt"), "w") as f:
            f.write("\n".join(split_map.get(split, names)) + "\n")

    calib_str = KITTI_CALIB
    for name in names:
        with open(os.path.join(obj_dir, "calib", f"{name}.txt"), "w") as f:
            f.write(calib_str)
        calib = Calibration(os.path.join(obj_dir, "calib", f"{name}.txt"))
        with open(os.path.join(obj_dir, "planes", f"{name}.txt"), "w") as f:
            f.write("# Plane\nWidth 4\nHeight 1\n0 -1 0 1.65\n")
        if image_files:
            from PIL import Image

            Image.new("RGB", (IMG_SHAPE[1], IMG_SHAPE[0])).save(
                os.path.join(obj_dir, "image_2", f"{name}.png"))

        n_cars = int(rng.integers(cars_per_frame[0], cars_per_frame[1] + 1))
        wanted = [("Car", car_dims_mean)] * n_cars
        for cls in extra_classes:
            for _ in range(int(rng.integers(1, 3))):
                wanted.append((cls, DEFAULT_CLASS_DIMS[cls]))
        boxes, classes, labels = [], [], []
        for cls, dims_mean in wanted:
            for _try in range(20):
                x = rng.uniform(-15, 15)
                z = rng.uniform(6, 65)
                ry = rng.uniform(-np.pi, np.pi)
                h = rng.normal(dims_mean[0], 0.05)
                w = rng.normal(dims_mean[1], 0.05)
                l = rng.normal(dims_mean[2], 0.2 if cls == "Car" else 0.05)
                box = np.array([x, 1.65, z, h, w, l, ry], np.float32)
                if all(np.hypot(b[0] - x, b[2] - z) > 4.0 for b in boxes):
                    boxes.append(box)
                    classes.append(cls)
                    break
        # background: ground plane + clutter in front of the camera
        gx = rng.uniform(-25, 25, n_bg_points)
        gz = rng.uniform(2, 69, n_bg_points)
        gy = np.where(rng.random(n_bg_points) < 0.8,
                      1.65 + rng.normal(0, 0.03, n_bg_points),
                      rng.uniform(-1.0, 1.6, n_bg_points))
        pts = [np.stack([gx, gy, gz], axis=1)]
        for box in boxes:
            pts.append(_car_surface_points(rng, box, pts_per_car))
        pts_rect = np.concatenate(pts).astype(np.float32)
        velo = calib.project_rect_to_velo(pts_rect).astype(np.float32)
        scan = np.concatenate(
            [velo, rng.uniform(0, 1, (len(velo), 1)).astype(np.float32)], axis=1)
        scan.tofile(os.path.join(obj_dir, "velodyne", f"{name}.bin"))

        for cls, box in zip(classes, boxes):
            x1, y1, x2, y2 = _project_box2d(calib, box)
            beta = np.arctan2(box[2], box[0])
            alpha = -np.sign(beta) * np.pi / 2 + beta + box[6]
            alpha = np.arctan2(np.sin(alpha), np.cos(alpha))
            labels.append(
                "%s 0.00 0 %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f "
                "%.2f %.2f" % (cls, alpha, x1, y1, x2, y2, box[3], box[4],
                               box[5], box[0], box[1], box[2], box[6]))
        with open(os.path.join(obj_dir, "label_2", f"{name}.txt"), "w") as f:
            f.write("\n".join(labels) + "\n")
    return root
