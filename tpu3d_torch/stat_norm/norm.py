"""Statistical normalization, the paper's domain-adaptation method: the
port's copy of ``tpu3d/stat_norm/norm.py``.

For each (src, dst) dataset pair, every labeled car's point-cloud patch
and 3D box is rescaled from the source domain's size statistics to the
target's (arXiv:2005.08139 §4). It runs on the host in numpy, one object
at a time, as tpu3d computes it; the files it writes are tpu3d's: velodyne
``.bin`` with reflectance 1.0 and ``label_2/*.txt`` through
``Object3d.to_kitti_format``.
"""

from __future__ import annotations

import argparse
import copy
import json
import multiprocessing as _mp
import os
import shutil

import numpy as np

from ..config.paths import dataset_path, dataset_paths, datasets
from ..kitti import Calibration, load_velo_scan, read_label

mp = _mp.get_context("spawn")

_CAR_SALES_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "car_sales")


def load_json(fname: str) -> dict:
    with open(fname) as f:
        return json.load(f)


def car_sales_stats() -> dict:
    """External car-sales size stats: Germany for KITTI, US for the US datasets
    (reference: norm.py:30-39; stat_norm/car_sales/{us,germany}.json)."""
    us = load_json(os.path.join(_CAR_SALES_PATH, "us.json"))
    germany = load_json(os.path.join(_CAR_SALES_PATH, "germany.json"))
    return {"kitti": germany, "argo": us, "nusc": us, "lyft": us, "waymo": us}


def format_lidar_data(x: np.ndarray, dst: str) -> None:
    """Write (N, 3) rect->velo points as KITTI .bin with reflectance 1.0."""
    x = np.concatenate(
        [x, np.ones((x.shape[0], 1), dtype=np.float32)], axis=1
    ).astype(np.float32)
    x.reshape(-1).tofile(dst)


def save_labels(labels, dst: str) -> None:
    with open(dst, "w") as f:
        f.write("\n".join(obj.to_kitti_format() for obj in labels))


def single_scale(x: float, src: dict, dst: dict, ratio: float = 1.0) -> float:
    """Mean-shift size mapping: x + (dst_mean − src_mean)·ratio
    (reference: norm.py:54-56 — the std-matching variant is commented out there)."""
    return x + (dst["mean"] - src["mean"]) * ratio


def get_scale_map(src: dict, dst: dict):
    """obj, ratio -> (1, 3) multiplicative factors in (l, h, w) axis order."""
    def mapping(obj, ratio):
        target = np.array([
            single_scale(obj.l, src["length"], dst["length"], ratio),
            single_scale(obj.h, src["height"], dst["height"], ratio),
            single_scale(obj.w, src["width"], dst["width"], ratio),
        ])
        return (target / np.array([obj.l, obj.h, obj.w])).reshape(1, 3)

    return mapping


def get_image_size(path: str) -> tuple[int, int]:
    """(width, height) of the dataset's first train image (norm.py:67-71)."""
    from PIL import Image

    with open(os.path.join(path, "train.txt")) as f:
        sample = f.readlines()[0].rstrip()
    with Image.open(os.path.join(path, "training", "image_2",
                                 f"{sample}.png")) as img:
        return img.size


def _roty(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _align_front_shift(obj, new_lhw, pts_or_point):
    """Shift a patch/center so the camera-facing faces stay fixed when the box
    resizes (reference: norm.py:162-179 / :220-240 — same formula both places).

    ``new_lhw`` is the post-scaling (l, h, w). Mutates and returns pts_or_point
    (works for (N, 3) patches and (3,) centers alike).
    """
    l_new, _, w_new = new_lhw
    dist = np.linalg.norm(obj.t)
    alpha = np.arctan2(np.sin(obj.alpha), np.cos(obj.alpha))
    if np.abs(np.sin(alpha)) * dist > obj.l / 2.0:
        shift = (obj.l - l_new) / 2.0
        angle = -obj.ry if 0 < alpha else -obj.ry + np.pi
        pts_or_point[..., 0] += shift * np.cos(angle)
        pts_or_point[..., 2] += shift * np.sin(angle)
    if np.abs(np.cos(alpha)) * dist > obj.w / 2.0:
        shift = (obj.w - w_new) / 2.0
        angle = (-obj.ry - np.pi / 2.0 if -np.pi / 2.0 < alpha < np.pi / 2.0
                 else -obj.ry + np.pi / 2.0)
        pts_or_point[..., 0] += shift * np.cos(angle)
        pts_or_point[..., 2] += shift * np.sin(angle)
    return pts_or_point


def rescale_ptc(mapping, velo: np.ndarray, labels, calib: Calibration,
                avoid_conflict: bool = False, align_front: bool = False,
                rescaled_classes=("Car", "Van")):
    """Rescale each labeled car's point patch; returns (new velo xyz, ratios).

    Reference parity: norm.py:186-244 —
    - points strictly inside the (unenlarged) box are rotated to the box frame,
      scaled anisotropically by the mapping factors, rotated back;
    - ``avoid_conflict`` backs the ratio off 1.0→0 in 0.1 steps until fewer than
      10 new environment points (y < −0.5 in the box frame) fall inside the
      scaled patch bounds;
    - output point order is [patches in object order..., untouched points],
      duplicating points that sit inside overlapping boxes (as the reference does);
    - objects with zero interior points keep ratio 0 (their labels stay unscaled).
    """
    ptc = calib.project_velo_to_rect(velo[:, :3])
    new_ptc = []
    keep = np.ones(ptc.shape[0], dtype=bool)
    ratios = []

    for obj in labels:
        if obj.cls_type not in rescaled_classes:
            continue
        R = _roty(obj.ry)
        local = (ptc - obj.t) @ R  # box-frame coords (x=length, y=up-neg, z=width)
        inside = ((local[:, 0] > -obj.l / 2.0) & (local[:, 0] < obj.l / 2.0)
                  & (local[:, 1] > -obj.h) & (local[:, 1] < 0)
                  & (local[:, 2] > -obj.w / 2.0) & (local[:, 2] < obj.w / 2.0))
        ratio = 0.0
        env0 = ((local[:, 0] > -obj.l / 2.0) & (local[:, 0] < obj.l / 2.0)
                & (local[:, 1] > -obj.h) & (local[:, 1] < -0.5)
                & (local[:, 2] > -obj.w / 2.0) & (local[:, 2] < obj.w / 2.0))
        if np.sum(inside) > 0:
            keep[inside] = False
            if avoid_conflict:
                for ratio in np.arange(1, -0.1, -0.1):
                    patch = local[inside] * mapping(obj, ratio)
                    env = ((local[:, 0] > np.min(patch[:, 0]))
                           & (local[:, 0] < np.max(patch[:, 0]))
                           & (local[:, 1] > np.min(patch[:, 1]))
                           & (local[:, 1] < -0.5)
                           & (local[:, 2] > np.min(patch[:, 2]))
                           & (local[:, 2] < np.max(patch[:, 2])))
                    if np.sum(env) - np.sum(env0) < 10:
                        break
            else:
                ratio = 1.0
                patch = local[inside] * mapping(obj, ratio)
            patch_world = patch @ R.T + obj.t
            if align_front:
                new_lhw = (np.array([obj.l, obj.h, obj.w])
                           * mapping(obj, ratio).reshape(-1))
                patch_world = _align_front_shift(obj, new_lhw, patch_world)
            new_ptc.append(patch_world)
        ratios.append(ratio)
    out = np.concatenate(new_ptc + [ptc[keep]], axis=0)
    return calib.project_rect_to_velo(out), ratios


def _gen_obj_corners(obj) -> np.ndarray:
    """(8, 3) corners, top face first (norm.py:92-115 ordering; min/max use only)."""
    R = _roty(obj.ry)
    x_c = np.array([obj.l / 2, obj.l / 2, -obj.l / 2, -obj.l / 2] * 2)
    y_c = np.array([-obj.h] * 4 + [0.0] * 4)
    z_c = np.array([obj.w / 2, -obj.w / 2, -obj.w / 2, obj.w / 2] * 2)
    corners = R @ np.vstack([x_c, y_c, z_c])
    return (corners + np.asarray(obj.t, dtype=np.float64).reshape(3, 1)).T


def refine(obj, calib: Calibration, w: int, h: int):
    """Regenerate the 2D box from the (rescaled) 3D box, clipped to the image
    (reference: norm.py:118-130)."""
    uv = calib.project_rect_to_image3(_gen_obj_corners(obj))
    bbox = [float(np.min(uv[:, 0])), float(np.min(uv[:, 1])),
            float(np.max(uv[:, 0])), float(np.max(uv[:, 1]))]
    obj.box2d = np.array([max(0, bbox[0]), max(0, bbox[1]),
                          min(w, bbox[2]), min(h, bbox[3])])
    return obj


def postprocessing(objs, w: int, h: int, fix_occlusion_field: bool = False):
    """Depth-ordered 2D paint-over visibility estimate (reference: norm.py:133-145).

    NOTE: the reference stores the estimated occlusion tier into the *truncation*
    field (`obj.trucation = int(...)`, norm.py:144) — almost certainly a typo for
    occlusion, but it is what the paper's pipeline shipped, so it is the default.
    Pass fix_occlusion_field=True to write the occlusion field instead.
    """
    canvas = np.full((h, w), -1, dtype=np.int64)
    objs = sorted(objs, key=lambda x: x.t[2], reverse=True)
    for i, obj in enumerate(objs):
        canvas[int(round(obj.box2d[1])): int(round(obj.box2d[3])),
               int(round(obj.box2d[0])): int(round(obj.box2d[2]))] = i
    unique, counts = np.unique(canvas, return_counts=True)
    visible = dict(zip(unique.tolist(), counts.tolist()))
    for i, obj in enumerate(objs):
        area = (obj.box2d[3] - obj.box2d[1]) * (obj.box2d[2] - obj.box2d[0])
        occlusion = 1.0 - visible.get(i, 0) / area
        tier = int(np.clip(occlusion * 4, 0, 3))
        if fix_occlusion_field:
            obj.occlusion = tier
        else:
            obj.truncation = tier
    return objs


def regenerate_labels(objs, calib, w, h, fix_occlusion_field=False):
    for i in range(len(objs)):
        objs[i] = refine(objs[i], calib, w, h)
    return postprocessing(objs, w, h, fix_occlusion_field)


def scale_labels(objs, mapping, ratios, calib, w0, h0, align_front=False,
                 rescaled_classes=("Car", "Van"), fix_occlusion_field=False):
    """Apply the size mapping (with the per-object ratios chosen during point
    rescaling) to labels and regenerate 2D boxes/visibility
    (reference: norm.py:154-183)."""
    new_objs = []
    cnt = 0
    for obj in objs:
        _obj = copy.deepcopy(obj)
        if obj.cls_type in rescaled_classes:
            l, h, w = (np.array([obj.l, obj.h, obj.w])
                       * mapping(obj, ratios[cnt]).reshape(-1)).tolist()
            if align_front:
                _align_front_shift(obj, (l, h, w), _obj.t)
            _obj.l, _obj.h, _obj.w = l, h, w
            cnt += 1
        new_objs.append(_obj)
    return regenerate_labels(new_objs, calib, w0, h0, fix_occlusion_field)


def convert(src: str, dst: str, spath: str | None = None,
            dpath: str | None = None, image_folder: str = "image_2",
            calib_folder: str = "calib", label_folder: str = "label_2",
            use_car_sales_stats: bool = False, avoid_conflict: bool = False,
            align_front: bool = False, rescaled_classes=("Car", "Van"),
            image_size: tuple[int, int] | None = None,
            fix_occlusion_field: bool = False,
            dst_stats_path: str | None = None) -> str:
    """Produce rescaled_datasets/{src}_scaledto_{dst} from the src dataset
    (reference parity: norm.py:247-307 — identical directory layout: copied
    split files, symlinked image_2/calib, regenerated velodyne/ + label_2/;
    DontCare objects are dropped from the output labels)."""
    spath = spath or dataset_paths[src]

    if use_car_sales_stats:
        ext = car_sales_stats()
        mapping = get_scale_map(ext[src], ext[dst])
    else:
        src_stats = load_json(os.path.join(spath, "label_stats_train.json"))
        dst_stats = load_json(os.path.join(
            dst_stats_path or dataset_paths[dst], "label_stats_train.json"))
        mapping = get_scale_map(src_stats, dst_stats)

    w, h = image_size or get_image_size(spath)

    dpath = dpath or os.path.join(dataset_path, "rescaled_datasets")
    root = os.path.join(dpath, f"{src}_scaledto_{dst}")
    os.makedirs(root, exist_ok=True)
    for split in ["train", "val", "trainval"]:
        shutil.copyfile(os.path.join(spath, f"{split}.txt"),
                        os.path.join(root, f"{split}.txt"))

    root = os.path.join(root, "training")
    os.makedirs(root, exist_ok=True)
    for link_name, src_folder in (("image_2", image_folder),
                                  ("calib", calib_folder)):
        link = os.path.join(root, link_name)
        if os.path.islink(link) or os.path.exists(link):
            os.remove(link)
        os.symlink(os.path.join(spath, "training", src_folder), link)
    os.makedirs(os.path.join(root, "velodyne"), exist_ok=True)
    os.makedirs(os.path.join(root, label_folder), exist_ok=True)

    with open(os.path.join(spath, "trainval.txt")) as f:
        names = [x.strip() for x in f if x.strip()]

    for name in names:
        ptc = load_velo_scan(
            os.path.join(spath, "training", "velodyne", f"{name}.bin"))
        calib = Calibration(
            os.path.join(spath, "training", calib_folder, f"{name}.txt"))
        labels = read_label(
            os.path.join(spath, "training", label_folder, f"{name}.txt"))
        labels = [obj for obj in labels if obj.cls_type != "DontCare"]

        new_ptc, ratios = rescale_ptc(
            mapping, ptc, labels, calib, avoid_conflict=avoid_conflict,
            align_front=align_front, rescaled_classes=rescaled_classes)
        format_lidar_data(new_ptc, os.path.join(root, "velodyne", f"{name}.bin"))
        labels = scale_labels(
            labels, mapping, ratios, calib, w, h, align_front=align_front,
            rescaled_classes=rescaled_classes,
            fix_occlusion_field=fix_occlusion_field)
        save_labels(labels, os.path.join(root, label_folder, f"{name}.txt"))
    return os.path.dirname(root)


def launch_rescale(**kwargs) -> None:
    """One process per (src, dst) pair, all 20 pairs (reference: norm.py:310-322)."""
    processes = []
    for src in datasets:
        for dst in datasets:
            if src != dst:
                p = mp.Process(target=convert, args=(src, dst), kwargs=kwargs)
                p.start()
                processes.append(p)
    for p in processes:
        p.join()
    dpath = kwargs.get("dpath") or os.path.join(dataset_path,
                                                "rescaled_datasets")
    print(f"Rescaled datasets have been generated to {dpath}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="statistical normalization")
    parser.add_argument("--path", type=str,
                        default=os.path.join(dataset_path, "rescaled_datasets"),
                        help="path to store converted datasets")
    parser.add_argument("--avoid_conflict", action="store_true")
    parser.add_argument("--align_front", action="store_true")
    parser.add_argument("--use_car_sales_stats", action="store_true")
    args = parser.parse_args()
    launch_rescale(dpath=args.path, avoid_conflict=args.avoid_conflict,
                   align_front=args.align_front,
                   use_car_sales_stats=args.use_car_sales_stats)
