"""Standalone KITTI AP evaluator CLI with output-transformation ablations
(the port's copy of ``tpu3d/evaluate/evaluate.py``).

Reference parity: evaluate/evaluate.py. Usage:

    python -m tpu3d_torch.evaluate.evaluate --result_path <pred label dir> \
        --dataset_path <kitti-format root> --metric new [--device cpu]

The rotated overlaps run on the card unless ``--device cpu`` is given
(without a card and without it, the CLI raises); the greedy matcher runs
in the native C library (``evaluate/native.py``).

Output transformations (used in the paper to localize the domain gap):
  --toground      snap predicted box bottoms to the ground plane (planes/)
  --rescale_pred  scale all predicted dimensions by a ratio
  --align_size    copy matched GT dimensions when BEV IoU > 0.2
  --align_front   align_size + shift to keep the camera-facing face fixed
  --reverse_align apply the statnorm size mapping to GT dimensions
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

from ..device import resolve_device
from ..kitti import annos as kitti
from .ap import get_coco_eval_result, get_official_eval_result
from .overlaps import calculate_iou_partly

DATA_NAMES = ["kitti", "argo", "nusc", "lyft", "waymo"]


def _read_imageset_file(path: str) -> list[int]:
    with open(path) as f:
        return [int(line) for line in f if line.strip()]


def read_plane(fname: str) -> np.ndarray:
    """Ground plane (a, b, c, d) from a KITTI planes file's last line."""
    with open(fname) as f:
        return np.array([float(x) for x in f.readlines()[-1].split()])


def anno_to_ground(anno: dict, plane: np.ndarray) -> dict:
    """Shift box y so the bottom face sits on the ground plane
    (reference: evaluate/evaluate.py:26-28)."""
    a, b, c, d = plane
    loc = anno["location"]
    loc[:, 1] -= (-d - a * loc[:, 0] - c * loc[:, 2]) / b
    return anno


def annos_to_ground(annos: list[dict], plane_dir: str, ids: list[int]):
    for i, idx in enumerate(ids):
        plane = read_plane(os.path.join(plane_dir, "%06d.txt" % idx))
        annos[i] = anno_to_ground(annos[i], plane)
    return annos


def save_labels(annos: list[dict], out_dir: str, ids: list[int]) -> None:
    assert len(annos) == len(ids)
    os.makedirs(out_dir, exist_ok=True)
    for anno, idx in zip(annos, ids):
        kitti.to_kitti_format(anno, os.path.join(out_dir, "%06d.txt" % idx))


def get_dataset_name(s: str) -> str:
    """Last dataset name mentioned in a path (reference: evaluate.py:52-55)."""
    loc = [s.lower().rfind(x) for x in DATA_NAMES]
    return DATA_NAMES[int(np.argmax(np.array(loc)))]


def get_model_name(s: str) -> str:
    """First dataset name mentioned in a path (reference: evaluate.py:44-48)."""
    loc = np.array([s.find(x) for x in DATA_NAMES])
    loc[loc == -1] = 10000
    return DATA_NAMES[int(np.argmin(loc))]


def get_scale_map(src: dict, dst: dict):
    """Mean-shift size mapping on (l, h, w) stat dicts
    (reference: evaluate.py:66-73 get_scale_map_regular, the active default)."""
    return lambda x: np.stack([
        x[:, 0] - src["length"]["mean"] + dst["length"]["mean"],
        x[:, 1] - src["height"]["mean"] + dst["height"]["mean"],
        x[:, 2] - src["width"]["mean"] + dst["width"]["mean"],
    ], axis=1)


def _align_annos(dt_annos, gt_annos, align_front: bool, device=None):
    """Copy matched-GT dims into predictions (IoU_bev > 0.2); optionally shift the
    box to keep the camera-facing face fixed (reference: evaluate.py:187-230)."""
    overlaps, *_ = calculate_iou_partly(dt_annos, gt_annos, 1, device=device)
    for i in range(len(overlaps)):
        if len(dt_annos[i]["name"]) == 0 or len(gt_annos[i]["name"]) == 0:
            continue
        val = np.max(overlaps[i], axis=1)
        idx = np.argmax(overlaps[i], axis=1)
        for j in range(len(dt_annos[i]["name"])):
            if val[j] <= 0.2:
                continue
            if align_front:
                dt = dt_annos[i]
                gt_dims = gt_annos[i]["dimensions"][idx[j]]
                dist = np.linalg.norm(dt["location"][j])
                alpha = np.arctan2(np.sin(dt["alpha"][j]), np.cos(dt["alpha"][j]))
                # length axis: shift when the side face is visible
                if np.abs(np.sin(alpha)) * dist > dt["dimensions"][j, 2] / 2.0:
                    shift = (dt["dimensions"][j, 2] - gt_dims[2]) / 2.0
                    angle = (-dt["rotation_y"][j] if 0 < alpha
                             else -dt["rotation_y"][j] + np.pi)
                    dt["location"][j, 0] += shift * np.cos(angle)
                    dt["location"][j, 2] += shift * np.sin(angle)
                if np.abs(np.cos(alpha)) * dist > dt["dimensions"][j, 1] / 2.0:
                    shift = (dt["dimensions"][j, 1] - gt_dims[1]) / 2.0
                    angle = (-dt["rotation_y"][j] - np.pi / 2.0
                             if -np.pi / 2.0 < alpha < np.pi / 2.0
                             else -dt["rotation_y"][j] + np.pi / 2.0)
                    dt["location"][j, 0] += shift * np.cos(angle)
                    dt["location"][j, 2] += shift * np.sin(angle)
            dt_annos[i]["dimensions"][j] = gt_annos[i]["dimensions"][idx[j]]
    return dt_annos


def _write_with_iou(annos_main, overlaps_max, out_dir, ids):
    """Label files with a trailing best-IoU column (reference: evaluate.py:130-185)."""
    os.makedirs(out_dir, exist_ok=True)
    for i, idx in enumerate(ids):
        a = annos_main[i]
        lines = []
        for j in range(len(a["name"])):
            lines.append(
                "%s %.2f %d %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f "
                "%.2f %.2f %.2f %.2f"
                % (a["name"][j], a["truncated"][j], a["occluded"][j], a["alpha"][j],
                   a["bbox"][j, 0], a["bbox"][j, 1], a["bbox"][j, 2], a["bbox"][j, 3],
                   a["dimensions"][j, 1], a["dimensions"][j, 2], a["dimensions"][j, 0],
                   a["location"][j, 0], a["location"][j, 1], a["location"][j, 2],
                   a["rotation_y"][j], a["score"][j], overlaps_max[i][j]))
        with open(os.path.join(out_dir, "%06d.txt" % idx), "w") as f:
            f.write("\n".join(lines))


def evaluate(result_path, dataset_path=None, label_split_file=None,
             label_path=None, metric="new", dataset="kitti", current_class=0,
             coco=False, score_thresh=-1, toground=False, rescale_pred=None,
             align_size=False, align_front=False, reverse_align=False,
             dense_sample=False, direct_save=False, output_iou=False,
             adapted=False, stats_dir=None, range_check=False, device=None):
    """Full evaluator entry point (reference parity: evaluate/evaluate.py:84-275;
    range_check adds pointrcnn/tools/evaluate.py:88-101's sanity asserts —
    detections must stay under 80 m depth, labels under 70 m). The rotated
    overlaps run on ``device`` (default ``cuda``, which raises without a
    card)."""
    device = resolve_device(device)
    label_split_file = label_split_file or os.path.join(dataset_path, "val.txt")
    label_path = label_path or os.path.join(dataset_path, "training", "label_2")
    val_image_ids = _read_imageset_file(label_split_file)
    dt_annos = kitti.get_label_annos(result_path, val_image_ids)
    if range_check:
        for i, anno in enumerate(dt_annos):
            if len(anno["name"]) > 0:
                assert np.max(anno["location"][:, 2]) < 80, (
                    f"{os.path.join(result_path, '%06d.txt' % val_image_ids[i])}"
                    ", Some detection > 80m!!!")

    if score_thresh > 0:
        dt_annos = kitti.filter_annos_low_score(dt_annos, score_thresh)
    if toground:
        dt_annos = annos_to_ground(
            dt_annos, os.path.join(os.path.dirname(label_path), "planes"),
            val_image_ids)
        save_labels(dt_annos, os.path.join(os.path.dirname(result_path),
                                           "grounded"), val_image_ids)
    if rescale_pred is not None:
        for anno in dt_annos:
            anno["dimensions"] *= rescale_pred

    gt_annos = kitti.get_label_annos(label_path, val_image_ids)
    if range_check:
        for i, anno in enumerate(gt_annos):
            if len(anno["name"]) > 0:
                assert np.max(anno["location"][:, 2]) < 70, (
                    f"{os.path.join(label_path, '%06d.txt' % val_image_ids[i])}"
                    ", Some label > 70m!!!")

    if output_iou:
        overlaps, *_ = calculate_iou_partly(dt_annos, gt_annos, 1,
                                            device=device)
        dt_max = [np.max(o, axis=1) if o.size else np.zeros(o.shape[0])
                  for o in overlaps]
        gt_max = [np.max(o, axis=0) if o.size else np.zeros(o.shape[1])
                  for o in overlaps]
        base = os.path.dirname(result_path)
        _write_with_iou(dt_annos, dt_max, os.path.join(base, "with_iou"),
                        val_image_ids)
        gt_with_scores = []
        for g in gt_annos:
            g = dict(g)
            if len(g["score"]) != len(g["name"]):
                g["score"] = np.zeros(len(g["name"]))
            gt_with_scores.append(g)
        _write_with_iou(gt_with_scores, gt_max, os.path.join(base, "with_iou_gt"),
                        val_image_ids)
        return None, None

    if align_size or align_front:
        dt_annos = _align_annos(dt_annos, gt_annos, align_front=align_front,
                                device=device)
        tag = "align_front" if align_front else "align_size"
        save_labels(dt_annos, os.path.join(os.path.dirname(result_path), tag),
                    val_image_ids)

    if reverse_align:
        src_name = get_model_name(label_path)
        dst_name = get_model_name(result_path)
        stats_dir = stats_dir or os.path.dirname(label_path)
        with open(os.path.join(stats_dir, f"label_stats_{src_name}.json")) as f:
            src = json.load(f)
        with open(os.path.join(stats_dir, f"label_stats_{dst_name}.json")) as f:
            dst = json.load(f)
        mapping = get_scale_map(src, dst)
        for g in gt_annos:
            if len(g["name"]) > 0:
                g["dimensions"] = mapping(g["dimensions"])
        save_labels(gt_annos, os.path.join(os.path.dirname(result_path),
                                           "reverse_align"), val_image_ids)

    if coco:
        return get_coco_eval_result(gt_annos, dt_annos, current_class, dataset,
                                    metric_mode=metric, device=device), None
    ap_result_str, ap_dict = get_official_eval_result(
        gt_annos, dt_annos, current_class, dataset, metric_mode=metric,
        dense_sample=dense_sample, device=device)
    if direct_save:
        base = os.path.dirname(result_path)
        fname = os.path.basename(base) + "_val20"
        for flag, tag in ((toground, "_ground"), (align_size, "_align_size"),
                          (reverse_align, "_reverse_align"), (adapted, "_adapted")):
            if flag:
                fname += tag
        with open(os.path.join(os.path.dirname(base), fname + ".pkl"), "wb") as fb:
            pickle.dump(ap_dict["result"], fb)
        with open(os.path.join(os.path.dirname(base), fname + ".txt"), "w") as f:
            f.write(ap_result_str)
    return ap_result_str, ap_dict


def main(argv=None):
    parser = argparse.ArgumentParser(description="KITTI rotated-IoU AP evaluator")
    parser.add_argument("--result_path", type=str, required=True,
                        help="predictions to be evaluated")
    parser.add_argument("--dataset_path", type=str, default=None,
                        help="KITTI format dataset path")
    parser.add_argument("--label_split_file", type=str, default=None)
    parser.add_argument("--label_path", type=str, default=None)
    parser.add_argument("--metric", type=str, default="new",
                        choices=["new", "old"])
    parser.add_argument("--dataset", type=str, default="kitti",
                        choices=DATA_NAMES)
    parser.add_argument("--current_class", type=int, default=0,
                        choices=range(5))
    parser.add_argument("--score_thresh", type=float, default=-1)
    parser.add_argument("--toground", action="store_true")
    parser.add_argument("--rescale_pred", type=float, default=None)
    parser.add_argument("--align_size", action="store_true")
    parser.add_argument("--align_front", action="store_true")
    parser.add_argument("--reverse_align", action="store_true")
    parser.add_argument("--dense_sample", action="store_true")
    parser.add_argument("--direct_save", action="store_true")
    parser.add_argument("--output_iou", action="store_true")
    parser.add_argument("--range_check", action="store_true",
                        help="assert detections < 80m and labels < 70m depth "
                             "(reference tools/evaluate.py sanity checks)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the rotated overlaps run: cuda "
                             "(default) or cpu")
    args = parser.parse_args(argv)
    assert args.dataset_path is not None or (
        args.label_split_file is not None and args.label_path is not None)
    info, ret = evaluate(**vars(args))
    if info:
        print(info)
    return info, ret


if __name__ == "__main__":
    main()
