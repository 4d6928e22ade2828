"""KITTI annotations as dicts of arrays ("annos") — the evaluator-facing data model.

The port's copy of ``tpu3d/kitti/annos.py``, held equal to it by the port's
tests.

One canonical implementation replacing the reference's two copies
(utils/kitti_common.py and evaluate/kitti_common.py).

An anno dict has keys: name (str array), truncated, occluded (int), alpha,
bbox (N,4 [x1,y1,x2,y2]), dimensions (N,3 stored **lhw**, converted from the label
file's hwl — reference: evaluate/kitti_common.py:331-334), location (N,3 xyz rect),
rotation_y (N,), score (N,), and optionally difficulty (N,) int.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np

ANNO_KEYS = (
    "name", "truncated", "occluded", "alpha", "bbox", "dimensions", "location",
    "rotation_y", "score",
)


def image_index_str(img_idx: int) -> str:
    return "{:06d}".format(img_idx)


def empty_anno() -> dict:
    return {
        "name": np.array([], dtype="<U16"),
        "truncated": np.array([], dtype=np.float64),
        "occluded": np.array([], dtype=np.int64),
        "alpha": np.array([], dtype=np.float64),
        "bbox": np.zeros((0, 4), dtype=np.float64),
        "dimensions": np.zeros((0, 3), dtype=np.float64),
        "location": np.zeros((0, 3), dtype=np.float64),
        "rotation_y": np.array([], dtype=np.float64),
        "score": np.array([], dtype=np.float64),
    }


def get_label_anno(label_path) -> dict:
    """Parse one KITTI label file into an anno dict
    (reference parity: evaluate/kitti_common.py:307-343)."""
    with open(label_path) as f:
        content = [line.strip().split(" ") for line in f if line.strip()]
    if len(content) == 0:
        return empty_anno()
    anno = {
        "name": np.array([x[0] for x in content]),
        "truncated": np.array([float(x[1]) for x in content]),
        "occluded": np.array([int(float(x[2])) for x in content]),
        "alpha": np.array([float(x[3]) for x in content]),
        "bbox": np.array([[float(v) for v in x[4:8]] for x in content]).reshape(-1, 4),
        # stored as lhw (file order is hwl)
        "dimensions": np.array(
            [[float(v) for v in x[8:11]] for x in content]
        ).reshape(-1, 3)[:, [2, 0, 1]],
        "location": np.array(
            [[float(v) for v in x[11:14]] for x in content]
        ).reshape(-1, 3),
        "rotation_y": np.array([float(x[14]) for x in content]).reshape(-1),
    }
    if len(content[0]) == 16:
        anno["score"] = np.array([float(x[15]) for x in content])
    else:
        anno["score"] = np.zeros([len(anno["bbox"])])
    return anno


def get_label_annos(label_folder, image_ids=None) -> list[dict]:
    """Load anno dicts for a directory of label files
    (reference parity: evaluate/kitti_common.py:345-360)."""
    label_folder = pathlib.Path(label_folder)
    if image_ids is None:
        prog = re.compile(r"^\d{6}.txt$")
        paths = filter(lambda f: prog.match(f.name), label_folder.glob("*.txt"))
        image_ids = sorted(int(p.stem) for p in paths)
    if not isinstance(image_ids, list):
        image_ids = list(range(image_ids))
    return [
        get_label_anno(label_folder / (image_index_str(idx) + ".txt"))
        for idx in image_ids
    ]


def anno_to_kitti_lines(anno: dict) -> list[str]:
    """Anno dict -> KITTI label lines with scores, exact reference formatting
    (evaluate/kitti_common.py:293-304: '%.2f' fields, dimensions written back as hwl)."""
    lines = []
    for i in range(len(anno["name"])):
        lines.append(
            "%s %.2f %d %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f"
            % (
                anno["name"][i], anno["truncated"][i], anno["occluded"][i],
                anno["alpha"][i],
                anno["bbox"][i, 0], anno["bbox"][i, 1], anno["bbox"][i, 2],
                anno["bbox"][i, 3],
                anno["dimensions"][i, 1], anno["dimensions"][i, 2],
                anno["dimensions"][i, 0],
                anno["location"][i, 0], anno["location"][i, 1], anno["location"][i, 2],
                anno["rotation_y"][i], anno["score"][i],
            )
        )
    return lines


def to_kitti_format(anno: dict, path) -> None:
    with open(path, "w") as f:
        f.write("\n".join(anno_to_kitti_lines(anno)))


def kitti_result_line(result_dict: dict, precision: int = 4) -> str:
    """Format one detection as a KITTI result line with defaults for missing fields
    (reference parity: evaluate/kitti_common.py:203-245; utils/kitti_common.py:408)."""
    prec_float = "{" + ":.{}f".format(precision) + "}"
    defaults = {
        "name": None, "truncated": -1, "occluded": -1, "alpha": -10, "bbox": None,
        "dimensions": [-1, -1, -1], "location": [-1000, -1000, -1000],
        "rotation_y": -10, "score": None,
    }
    for key in result_dict:
        if key not in defaults:
            raise ValueError(f"unknown key {key}. supported: {list(defaults)}")
        if defaults[key] is None and result_dict[key] is None:
            raise ValueError(f"you must specify a value for {key}")
    res_line = []
    for key, default in defaults.items():
        val = result_dict.get(key)
        if key == "name":
            res_line.append(val)
        elif key in ("truncated", "alpha", "rotation_y", "score"):
            res_line.append(str(default) if val is None else prec_float.format(val))
        elif key == "occluded":
            res_line.append(str(default) if val is None else "{}".format(val))
        else:  # bbox, dimensions, location
            if val is None:
                res_line += [str(v) for v in default]
            else:
                res_line += [prec_float.format(v) for v in val]
    return " ".join(res_line)


def filter_anno_rows(anno: dict, keep) -> dict:
    """Select rows of every field by a boolean mask or index list."""
    keep = np.asarray(keep)
    return {key: anno[key][keep] for key in anno}


def filter_kitti_anno(anno: dict, used_classes, used_difficulty=None) -> dict:
    """Keep only rows of the given classes (and difficulties)
    (reference parity: evaluate/kitti_common.py:151-171)."""
    if not isinstance(used_classes, (list, tuple)):
        used_classes = [used_classes]
    keep = np.array([x in used_classes for x in anno["name"]], dtype=bool)
    out = filter_anno_rows(anno, keep)
    if used_difficulty is not None:
        keep = np.array([d in used_difficulty for d in out["difficulty"]], dtype=bool)
        out = filter_anno_rows(out, keep)
    return out


def filter_annos_low_score(annos: list[dict], thresh: float) -> list[dict]:
    """Drop detections below a score threshold
    (reference parity: evaluate/kitti_common.py:190-201)."""
    return [filter_anno_rows(anno, anno["score"] >= thresh) for anno in annos]


def add_difficulty_to_annos_dict(anno: dict) -> np.ndarray:
    """Per-object KITTI difficulty: 0=easy, 1=moderate, 2=hard, -1=none.

    Vectorized re-derivation of evaluate/kitti_common.py:248-290: an object is
    counted at a tier if bbox height > [40, 25, 25] px (strict), occlusion
    <= [0, 1, 2] and truncation <= [0.15, 0.3, 0.5]; difficulty is the easiest
    tier it qualifies for.
    """
    height = anno["bbox"][:, 3] - anno["bbox"][:, 1]
    occ = anno["occluded"]
    trunc = anno["truncated"]
    min_height = (40, 25, 25)
    max_occ = (0, 1, 2)
    max_trunc = (0.15, 0.3, 0.5)
    masks = [
        (height > min_height[k]) & (occ <= max_occ[k]) & (trunc <= max_trunc[k])
        for k in range(3)
    ]
    diff = np.full(len(height), -1, dtype=np.int32)
    # assign hardest first so easier tiers overwrite
    diff[masks[2]] = 2
    diff[masks[1]] = 1
    diff[masks[0]] = 0
    anno["difficulty"] = diff
    return diff


def iou_2d(boxes1: np.ndarray, boxes2: np.ndarray, add1: bool = False) -> np.ndarray:
    """Pairwise axis-aligned 2D IoU, (N,4)x(M,4) -> (N,M)
    (reference parity: evaluate/kitti_common.py:362-425)."""
    boxes1 = np.asarray(boxes1, dtype=np.float64)
    boxes2 = np.asarray(boxes2, dtype=np.float64)
    add = 1.0 if add1 else 0.0
    area1 = (boxes1[:, 2] - boxes1[:, 0] + add) * (boxes1[:, 3] - boxes1[:, 1] + add)
    area2 = (boxes2[:, 2] - boxes2[:, 0] + add) * (boxes2[:, 3] - boxes2[:, 1] + add)
    lt = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = np.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:]) + add
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return inter / union
