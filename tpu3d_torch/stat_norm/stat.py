"""Per-dataset car-size statistics: the port's copy of
``tpu3d/stat_norm/stat.py``.

Computes the mean and std of Car height, width and length over a split's
labels and caches them as ``label_stats_{split}.json`` at the dataset root.
Host numpy, as in tpu3d.
"""

from __future__ import annotations

import json
import os
from itertools import chain

import numpy as np

from ..config.paths import dataset_full_name, dataset_paths, datasets
from ..kitti import read_label

SPLIT_PATH_DIC = {"train": "training", "val": "training", "test": "testing"}
STAT_SUBJECTS = ["height", "width", "length"]


def get_stats(data: np.ndarray) -> dict:
    return {"mean": float(np.mean(data)), "std": float(np.std(data))}


def get_dataset_stats(root: str, split: str = "train", force: bool = False,
                      cls_type: str = "Car") -> dict:
    """Collect {height,width,length}: {mean,std} for Cars in a split, with a JSON
    cache (reference: stat_norm/stat.py:24-52)."""
    assert split in SPLIT_PATH_DIC
    stat_file = os.path.join(root, f"label_stats_{split}.json")
    if os.path.isfile(stat_file) and not force:
        with open(stat_file) as f:
            return json.load(f)

    with open(os.path.join(root, f"{split}.txt")) as f:
        data_ids = [x.strip() for x in f if x.strip()]
    label_dir = os.path.join(root, SPLIT_PATH_DIC[split], "label_2")

    values = {x: [] for x in STAT_SUBJECTS}
    for data_id in data_ids:
        for obj in read_label(os.path.join(label_dir, f"{data_id}.txt")):
            if obj.cls_type == cls_type:
                values["height"].append(obj.h)
                values["width"].append(obj.w)
                values["length"].append(obj.l)
    stats = {x: get_stats(np.array(values[x])) for x in STAT_SUBJECTS}
    with open(stat_file, "w") as f:
        json.dump(stats, f, indent=4)
    return stats


def print_stats(dataset_stats: dict) -> None:
    lines = [["mean (std)"] + STAT_SUBJECTS]
    for d, stat in dataset_stats.items():
        lines.append([dataset_full_name.get(d, d)]
                     + [f"{stat[x]['mean']:0.2f} ({stat[x]['std']:0.2f})"
                        for x in STAT_SUBJECTS])
    max_len = max(map(len, chain(*lines)))
    for line in lines:
        print("|".join(f"{s:{max_len}}" for s in line))


if __name__ == "__main__":
    all_stats = {d: get_dataset_stats(dataset_paths[d]) for d in datasets}
    print_stats(all_stats)
