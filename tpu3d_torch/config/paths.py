"""The dataset-path registry: the port's copy of ``tpu3d/config/paths.py``.

The root is taken from $TPU3D_DATASET_PATH (default
~/scratch/driving_datasets), the variable tpu3d reads. Importing this
module has no side effects (no mkdir, no print); call ensure_dirs().
"""

from __future__ import annotations

import os

dataset_path = os.environ.get(
    "TPU3D_DATASET_PATH", os.path.expanduser("~/scratch/driving_datasets"))

raw_path_dic = {
    "kitti": os.path.join(dataset_path, "kitti"),
    "argo": os.path.join(dataset_path, "argo"),
    "nusc": os.path.join(dataset_path, "nusc"),
    "lyft": os.path.join(dataset_path, "lyft"),
    "waymo": os.path.join(dataset_path, "waymo"),
    "argo-in-kitti-format": os.path.join(dataset_path, "argo-in-kitti-format"),
    "nusc-in-kitti-format": os.path.join(dataset_path, "nusc-in-kitti-format"),
    "lyft-in-kitti-format": os.path.join(dataset_path, "lyft-in-kitti-format"),
    "waymo-in-kitti-format": os.path.join(dataset_path, "waymo-in-kitti-format"),
}

dataset_paths = {
    "kitti": os.path.join(dataset_path, "kitti"),
    "argo": os.path.join(dataset_path, "argo-in-kitti-format"),
    "nusc": os.path.join(dataset_path, "nusc-in-kitti-format"),
    "lyft": os.path.join(dataset_path, "lyft-in-kitti-format"),
    "waymo": os.path.join(dataset_path, "waymo-in-kitti-format"),
}

dataset_full_name = {
    "kitti": "KITTI",
    "argo": "Argoverse",
    "nusc": "nuScenes",
    "lyft": "Lyft",
    "waymo": "Waymo",
}

datasets = list(dataset_paths.keys())


def ensure_dirs() -> None:
    os.makedirs(dataset_path, exist_ok=True)
