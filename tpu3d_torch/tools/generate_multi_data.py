"""Build the multi_data/{dataset} symlink farm the train and eval CLIs
read: the port's copy of ``tpu3d/tools/generate_multi_data.py``.

Each dataset gets multi_data/{name}/KITTI/{object/training/{image_2,
label_2,velodyne,calib,planes}, ImageSets} linked from its KITTI-format
root in ``config/paths.py``.

    python -m tpu3d_torch.tools.generate_multi_data
"""

from __future__ import annotations

import os

SUB_DIRS = ["image_2", "label_2", "velodyne", "calib", "planes"]


def gen_data(src: str, dst: str) -> None:
    os.makedirs(os.path.join(dst, "KITTI/object/training"), exist_ok=True)
    imagesets = os.path.join(dst, "KITTI/ImageSets")
    if not os.path.isdir(imagesets):
        os.symlink(src, imagesets)
    for sub in SUB_DIRS:
        src_path = os.path.join(src, "training", sub)
        if os.path.isdir(src_path):
            dst_path = os.path.join(dst, "KITTI/object/training", sub)
            if not os.path.isdir(dst_path):
                os.symlink(src_path, dst_path)


def gen_all_data(multi_data_root: str = "multi_data") -> None:
    from ..config.paths import dataset_paths

    for dataset, path in dataset_paths.items():
        print(f"generating multi_data folder for {dataset} ...")
        gen_data(path, os.path.join(multi_data_root, dataset))


if __name__ == "__main__":
    gen_all_data()
