"""tpu3d_torch.datasets — the host-side input pipeline (KITTI-format frames
on disk -> fixed-shape batches on the card) and synthetic scenes."""

from .kitti_dataset import KittiDataset
from .kitti_rcnn_dataset import MAX_GT, KittiRCNNDataset
from .loader import BatchLoader, device_prefetch
from .synthetic import (create_synthetic_kitti, plant_clusters,
                        random_scenes, train_batch)

__all__ = ["KittiDataset", "KittiRCNNDataset", "MAX_GT", "BatchLoader",
           "create_synthetic_kitti", "device_prefetch", "plant_clusters",
           "random_scenes", "train_batch"]
