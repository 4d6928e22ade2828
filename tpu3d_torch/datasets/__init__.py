"""tpu3d_torch.datasets — synthetic scenes for the port's checks."""

from .synthetic import plant_clusters, random_scenes, train_batch

__all__ = ["plant_clusters", "random_scenes", "train_batch"]
