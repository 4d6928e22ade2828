"""tpu3d_torch.stat_norm — statistical normalization (car-size domain
adaptation): the port's copy of ``tpu3d.stat_norm``, host numpy.
"""

from .stat import get_dataset_stats, get_stats, print_stats
from .norm import (
    car_sales_stats,
    convert,
    get_scale_map,
    launch_rescale,
    rescale_ptc,
    scale_labels,
    single_scale,
)
from .visualize import compare_stat_norm, get_object_mask

__all__ = [
    "get_dataset_stats", "get_stats", "print_stats", "car_sales_stats",
    "convert", "get_scale_map", "launch_rescale", "rescale_ptc", "scale_labels",
    "single_scale", "compare_stat_norm", "get_object_mask",
]
