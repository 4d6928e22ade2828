"""tpu3d_torch.ops — point-cloud ops with hand-written CUDA kernels.

Every wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version, in the same module, for CPU tensors. Kernels are built from
``tpu3d_torch/csrc`` at first use (``ops/_build.py``).
"""

from .grouping import ball_query_from_nearest, group_points, nearest_k
from .interpolate import interpolation_weights, three_interpolate
from .nms import nms_blocked_sorted
from .sampling import furthest_point_sample_with_3nn, gather_points

__all__ = ["ball_query_from_nearest", "furthest_point_sample_with_3nn",
           "gather_points", "group_points", "interpolation_weights",
           "nearest_k", "nms_blocked_sorted", "three_interpolate"]
