"""tpu3d_torch.ops — point-cloud ops with hand-written CUDA kernels.

Every wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version, in the same module, for CPU tensors. Kernels are built from
``tpu3d_torch/csrc`` at first use (``ops/_build.py``). ROI pooling, the
rotated IoU and NMS are plain PyTorch on every device.
"""

from .fused_sa import (fused_bn_mlp_pool, fused_gather_supported,
                       fused_gathered_mlp_pool, fused_mlp_pool,
                       fused_sa_supported, sa_route)
from .grouping import (ball_query, ball_query_from_nearest, group_points,
                       nearest_k)
from .interpolate import (interpolation_weights, three_interpolate,
                          three_nn, three_nn_plain)
from .nms import nms_bev, nms_blocked_sorted
from .roipool import roipool3d
from .rotated_iou import (boxes3d_to_bev5, boxes_iou3d, boxes_iou_bev,
                          rotated_overlap_bev)
from .sampling import (furthest_point_sample, furthest_point_sample_with_3nn,
                       fused_route, gather_points)

__all__ = ["ball_query", "ball_query_from_nearest", "boxes3d_to_bev5",
           "boxes_iou3d", "boxes_iou_bev", "furthest_point_sample",
           "furthest_point_sample_with_3nn", "fused_bn_mlp_pool",
           "fused_gather_supported", "fused_gathered_mlp_pool",
           "fused_mlp_pool", "fused_route", "fused_sa_supported",
           "gather_points", "group_points",
           "interpolation_weights", "nearest_k", "nms_bev",
           "nms_blocked_sorted", "roipool3d", "rotated_overlap_bev",
           "sa_route",
           "three_interpolate", "three_nn", "three_nn_plain"]
