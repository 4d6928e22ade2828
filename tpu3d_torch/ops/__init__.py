"""tpu3d_torch.ops — point-cloud ops with hand-written CUDA kernels.

Every wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version, in the same module, for CPU tensors. Kernels are built from
``tpu3d_torch/csrc`` at first use (``ops/_build.py``). ROI pooling, the
rotated IoU, NMS and the box geometry are plain PyTorch on every device;
the ``*_numpy`` functions are tpu3d's host oracles, and the
``*_reference`` ones its plain chains under its names.
"""

from ..kitti.boxes import boxes_iou3d_numpy, rotated_iou_bev_numpy
from .box_geometry import (bev_corners_from_boxes3d, corners_from_boxes3d,
                           enlarge_box3d, points_in_boxes3d,
                           rotate_points_along_y)
from .fused_sa import (fused_bn_mlp_pool, fused_bn_mlp_pool_reference,
                       fused_gather_supported, fused_gathered_mlp_pool,
                       fused_mlp_pool, fused_mlp_pool_reference,
                       fused_sa_supported, sa_route)
from .grouping import (ball_query, ball_query_from_nearest,
                       ball_query_numpy, group_points, nearest_k)
from .interpolate import (interpolation_weights, nn_dist_from_idx,
                          three_interpolate, three_nn, three_nn_numpy,
                          three_nn_plain)
from .nms import (nms_bev, nms_blocked_sorted, nms_normal, nms_numpy,
                  nms_rotated, nms_streaming_sorted)
from .roipool import roipool3d, roipool3d_numpy
from .rotated_iou import (boxes3d_to_bev5, boxes_iou3d, boxes_iou_bev,
                          rotated_overlap_bev)
from .sampling import (furthest_point_sample, furthest_point_sample_numpy,
                       furthest_point_sample_with_3nn, fused_route,
                       gather_points)

__all__ = ["ball_query", "ball_query_from_nearest", "ball_query_numpy",
           "bev_corners_from_boxes3d", "boxes3d_to_bev5", "boxes_iou3d",
           "boxes_iou3d_numpy", "boxes_iou_bev", "corners_from_boxes3d",
           "enlarge_box3d", "furthest_point_sample",
           "furthest_point_sample_numpy", "furthest_point_sample_with_3nn",
           "fused_bn_mlp_pool", "fused_bn_mlp_pool_reference",
           "fused_gather_supported", "fused_gathered_mlp_pool",
           "fused_mlp_pool", "fused_mlp_pool_reference", "fused_route",
           "fused_sa_supported", "gather_points", "group_points",
           "interpolation_weights", "nearest_k", "nms_bev",
           "nms_blocked_sorted", "nms_normal", "nms_numpy", "nms_rotated",
           "nms_streaming_sorted", "nn_dist_from_idx", "points_in_boxes3d",
           "roipool3d", "roipool3d_numpy", "rotate_points_along_y",
           "rotated_iou_bev_numpy", "rotated_overlap_bev", "sa_route",
           "three_interpolate", "three_nn", "three_nn_numpy",
           "three_nn_plain"]
