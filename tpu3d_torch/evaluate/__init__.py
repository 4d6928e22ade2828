"""tpu3d_torch.evaluate — the standalone KITTI rotated-IoU AP evaluator
(counterpart of ``tpu3d/evaluate``).

Old (bbox-height) and new (distance-band) difficulty metrics, AOS, coco-style
sweeps, and the paper's output-transformation ablations. The rotated IoU
matrices run on the caller's device through ``tpu3d_torch.ops``; the tiny
order-dependent greedy matcher stays on the host, in a C library built at
first use (``evaluate/native.py``).
"""

from .ap import (
    clean_data,
    compute_statistics,
    do_eval,
    eval_class,
    get_coco_eval_result,
    get_mAP,
    get_official_eval_result,
    get_thresholds,
)
from .overlaps import (
    bev_box_overlap,
    calculate_iou_partly,
    d3_box_overlap,
    image_box_overlap,
)
from .evaluate import evaluate

__all__ = [
    "clean_data", "compute_statistics", "do_eval", "eval_class",
    "get_coco_eval_result", "get_mAP", "get_official_eval_result",
    "get_thresholds", "bev_box_overlap", "calculate_iou_partly", "d3_box_overlap",
    "image_box_overlap", "evaluate",
]
