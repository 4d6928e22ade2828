"""tpu3d_torch.kitti — the port's copy of ``tpu3d.kitti``, the KITTI data
model (labels, calibration, box geometry), with the host 3D IoU.

Pure numpy; the loader, the dataset and the GT database read frames through
it. Held equal to tpu3d's by ``tests/test_torch_data.py``.
"""

from .object3d import (
    CLS_TYPE_TO_ID,
    Object3d,
    cls_type_to_id,
    get_level,
    objs_to_boxes3d,
    objs_to_scores,
    read_label,
    write_label,
)
from .calibration import (
    Calibration,
    get_road_plane,
    inverse_rigid_trans,
    load_velo_scan,
    read_calib_file,
    save_velo_scan,
)
from .boxes import (
    boxes3d_to_bev,
    boxes3d_to_corners3d,
    boxes_iou3d_numpy,
    corners_from_boxes3d,
    dist_to_plane,
    enlarge_box3d,
    points_in_boxes3d,
    rotate_points_along_y,
)
from . import annos

__all__ = [
    "CLS_TYPE_TO_ID", "Object3d", "cls_type_to_id", "get_level", "objs_to_boxes3d",
    "objs_to_scores", "read_label", "write_label", "Calibration", "get_road_plane",
    "inverse_rigid_trans", "load_velo_scan", "read_calib_file", "save_velo_scan",
    "boxes3d_to_bev", "boxes3d_to_corners3d", "boxes_iou3d_numpy",
    "corners_from_boxes3d", "dist_to_plane", "enlarge_box3d",
    "points_in_boxes3d", "rotate_points_along_y", "annos",
]
