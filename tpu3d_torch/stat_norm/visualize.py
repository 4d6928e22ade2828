"""Before / after statistical normalization in 3D: the port's copy of
``tpu3d/stat_norm/visualize.py``.

Plotly is imported inside ``compare_stat_norm``, so only a call needs it.
"""

from __future__ import annotations

import os

import numpy as np

from ..kitti import Calibration, load_velo_scan, read_label
from ..kitti.boxes import points_in_boxes3d
from ..kitti.object3d import objs_to_boxes3d


def get_object_mask(ptc_rect: np.ndarray, labels,
                    classes=("Car", "Van")) -> np.ndarray:
    """Boolean mask of points inside any labeled box of the given classes
    (reference: visualize.py:13-28, via the analytic in-box test)."""
    objs = [obj for obj in labels if obj.cls_type in classes]
    if not objs:
        return np.zeros(ptc_rect.shape[0], dtype=bool)
    return points_in_boxes3d(ptc_rect, objs_to_boxes3d(objs)).any(axis=1)


def compare_stat_norm(name: str, src_root: str, rescaled_root: str,
                      classes=("Car", "Van")):
    """Render original vs rescaled object points + wireframe boxes for one frame
    (reference: visualize.py:31-51). Returns a plotly Figure."""
    import plotly.graph_objects as go

    fig = go.Figure()
    for tag, root in (("original", src_root), ("rescaled", rescaled_root)):
        velo = load_velo_scan(
            os.path.join(root, "training", "velodyne", f"{name}.bin"))
        calib = Calibration(
            os.path.join(root, "training", "calib", f"{name}.txt"))
        labels = read_label(
            os.path.join(root, "training", "label_2", f"{name}.txt"))
        rect = calib.project_velo_to_rect(velo[:, :3])
        mask = get_object_mask(rect, labels, classes)
        pts = rect[mask]
        fig.add_trace(go.Scatter3d(
            x=pts[:, 0], y=pts[:, 2], z=-pts[:, 1], mode="markers",
            marker=dict(size=1), name=f"{tag} points"))
        from ..kitti.boxes import corners_from_boxes3d

        boxes = objs_to_boxes3d(
            [o for o in labels if o.cls_type in classes])
        for corners in corners_from_boxes3d(boxes):
            edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
                     (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)]
            xs, ys, zs = [], [], []
            for a, b in edges:
                xs += [corners[a, 0], corners[b, 0], None]
                ys += [corners[a, 2], corners[b, 2], None]
                zs += [-corners[a, 1], -corners[b, 1], None]
            fig.add_trace(go.Scatter3d(x=xs, y=ys, z=zs, mode="lines",
                                       name=f"{tag} box"))
    return fig
