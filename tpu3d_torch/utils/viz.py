"""Scene rendering: 2D boxes on images, 3D point clouds with wireframe
boxes (counterpart of ``tpu3d/utils/viz.py``; reference:
utils/plotly_utils.py showimg / showvelo / showvelo2).

Backends: plotly when installed (interactive, the reference's choice),
otherwise matplotlib 3D. A host without either raises matplotlib's
ImportError at the first render, as tpu3d's does. Inputs are numpy arrays
or CPU tensors; every function returns the figure.
"""

from __future__ import annotations

import numpy as np

from ..kitti.boxes import corners_from_boxes3d

BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]


def _have_plotly() -> bool:
    try:
        import plotly  # noqa: F401

        return True
    except ImportError:
        return False


def showimg(img: np.ndarray, objects=None, scores=None):
    """Image with 2D boxes (reference: plotly_utils.py:74 showimg)."""
    img = np.asarray(img)
    if _have_plotly():
        import plotly.express as px
        import plotly.graph_objects as go

        fig = px.imshow(img)
        for k, obj in enumerate(objects or []):
            x1, y1, x2, y2 = obj.box2d
            fig.add_shape(type="rect", x0=x1, y0=y1, x1=x2, y1=y2,
                          line=dict(color="red"))
            if scores is not None:
                fig.add_annotation(x=x1, y=y1, text=f"{scores[k]:.2f}",
                                   showarrow=False)
        return fig
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    fig, ax = plt.subplots(figsize=(12, 4))
    ax.imshow(img)
    for k, obj in enumerate(objects or []):
        x1, y1, x2, y2 = obj.box2d
        ax.add_patch(Rectangle((x1, y1), x2 - x1, y2 - y1, fill=False,
                               edgecolor="red"))
        if scores is not None:
            ax.text(x1, y1, f"{scores[k]:.2f}", color="red")
    return fig


def _boxes_to_wires(boxes3d: np.ndarray):
    """(N, 7) -> per-box wireframe segments in the display frame
    (x right, y forward = z_rect, z up = -y_rect)."""
    wires = []
    for corners in corners_from_boxes3d(np.asarray(boxes3d).reshape(-1, 7)):
        xs, ys, zs = [], [], []
        for a, b in BOX_EDGES:
            xs += [corners[a, 0], corners[b, 0], None]
            ys += [corners[a, 2], corners[b, 2], None]
            zs += [-corners[a, 1], -corners[b, 1], None]
        wires.append((xs, ys, zs))
    return wires


def showvelo(pts_rect: np.ndarray, boxes3d=None, pred_boxes3d=None,
             point_size: float = 1.0, max_points: int = 60000):
    """3D scatter of rect-frame points + gt (green) / pred (red) wireframes
    (reference: plotly_utils.py:194-210 showvelo/showvelo2)."""
    pts = np.asarray(pts_rect)
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points,
                                              replace=False)
        pts = pts[sel]
    # display frame: x right, y forward (=z_rect), z up (=-y_rect)
    disp = np.stack([pts[:, 0], pts[:, 2], -pts[:, 1]], axis=1)

    if _have_plotly():
        import plotly.graph_objects as go

        fig = go.Figure()
        fig.add_trace(go.Scatter3d(
            x=disp[:, 0], y=disp[:, 1], z=disp[:, 2], mode="markers",
            marker=dict(size=point_size, color=disp[:, 2],
                        colorscale="Viridis"), name="points"))
        for name, boxes, color in (("gt", boxes3d, "green"),
                                   ("pred", pred_boxes3d, "red")):
            if boxes is None or len(boxes) == 0:
                continue
            for xs, ys, zs in _boxes_to_wires(boxes):
                fig.add_trace(go.Scatter3d(
                    x=xs, y=ys, z=zs, mode="lines", line=dict(color=color),
                    name=name, showlegend=False))
        fig.update_scenes(aspectmode="data")
        return fig

    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(disp[:, 0], disp[:, 1], disp[:, 2], s=point_size,
               c=disp[:, 2], cmap="viridis")
    for boxes, color in ((boxes3d, "green"), (pred_boxes3d, "red")):
        if boxes is None or len(boxes) == 0:
            continue
        for corners in corners_from_boxes3d(np.asarray(boxes).reshape(-1, 7)):
            d = np.stack([corners[:, 0], corners[:, 2], -corners[:, 1]], axis=1)
            for a, b in BOX_EDGES:
                ax.plot(*zip(d[a], d[b]), color=color, linewidth=1)
    ax.set_box_aspect((1, 2, 0.3))
    return fig


showvelo2 = showvelo
