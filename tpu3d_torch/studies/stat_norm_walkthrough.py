"""Statistical-normalization walkthrough (the port's copy of
``examples/stat_norm_walkthrough.py``; reference: notebooks/
stat_norm.ipynb): compute per-dataset car-size statistics, rescale one
(src, dst) pair, and render a before / after comparison of one frame.

    python -m tpu3d_torch.studies.stat_norm_walkthrough --src kitti \\
        --dst waymo [--frame 000000] [--out compare.png]
        [--synthetic [--synthetic_root DIR]]

Works on the dataset registry (``config/paths.py``, $TPU3D_DATASET_PATH)
or, with ``--synthetic``, on two synthetic domains written under
``--synthetic_root`` (default: ``tpu3d_statnorm_demo`` in the temporary
directory), KITTI-sized cars as src and larger ones as dst, in the
registry's layout under that root. Host numpy work; the render needs
matplotlib (or plotly for ``utils.viz``) and raises its ImportError on a
host without it, after the statistics and the rescaled dataset are
written. ``main`` returns the statistics, the rescaled root, the frame
and the figure's path.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

SRC_CARS = (1.52, 1.63, 3.88)  # h, w, l: KITTI-like
DST_CARS = (1.75, 1.93, 5.15)  # larger cars


def make_synthetic_domain(root: str, dims) -> None:
    """Four synthetic frames with cars of mean size ``dims`` in the
    registry's dataset layout ({root}/training/..., {root}/{split}.txt),
    unless ``root`` already holds one."""
    from ..datasets.synthetic import create_synthetic_kitti

    if os.path.exists(os.path.join(root, "train.txt")):
        return
    create_synthetic_kitti(root, n_frames=4, image_files=True,
                           car_dims_mean=dims)
    obj = os.path.join(root, "KITTI", "object", "training")
    os.symlink(obj, os.path.join(root, "training"))
    for split in ("train", "val", "trainval"):
        dst = os.path.join(root, f"{split}.txt")
        if not os.path.exists(dst):
            shutil.copyfile(os.path.join(root, "KITTI", "ImageSets",
                                         f"{split}.txt"), dst)


def render(out: str, frame: str, roots) -> None:
    """Side-by-side 3D scatter of ``frame`` in each (tag, training dir) of
    ``roots``, its cars' wireframes in red, saved to ``out``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    from ..kitti import Calibration, load_velo_scan, read_label
    from ..kitti.boxes import corners_from_boxes3d
    from ..kitti.object3d import objs_to_boxes3d
    from ..utils.viz import BOX_EDGES

    fig, axes = plt.subplots(1, len(roots), figsize=(16, 6),
                             subplot_kw={"projection": "3d"})
    for ax, (tag, root) in zip(axes, roots):
        velo = load_velo_scan(os.path.join(root, "velodyne", f"{frame}.bin"))
        calib = Calibration(os.path.join(root, "calib", f"{frame}.txt"))
        labels = read_label(os.path.join(root, "label_2", f"{frame}.txt"))
        rect = calib.project_velo_to_rect(velo[:, :3])
        disp = np.stack([rect[:, 0], rect[:, 2], -rect[:, 1]], axis=1)
        ax.scatter(disp[:, 0], disp[:, 1], disp[:, 2], s=0.3)
        boxes = objs_to_boxes3d([o for o in labels if o.cls_type == "Car"])
        for corners in corners_from_boxes3d(boxes):
            d = np.stack([corners[:, 0], corners[:, 2], -corners[:, 1]],
                         axis=1)
            for a, b in BOX_EDGES:
                ax.plot(*zip(d[a], d[b]), color="red", linewidth=1)
        ax.set_title(tag)
    fig.savefig(out, dpi=100)
    plt.close(fig)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default="kitti")
    parser.add_argument("--dst", default="waymo")
    parser.add_argument("--frame", default=None)
    parser.add_argument("--out", default="stat_norm_compare.png")
    parser.add_argument("--synthetic", action="store_true",
                        help="demo on generated data under --synthetic_root")
    parser.add_argument("--synthetic_root", default=os.path.join(
        tempfile.gettempdir(), "tpu3d_statnorm_demo"))
    args = parser.parse_args(argv)

    from ..config import paths
    from ..stat_norm import convert, get_dataset_stats, print_stats

    base = paths.dataset_path
    roots = {d: paths.dataset_paths[d] for d in (args.src, args.dst)}
    if args.synthetic:
        # the registry's layout under the synthetic root
        base = args.synthetic_root
        roots = {d: os.path.join(base, os.path.relpath(r, paths.dataset_path))
                 for d, r in roots.items()}
        for name, dims in ((args.src, SRC_CARS), (args.dst, DST_CARS)):
            make_synthetic_domain(roots[name], dims)

    # 1. per-dataset car-size statistics (cached as label_stats_train.json)
    stats = {d: get_dataset_stats(roots[d]) for d in (args.src, args.dst)}
    print_stats(stats)

    # 2. rescale src -> dst
    out_root = convert(args.src, args.dst, spath=roots[args.src],
                       dpath=os.path.join(base, "rescaled_datasets"),
                       image_size=(1242, 375),
                       dst_stats_path=roots[args.dst])
    print(f"rescaled dataset at {out_root}")

    # 3. before / after render of one frame
    frame = args.frame
    if frame is None:
        with open(os.path.join(roots[args.src], "trainval.txt")) as f:
            frame = f.readline().strip()
    render(args.out, frame, (
        ("original", os.path.join(roots[args.src], "training")),
        ("rescaled", os.path.join(out_root, "training"))))
    print(f"comparison figure saved to {args.out}")
    return {"stats": stats, "rescaled": out_root, "frame": frame,
            "figure": args.out}


if __name__ == "__main__":
    main()
