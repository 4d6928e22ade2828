"""Multi-class learning on the port: train and score a Cyclist detector (the
copy of ``examples/multiclass_cyclist.py``).

Trains the joint model with ``configs/default_cyclist.yaml``'s class
(CLASSES Cyclist, set on quickstart.yaml as tpu3d's study sets it) on
synthetic multi-class scenes (Cars, Pedestrians and Cyclists) and scores
Cyclist AP with the evaluator: the class machinery learns end to end.

The reference's default_cyclist.yaml keeps the car mean size as
CLS_MEAN_SIZE (its quirk, default_cyclist.yaml:27); ``--cyclist_anchor``
takes a cyclist-sized anchor instead.

    python -m tpu3d_torch.studies.multiclass_cyclist \\
        --out output/multiclass_cyclist [--cyclist_anchor] [--device cpu]

Writes <out>/summary.json.
"""

from __future__ import annotations

import argparse
import json
import os

from ..datasets.synthetic import create_synthetic_kitti
from .statnorm_effect import eval_cmd, run, score, train_cmd

CLASS_INDEX = {"Car": 0, "Pedestrian": 1, "Cyclist": 2}


def overrides(classes: str, cyclist_anchor: bool) -> list[str]:
    """The ``--set`` pairs both CLIs take."""
    out = ["CLASSES", classes]
    if cyclist_anchor:
        out += ["CLS_MEAN_SIZE", "[[1.74, 0.60, 1.76]]"]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="output/multiclass_cyclist")
    ap.add_argument("--cfg", default="configs/quickstart.yaml")
    ap.add_argument("--classes", default="Cyclist",
                    choices=("Cyclist", "Pedestrian", "People"))
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--cyclist_anchor", action="store_true",
                    help="use a cyclist-sized CLS_MEAN_SIZE instead of the "
                         "reference's car-sized quirk")
    ap.add_argument("--skip_train", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    args = ap.parse_args(argv)
    args.out = os.path.abspath(args.out)
    os.makedirs(args.out, exist_ok=True)

    root = os.path.join(args.out, "data")
    if not os.path.isdir(os.path.join(root, "KITTI")):
        create_synthetic_kitti(root, n_frames=args.frames, seed=21,
                               image_files=True,
                               extra_classes=("Pedestrian", "Cyclist"))

    sets = ["--set"] + overrides(args.classes, args.cyclist_anchor)
    out_train = os.path.join(args.out, "train")
    ckpt = os.path.join(out_train, "ckpt")
    if not (args.skip_train and os.path.isdir(ckpt)):
        run(train_cmd(root, out_train, args, sets))
    out_eval = os.path.join(args.out, "eval")
    run(eval_cmd(root, ckpt, out_eval, args, sets))

    ret = score(out_eval, root, args.device,
                CLASS_INDEX.get(args.classes, 2))
    # the evaluator's keys say "Car_" whatever the class (tpu3d's quirk,
    # eval2.py:711-719): relabel with the class evaluated
    results = {k.replace("Car_", f"{args.classes}_"): v
               for k, v in ret.items()}
    summary = {"classes": args.classes, "epochs": args.epochs,
               "cyclist_anchor": bool(args.cyclist_anchor),
               "results": results}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
