"""The cross-domain source -> target matrix, the paper's headline
experiment's shape, through the port's batch inference (the copy of
``examples/domain_matrix.py``).

Builds three synthetic domains with shifted car-size statistics (S, small
European-style cars; K, KITTI-like; L, large US-style cars), trains one
PointRCNN per domain, and produces the 3x3 source -> target Car AP matrix
by running ``tpu3d_torch.tools.batch_inference`` (executed, not a dry run)
over models x domains. Then statistical normalization: for every ordered
source != target pair the source is rescaled to the target's car
statistics, a model is trained on it, and a second batch inference
(one2one) gives the adapted matrix. Everything is scored with the
evaluator ("new" metric).

    python -m tpu3d_torch.studies.domain_matrix --out output/domain_matrix \\
        --epochs 300 [--device cpu]

Writes <out>/summary.json and prints the two matrices as markdown.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..datasets.synthetic import create_synthetic_kitti
from ..stat_norm.norm import convert
from ..stat_norm.stat import get_dataset_stats
from ..tools.batch_inference import get_true_name
from .statnorm_effect import kitti_layout, run, score, stat_layout, train_cmd

# h, w, l car-size means per domain: the "train in Germany, test in the
# USA" gap in miniature, three ways
DOMAINS = {
    "S": (1.45, 1.58, 3.60),  # small European-style cars
    "K": (1.52, 1.63, 3.88),  # KITTI-like
    "L": (1.80, 2.00, 5.00),  # large US-style cars
}
FAR_POINTS = 4000  # batch_inference's default


def train_model(tag: str, data_root: str, args) -> str:
    out_train = os.path.join(args.out, f"train_{tag}")
    ckpt = os.path.join(out_train, "ckpt")
    if not (args.skip_train and os.path.isdir(ckpt)):
        run(train_cmd(data_root, out_train, args))
    return ckpt


def batch_inference_cmd(models: dict, datasets, dom_base: str,
                        out_base: str, cfg_name: str, args,
                        one2one: bool = False) -> list[str]:
    return ([sys.executable, "-m", "tpu3d_torch.tools.batch_inference",
             "--cfg", cfg_name, "--eval_mode", "joint"]
            + (["--one2one"] if one2one else [])
            + ["--models"] + [f"{m}={c}" for m, c in models.items()]
            + ["--datasets"] + list(datasets)
            + ["--data_root_base", dom_base, "--out_base", out_base,
               "--device", args.device])


def table(results: dict, title: str) -> str:
    """A matrix of Car AP_3D moderate as a markdown table."""
    names = list(DOMAINS)
    lines = [f"\n### {title} (Car AP_3D@0.7 moderate)\n",
             "| train\\test | " + " | ".join(names) + " |",
             "|---|" + "---|" * len(names)]
    for s in names:
        row = []
        for t in names:
            r = results.get(f"{s}->{t}")
            row.append(f"{r['Car_3d_moderate']:.2f}" if r else "—")
        lines.append(f"| {s} | " + " | ".join(row) + " |")
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="output/domain_matrix")
    ap.add_argument("--cfg", default="configs/quickstart.yaml")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--skip_train", action="store_true")
    ap.add_argument("--skip_adapted", action="store_true",
                    help="only the 3x3 unadapted matrix")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    args = ap.parse_args(argv)
    args.out = os.path.abspath(args.out)
    os.makedirs(args.out, exist_ok=True)
    cfg_name = os.path.splitext(os.path.basename(args.cfg))[0]

    # 1. domains and each domain's car statistics
    roots, stats, stat_roots = {}, {}, {}
    dom_base = os.path.join(args.out, "domains")
    for i, (name, dims) in enumerate(DOMAINS.items()):
        root = os.path.join(dom_base, name)
        if not os.path.isdir(os.path.join(root, "KITTI")):
            create_synthetic_kitti(root, n_frames=args.frames, seed=10 + i,
                                   image_files=True, car_dims_mean=dims)
        roots[name] = root
        stat_roots[name] = stat_layout(
            root, os.path.join(args.out, f"stat_{name}"))
        stats[name] = get_dataset_stats(stat_roots[name])
        print(f"domain {name} car stats:", json.dumps(stats[name]))

    # 2. one base model per domain
    base_ckpts = {s: train_model(s, roots[s], args) for s in DOMAINS}

    # 3. statnorm: rescale every source to every other target's statistics
    #    and train the adapted models
    pairs = [(s, t) for s in DOMAINS for t in DOMAINS if s != t]
    adapted_ckpts = {}
    if not args.skip_adapted:
        for s, t in pairs:
            tag = f"{s}2{t}"
            converted = convert(
                f"syn_{s}", f"syn_{t}", spath=stat_roots[s],
                dpath=os.path.join(args.out, "rescaled", tag),
                dst_stats_path=stat_roots[t], image_size=(1242, 375))
            adapted_root = kitti_layout(
                converted, os.path.join(dom_base, tag))
            adapted_ckpts[tag] = train_model(tag, adapted_root, args)

    # 4. the 3x3 matrix through the batch inference CLI
    out_base = os.path.join(args.out, "matrix")
    run(batch_inference_cmd(base_ckpts, DOMAINS, dom_base, out_base,
                            cfg_name, args))
    if adapted_ckpts:  # adapted models: each evaluates on its target only
        run(batch_inference_cmd(adapted_ckpts, [t for _, t in pairs],
                                dom_base, out_base, cfg_name, args,
                                one2one=True))

    # 5. score everything
    matrix, adapted = {}, {}
    for s in DOMAINS:
        for t in DOMAINS:
            rd = os.path.join(out_base,
                              get_true_name(s, t, FAR_POINTS, cfg_name))
            matrix[f"{s}->{t}"] = score(rd, roots[t], args.device)
    for s, t in pairs if adapted_ckpts else []:
        tag = f"{s}2{t}"
        rd = os.path.join(out_base, get_true_name(tag, t, FAR_POINTS,
                                                  cfg_name))
        adapted[f"{s}->{t}"] = score(rd, roots[t], args.device)

    summary = {"stats": stats, "matrix": matrix, "adapted": adapted}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(table(matrix, "No adaptation"))
    if adapted:
        print(table(adapted, "With statistical normalization (off-diagonal)"))
    return summary


if __name__ == "__main__":
    main()
