"""The statistical-normalization effect study, the paper's core claim, end
to end on the port: the copy of ``examples/statnorm_effect.py``.

Builds two synthetic domains with shifted car-size statistics (domain A,
KITTI-like cars; domain B, larger US-like cars: "train in Germany, test in
the USA" in miniature), then measures cross-domain Car AP_3D with and
without statistical normalization:

  1. train on A -> eval on B (the domain gap: low AP);
  2. convert A to B's statistics (``stat_norm.norm.convert``, the method
     under test) -> train on A_scaledto_B -> eval on B (the AP recovers);
  3. train on A -> eval on A (the in-domain ceiling).

Training and evaluation run as the port's CLIs in subprocesses, on the card
unless ``--device cpu``.

    python -m tpu3d_torch.studies.statnorm_effect --out output/statnorm_fx \\
        --epochs 300 --frames 48

Writes <out>/summary.json and prints a markdown table.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

from ..datasets.synthetic import create_synthetic_kitti
from ..stat_norm.norm import convert
from ..stat_norm.stat import get_dataset_stats

# the root of the checkout: the subprocesses run there
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KITTI_CARS = (1.52, 1.63, 3.88)  # h, w, l — KITTI-like statistics
US_CARS = (1.80, 2.00, 5.00)  # larger cars, the paper's USA-style shift


def stat_layout(kitti_root: str, out_root: str) -> str:
    """Bridge a KITTI/object layout into the stat_norm interchange layout
    (<root>/{train,val,trainval}.txt + <root>/training -> object/training)."""
    os.makedirs(out_root, exist_ok=True)
    ids = {}
    for split in ("train", "val"):
        src = os.path.join(kitti_root, "KITTI", "ImageSets", f"{split}.txt")
        with open(src) as f:
            ids[split] = [x.strip() for x in f if x.strip()]
        shutil.copyfile(src, os.path.join(out_root, f"{split}.txt"))
    with open(os.path.join(out_root, "trainval.txt"), "w") as f:
        f.write("\n".join(ids["train"] + ids["val"]) + "\n")
    link = os.path.join(out_root, "training")
    if not (os.path.islink(link) or os.path.exists(link)):
        os.symlink(os.path.join(kitti_root, "KITTI", "object", "training"),
                   link)
    return out_root


def kitti_layout(stat_root: str, out_root: str) -> str:
    """Bridge back: stat_norm layout -> KITTI/object layout for the loaders."""
    obj = os.path.join(out_root, "KITTI", "object")
    imagesets = os.path.join(out_root, "KITTI", "ImageSets")
    os.makedirs(obj, exist_ok=True)
    os.makedirs(imagesets, exist_ok=True)
    link = os.path.join(obj, "training")
    if not (os.path.islink(link) or os.path.exists(link)):
        os.symlink(os.path.join(stat_root, "training"), link)
    for split in ("train", "val"):
        shutil.copyfile(os.path.join(stat_root, f"{split}.txt"),
                        os.path.join(imagesets, f"{split}.txt"))
    return out_root


def run(cmd: list[str]) -> None:
    """Run a CLI of the port from the root of the checkout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    print("+", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True, cwd=REPO, env=env)


def train_cmd(train_root: str, out_train: str, args, extra=()) -> list[str]:
    """The training CLI's command: joint mode, a checkpoint at the end."""
    return [sys.executable, "-m", "tpu3d_torch.tools.train_rcnn",
            "--cfg_file", args.cfg, "--train_mode", "joint",
            "--data_root", train_root, "--batch_size", str(args.batch_size),
            "--epochs", str(args.epochs), "--output_dir", out_train,
            "--ckpt_save_interval", str(args.epochs), "--workers", "2",
            "--device", args.device, *extra]


def eval_cmd(eval_root: str, ckpt: str, out_eval: str, args,
             extra=()) -> list[str]:
    """The eval CLI's command: joint mode on the val split."""
    return [sys.executable, "-m", "tpu3d_torch.tools.eval_rcnn",
            "--cfg_file", args.cfg, "--eval_mode", "joint",
            "--data_root", eval_root, "--batch_size", str(args.batch_size),
            "--ckpt_dir", ckpt, "--output_dir", out_eval, "--workers", "2",
            "--device", args.device, *extra]


def score(result_dir: str, eval_root: str, device: str,
          current_class: int = 0) -> dict:
    """The evaluator's 3D and BEV APs ("new" metric) of an eval run's label
    files against eval_root's val split."""
    from ..evaluate.evaluate import evaluate as ap_evaluate

    _, ret = ap_evaluate(
        os.path.join(result_dir, "final_result", "data"),
        label_path=os.path.join(eval_root, "KITTI", "object", "training",
                                "label_2"),
        label_split_file=os.path.join(eval_root, "KITTI", "ImageSets",
                                      "val.txt"),
        metric="new", current_class=current_class, device=device)
    return {k: float(v) for k, v in ret.items() if "3d" in k or "bev" in k}


def train_once(tag: str, train_root: str, args) -> str:
    """Train joint PointRCNN on train_root; returns the checkpoint dir."""
    out_train = os.path.join(args.out, f"train_{tag}")
    ckpt = os.path.join(out_train, "ckpt")
    if not (args.skip_train and os.path.isdir(ckpt)):
        run(train_cmd(train_root, out_train, args))
    return ckpt


def eval_and_score(tag: str, ckpt: str, eval_root: str, args) -> dict:
    """Eval a checkpoint on eval_root's val split, score with the standalone
    evaluator; returns the Car 3D/BEV AP summary."""
    out_eval = os.path.join(args.out, f"eval_{tag}")
    run(eval_cmd(eval_root, ckpt, out_eval, args))
    return score(out_eval, eval_root, args.device)


def make_domains(args, a_dims, b_dims):
    """Step 1-3: the two domains, their car statistics, A converted to B's
    -> (roots A, B, A_scaledto_B; stats A, B, A_scaledto_B)."""
    dom_a = os.path.join(args.out, "domain_a")
    dom_b = os.path.join(args.out, "domain_b")
    if not os.path.isdir(os.path.join(dom_a, "KITTI")):
        create_synthetic_kitti(dom_a, n_frames=args.frames, seed=1,
                               image_files=True, car_dims_mean=a_dims)
    if not os.path.isdir(os.path.join(dom_b, "KITTI")):
        create_synthetic_kitti(dom_b, n_frames=args.frames, seed=2,
                               image_files=True, car_dims_mean=b_dims)
    stat_a = stat_layout(dom_a, os.path.join(args.out, "stat_a"))
    stat_b = stat_layout(dom_b, os.path.join(args.out, "stat_b"))
    sa = get_dataset_stats(stat_a)
    sb = get_dataset_stats(stat_b)
    print("domain A car stats:", json.dumps(sa))
    print("domain B car stats:", json.dumps(sb))
    converted = convert("syn_a", "syn_b", spath=stat_a,
                        dpath=os.path.join(args.out, "rescaled"),
                        dst_stats_path=stat_b, image_size=(1242, 375))
    a2b = kitti_layout(converted, os.path.join(args.out, "domain_a2b"))
    s_a2b = get_dataset_stats(stat_layout(
        a2b, os.path.join(args.out, "stat_a2b")), force=True)
    print("A_scaledto_B car stats:", json.dumps(s_a2b))
    return (dom_a, dom_b, a2b), (sa, sb, s_a2b)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="output/statnorm_effect")
    ap.add_argument("--cfg", default="configs/quickstart.yaml")
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--skip_train", action="store_true",
                    help="reuse existing checkpoints when present")
    ap.add_argument("--reverse", action="store_true",
                    help="swap the domains (train on US-sized cars, test on "
                         "KITTI-sized): the method is symmetric")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    a_dims, b_dims = ((US_CARS, KITTI_CARS) if args.reverse
                      else (KITTI_CARS, US_CARS))
    args.out = os.path.abspath(args.out)
    os.makedirs(args.out, exist_ok=True)

    # refuse to mix directions/settings in one output dir: a stale forward
    # run's domains/stat caches/checkpoints would silently masquerade as the
    # new configuration
    marker_path = os.path.join(args.out, "domains.json")
    marker = {"a_dims": list(a_dims), "b_dims": list(b_dims),
              "frames": args.frames}
    if os.path.exists(marker_path):
        with open(marker_path) as f:
            prior = json.load(f)
        if prior != marker:
            raise SystemExit(
                f"{args.out} holds a run with different domains/settings "
                f"({prior} vs {marker}); use a fresh --out")
    else:
        with open(marker_path, "w") as f:
            json.dump(marker, f)

    (dom_a, dom_b, a2b), (sa, sb, s_a2b) = make_domains(args, a_dims, b_dims)

    # 4. the three runs (the A model is trained once, evaluated twice)
    ckpt_a = train_once("a", dom_a, args)
    ckpt_a2b = train_once("a2b", a2b, args)
    results = {
        "A->B (no adaptation)": eval_and_score("a_on_b", ckpt_a, dom_b, args),
        "A_scaledto_B->B (statnorm)": eval_and_score("a2b_on_b", ckpt_a2b,
                                                     dom_b, args),
        "A->A (in-domain ceiling)": eval_and_score("a_on_a", ckpt_a, dom_a,
                                                   args),
    }
    summary = {"stats": {"A": sa, "B": sb, "A_scaledto_B": s_a2b},
               "results": results}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)

    print("\n| run | " + " | ".join(
        next(iter(results.values())).keys()) + " |")
    for name, r in results.items():
        print(f"| {name} | " + " | ".join(f"{v:.2f}" for v in r.values())
              + " |")
    return summary


if __name__ == "__main__":
    main()
