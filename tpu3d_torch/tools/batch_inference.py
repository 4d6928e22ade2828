"""Cross-domain batch inference: eval every (model, dataset, far-points)
combination (counterpart of ``tpu3d/tools/batch_inference.py``).

Reference parity: pointrcnn/tools/batch_inference.py, a Cartesian model x
dataset x far-points command generator for the 5x5 source->target
evaluation matrix (the paper's main table). Each command runs the port's
eval CLI, ``tpu3d_torch.tools.eval_rcnn``, over every visible card as
tpu3d's runs over its mesh: under ``torchrun --standalone
--nproc_per_node <cards>`` when more than one card is visible (each rank
runs its rows of every batch, rank 0 writes), else as a plain ``python
-m``. The commands run one after another.

    python -m tpu3d_torch.tools.batch_inference --models kitti=ckpt/ \\
        --datasets kitti argo --dry_run
"""

from __future__ import annotations

import argparse
import itertools
import os
import subprocess

import torch


def get_true_name(model_name, data_name, far_points, cfg_name="default",
                  within=None):
    res = f"{model_name}_{data_name}_farsample{far_points}"
    if within is not None:
        res = f"{model_name}_{data_name}_within{within}_farsample{far_points}"
    if cfg_name != "default":
        res += f"_{cfg_name}"
    return res


def launcher(cards: int | None = None) -> list[str]:
    """How a command starts: ``torchrun`` over ``cards`` processes when
    there are more than one (the visible cards by default), else a plain
    ``python -m``."""
    cards = torch.cuda.device_count() if cards is None else cards
    if cards > 1:
        return ["torchrun", "--standalone", "--nproc_per_node", str(cards),
                "-m"]
    return ["python", "-m"]


def gen_cmd(model_ckpt, data_name, out_name, cfg_name="default", batch_size=8,
            extra_flags=(), data_root_base="multi_data", eval_mode="rcnn",
            out_base="output/rcnn", known=("kitti", "argo", "nusc", "lyft",
                                           "waymo"), cards=None):
    if cfg_name == "double":
        batch_size = 4
    cfg_file = (f"configs/{cfg_name}.yaml" if not cfg_name.endswith(".yaml")
                else cfg_name)
    cmd = launcher(cards) + [
        "tpu3d_torch.tools.eval_rcnn",
        "--cfg_file", cfg_file,
        "--ckpt" if model_ckpt.endswith(".msgpack") else "--ckpt_dir",
        model_ckpt,
        "--batch_size", str(batch_size),
        "--eval_mode", eval_mode,
        "--data_root", os.path.join(data_root_base, data_name),
        "--output_dir", os.path.join(out_base, out_name),
    ]
    base = data_name.split("_")[0]
    if base.startswith("argo"):
        base = "argo"
    if base in known:  # synthetic domains keep the default calib/convention
        cmd += ["--dataset", base]
    cmd += list(extra_flags)
    return cmd


def gen_commands(model_paths: dict, data_names, far_points, cfg_name="default",
                 one2one=False, extra_flags=(), data_root_base="multi_data",
                 eval_mode="rcnn", out_base="output/rcnn", cards=None):
    pairs = (zip(model_paths.keys(), data_names) if one2one
             else itertools.product(model_paths.keys(), data_names))
    for model_name, data_name in pairs:
        for fp in far_points:
            yield gen_cmd(
                model_paths[model_name], data_name,
                get_true_name(model_name, data_name, fp, cfg_name),
                cfg_name, extra_flags=extra_flags,
                data_root_base=data_root_base, eval_mode=eval_mode,
                out_base=out_base, cards=cards)


def main(argv=None):
    parser = argparse.ArgumentParser(description="batch cross-domain inference")
    parser.add_argument("--cfg", type=str, default="default")
    parser.add_argument("--models", type=str, nargs="+", required=True,
                        help="name=ckpt_path pairs")
    parser.add_argument("--datasets", type=str, nargs="+",
                        default=["kitti", "argo", "nusc", "lyft", "waymo"])
    parser.add_argument("--far_points", type=int, nargs="+", default=[4000])
    parser.add_argument("--one2one", action="store_true")
    parser.add_argument("--data_root_base", default="multi_data",
                        help="datasets live at <base>/<name> (synthetic "
                             "domain dirs work too)")
    parser.add_argument("--eval_mode", default="rcnn",
                        choices=("rcnn", "joint", "rpn", "rcnn_offline"))
    parser.add_argument("--out_base", default="output/rcnn")
    parser.add_argument("--dry_run", action="store_true",
                        help="print commands without running")
    parser.add_argument("--device", default=None,
                        help="passed on to each eval command (the eval "
                             "CLI's default, cuda, when not given)")
    args = parser.parse_args(argv)

    model_paths = dict(m.split("=", 1) for m in args.models)
    extra = ("--device", args.device) if args.device else ()
    for cmd in gen_commands(model_paths, args.datasets, args.far_points,
                            args.cfg, args.one2one, extra_flags=extra,
                            data_root_base=args.data_root_base,
                            eval_mode=args.eval_mode, out_base=args.out_base):
        print(" ".join(cmd))
        if not args.dry_run:
            subprocess.run(cmd, check=True)


if __name__ == "__main__":
    main()
