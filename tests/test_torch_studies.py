"""The port's studies against tpu3d's ``examples/`` on the CPU.

The host steps are held equal to the examples': the layout bridges (files
and links), the domains, their car statistics and the converted
A_scaledto_B tree, byte for byte (the same seeds, the synthetic generator
byte-equal between the packages). Then ``statnorm_effect`` runs whole on
the CPU at a smoke scale (8 frames, 2 epochs, ``configs/smoke.yaml``):
its summary keeps the example's shape, A_scaledto_B's car means land
within 0.01 m of B's, and every AP is a finite number in [0, 100]. The
other two studies' commands and tables are held to the examples' form.
"""

import json
import math
import os
import sys
from types import SimpleNamespace

import pytest

from examples import statnorm_effect as jstudy
from test_torch_stat_norm import tree
from tpu3d.datasets import create_synthetic_kitti as jax_create
from tpu3d.stat_norm.norm import convert as jax_convert
from tpu3d.stat_norm.stat import get_dataset_stats as jax_stats
from tpu3d_torch.studies import domain_matrix, multiclass_cyclist
from tpu3d_torch.studies import statnorm_effect as study
from tpu3d_torch.tools import batch_inference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 4


def _example_domains(out):
    """The example's steps 1-3 with tpu3d's functions (examples/
    statnorm_effect.py:146-166)."""
    dom_a, dom_b = os.path.join(out, "domain_a"), os.path.join(out,
                                                                "domain_b")
    jax_create(dom_a, n_frames=FRAMES, seed=1, image_files=True,
               car_dims_mean=jstudy.KITTI_CARS)
    jax_create(dom_b, n_frames=FRAMES, seed=2, image_files=True,
               car_dims_mean=jstudy.US_CARS)
    stat_a = jstudy.stat_layout(dom_a, os.path.join(out, "stat_a"))
    stat_b = jstudy.stat_layout(dom_b, os.path.join(out, "stat_b"))
    sa, sb = jax_stats(stat_a), jax_stats(stat_b)
    converted = jax_convert("syn_a", "syn_b", spath=stat_a,
                            dpath=os.path.join(out, "rescaled"),
                            dst_stats_path=stat_b, image_size=(1242, 375))
    a2b = jstudy.kitti_layout(converted, os.path.join(out, "domain_a2b"))
    s_a2b = jax_stats(jstudy.stat_layout(a2b, os.path.join(out, "stat_a2b")),
                      force=True)
    return sa, sb, s_a2b


def _relative(t, out):
    """Link targets relative to the run's directory, so two runs compare."""
    return {k: (v[0], os.path.relpath(v[1], out)) if isinstance(v, tuple)
            else v for k, v in t.items()}


def test_domain_steps_equal_examples(tmp_path):
    """The layout bridges, the domains, their statistics and the converted
    tree: the port's study steps against the example's, byte for byte."""
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    args = SimpleNamespace(out=ours, frames=FRAMES)
    _, stats = study.make_domains(args, study.KITTI_CARS, study.US_CARS)
    assert tuple(stats) == _example_domains(ref)
    assert (study.KITTI_CARS, study.US_CARS) == (jstudy.KITTI_CARS,
                                                 jstudy.US_CARS)
    for sub in ("domain_a", "stat_a", "stat_b", "rescaled", "domain_a2b",
                "stat_a2b"):
        assert _relative(tree(os.path.join(ours, sub)), ours) == \
            _relative(tree(os.path.join(ref, sub)), ref), sub


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("statnorm_smoke")
    summary = study.main(["--out", str(out), "--frames", "8", "--epochs",
                          "2", "--cfg", os.path.join(ROOT, "configs",
                                                     "smoke.yaml"),
                          "--device", "cpu"])
    return out, summary


def test_statnorm_effect_runs_on_cpu(smoke_run, capfd):
    """The whole study on the CPU at smoke scale: summary.json in the
    example's shape, A_scaledto_B's car means within 0.01 m of B's, three
    AP tables of finite values."""
    out, summary = smoke_run
    with open(out / "summary.json") as f:
        assert json.load(f) == summary
    assert set(summary) == {"stats", "results"}
    assert set(summary["stats"]) == {"A", "B", "A_scaledto_B"}
    a2b, b = summary["stats"]["A_scaledto_B"], summary["stats"]["B"]
    for k in ("height", "width", "length"):
        assert abs(a2b[k]["mean"] - b[k]["mean"]) < 0.01, k
    assert list(summary["results"]) == ["A->B (no adaptation)",
                                        "A_scaledto_B->B (statnorm)",
                                        "A->A (in-domain ceiling)"]
    for aps in summary["results"].values():
        assert {f"Car_{m}_{d}" for m in ("3d", "bev")
                for d in ("easy", "moderate", "hard")} <= set(aps)
        assert all(math.isfinite(v) and 0 <= v <= 100 for v in aps.values())
    # a second run with other domains into the same directory is refused
    with pytest.raises(SystemExit, match="different domains"):
        study.main(["--out", str(out), "--frames", "8", "--reverse",
                    "--device", "cpu"])


def test_other_studies_commands(tmp_path, capsys):
    """multiclass_cyclist's overrides are the example's; domain_matrix's
    batch inference runs the eval CLI on the requested device, and its
    tables keep the example's form."""
    assert multiclass_cyclist.overrides("Cyclist", False) == \
        ["CLASSES", "Cyclist"]
    assert multiclass_cyclist.overrides("Cyclist", True) == \
        ["CLASSES", "Cyclist", "CLS_MEAN_SIZE", "[[1.74, 0.60, 1.76]]"]
    args = SimpleNamespace(device="cpu")
    cmd = domain_matrix.batch_inference_cmd({"S": "ckpt_s"}, ["S", "K"],
                                            "domains", "matrix",
                                            "quickstart", args)
    assert cmd[:3] == [sys.executable, "-m",
                       "tpu3d_torch.tools.batch_inference"]
    batch_inference.main(cmd[3:] + ["--dry_run"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    assert all(line.endswith("--device cpu") for line in lines)
    assert "--data_root domains/K" in lines[1]
    table = domain_matrix.table(
        {"S->S": {"Car_3d_moderate": 12.345}}, "No adaptation")
    assert "| S | 12.35 | — | — |" in table
