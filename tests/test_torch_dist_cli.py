"""The port's CLIs over a data-parallel mesh of 2 gloo processes on the CPU
(as ``torchrun`` would start them, each with the same arguments), against
the same CLIs in one process; ``batch_inference``'s commands; and
``entry.dryrun_multichip(2)`` under gloo.

The CLIs run configs/smoke.yaml at ``tests/test_torch_train_cli.py``'s
narrow widths on 6 synthetic KITTI frames with ``--device cpu``:

- ``train_rcnn.main``, joint, ``--batch_size 2`` (one scene a rank), GT
  augmentation, ``--train_with_eval``, one epoch of 3 steps from a
  checkpoint of seeded weights (``--ckpt``, at step 0): rank 0 alone logs;
  both ranks end with the same checkpoint path, losses and validation
  metrics, and the checkpoint matches the one-process run's within the
  float32 noise floor: each step's loss within 1e-5 relative (the global
  loss, summed over the ranks in another order); the checkpoint's largest
  difference over all its tensors, and each validation metric's, within
  10 times the change that one-process training makes when every starting
  weight is nudged by about one float32 rounding (a factor
  1 + 1e-7·N(0, 1)), plus 1e-6 of the largest entry, as ``chip_smoke.py``
  bounds the card's gradients. Adam's early steps are nearly sign steps,
  so a gradient near zero whose sign a rounding flips moves its parameter
  by up to 2·lr a step, in both comparisons alike;
- ``eval_rcnn.main`` in joint, rcnn and rpn modes (``--batch_size 2``, the
  last batch padded; rpn with ``--save_rpn_feature``) from one checkpoint
  of seeded weights whose classification biases are raised, and in
  rcnn_offline mode on the one-process rpn run's dumps: rank 0 writes
  the same label files (within 1.5e-4, as ``tests/test_torch_eval_cli.py``
  holds them), dumps (within 1e-5) and recall tables (equal) as one
  process, and rank 1 returns None.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import _torch_dist_cases as cases
from test_torch_eval_cli import _same_label_files
from test_torch_train_cli import NARROW, _merge
from tpu3d.tools import batch_inference as jax_batch_inference
from tpu3d_torch.config import cfg_from_file, fresh_cfg
from tpu3d_torch.datasets import create_synthetic_kitti
from tpu3d_torch.entry import dryrun_multichip, spawn
from tpu3d_torch.models import PointRCNN
from tpu3d_torch.parallel import create_train_state
from tpu3d_torch.tools import batch_inference, eval_rcnn, train_rcnn
from tpu3d_torch.tools import generate_gt_database as gtdb
from tpu3d_torch.tools.train_rcnn import configure_mode
from tpu3d_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tpu3d_torch.weights import seeded_state_dict

ROOT = Path(__file__).resolve().parents[1]
SPLIT = ["--set", "TEST.SPLIT", "train"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's processes compute on one thread each, the spawned
    ranks too (OMP_NUM_THREADS rides into them): several ranks and the
    test process share the host's cores with the other test workers, and
    torch's intra-op threads on a loaded host wait for each other far
    longer than they save."""
    n = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        torch.set_num_threads(1)
        try:
            yield
        finally:
            torch.set_num_threads(n)


@pytest.fixture(scope="module")
def w(tmp_path_factory):
    """The frames, GT database, narrow config and an eval checkpoint; the
    one-process runs; the 2-rank runs of the same argument lists."""
    base = tmp_path_factory.mktemp("distcli")
    root = str(base / "data")
    create_synthetic_kitti(root, n_frames=6, image_files=True, seed=2)
    db = gtdb.main(["--root", root, "--save_dir", str(base / "db")])
    with open(ROOT / "configs" / "smoke.yaml") as f:
        narrow = _merge(yaml.safe_load(f), NARROW)
    cfg_file = str(base / "narrow.yaml")
    with open(cfg_file, "w") as f:
        yaml.safe_dump(narrow, f)
    cfg = configure_mode(cfg_from_file(cfg_file, fresh_cfg()), "joint")
    model = PointRCNN(cfg, mode="TRAIN", device="cpu")
    model.load_state_dict(cases.surgery_state(model))
    ckpt = save_checkpoint(str(base / "ckpt"), model,
                           create_train_state(cfg, model, 1, 1), 1)
    # the training runs' start, exact and nudged
    starts = {}
    for tag, nudge in (("exact", 0.0), ("nudged", 1e-7)):
        gen = torch.Generator().manual_seed(11)
        model.load_state_dict({
            k: v * (1 + nudge * torch.randn(v.shape, generator=gen))
            if v.is_floating_point() else v
            for k, v in seeded_state_dict(model, 5).items()})
        starts[tag] = save_checkpoint(str(base / tag), model,
                                      create_train_state(cfg, model, 3, 1),
                                      0)

    def train_job(tag, start):
        return ("tpu3d_torch.tools.train_rcnn", [
            "--cfg_file", cfg_file, "--train_mode", "joint",
            "--batch_size", "2", "--epochs", "1", "--data_root", root,
            "--gt_database", db, "--workers", "2", "--train_with_eval",
            "--ckpt", starts[start], "--output_dir",
            str(base / tag / "train"), "--device", "cpu", "--seed", "5",
            "--set", "TRAIN.SPLIT", "trainval", "GT_AUG_ENABLED", "True"])

    # rcnn_offline reads the one-process rpn run's dumps, its weights
    # seeded (the joint checkpoint holds an RPN this mode has not)
    dumps = base / "one" / "rpn"
    extras = {"joint": ["--ckpt", ckpt], "rcnn": ["--ckpt", ckpt],
              "rpn": ["--ckpt", ckpt, "--save_rpn_feature"],
              "rcnn_offline": [
                  "--rcnn_eval_roi_dir", str(dumps / "detections" / "data"),
                  "--rcnn_eval_feature_dir", str(dumps / "features")]}

    def jobs(tag):
        out = [train_job(tag, "exact")]
        for mode, extra in extras.items():
            out.append(("tpu3d_torch.tools.eval_rcnn", [
                "--cfg_file", cfg_file, "--eval_mode", mode, "--data_root",
                root, "--batch_size", "2", "--workers", "2",
                "--save_result", *extra, "--output_dir",
                str(base / tag / mode), "--device", "cpu", *SPLIT]))
        return out

    one = []
    for module, argv in jobs("one") + [train_job("nudged", "nudged")]:
        mod = {"tpu3d_torch.tools.train_rcnn": train_rcnn,
               "tpu3d_torch.tools.eval_rcnn": eval_rcnn}[module]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(train_rcnn, "create_tb_writer", lambda log_dir: None)
            got = mod.main(argv)
        if hasattr(got, "state"):
            got = {"losses": got.losses, "checkpoints": got.checkpoints,
                   "val": got.val}
        one.append(got)
    torch.save(jobs("two"), base / "jobs.pt")
    spawn(cases.run_cli, 2, str(base / "jobs.pt"), str(base / "two.out"))
    two = [torch.load(base / f"two.out.{r}", weights_only=False)
           for r in range(2)]
    return {"base": base, "cfg": cfg_file, "one": one, "two": two}


def test_train_cli_rank0_logs_and_both_ranks_agree(w):
    """Rank 0 alone logs; both ranks report the same checkpoint, the same
    losses (the global batch's) and validation metrics; the log holds one
    run."""
    (r0, logs0), (r1, logs1) = w["two"][0][0], w["two"][1][0]
    assert logs0 and not logs1
    assert r0["checkpoints"] == r1["checkpoints"] and r0["checkpoints"]
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 3
    assert r0["val"] == r1["val"] and "recall" in r0["val"][0]
    log = (w["base"] / "two" / "train" / "log_train.txt").read_text()
    assert log.count("Start logging") == 1


def _cfg_model(path):
    cfg = configure_mode(cfg_from_file(path, fresh_cfg()), "joint")
    model = PointRCNN(cfg, mode="TRAIN", device="cpu")
    state = create_train_state(cfg, model, 3, 1)
    return cfg, model, state


def test_train_cli_checkpoint_matches_one_process(w):
    """The 2-rank run's checkpoint against the one-process run's, under the
    module's float32 noise floor; step and epoch equal; the losses within
    1e-5 relative; the validation metrics under the floor."""
    one, two, nudged = w["one"][0], w["two"][0][0][0], w["one"][-1]
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    for k, v in one["val"][0].items():
        floor = abs(nudged["val"][0][k] - v)
        assert abs(two["val"][0][k] - v) <= 10 * floor + 1e-6 * abs(v), k

    def trained(run):
        _, model, state = _cfg_model(w["cfg"])
        state, epoch = load_checkpoint(run["checkpoints"][-1], model, state)
        return model.state_dict(), (epoch, state.step)

    (ref, at), (got, at2), (near, _) = map(trained, (one, two, nudged))
    assert at == at2 == (1, 3)
    floats = [k for k, v in ref.items() if v.is_floating_point()]
    for k in set(ref) - set(floats):
        assert torch.equal(got[k], ref[k]), k

    def largest(a):
        return max((a[k] - ref[k]).abs().max().item() for k in floats)

    err, floor = largest(got), largest(near)
    top = max(ref[k].abs().max().item() for k in floats)
    assert 0 < floor and err <= 10 * floor + 1e-6 * top, (err, floor)


@pytest.mark.parametrize("mode", ["joint", "rcnn", "rpn", "rcnn_offline"])
def test_eval_cli_rank0_writes_what_one_process_writes(w, mode):
    """Rank 0's tables equal one process's, rank 1 returns None and logs
    nothing, and the label files match line for line."""
    i = {"joint": 1, "rcnn": 2, "rpn": 3, "rcnn_offline": 4}[mode]
    one = w["one"][i]
    (got, logs0), (other, logs1) = w["two"][0][i], w["two"][1][i]
    assert other is None and logs0 and not logs1
    assert sorted(got) == sorted(one)
    for k, v in one.items():
        if k not in ("final_output_dir", "scenes_per_sec"):
            assert got[k] == v, k
    subs = (["detections/data"] if mode == "rpn"
            else ["final_result/data", "roi_result/data",
                  "refine_result/data"])
    for sub in subs:
        lines = _same_label_files(w["base"] / "two" / mode / sub,
                                  w["base"] / "one" / mode / sub)
        if sub != "refine_result/data":
            assert lines > 0, sub


def test_eval_cli_rank0_dumps_what_one_process_dumps(w):
    """rpn mode's dumps (features/, seg_result/): the same files, shapes
    and dtypes, values within 1e-5 (the float16 seg files equal)."""
    ours, ref = w["base"] / "two" / "rpn", w["base"] / "one" / "rpn"
    for sub in ("features", "seg_result"):
        names = sorted(p.name for p in (ref / sub).iterdir())
        assert names and names == sorted(p.name for p in (ours / sub).iterdir())
        for name in names:
            a, b = np.load(ours / sub / name), np.load(ref / sub / name)
            assert (a.dtype, a.shape) == (b.dtype, b.shape), name
            if a.dtype in (np.float16, bool):
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5,
                                           err_msg=name)


@pytest.mark.parametrize("cards", [1, 4])
def test_batch_inference_commands(cards, monkeypatch, capsys):
    """--dry_run prints tpu3d's commands with the port's eval module: a
    plain ``python -m`` with one visible card, under ``torchrun
    --standalone --nproc_per_node 4`` with four."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    argv = ["--models", "kitti=ckpt/checkpoint_epoch_1.msgpack", "b=dir",
            "--datasets", "kitti", "argo2", "--far_points", "4000", "8000",
            "--eval_mode", "joint", "--dry_run"]
    batch_inference.main(argv)
    got = capsys.readouterr().out.splitlines()
    jax_batch_inference.main(argv)
    want = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 8
    prefix = ("python -m " if cards == 1 else
              "torchrun --standalone --nproc_per_node 4 -m ")
    for g, t in zip(got, want):
        assert t.startswith("python -m tpu3d.tools.eval_rcnn ")
        assert g == prefix + t[len("python -m "):].replace(
            "tpu3d.tools.eval_rcnn", "tpu3d_torch.tools.eval_rcnn", 1)


def test_dryrun_multichip_two_gloo_ranks(capsys):
    """One data-parallel train step at the 4096-point mid shape and the
    sharded eval over 2 gloo processes on the CPU, with tpu3d's dry run's
    assertions (rank 0 asserts them)."""
    got = dryrun_multichip(2, backend="gloo", device="cpu")
    assert np.isfinite(got["loss"]) and got["step"] == 1
    assert got["scenes"] == 4 and got["detections"] > 0
    assert got["recall_0.1"] > 0
    assert "eval OK" in capsys.readouterr().out


def test_dryrun_multichip_nccl_wants_a_card_each():
    """Under NCCL (the default on cards) too few cards raise; without a
    card the default device raises before any process starts."""
    with pytest.raises(RuntimeError):
        dryrun_multichip(max(2, torch.cuda.device_count() + 1))
