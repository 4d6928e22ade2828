"""The port's training CLI (``tpu3d_torch.tools.train_rcnn.main``) on the
CPU, and its validation pass against tpu3d's.

The CLI runs with ``--device cpu`` at configs/smoke.yaml (1024 points, the
RCNN at 128 points and 16 rois per scene; the MLPs at tests/test_model.py's
narrow widths) on synthetic KITTI frames written by the port, with GT
augmentation from the port's database, batches of 2 and ``TRAIN.SPLIT
trainval`` (3 steps an epoch on 6 frames). What tpu3d's
CLI has no test for is held here:

- resume: an unbroken 2-epoch run and a run resumed with ``--ckpt`` from
  its epoch-1 checkpoint end bit for bit equal (parameters, statistics,
  optimizer state, the last checkpoint's bytes, each step's loss);
- warm start: ``--rpn_ckpt`` grafts an RPN-mode checkpoint's RPN;
- the validation pass: ``make_eval_loss_step``'s metrics equal tpu3d's on
  the same weights and batch, in float32 (tpu3d's joint eval path does not
  trace in float64), with ``tests/test_torch_train.py``'s float32
  tolerance for its RCNN: the loss within 1e-5 relative, and each loss term
  within 1e-5 relative plus 1e-5 of the loss (as its gradients are held to
  their largest: a small term carries the rounding of the sums it is cut
  from); the counts (foreground points, recalled and all gt boxes)
  exactly.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from test_model import small_cfg
from test_torch_rpn import _numpy_variables, _port_cfg
from tpu3d.models import PointRCNN as JaxPointRCNN
from tpu3d.parallel.train_state import TrainState as JaxTrainState
from tpu3d.parallel.train_state import \
    make_eval_loss_step as jax_make_eval_loss_step
from tpu3d_torch.config import fresh_cfg
from tpu3d_torch.datasets import (BatchLoader, KittiRCNNDataset,
                                  create_synthetic_kitti)
from tpu3d_torch.models import PointRCNN
from tpu3d_torch.parallel import make_eval_loss_step, make_eval_step
from tpu3d_torch.tools import generate_gt_database as gtdb
from tpu3d_torch.tools import eval_rcnn, train_rcnn
from tpu3d_torch.tools.train_rcnn import main
from tpu3d_torch.utils import msgpack_io
from tpu3d_torch.weights import params_from_jax, seeded_state_dict

ROOT = Path(__file__).resolve().parents[1]


# configs/smoke.yaml's network at tests/test_model.py's narrow widths, so
# that a step and a checkpoint are cheap on the CPU
NARROW = {
    "RPN": {"SA_CONFIG": {"MLPS": [[[8, 8], [8, 8]], [[8, 16], [8, 16]],
                                   [[16, 16], [16, 16]],
                                   [[16, 32], [16, 32]]]},
            "FP_MLPS": [[32, 32], [32, 32], [32, 32], [64, 64]],
            "CLS_FC": [16], "REG_FC": [16]},
    "RCNN": {"SA_CONFIG": {"MLPS": [[16, 16], [16, 16], [16, 32]]},
             "XYZ_UP_LAYER": [16, 16], "CLS_FC": [16], "REG_FC": [16]},
}


def _merge(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            _merge(dst.setdefault(k, {}), v)
        else:
            dst[k] = v
    return dst


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The runs here write no tensorboard events: torch's SummaryWriter
    imports TensorFlow where it is installed, seconds per process, and
    nothing here reads the events (the card's run writes them)."""
    monkeypatch.setattr(train_rcnn, "create_tb_writer", lambda log_dir: None)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    root = str(base / "data")
    create_synthetic_kitti(root, n_frames=6, image_files=True, seed=2)
    db = gtdb.main(["--root", root, "--save_dir", str(base / "db")])
    with open(ROOT / "configs" / "smoke.yaml") as f:
        cfg = _merge(yaml.safe_load(f), NARROW)
    with open(base / "smoke_narrow.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    return base, root, db


def _args(data, out, mode="joint", epochs=2, *extra):
    base, root, db = data
    return (["--cfg_file", str(base / "smoke_narrow.yaml"), "--train_mode",
             mode,
             "--batch_size", "2", "--epochs", str(epochs), "--data_root",
             root, "--gt_database", db, "--ckpt_save_interval", "1",
             "--workers", "2", "--output_dir", str(base / out), "--device",
             "cpu", "--seed", "5"] + list(extra)
            + ["--set", "TRAIN.SPLIT", "trainval", "GT_AUG_ENABLED", "True"])


def _optimizer_state(run):
    return [{k: v.clone() for k, v in s.items()}
            for s in run.state.optimizer.opt.state.values()]


def test_resume_equals_unbroken_run(data):
    """Two epochs straight equal one epoch, then --ckpt, then one more,
    bit for bit, with the validation pass on; every loss is finite."""
    unbroken = main(_args(data, "a", "joint", 2, "--train_with_eval"))
    assert len(unbroken.checkpoints) == 2 and len(unbroken.losses) == 6
    assert np.isfinite(unbroken.losses).all()
    assert len(unbroken.val) == 2 and "recall" in unbroken.val[0]
    resumed = main(_args(data, "b", "joint", 2, "--train_with_eval",
                         "--ckpt", unbroken.checkpoints[0]))
    assert resumed.state.step == unbroken.state.step == 6
    assert resumed.losses == unbroken.losses[3:]
    assert resumed.val == unbroken.val[1:]
    a, b = unbroken.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    for x, y in zip(_optimizer_state(unbroken), _optimizer_state(resumed)):
        assert all(torch.equal(x[k], y[k]) for k in x)
    with open(unbroken.checkpoints[1], "rb") as f, \
            open(resumed.checkpoints[0], "rb") as g:
        assert f.read() == g.read()


def test_rpn_ckpt_grafts_the_rpn(data):
    """rcnn mode with --rpn_ckpt from an RPN-mode run: the RPN's parameters
    and statistics are the checkpoint's, the RCNN's the seeded ones."""
    rpn = main(_args(data, "rpn", "rpn", 1))
    with open(rpn.checkpoints[0], "rb") as f:
        saved = msgpack_io.decode(f.read())
    warm = main(_args(data, "warm", "rcnn", 0, "--rpn_ckpt",
                      rpn.checkpoints[0]))
    got = warm.model.state_dict()
    want = params_from_jax(saved["params"], saved["batch_stats"])
    seeded = seeded_state_dict(warm.model, 5)
    assert sorted(k for k in got if k.startswith("rpn.")) == sorted(want)
    for k, v in got.items():
        assert torch.equal(v, want[k] if k.startswith("rpn.") else seeded[k]), k


def test_profile_traces_steps_10_to_15(data):
    """--profile writes a torch.profiler trace of steps 10 to 15 into the
    run directory, as tpu3d's writes a jax one (6 epochs of 3 steps)."""
    base, _, _ = data
    run = main(_args(data, "prof", "rpn", 6, "--profile"))
    assert run.state.step == 18
    trace = base / "prof" / "profile" / "trace.json"
    assert trace.stat().st_size > 0
    assert '"traceEvents"' in trace.read_text()


def test_cli_wants_the_card_and_no_offline_mode(data):
    """Without --device cpu the CLI trains on the card and raises on a
    machine without one. rcnn_offline trains: from the RPN dumps of the
    port's eval CLI (rpn mode, --save_rpn_feature --save_result, on the
    same frames), one epoch of the RCNN alone, finite losses, a checkpoint
    holding the RCNN's parameters only; without its dump directories it
    raises."""
    base, root, _ = data
    args = _args(data, "x", "joint", 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([a for a in args if a not in ("--device", "cpu")])
    with pytest.raises(ValueError, match="rcnn_training_roi_dir"):
        main(_args(data, "y", "rcnn_offline", 1))
    eval_rcnn.main(["--cfg_file", str(base / "smoke_narrow.yaml"),
                    "--eval_mode", "rpn", "--data_root", root,
                    "--batch_size", "2", "--workers", "2",
                    "--save_rpn_feature", "--save_result", "--device", "cpu",
                    "--output_dir", str(base / "dumps"), "--set",
                    "TEST.SPLIT", "trainval"])
    run = main(_args(data, "offline", "rcnn_offline", 1,
                     "--rcnn_training_roi_dir",
                     str(base / "dumps" / "detections" / "data"),
                     "--rcnn_training_feature_dir",
                     str(base / "dumps" / "features")))
    assert len(run.losses) == 3 and np.isfinite(run.losses).all()
    assert run.state.step == run.state.opt_count == 3
    assert not hasattr(run.model, "rpn")
    with open(run.checkpoints[0], "rb") as f:
        saved = msgpack_io.decode(f.read())
    assert list(saved["params"]) == ["rcnn_net"]


@pytest.mark.parametrize("mode", ["joint", "rcnn"])
def test_eval_loss_step_matches(data, mode):
    """make_eval_loss_step's metrics against tpu3d's on the same weights
    and validation batch (two EVAL-mode scenes with their RPN labels): the
    loss within 1e-5 relative, each term within 1e-5 relative plus 1e-5 of
    the loss, the counts exactly. rcnn mode (fixed RPN) reports the recall
    alone. make_eval_step gives the eval-mode forward's outputs."""
    _, root, _ = data
    jcfg = small_cfg(rcnn=True)
    jcfg.RPN.FIXED = mode == "rcnn"
    cfg = _port_cfg(jcfg)
    ds = KittiRCNNDataset(root, npoints=jcfg.RPN.NUM_POINTS, split="val",
                          mode="EVAL", cfg=cfg, seed=3)
    batch = next(iter(BatchLoader(ds, batch_size=2)))
    batch = {k: batch[k] for k in ("pts_input", "gt_boxes3d",
                                   "rpn_cls_label", "rpn_reg_label")
             if k in batch}
    jmodel = JaxPointRCNN(cfg=jcfg, mode="TRAIN")
    shapes = jax.eval_shape(lambda p: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, {"pts_input": p}, train=False),
        batch["pts_input"])
    params, stats = _numpy_variables(shapes, np.random.default_rng(8))
    jstate = JaxTrainState(step=0, params=params, batch_stats=stats,
                           opt_state=None, tx=None)
    want = jax.device_get(jax.jit(jax_make_eval_loss_step(jcfg, jmodel))(
        jstate, batch))

    model = PointRCNN(cfg, mode="TRAIN", device="cpu")
    model.load_state_dict(params_from_jax(params, stats))
    got = make_eval_loss_step(cfg, model)(
        None, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(got) == sorted(want)
    assert int(want["gt_cnt"]) > 0
    for k, v in want.items():
        if k in ("recalled_cnt", "gt_cnt", "rpn_fg_sum"):
            assert int(got[k]) == int(v), k
        else:
            np.testing.assert_allclose(
                float(got[k]), float(v), rtol=1e-5,
                atol=0 if k == "loss" else 1e-5 * abs(float(want["loss"])),
                err_msg=k)
    if mode == "joint":
        assert float(want["rpn_loss"]) > 0
    # make_eval_step is the eval-mode forward itself
    pts = torch.from_numpy(batch["pts_input"])
    out = make_eval_step(cfg, model)(None, {"pts_input": pts})
    ref = model({"pts_input": pts}, train=False)
    assert sorted(out) == sorted(ref)
    assert all(torch.equal(out[k], ref[k]) for k in ref)
