"""The port's eval CLI (``tpu3d_torch.tools.eval_rcnn.main``) against
tpu3d's on the CPU, and the RCNN-offline chain from tpu3d's RPN dumps.

Both CLIs run configs/smoke.yaml at tests/test_torch_train_cli.py's narrow
widths (1024 points, 64 proposals per scene) on 6 synthetic KITTI frames
(``TEST.SPLIT train``: 3 frames, batches of 2, the last one padded), from
one tpu3d-format checkpoint of flax-initialized weights; the port with ``--device
cpu``. Held:

- the recall tables (final boxes and rois at IoU 0.1 ... 0.9, the RPN's
  seg IoU) and the average detections equal. ``rcnn`` mode (RPN.FIXED,
  which changes nothing at eval) is held to tpu3d's ``joint`` run;
- the label files (final_result, roi_result, refine_result, the RPN's
  detections): the same files and lines, the numbers within 1.5e-4 (each
  is printed with ``%.4f``, and a value 1e-7 apart can print one digit
  apart), and ``save_kitti_format`` byte-equal on identical inputs;
- the RPN dumps: tpu3d's names, shapes and dtypes, values within 1e-5;
- ``repeat_eval_ckpt`` over two checkpoints (``--wait_seconds 0
  --max_waitmins 0``: no test waits);
- the offline chain on tpu3d's dumps: one ``rcnn_offline`` train step
  against tpu3d's (the loss and the parameters within 1e-5), and the
  ``rcnn_offline`` eval against tpu3d's (label files as above, both cls
  accuracies and the recall tables equal).

A proposal swap (RPN scores ~1e-6 apart between the packages) would show
as a line-order difference in the roi files; on these weights there is
none, so the whole pipeline is held.
"""

import contextlib
import copy
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_train_cli import NARROW, _merge
from tpu3d.config import cfg as jax_global_cfg
from tpu3d.config import cfg_from_file as jax_cfg_from_file
from tpu3d.config import fresh_cfg as jax_fresh_cfg
from tpu3d.datasets import KittiRCNNDataset as JaxDataset
from tpu3d.models import PointRCNN as JaxPointRCNN
from tpu3d.parallel import train_state as jax_ts
from tpu3d.tools import eval_rcnn as jax_eval
from tpu3d.tools import train_rcnn as jax_train
from tpu3d.utils.checkpoint import save_checkpoint as jax_save
from tpu3d_torch.config import cfg_from_file, fresh_cfg
from tpu3d_torch.datasets import (BatchLoader, KittiRCNNDataset,
                                  create_synthetic_kitti)
from tpu3d_torch.kitti import Calibration, objs_to_boxes3d, read_label
from tpu3d_torch.models import PointRCNN
from tpu3d_torch.parallel import create_train_state, make_train_step
from tpu3d_torch.tools import eval_rcnn
from tpu3d_torch.tools.train_rcnn import configure_mode
from tpu3d_torch.weights import params_from_jax, params_to_jax

ROOT = Path(__file__).resolve().parents[1]
SPLIT = ["--set", "TEST.SPLIT", "train"]


@contextlib.contextmanager
def _tpu3d_cli():
    """tpu3d's CLIs merge into its global config and switch on JAX's
    persistent compilation cache: start them from the defaults, keep the
    cache off, and leave the global config as it was."""
    saved = copy.deepcopy(dict(jax_global_cfg))
    jax_global_cfg.clear()
    jax_global_cfg.update(jax_fresh_cfg())
    update = jax.config.update
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.config, "update", lambda k, v: None if "cache" in k
                   else update(k, v))
        try:
            yield jax_global_cfg
        finally:
            jax_global_cfg.clear()
            jax_global_cfg.update(saved)


def _jax_state(jcfg, pts_shape, seed):
    """tpu3d's model and TrainState for ``jcfg``, initialized by flax from
    ``PRNGKey(seed)`` as tpu3d's eval CLI initializes it."""
    jmodel = JaxPointRCNN(cfg=jcfg, mode="TRAIN")
    return jmodel, jax_ts.create_train_state(
        jcfg, jmodel, {"pts_input": np.zeros(pts_shape, np.float32)},
        jax.random.PRNGKey(seed), 1, 1, train=False)


def _common(w, mode, ckpt, *extra):
    return (["--cfg_file", str(w["cfg"]), "--eval_mode", mode,
             "--data_root", w["root"], "--batch_size", "2", "--workers", "2",
             "--ckpt", ckpt, "--save_result", *extra])


@pytest.fixture(scope="module")
def w(tmp_path_factory):
    """The frames, the narrow config, a joint checkpoint, and each CLI's
    joint and rpn runs (the rpn ones with --save_rpn_feature), the port's
    rcnn run."""
    base = tmp_path_factory.mktemp("evalcli")
    root = str(base / "data")
    create_synthetic_kitti(root, n_frames=6, image_files=True, seed=2)
    with open(ROOT / "configs" / "smoke.yaml") as f:
        narrow = _merge(yaml.safe_load(f), NARROW)
    with open(base / "narrow.yaml", "w") as f:
        yaml.safe_dump(narrow, f)
    w = {"base": base, "root": root, "cfg": base / "narrow.yaml"}
    with _tpu3d_cli() as jcfg:
        jax_cfg_from_file(str(w["cfg"]))
        jax_train.configure_mode("joint")
        _, state = _jax_state(jcfg, (1, 1024, 3), 7)
        w["ckpt"] = jax_save(str(base / "ckpt"), state, 1)
        for mode in ("joint", "rpn"):
            extra = ["--save_rpn_feature"] if mode == "rpn" else []
            w[("tpu3d", mode)] = jax_eval.main(
                _common(w, mode, w["ckpt"], *extra, "--output_dir",
                        str(base / f"tpu3d_{mode}"), *SPLIT))
    for mode in ("joint", "rcnn", "rpn"):
        extra = ["--save_rpn_feature"] if mode == "rpn" else []
        w[("port", mode)] = eval_rcnn.main(
            _common(w, mode, w["ckpt"], *extra, "--output_dir",
                    str(base / f"port_{mode}"), "--device", "cpu", *SPLIT))
    return w


def _labels(path):
    rows = [line.split() for line in Path(path).read_text().splitlines()]
    return ([r[0] for r in rows],
            np.array([[float(x) for x in r[1:]] for r in rows]).reshape(
                len(rows), -1))


def _same_label_files(a: Path, b: Path):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir()) and names
    lines = 0
    for name in names:
        (ca, va), (cb, vb) = _labels(a / name), _labels(b / name)
        assert ca == cb, name
        np.testing.assert_allclose(va, vb, rtol=0, atol=1.5e-4, err_msg=name)
        lines += len(ca)
    return lines


def _same_metrics(got: dict, want: dict):
    for k, v in want.items():
        if k in ("final_output_dir", "scenes_per_sec"):
            continue
        assert got[k] == v, k


@pytest.mark.parametrize("mode,ref", [("joint", "joint"), ("rcnn", "joint"),
                                      ("rpn", "rpn")])
def test_recall_tables_match(w, mode, ref):
    """The returned tables equal tpu3d's: recall and roi recall at every
    threshold, the average detections and empty files (joint, rcnn), the
    RPN's seg IoU and proposal recall (rpn); the port times scenes/s."""
    got, want = w[("port", mode)], w[("tpu3d", ref)]
    assert sorted(got) == sorted(want)
    _same_metrics(got, want)
    if mode != "rpn":
        assert got["scenes_per_sec"] > 0
        assert want["recall"][0.1] > 0 or want["roi_recall"][0.1] > 0


@pytest.mark.parametrize("mode,sub", [
    ("joint", "final_result/data"), ("joint", "roi_result/data"),
    ("joint", "refine_result/data"), ("rcnn", "final_result/data"),
    ("rpn", "detections/data")])
def test_label_files_match(w, mode, sub):
    """Every label file, line for line, within 1.5e-4."""
    ref = "joint" if mode == "rcnn" else mode
    lines = _same_label_files(w["base"] / f"port_{mode}" / sub,
                              w["base"] / f"tpu3d_{ref}" / sub)
    assert lines > 0


def test_rpn_dumps_match(w):
    """features/%06d{,_xyz,_seg,_intensity,_rawscore}.npy and seg_result/
    in tpu3d's names, shapes and dtypes, features (N, C); values within
    1e-5 (the fp16 seg file and the mask equal)."""
    ours, ref = w["base"] / "port_rpn", w["base"] / "tpu3d_rpn"
    for sub in ("features", "seg_result"):
        names = sorted(p.name for p in (ref / sub).iterdir())
        assert names == sorted(p.name for p in (ours / sub).iterdir())
        for name in names:
            a, b = np.load(ours / sub / name), np.load(ref / sub / name)
            assert (a.dtype, a.shape) == (b.dtype, b.shape), name
            if a.dtype in (np.float16, bool):
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5,
                                           err_msg=name)
    assert np.load(ours / "features" / "000000.npy").shape == (1024, 32)
    assert np.load(ours / "seg_result" / "000000.npy").dtype == np.float16


def test_save_kitti_format_byte_equal(w, tmp_path):
    """The same boxes and scores written by both packages' save_kitti_format
    give the same bytes: boxes inside and outside the image, and none."""
    calib_file = Path(w["root"]) / "KITTI" / "object" / "training" / \
        "calib" / "000000.txt"
    calib = Calibration(str(calib_file))
    rng = np.random.default_rng(0)
    boxes = np.concatenate([
        rng.uniform([-10, 1, 5, 1.3, 1.5, 3.5, -3], [10, 2, 60, 1.8, 1.8, 4.5,
                                                      3], (20, 7)),
        [[0.0, 1.6, 1.5, 1.5, 1.6, 3.9, 0.0]]]).astype(np.float32)
    scores = rng.normal(0, 2, len(boxes)).astype(np.float32)
    for side, fn in (("a", eval_rcnn.save_kitti_format),
                     ("b", jax_eval.save_kitti_format)):
        (tmp_path / side).mkdir()
        n = fn(3, calib, boxes, str(tmp_path / side), scores, (375, 1242))
        fn(4, calib, boxes[:0], str(tmp_path / side), scores[:0], (375, 1242))
        assert 0 < n < len(boxes)
    for name in ("000003.txt", "000004.txt"):
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes()


def test_repeat_eval_ckpt_over_two_checkpoints(w):
    """--eval_all over a directory of two checkpoints evaluates each once
    into epoch_<n>/, records them in eval_list_val.txt and returns at once
    with --max_waitmins 0; epoch 1 (the fixture's checkpoint) gives the
    single run's tables; a second call finds nothing new."""
    ckpt_dir = w["base"] / "ckpts"
    ckpt_dir.mkdir()
    shutil.copy(w["ckpt"], ckpt_dir / "checkpoint_epoch_1.msgpack")
    with _tpu3d_cli() as jcfg:
        jax_cfg_from_file(str(w["cfg"]))
        jax_train.configure_mode("joint")
        _, state = _jax_state(jcfg, (1, 1024, 3), 8)
        jax_save(str(ckpt_dir), state, 2)
    out = w["base"] / "repeat"
    args = ["--cfg_file", str(w["cfg"]), "--eval_mode", "joint",
            "--data_root", w["root"], "--batch_size", "2", "--workers", "2",
            "--eval_all", "--ckpt_dir", str(ckpt_dir), "--wait_seconds", "0",
            "--max_waitmins", "0", "--output_dir", str(out), "--device",
            "cpu", *SPLIT]
    results = eval_rcnn.main(args)
    assert sorted(results) == [1, 2]
    assert (out / "eval_list_val.txt").read_text() == "1\n2"
    for epoch in (1, 2):
        assert len(list((out / f"epoch_{epoch}" / "final_result" / "data")
                        .iterdir())) == 3
    _same_metrics(results[1], w[("port", "joint")])
    assert eval_rcnn.main(args) == {}


def _offline_cfgs(w):
    """The narrow config in rcnn_offline mode, in each package's tree."""
    jcfg = jax_cfg_from_file(str(w["cfg"]), jax_fresh_cfg())
    jcfg.RCNN.ENABLED, jcfg.RPN.ENABLED = True, False
    return jcfg, configure_mode(cfg_from_file(str(w["cfg"]), fresh_cfg()),
                                "rcnn_offline")


def _proposals_with_gt(w):
    """tpu3d's proposal files with each frame's gt boxes, jittered by
    N(0, 0.1), put first (the eval loader keeps the first
    TEST.RPN_POST_NMS_TOP_N): the RPN of random weights proposes no box near a
    gt, and a train step without foreground rois has no regression loss."""
    out = w["base"] / "rois_with_gt"
    if out.exists():
        return out
    shutil.copytree(w["base"] / "tpu3d_rpn" / "detections" / "data", out)
    rng = np.random.default_rng(0)
    labels = Path(w["root"]) / "KITTI" / "object" / "training" / "label_2"
    for f in sorted(out.iterdir()):
        gt = objs_to_boxes3d([o for o in read_label(str(labels / f.name))
                              if o.cls_type == "Car"])
        lines = ["Car -1 -1 0.0 0 0 50 50 %.4f %.4f %.4f %.4f %.4f %.4f %.4f "
                 "0.5" % (b[3], b[4], b[5], b[0], b[1], b[2], b[6])
                 for b in gt + rng.normal(0, 0.1, gt.shape)]
        f.write_text("".join(x + "\n" for x in lines) + f.read_text())
    return out


def test_offline_train_step_matches(w):
    """tpu3d's RPN dumps (its proposals after the gt boxes jittered)
    -> the offline TRAIN loader (batch of 2: 32 rois of 128 points) -> one
    rcnn_offline train step in each package from the same RCNN-only
    weights (params_from_jax takes the RCNN-only tree and params_to_jax
    gives it back): the loss and every parameter after the update within
    1e-5."""
    jcfg, cfg = _offline_cfgs(w)
    dumps = w["base"] / "tpu3d_rpn"
    kw = dict(npoints=1024, split="train", mode="TRAIN", seed=3,
              rcnn_training_roi_dir=str(_proposals_with_gt(w)),
              rcnn_training_feature_dir=str(dumps / "features"))
    batch = next(iter(BatchLoader(KittiRCNNDataset(w["root"], cfg=cfg, **kw),
                                  batch_size=2)))
    jbatch = next(iter(BatchLoader(JaxDataset(w["root"], cfg=jcfg, **kw),
                                   batch_size=2)))
    keys = ("pts_input", "cls_label", "reg_valid_mask", "gt_boxes3d_ct",
            "roi_boxes3d")
    for k in keys:
        np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)
    assert batch["pts_input"].shape == (2, 16, 128, 3 + 2 + 32)
    assert (batch["reg_valid_mask"] > 0).sum() > 0

    pts = batch["pts_input"]
    jmodel, jstate = _jax_state(jcfg, (pts.shape[0] * pts.shape[1],
                                       *pts.shape[2:]), 9)
    assert list(jstate.params) == ["rcnn_net"]
    model = PointRCNN(cfg, mode="TRAIN", device="cpu")
    assert not hasattr(model, "rpn")
    sd = params_from_jax(jstate.params, jstate.batch_stats)
    model.load_state_dict(sd)
    back = params_to_jax(model.state_dict())[0]
    for (path, a), (_, b) in zip(_leaves(back), _leaves(jstate.params)):
        np.testing.assert_array_equal(a, b, err_msg=path)

    jstep = jax.jit(jax_ts.make_train_step(jcfg, jmodel))
    jnext, jtb = jstep(jstate, {k: jnp.asarray(batch[k]) for k in keys},
                       jax.random.PRNGKey(0), 0.9)
    state = create_train_state(cfg, model, 1, 1)
    tb = make_train_step(cfg, model)(
        state, {k: torch.from_numpy(batch[k]) for k in keys}, None, 0.9)
    np.testing.assert_allclose(float(tb["loss"]), float(jtb["loss"]),
                               rtol=1e-5, atol=1e-5)
    assert float(tb["rcnn_reg_fg"]) == float(jtb["rcnn_reg_fg"]) > 0
    got = dict(_leaves(params_to_jax(model.state_dict())[0]))
    for path, want in _leaves(jax.device_get(jnext.params)):
        np.testing.assert_allclose(got[path], want, rtol=1e-5, atol=1e-5,
                                   err_msg=path)


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if hasattr(tree[k], "items"):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(tree[k])


def test_offline_eval_matches(w):
    """rcnn_offline eval over tpu3d's dumps (its proposals after the gt
    boxes jittered) with an RCNN-only tpu3d checkpoint, in both
    CLIs: the label files as above, both cls accuracies,
    the recall tables and the average detections equal."""
    base = w["base"]
    dumps = base / "tpu3d_rpn"
    with _tpu3d_cli() as jcfg:
        jax_cfg_from_file(str(w["cfg"]))
        jax_train.configure_mode("rcnn_offline")
        _, state = _jax_state(jcfg, (64, 128, 3 + 2 + 32), 10)
        ckpt = jax_save(str(base / "ckpt_offline"), state, 1)
        extra = ["--rcnn_eval_roi_dir", str(_proposals_with_gt(w)),
                 "--rcnn_eval_feature_dir", str(dumps / "features")]
        want = jax_eval.main(_common(w, "rcnn_offline", ckpt, *extra,
                                     "--output_dir", str(base / "tpu3d_off"),
                                     *SPLIT))
    got = eval_rcnn.main(_common(w, "rcnn_offline", ckpt, *extra,
                                 "--output_dir", str(base / "port_off"),
                                 "--device", "cpu", *SPLIT))
    assert sorted(got) == sorted(want)
    _same_metrics(got, want)
    assert 0 < got["rcnn_cls_acc"] and 0 < got["rcnn_cls_acc_refined"]
    for sub in ("final_result/data", "roi_result/data", "refine_result/data"):
        assert _same_label_files(base / "port_off" / sub,
                                 base / "tpu3d_off" / sub) > 0


@pytest.mark.parametrize("size_res_on_roi", [False, True])
def test_decode_anchors_on_roi_size(w, size_res_on_roi):
    """rcnn_decode_and_nms with each roi's size given (the offline eval's
    roi_size): with RCNN.SIZE_RES_ON_ROI the size residuals scale each
    roi's size, else CLS_MEAN_SIZE[0], as tpu3d's (small residuals keep
    the anchor's size within 5%); the decoded boxes within 1e-5 of
    tpu3d's, the NMS keeps equal."""
    jcfg, cfg = _offline_cfgs(w)
    jcfg.RCNN.SIZE_RES_ON_ROI = cfg.RCNN.SIZE_RES_ON_ROI = size_res_on_roi
    rng = np.random.default_rng(4)
    b, m = 2, 16
    rois = np.concatenate([
        rng.uniform([-10, 1, 10], [10, 2, 40], (b, m, 3)),
        rng.uniform([1.3, 1.4, 3.2], [1.9, 1.9, 4.8], (b, m, 3)),
        rng.uniform(-np.pi, np.pi, (b, m, 1))], -1).astype(np.float32)
    cls = rng.normal(0, 1, (b, m)).astype(np.float32)
    n_reg = 2 * 2 * int(2 * cfg.RCNN.LOC_SCOPE / cfg.RCNN.LOC_BIN_SIZE) \
        + 2 * cfg.RCNN.NUM_HEAD_BIN + 4
    reg = rng.normal(0, 0.01, (b, m, n_reg)).astype(np.float32)
    valid = np.ones((b, m), bool)
    args = (rois, cls, reg, valid, rois[..., 3:6])
    got = eval_rcnn.rcnn_decode_and_nms(
        cfg, *(torch.from_numpy(a) for a in args))
    want = jax.device_get(jax_eval.rcnn_decode_and_nms(
        jcfg, *(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got["pred_boxes3d"].numpy(),
                               want["pred_boxes3d"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["final_mask"].numpy(),
                                  want["final_mask"])
    # small residuals: each box keeps its anchor's size
    anchor = rois[..., 3:6] if size_res_on_roi else cfg.CLS_MEAN_SIZE[0]
    np.testing.assert_allclose(got["pred_boxes3d"][..., 3:6].numpy(),
                               np.broadcast_to(anchor, (b, m, 3)), rtol=0.05)
