"""The port's KITTI AP evaluator (``tpu3d_torch.evaluate``) against tpu3d's
on the CPU.

- The overlap matrices (metric 0 image boxes, 1 rotated BEV, 2 3D; every
  criterion) within 1e-5 of tpu3d's: the rotated ones are float32 on both
  sides, the polygon integral summed in another order by XLA and by
  PyTorch.
- The greedy matcher, fed tpu3d's own overlap matrices: the Python matcher
  (``compute_statistics``) and the ctypes one (``csrc/ap_matcher.c``),
  each through ``eval_class``, give tpu3d's arrays exactly.
- The report strings (``get_official_eval_result``, new / old metric,
  with and without the dense sweep; ``get_coco_eval_result``) equal tpu3d's
  on the port's own overlaps. An IoU within a few ulps of a threshold
  could flip a match, so each such test first states the smallest distance
  of tpu3d's overlaps from every threshold it uses and requires it above
  the largest difference between the two packages' overlaps.
- The evaluate CLI with every output transformation on a synthetic KITTI
  tree (tests/test_evaluate_cli_reference_diff.py's, 50 frames): the same
  AP tables and strings, and the same written label files.
- The native matcher builds through ``cc`` into ``build/native`` and loads
  with ctypes; a failed build raises, with no fallback to Python.
"""

import importlib
import shutil

import numpy as np
import pytest
import torch

from test_ap_reference_diff import _random_annos
from test_evaluate_cli_reference_diff import (N_FRAMES, _assert_ap_dicts_match,
                                              tree)
from tpu3d.evaluate import ap as jax_ap
from tpu3d.evaluate import overlaps as jax_ov
from tpu3d_torch.evaluate import ap, native
from tpu3d_torch.evaluate import overlaps as ov

# the modules, which the packages' evaluate functions shadow
jax_evaluate_mod = importlib.import_module("tpu3d.evaluate.evaluate")
evaluate_mod = importlib.import_module("tpu3d_torch.evaluate.evaluate")

assert tree  # the 50-frame tree fixture, shared with the reference diff

OFFICIAL = (0.7, 0.5, 0.25)


def _annos(seed=3, n=40):
    gt, dt = _random_annos(np.random.default_rng(seed), n)
    # half the detections sit on a gt, so that every metric has matches
    for g, d in zip(gt, dt):
        k = min(len(g["name"]), len(d["name"]))
        rng = np.random.default_rng(len(d["name"]))
        for key in ("location", "dimensions", "rotation_y"):
            d[key][:k] = g[key][:k] + rng.normal(0, 0.05, g[key][:k].shape)
    return gt, dt


def _threshold_margin(gt, dt, thresholds):
    """Each package's overlaps (metrics 1 and 2) on the same side of every
    threshold (the matcher's ``overlap > min_overlap``), so that no match
    can flip -> (the largest difference between the two packages'
    overlaps, the smallest distance of tpu3d's non-zero overlaps from a
    threshold), for the assertion's message."""
    t = np.asarray(sorted(set(float(x) for x in thresholds)))
    diff, dist = 0.0, np.inf
    for metric in (1, 2):
        ours = np.concatenate([o.ravel() for o in ov.calculate_iou_partly(
            dt, gt, metric, device="cpu")[0]])
        want = np.concatenate([o.ravel() for o in jax_ov.calculate_iou_partly(
            dt, gt, metric)[0]])
        assert np.array_equal(ours[:, None] > t, want[:, None] > t), metric
        diff = max(diff, float(np.abs(ours - want).max()))
        nz = want[want != 0]
        dist = min(dist, float(np.abs(nz[:, None] - t).min()))
    return diff, dist


def _same_files(a, b):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir()) and names
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.parametrize("criterion", [-1, 0, 1, 2])
def test_overlaps_match(criterion):
    """Every metric and criterion within 1e-5 of tpu3d's (image boxes
    exactly: the same float64 numpy; the rotated form's raw intersection,
    criterion -2, in m², within 1e-5 relative); calculate_iou_partly's
    per-image slices likewise, over parts of 7 frames."""
    gt, dt = _annos()
    dt7 = np.concatenate([ov._anno_boxes7(a) for a in dt])
    gt7 = np.concatenate([ov._anno_boxes7(a) for a in gt])
    bb_d = np.concatenate([a["bbox"] for a in dt])
    bb_g = np.concatenate([a["bbox"] for a in gt])
    np.testing.assert_array_equal(
        ov.image_box_overlap(bb_d, bb_g, criterion),
        jax_ov.image_box_overlap(bb_d, bb_g, criterion))
    if criterion == 2:  # the rotated form's raw intersection is -2
        criterion = -2
    for fn, jfn in ((ov.bev_box_overlap, jax_ov.bev_box_overlap),
                    (ov.d3_box_overlap, jax_ov.d3_box_overlap)):
        got = fn(dt7, gt7, criterion, device="cpu")
        want = jfn(dt7, gt7, criterion)
        assert got.dtype == np.float64 and got.shape == want.shape
        assert (want > 0.1).sum() > 20
        if criterion == -2 and fn is ov.bev_box_overlap:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for metric in (0, 1, 2):
        got = ov.calculate_iou_partly(dt, gt, metric, num_parts=7,
                                      device="cpu")
        want = jax_ov.calculate_iou_partly(dt, gt, metric, num_parts=7)
        for a, b in zip(got[0], want[0]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        for a, b in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_native", [True, False])
def test_matchers_on_tpu3d_overlaps(monkeypatch, use_native):
    """Fed tpu3d's overlap matrices, the port's matcher (native or Python)
    gives tpu3d's precision, recall and orientation arrays exactly, for
    every metric, both difficulty modes, AOS on, and tpu3d's
    compute_statistics' counts per image and threshold exactly."""
    gt, dt = _annos()
    monkeypatch.setattr(ap, "calculate_iou_partly",
                        lambda d, g, m, n, device: jax_ov.calculate_iou_partly(
                            d, g, m, n))
    mo = np.stack([np.array([[0.7, 0.5, 0.5, 0.7, 0.5]] * 3),
                   np.array([[0.5, 0.25, 0.25, 0.5, 0.25]] * 3)])[:, :, [0, 1]]
    for metric in (0, 1, 2):
        for mode, diffs in (("new", list(range(6))), ("old", [0, 1, 2])):
            got = ap.eval_class(gt, dt, [0, 1], "kitti", diffs, metric, mo,
                                mode, compute_aos=True, use_native=use_native,
                                device="cpu")
            want = jax_ap.eval_class(gt, dt, [0, 1], "kitti", diffs, metric,
                                     mo, mode, compute_aos=True,
                                     use_native=False)
            for key in ("precision", "recall", "orientation"):
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=f"{metric} {mode} {key}")
    overlaps = jax_ov.calculate_iou_partly(dt, gt, 1)[0]
    for i in range(len(gt)):
        _, ig_gt, ig_dt, dc = jax_ap.clean_data(gt[i], dt[i], 0, "kitti", 1,
                                                "new")
        assert ap.clean_data(gt[i], dt[i], 0, "kitti", 1, "new")[1:3] == (
            ig_gt, ig_dt)
        gdata = np.concatenate([gt[i]["bbox"], gt[i]["alpha"][:, None]], 1)
        ddata = np.concatenate([dt[i]["bbox"], dt[i]["alpha"][:, None],
                                dt[i]["score"][:, None]], 1)
        dc = np.asarray(dc).reshape(-1, 4)
        for thresh, fp in ((0.0, False), (0.3, True), (0.6, True)):
            got = ap.compute_statistics(overlaps[i], gdata, ddata, ig_gt, ig_dt,
                                        dc, 1, 0.5, thresh, fp, True)
            want = jax_ap.compute_statistics(overlaps[i], gdata, ddata, ig_gt,
                                             ig_dt, dc, 1, 0.5, thresh, fp,
                                             True)
            assert got[:4] == want[:4]
            np.testing.assert_array_equal(got[4], want[4])


@pytest.mark.parametrize("metric_mode,dense", [("new", False), ("old", False),
                                               ("new", True)])
def test_report_strings_match(metric_mode, dense):
    """get_official_eval_result's report and dict, and the coco report, on
    the port's own overlaps (device cpu) equal tpu3d's, with both classes
    and AOS; first, each overlap lies on the same side of every threshold
    in both packages (the data's smallest distance of a non-zero overlap
    from a threshold is above 1e-5, the packages' overlaps differ by less
    than 1e-5)."""
    gt, dt = _annos(seed=11)
    thresholds = list(OFFICIAL) + list(np.linspace(0.5, 0.95, 10)) \
        + list(np.linspace(0.25, 0.7, 10))
    if dense:
        thresholds += [i / 100.0 for i in range(101)]
    diff, dist = _threshold_margin(gt, dt, thresholds)
    assert diff < 1e-5 < dist, (diff, dist)
    got = ap.get_official_eval_result(gt, dt, [0, 1], "kitti", metric_mode,
                                      dense, device="cpu")
    want = jax_ap.get_official_eval_result(gt, dt, [0, 1], "kitti",
                                           metric_mode, dense)
    assert got[0] == want[0]
    assert "aos  AP" in got[0]
    _assert_ap_dicts_match(want[1], got[1])
    if not dense:
        assert ap.get_coco_eval_result(gt, dt, [0, 1], "kitti", metric_mode,
                                       device="cpu") == \
            jax_ap.get_coco_eval_result(gt, dt, [0, 1], "kitti", metric_mode)


TRANSFORMS = [
    ("base", {}, None), ("thresh", {"score_thresh": 0.35}, None),
    ("ground", {"toground": True}, "grounded"),
    ("rescale", {"rescale_pred": 1.1}, None),
    ("asize", {"align_size": True}, "align_size"),
    ("afront", {"align_front": True}, "align_front"),
    ("reverse", {"reverse_align": True}, "reverse_align"),
    ("old", {"metric": "old"}, None), ("coco", {"coco": True}, None),
    ("dense", {"dense_sample": True, "direct_save": True}, None),
    ("iou", {"output_iou": True}, "with_iou"),
    ("range", {"range_check": True}, None),
]


@pytest.mark.parametrize("tag,kw,out_dir", TRANSFORMS,
                         ids=[t[0] for t in TRANSFORMS])
def test_evaluate_cli_transforms_match(tree, tmp_path, tag, kw, out_dir):
    """evaluate() on fresh copies of the tree's result directory, in the
    port (device cpu) and in tpu3d: the same report string and AP dict, and
    the same label files written beside the results (grounded/,
    align_size/, align_front/, reverse_align/, with_iou/ and with_iou_gt/;
    the .pkl and .txt of --direct_save)."""
    gt = str(tree / "kitti_data" / "training" / "label_2")
    split = str(tree / "kitti_data" / "val.txt")
    runs = {}
    for side in ("ref", "ours"):
        runs[side] = tmp_path / side / f"{tag}_run_waymo"
        shutil.copytree(tree / "ours_run_waymo", runs[side])
    kw = dict({"metric": "new"}, **kw)
    if kw.get("reverse_align"):
        kw["stats_dir"] = str(tree / "stats")
    want = jax_evaluate_mod.evaluate(str(runs["ref"] / "data"), label_path=gt,
                                     label_split_file=split, current_class=0,
                                     **kw)
    got = evaluate_mod.evaluate(str(runs["ours"] / "data"), label_path=gt,
                                label_split_file=split, current_class=0,
                                device="cpu", **kw)
    assert got[0] == want[0]
    if want[1] is not None:
        _assert_ap_dicts_match(want[1], got[1])
    if out_dir is not None:
        _same_files(runs["ref"] / out_dir, runs["ours"] / out_dir)
        assert len(list((runs["ours"] / out_dir).iterdir())) == N_FRAMES
    if tag == "iou":
        _same_files(runs["ref"] / "with_iou_gt",
                    runs["ours"] / "with_iou_gt")
    if kw.get("direct_save"):
        for suffix in (".txt", ".pkl"):
            name = f"{tag}_run_waymo_val20{suffix}"
            assert (tmp_path / "ours" / name).read_bytes() == \
                (tmp_path / "ref" / name).read_bytes()


def test_evaluate_main_prints_and_wants_the_card(tree, capsys):
    """``python -m tpu3d_torch.evaluate.evaluate``: with --device cpu it
    prints tpu3d's report; without it, on a machine without a card, it
    raises instead of running on the host."""
    args = ["--result_path", str(tree / "ours_run_waymo" / "data"),
            "--label_path", str(tree / "kitti_data" / "training" / "label_2"),
            "--label_split_file", str(tree / "kitti_data" / "val.txt")]
    info, _ = evaluate_mod.main(args + ["--device", "cpu", "--metric", "old"])
    assert info and info in capsys.readouterr().out
    want, _ = jax_evaluate_mod.evaluate(
        str(tree / "ours_run_waymo" / "data"),
        label_path=str(tree / "kitti_data" / "training" / "label_2"),
        label_split_file=str(tree / "kitti_data" / "val.txt"), metric="old")
    assert info == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            evaluate_mod.main(args)


def test_native_matcher_builds_with_cc_and_never_falls_back(monkeypatch,
                                                            tmp_path):
    """The matcher library is built by the host C compiler into
    build/native/ under a name carrying its source's hash, and loaded with
    ctypes; when the build fails, ap_matcher() and eval_class raise, and
    the Python matcher runs only when asked for."""
    lib = native.ap_matcher()
    assert native.library_path().exists()
    assert native.library_path().parent.name == "native"
    assert native.library_path().parent.parent.name == "build"
    assert lib.collect_tp_scores.restype is native.L

    gt, dt = _annos(n=6)
    mo = np.array([[[0.7], [0.5], [0.5]]])
    py = ap.eval_class(gt, dt, [0], "kitti", [0], 0, mo, use_native=False,
                       device="cpu")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "native" / "ap_matcher-x.so")
    monkeypatch.setenv("CC", "false")
    with pytest.raises(RuntimeError, match="native AP matcher"):
        native.ap_matcher()
    with pytest.raises(RuntimeError, match="native AP matcher"):
        ap.eval_class(gt, dt, [0], "kitti", [0], 0, mo, device="cpu")
    again = ap.eval_class(gt, dt, [0], "kitti", [0], 0, mo, use_native=False,
                          device="cpu")
    for key in ("precision", "recall"):
        np.testing.assert_array_equal(again[key], py[key])
    with pytest.raises(TypeError, match="C-contiguous"):
        native._ptr(np.zeros(3, np.int32), np.int64)
