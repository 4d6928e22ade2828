"""The port's input pipeline against tpu3d's on the CPU: the synthetic KITTI
frames on disk, the kitti host functions, the GT database, the dataset's
samples and the loader's batches.

Every piece is host numpy code that the port keeps as its own copy, so
everything is held equal: files byte for byte, arrays bit for bit, lists
and strings exactly. The one exception is the host 3D IoU, where tpu3d
takes a C build of the polygon clip and the port its numpy oracle: those
two agree within 1e-9 (rounding in another order), and the port's equals
tpu3d's numpy path exactly.

Sizes: 8 frames of the default synthetic scene (14000 clutter points and
2-5 cars), 1024 points per sample, batches of 3.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from test_offline_rcnn import _small_offline_cfg, _write_dumps
from test_torch_rpn import _port_cfg
from tpu3d import kitti as jkitti
from tpu3d.config import fresh_cfg as jax_fresh_cfg
from tpu3d.datasets import BatchLoader as JaxBatchLoader
from tpu3d.datasets import KittiRCNNDataset as JaxDataset
from tpu3d.datasets import create_synthetic_kitti as jax_create
from tpu3d.ops import rotated_iou as jax_iou
from tpu3d.tools import generate_gt_database as jax_gtdb
from tpu3d_torch import kitti
from tpu3d_torch.datasets import (BatchLoader, KittiRCNNDataset,
                                  create_synthetic_kitti, device_prefetch)
from tpu3d_torch.tools import generate_gt_database as gtdb

N_FRAMES = 8


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The same frames written by both packages, and each package's GT
    database of its own frames."""
    base = tmp_path_factory.mktemp("kitti")
    ours, ref = str(base / "ours"), str(base / "ref")
    create_synthetic_kitti(ours, n_frames=N_FRAMES, image_files=True, seed=3)
    jax_create(ref, n_frames=N_FRAMES, image_files=True, seed=3)
    db = gtdb.main(["--root", ours, "--save_dir", str(base / "db_ours")])
    jdb = jax_gtdb.main(["--root", ref, "--save_dir", str(base / "db_ref")])
    return ours, ref, db, jdb


@pytest.mark.parametrize("kwargs", [
    {}, {"extra_classes": ("Pedestrian", "Cyclist"), "n_frames": 4,
         "seed": 5}])
def test_synthetic_frames_are_byte_equal(tmp_path, kwargs):
    """create_synthetic_kitti writes the same files, byte for byte, with
    and without the extra classes (default_cyclist / default_people)."""
    args = dict({"n_frames": N_FRAMES, "image_files": True, "seed": 3},
                **kwargs)
    create_synthetic_kitti(str(tmp_path / "a"), **args)
    jax_create(str(tmp_path / "b"), **args)
    a, b = _files(tmp_path / "a"), _files(tmp_path / "b")
    assert sorted(a) == sorted(b)
    assert len(a) >= 5 * args["n_frames"]
    for name in a:
        assert a[name] == b[name], name


def test_kitti_host_functions_match(roots):
    """Labels, calibration and its projections, box geometry and annos of
    every frame equal tpu3d's."""
    ours, _, _, _ = roots
    obj_dir = os.path.join(ours, "KITTI", "object", "training")
    for i in range(N_FRAMES):
        label = os.path.join(obj_dir, "label_2", "%06d.txt" % i)
        objs, jobjs = kitti.read_label(label), jkitti.read_label(label)
        assert ([o.to_kitti_format() for o in objs]
                == [o.to_kitti_format() for o in jobjs])
        assert [o.level_str for o in objs] == [o.level_str for o in jobjs]
        boxes = kitti.objs_to_boxes3d(objs)
        np.testing.assert_array_equal(boxes, jkitti.objs_to_boxes3d(jobjs))
        calib_file = os.path.join(obj_dir, "calib", "%06d.txt" % i)
        calib, jcalib = kitti.Calibration(calib_file), \
            jkitti.Calibration(calib_file)
        scan = kitti.load_velo_scan(
            os.path.join(obj_dir, "velodyne", "%06d.bin" % i))
        rect = calib.project_velo_to_rect(scan[:, :3])
        np.testing.assert_array_equal(rect,
                                      jcalib.project_velo_to_rect(scan[:, :3]))
        for a, b in zip(calib.rect_to_img(rect), jcalib.rect_to_img(rect)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            kitti.points_in_boxes3d(rect, boxes),
            jkitti.points_in_boxes3d(rect, boxes))
        np.testing.assert_array_equal(
            kitti.corners_from_boxes3d(boxes),
            jkitti.corners_from_boxes3d(boxes))
        np.testing.assert_array_equal(
            kitti.enlarge_box3d(boxes, 0.2), jkitti.enlarge_box3d(boxes, 0.2))
        np.testing.assert_array_equal(
            kitti.rotate_points_along_y(rect, 0.3),
            jkitti.rotate_points_along_y(rect, 0.3))
        np.testing.assert_array_equal(
            kitti.get_road_plane(os.path.join(obj_dir, "planes",
                                              "%06d.txt" % i)),
            jkitti.get_road_plane(os.path.join(obj_dir, "planes",
                                               "%06d.txt" % i)))
    label_dir = os.path.join(obj_dir, "label_2")
    for a, b in zip(kitti.annos.get_label_annos(label_dir),
                    jkitti.annos.get_label_annos(label_dir)):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_host_iou_matches():
    """boxes_iou3d_numpy on overlapping, touching and apart boxes: equal to
    tpu3d's numpy clip exactly, within 1e-9 of its C clip."""
    rng = np.random.default_rng(7)
    a = np.concatenate([rng.uniform(-5, 5, (40, 3)), rng.uniform(1, 4, (40, 3)),
                        rng.uniform(-3, 3, (40, 1))], 1).astype(np.float32)
    b = a[rng.permutation(40)] + rng.normal(0, 0.3, a.shape).astype(
        np.float32)
    b[:5] = a[:5]  # identical pairs
    ours = kitti.boxes_iou3d_numpy(a, b)
    np.testing.assert_allclose(ours, jax_iou.boxes_iou3d_numpy(a, b),
                               rtol=0, atol=1e-9)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    inter = jax_iou.rotated_iou_bev_numpy(a64[:, [0, 2, 5, 4, 6]],
                                          b64[:, [0, 2, 5, 4, 6]],
                                          criterion=-2, backend="python")
    np.testing.assert_array_equal(
        kitti.boxes.rotated_iou_bev_numpy(a64[:, [0, 2, 5, 4, 6]],
                                          b64[:, [0, 2, 5, 4, 6]],
                                          criterion=-2), inter)
    assert (ours > 0.1).sum() > 5


def test_gt_database_matches(roots):
    """generate_gt_database gives the same objects: sample ids, classes,
    boxes, point patches and intensities bit for bit, and the same label
    objects (each pickle names its own package's Object3d class)."""
    _, _, db, jdb = roots
    assert os.path.basename(db) == os.path.basename(jdb)
    with open(db, "rb") as f:
        ours = pickle.load(f)
    with open(jdb, "rb") as f:
        ref = pickle.load(f)
    assert len(ours) == len(ref) > 5
    for a, b in zip(ours, ref):
        assert list(a) == list(b)
        assert a["sample_id"] == b["sample_id"]
        assert a["cls_type"] == b["cls_type"]
        for k in ("gt_box3d", "points", "intensity"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for slot in type(b["obj"]).__slots__:
            x, y = getattr(a["obj"], slot), getattr(b["obj"], slot)
            if isinstance(y, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=slot)
            else:
                assert x == y, slot


def _cfgs(intensity: bool):
    """default-config pipelines with GT augmentation always applied."""
    jcfg = jax_fresh_cfg()
    jcfg.RPN.USE_INTENSITY = intensity
    jcfg.GT_AUG_ENABLED = True
    jcfg.GT_AUG_APPLY_PROB = 1.0
    return jcfg, _port_cfg(jcfg)


def _datasets(roots, mode, intensity, seed=11):
    ours, ref, db, jdb = roots
    jcfg, cfg = _cfgs(intensity)
    split = "train" if mode == "TRAIN" else "val"
    kw = dict(npoints=1024, split=split, mode=mode, seed=seed)
    return (KittiRCNNDataset(ours, cfg=cfg, gt_database_dir=db, **kw),
            JaxDataset(ref, cfg=jcfg, gt_database_dir=jdb, **kw))


def _assert_same(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("intensity", [False, True])
@pytest.mark.parametrize("mode", ["TRAIN", "EVAL", "TEST"])
def test_dataset_samples_match(roots, mode, intensity):
    """KittiRCNNDataset's samples equal tpu3d's key by key in each mode,
    with RPN.USE_INTENSITY off and on, GT augmentation on in TRAIN (it
    pastes objects into most scenes), at two epochs."""
    ds, jds = _datasets(roots, mode, intensity)
    assert ds.sample_id_list == jds.sample_id_list and len(ds) > 0
    pasted = 0
    for epoch in (0, 3):
        ds.epoch = jds.epoch = epoch
        for i in range(len(ds)):
            s, js = ds[i], jds[i]
            _assert_same(s, js)
            assert s["pts_input"].shape == (1024, 4 if intensity else 3)
            if mode == "TRAIN":
                label = ds.filtrate_objects(ds.get_label(s["sample_id"]))
                pasted += (np.abs(s["gt_boxes3d"]).sum(1) > 0).sum() \
                    > len(label)
    if mode == "TRAIN":
        assert pasted > len(ds)


@pytest.mark.parametrize("method", ["single", "multiple", "normal"])
def test_roi_jitter_and_background_sampling_match(roots, method):
    """random_aug_box3d, aug_roi_by_noise_batch and _sample_bg_inds (the
    ROI helpers the offline sampler uses) draw the same boxes and indices
    as tpu3d's from the same generator state, and the jittered boxes'
    IoUs within 1e-6 (tpu3d's C clip against the port's numpy one)."""
    ds, jds = _datasets(roots, "TRAIN", False)
    ds.cfg.RCNN.REG_AUG_METHOD = jds.cfg.RCNN.REG_AUG_METHOD = method
    box = np.array([1.0, 1.6, 20.0, 1.5, 1.6, 3.9, 0.3], np.float32)
    rng, jrng = np.random.default_rng(4), np.random.default_rng(4)
    np.testing.assert_array_equal(
        ds.random_aug_box3d(rng, box, method),
        jds.random_aug_box3d(jrng, box, method))
    rois = np.stack([box, box + [0.4, 0, 0.3, 0, 0, 0, 0.2],
                     box + [3.0, 0, 1.0, 0, 0, 0, 1.0]]).astype(np.float32)
    gts = np.repeat(box[None], 3, axis=0)
    got = ds.aug_roi_by_noise_batch(rng, rois, gts, aug_times=10)
    want = jds.aug_roi_by_noise_batch(jrng, rois, gts, aug_times=10)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    for hard, easy in ((np.arange(5), np.arange(5, 12)),
                       (np.arange(0), np.arange(7)),
                       (np.arange(4), np.arange(0))):
        np.testing.assert_array_equal(
            ds._sample_bg_inds(rng, hard, easy, 9),
            jds._sample_bg_inds(jrng, hard, easy, 9))


def _offline(roots, tmp_path, mode, seed=11):
    """RCNN-offline datasets of both packages (tests/test_offline_rcnn.py's
    small config: RPN off, 16 rois of 64 points per TRAIN sample, 24 roi
    slots per EVAL sample) over one set of synthetic RPN dumps and
    proposal files, written for every labelled frame."""
    ours, ref, _, _ = roots
    feat, rois = tmp_path / "feat", tmp_path / "rois"
    _write_dumps(ours, feat, rois)
    jcfg = _small_offline_cfg()
    jcfg.TEST.RPN_POST_NMS_TOP_N = 24
    dirs = ({"rcnn_training_roi_dir": str(rois),
             "rcnn_training_feature_dir": str(feat)} if mode == "TRAIN" else
            {"rcnn_eval_roi_dir": str(rois),
             "rcnn_eval_feature_dir": str(feat)})
    kw = dict(npoints=1024, split="train", mode=mode, seed=seed, **dirs)
    return (KittiRCNNDataset(ours, cfg=_port_cfg(jcfg), **kw),
            JaxDataset(ref, cfg=jcfg, **kw))


def test_offline_branches_raise(roots, tmp_path):
    """The RCNN-offline samples raise as tpu3d's do where their dumps are
    missing: FileNotFoundError, in TRAIN and in EVAL, and from
    get_rpn_features."""
    for mode in ("TRAIN", "EVAL"):
        (tmp_path / mode).mkdir()
        ds, jds = _offline(roots, tmp_path / mode, mode)
        for d in (ds, jds):
            d.rcnn_training_feature_dir = d.rcnn_eval_feature_dir = str(
                tmp_path)
            with pytest.raises(FileNotFoundError):
                d[0]
    for d in (KittiRCNNDataset, JaxDataset):
        with pytest.raises(FileNotFoundError):
            d.get_rpn_features(str(tmp_path), 0)


@pytest.mark.parametrize("mode", ["TRAIN", "EVAL"])
def test_offline_samples_match(roots, tmp_path, mode):
    """With RPN.ENABLED False the samples come from the dumps
    (get_rcnn_training_sample_batch in TRAIN: fg/bg sampling, the jitter
    until IoU, the pooling and the stage-2 augmentation; get_proposal_from_file
    in EVAL: the proposals padded to TEST.RPN_POST_NMS_TOP_N slots, pooled,
    their IoU with the gt) and equal tpu3d's key by key at two epochs:
    every array bit for bit but gt_iou, which is a host 3D IoU (tpu3d's C
    clip, the port's numpy one) and agrees within 1e-6."""
    ds, jds = _offline(roots, tmp_path, mode)
    assert ds.sample_id_list == jds.sample_id_list and len(ds) > 2
    fg = 0
    for epoch in (0, 2):
        ds.epoch = jds.epoch = epoch
        for i in range(len(ds)):
            s, js = ds[i], jds[i]
            assert list(s) == list(js)
            for k in s:
                if k == "gt_iou":
                    np.testing.assert_allclose(s[k], js[k], rtol=0, atol=1e-6)
                    assert s[k].dtype == js[k].dtype
                else:
                    _assert_same({k: s[k]}, {k: js[k]})
            if mode == "TRAIN":
                assert s["pts_input"].shape == (16, 64, 3 + 2 + 128)
                fg += int((s["cls_label"] == 1).sum())
            else:
                assert s["pts_input"].shape == (24, 64, 3 + 2 + 128)
                fg += int((s["gt_iou"] > 0.55).sum())
    assert fg > 0


@pytest.mark.parametrize("worker_mode", ["thread", "process"])
def test_loader_batches_match(roots, worker_mode):
    """BatchLoader's batches (shuffled, the short last batch padded) equal
    tpu3d's in both worker modes across set_epoch."""
    ds, jds = _datasets(roots, "EVAL", False, seed=2)
    kw = dict(batch_size=3, shuffle=True, num_workers=2, seed=5,
              worker_mode=worker_mode)
    loader, jloader = BatchLoader(ds, **kw), JaxBatchLoader(jds, **kw)
    try:
        orders = []
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            jloader.set_epoch(epoch)
            batches, jbatches = list(loader), list(jloader)
            assert len(batches) == len(jbatches) == len(loader)
            for b, jb in zip(batches, jbatches):
                _assert_same(b, jb)
            orders.append([int(i) for b in batches
                           for i in b["sample_id"][b["batch_valid"]]])
        assert sorted(orders[0]) == sorted(orders[1]) == ds.sample_id_list
        assert orders[0] != orders[1]  # reshuffled by set_epoch
    finally:
        loader.close()
        jloader.close()


def test_device_prefetch_on_cpu_is_from_numpy(roots):
    """device_prefetch with device="cpu" stages each kept key with
    torch.from_numpy (the same values and dtype, the numpy buffer shared)
    and drops the others."""
    ds, _ = _datasets(roots, "EVAL", False)
    batches = list(BatchLoader(ds, batch_size=2))
    keys = ("pts_input", "gt_boxes3d", "rpn_cls_label", "batch_valid")
    staged = list(device_prefetch(iter(batches), keys=keys, device="cpu"))
    assert len(staged) == len(batches)
    for b, t in zip(batches, staged):
        assert list(t) == list(keys)
        for k in keys:
            assert t[k].device.type == "cpu"
            np.testing.assert_array_equal(t[k].numpy(), b[k])
            assert t[k].numpy().ctypes.data == b[k].ctypes.data


def test_device_prefetch_wants_the_card():
    """Without device="cpu", device_prefetch stages onto the card, and on a
    machine without one it raises instead of staying on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(device_prefetch(iter([{"x": np.zeros(2)}])))
