"""The port's data tools against tpu3d's on the CPU: offline GT
augmentation (``generate_aug_scene``) and the multi_data symlink farm
(``generate_multi_data``).

Both are host numpy code, so their output is held equal byte for byte:
the same frames (the synthetic generator, byte-equal between the packages)
and each package's own GT database of them, the same seed, the same files
(rectified points, label lines, the split list). What tpu3d's dataset
reads back of that tree is held too: it reads the pasted scenes' points
from ``KITTI/aug_scene/training/rectified_data`` but their labels from
``label_2/`` for every id below 2 000 000, so the ids the writer gives
((epoch + 1)·400000 + id) find no label there; both packages fail alike,
and read the scenes once each label is linked into ``label_2/``.

Sizes: 4 frames of the default synthetic scene, 2 augmentation epochs.
"""

import os

import numpy as np
import pytest

from test_torch_stat_norm import tree
from tpu3d.datasets import KittiRCNNDataset as JaxDataset
from tpu3d.tools import generate_aug_scene as jaug
from tpu3d.tools import generate_gt_database as jax_gtdb
from tpu3d.tools import generate_multi_data as jmulti
from tpu3d_torch.config import fresh_cfg
from tpu3d_torch.datasets import KittiRCNNDataset, create_synthetic_kitti
from tpu3d_torch.tools import generate_aug_scene as aug
from tpu3d_torch.tools import generate_gt_database as gtdb
from tpu3d_torch.tools import generate_multi_data as multi

FRAMES = 4
AUG_TIMES = 2


@pytest.fixture(scope="module")
def aug_trees(tmp_path_factory):
    """The frames, and the augmentation each package writes from its own
    GT database of them."""
    base = tmp_path_factory.mktemp("aug")
    root = str(base / "data")
    create_synthetic_kitti(root, n_frames=FRAMES, image_files=True, seed=4)
    out = {}
    for tag, db_main, tool in (("ours", gtdb.main, aug.main),
                               ("ref", jax_gtdb.main, jaug.main)):
        db = db_main(["--root", root, "--save_dir", str(base / f"db_{tag}")])
        save = str(base / f"aug_{tag}")
        split = tool(["--root", root, "--save_dir", save,
                      "--gt_database_dir", db,
                      "--aug_times", str(AUG_TIMES)])
        assert split == os.path.join(save, "train_aug.txt")
        out[tag] = save
    return root, out


def test_aug_scene_files_equal_tpu3d(aug_trees):
    """Every file generate_aug_scene writes, byte for byte: the rectified
    points, the label lines (the scene's own objects, then the pasted ones
    at %.4f) and the split list with the offset ids."""
    _, out = aug_trees
    ours, ref = tree(out["ours"]), tree(out["ref"])
    assert ours == ref
    ids = ours["train_aug.txt"].decode().split("\n")
    train = [i for i in ids if int(i) < 400000]
    assert len(ids) == len(train) * (1 + AUG_TIMES)
    assert {int(i) // 400000 for i in ids} == {0, 1, 2}
    for i in ids[len(train):]:
        assert f"rectified_data/{i}.bin" in ours
        assert f"aug_label/{i}.txt" in ours
    pasted = [k for k, v in ours.items() if k.startswith("aug_label/")
              and len(v.decode().splitlines()) > 0]
    assert pasted


def _aug_root(root, save, tmp):
    """A dataset root whose KITTI/aug_scene/training holds save's tree and
    whose ImageSets holds its split list, beside root's frames."""
    kitti = os.path.join(tmp, "KITTI")
    os.makedirs(os.path.join(kitti, "aug_scene"), exist_ok=True)
    os.makedirs(os.path.join(kitti, "ImageSets"), exist_ok=True)
    os.symlink(os.path.join(root, "KITTI", "object"),
               os.path.join(kitti, "object"))
    os.symlink(save, os.path.join(kitti, "aug_scene", "training"))
    os.symlink(os.path.join(save, "train_aug.txt"),
               os.path.join(kitti, "ImageSets", "train_aug.txt"))
    return tmp


def test_aug_scene_reads_back_as_tpu3d_does(aug_trees, tmp_path):
    """The datasets read the pasted scenes' points from aug_scene and their
    labels from label_2 below id 2 000 000: both packages fail alike on the
    writer's ids, and read the same samples once the labels are linked."""
    from tpu3d.config import fresh_cfg as jax_fresh_cfg

    root, out = aug_trees
    data = _aug_root(root, out["ours"], str(tmp_path / "root"))
    cfg, jcfg = fresh_cfg(), jax_fresh_cfg()
    for c in (cfg, jcfg):
        c.GT_AUG_ENABLED = False
        c.RPN.NUM_POINTS = 1024
    errors = []
    for cls, c in ((KittiRCNNDataset, cfg), (JaxDataset, jcfg)):
        with pytest.raises(FileNotFoundError) as err:
            cls(root_dir=data, npoints=1024, split="train_aug",
                mode="TRAIN", cfg=c)
        errors.append(os.path.basename(err.value.filename))
    assert errors[0] == errors[1]
    labels = os.path.join(root, "KITTI", "object", "training", "label_2")
    linked = []
    for name in os.listdir(os.path.join(out["ours"], "aug_label")):
        dst = os.path.join(labels, name)
        os.symlink(os.path.join(out["ours"], "aug_label", name), dst)
        linked.append(dst)
    try:
        ours = KittiRCNNDataset(root_dir=data, npoints=1024,
                                split="train_aug", mode="TRAIN", cfg=cfg)
        ref = JaxDataset(root_dir=data, npoints=1024, split="train_aug",
                         mode="TRAIN", cfg=jcfg)
        assert ours.sample_id_list == ref.sample_id_list
        assert max(ours.sample_id_list) >= 400000
        for i in (0, len(ours.sample_id_list) - 1):
            a, b = ours[i], ref[i]
            assert a["sample_id"] == b["sample_id"]
            for k in ("pts_input", "gt_boxes3d", "rpn_cls_label"):
                assert np.array_equal(a[k], b[k]), k
    finally:
        for dst in linked:
            os.remove(dst)


def test_multi_data_farm_equal_tpu3d(tmp_path, monkeypatch):
    """gen_data links the same farm as tpu3d's, and gen_all_data walks the
    same registry."""
    src = tmp_path / "src"
    for sub in ("image_2", "label_2", "velodyne", "calib"):
        (src / "training" / sub).mkdir(parents=True)
    (src / "train.txt").write_text("000000\n")
    farms = {}
    for tag, mod in (("ours", multi), ("ref", jmulti)):
        dst = tmp_path / tag / "multi_data"
        mod.gen_data(str(src), str(dst / "kitti"))
        mod.gen_data(str(src), str(dst / "kitti"))  # a second run adds none
        farms[tag] = tree(str(dst))
    assert farms["ours"] == farms["ref"]
    assert farms["ours"]["kitti/KITTI/ImageSets"] == ("link", str(src))
    assert "kitti/KITTI/object/training/planes" not in farms["ours"]

    seen = {}
    for tag, mod in (("ours", multi), ("ref", jmulti)):
        calls = []
        monkeypatch.setattr(mod, "gen_data",
                            lambda s, d, calls=calls: calls.append((s, d)))
        mod.gen_all_data(str(tmp_path / "farm"))
        seen[tag] = calls
    assert seen["ours"] == seen["ref"] and len(seen["ours"]) == 5


def _walkthrough_files(root):
    """The rescaled tree's files by relative path, and each link's target's
    last two parts (the roots differ)."""
    out = {}
    for rel, v in tree(root).items():
        out[rel] = (("link", os.path.join(*v[1].split(os.sep)[-2:]))
                    if isinstance(v, tuple) else v)
    return out


def test_stat_norm_walkthrough_equal_tpu3d(tmp_path, monkeypatch, capsys):
    """examples/stat_norm_walkthrough.py and the port's copy on the same
    synthetic frames (the generator is byte-equal), each in its own root:
    the car statistics (returned, and the cached JSON byte for byte), the
    rescaled dataset (velodyne, labels, split files; links to the same
    folders) and the frame each renders, both figures written."""
    import importlib.util
    import sys

    from tpu3d.config import paths as jpaths
    from tpu3d_torch.config import paths
    from tpu3d_torch.studies import stat_norm_walkthrough as walk

    jroot = tmp_path / "ref"
    jroots = {d: str(jroot / os.path.relpath(paths.dataset_paths[d],
                                             paths.dataset_path))
              for d in ("kitti", "waymo")}
    walk.make_synthetic_domain(jroots["kitti"], walk.SRC_CARS)
    walk.make_synthetic_domain(jroots["waymo"], walk.DST_CARS)
    monkeypatch.setattr(jpaths, "dataset_path", str(jroot))
    for d, r in jroots.items():
        monkeypatch.setitem(jpaths.dataset_paths, d, r)
    spec = importlib.util.spec_from_file_location(
        "stat_norm_walkthrough_ref",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "examples",
            "stat_norm_walkthrough.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    monkeypatch.setattr(sys, "argv", [
        "stat_norm_walkthrough.py", "--src", "kitti", "--dst", "waymo",
        "--out", str(tmp_path / "ref.png")])
    ref.main()
    ref_out = capsys.readouterr().out

    got = walk.main(["--src", "kitti", "--dst", "waymo", "--synthetic",
                     "--synthetic_root", str(tmp_path / "ours"), "--out",
                     str(tmp_path / "ours.png")])
    out = capsys.readouterr().out
    assert out.splitlines()[:3] == ref_out.splitlines()[:3]  # the table
    from tpu3d.stat_norm.stat import get_dataset_stats as jax_stats
    for d in ("kitti", "waymo"):
        assert got["stats"][d] == jax_stats(jroots[d])
        with open(os.path.join(jroots[d], "label_stats_train.json"),
                  "rb") as f:
            want = f.read()
        ours_root = os.path.join(str(tmp_path / "ours"),
                                 os.path.relpath(jroots[d], jroot))
        with open(os.path.join(ours_root, "label_stats_train.json"),
                  "rb") as f:
            assert f.read() == want
    assert got["stats"]["kitti"]["length"]["mean"] < \
        got["stats"]["waymo"]["length"]["mean"]
    rescaled = _walkthrough_files(got["rescaled"])
    assert rescaled == _walkthrough_files(
        str(jroot / "rescaled_datasets" / "kitti_scaledto_waymo"))
    assert any(k.startswith("training/label_2/") for k in rescaled)
    assert f"rescaled dataset at {got['rescaled']}" in out
    assert os.path.getsize(tmp_path / "ours.png") > 0
    assert os.path.getsize(tmp_path / "ref.png") > 0


def test_showvelo_segments_equal_tpu3d(monkeypatch):
    """utils.viz.showvelo with the matplotlib backend: the same scattered
    points and the same wireframe segments (gt green, pred red) as
    tpu3d's, and BOX_EDGES equal."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch

    from tpu3d.utils import viz as jviz
    from tpu3d_torch.utils import viz

    assert viz.BOX_EDGES == jviz.BOX_EDGES
    for mod in (viz, jviz):
        monkeypatch.setattr(mod, "_have_plotly", lambda: False)
    rng = np.random.default_rng(6)
    pts = rng.uniform([-20, -2, 0], [20, 2, 60], size=(500, 3)).astype(
        np.float32)
    gt = np.array([[1.0, 1.6, 20.0, 1.5, 1.6, 3.9, 0.3],
                   [-4.0, 1.7, 30.0, 1.6, 1.7, 4.2, -1.2]], np.float32)
    pred = gt[:1] + 0.1
    figs = [viz.showvelo(torch.from_numpy(pts), torch.from_numpy(gt),
                         pred, point_size=0.5),
            jviz.showvelo(pts, gt, pred, point_size=0.5)]
    (ax,), (jax_,) = figs[0].axes, figs[1].axes
    assert len(ax.lines) == len(jax_.lines) == 12 * 3
    for a, b in zip(ax.lines, jax_.lines):
        np.testing.assert_array_equal(np.asarray(a.get_data_3d()),
                                      np.asarray(b.get_data_3d()))
        assert a.get_color() == b.get_color()
    for a, b in zip(ax.collections[0]._offsets3d,
                    jax_.collections[0]._offsets3d):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for fig in figs:
        plt.close(fig)
