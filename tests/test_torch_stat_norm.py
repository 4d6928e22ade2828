"""The port's statistical normalization against tpu3d's on the CPU.

Both packages' ``stat_norm`` are host numpy code, so everything is held
equal: the label statistics (the returned dicts and the JSON caches byte
for byte) and ``convert``'s output trees (velodyne ``.bin``, ``label_2/``
text, split files, the links to the source's images and calibration) byte
for byte, on two small synthetic domains with shifted car sizes: with the
domains' own statistics, with ``align_front``, with ``avoid_conflict``
and with the car-sales statistics.

Sizes: 4 frames a domain of the default synthetic scene.
"""

import json
import os

import pytest

from tpu3d.stat_norm import norm as jnorm
from tpu3d.stat_norm import stat as jstat
from tpu3d_torch.datasets import create_synthetic_kitti
from tpu3d_torch.stat_norm import norm, stat
from tpu3d_torch.studies.statnorm_effect import stat_layout

FRAMES = 4


def tree(root):
    """Every file's bytes and every link's target under root, by relative
    path (links are not followed)."""
    out = {}
    for d, dirs, names in os.walk(root):
        for n in dirs + names:
            path = os.path.join(d, n)
            rel = os.path.relpath(path, root)
            if os.path.islink(path):
                out[rel] = ("link", os.readlink(path))
            elif os.path.isfile(path):
                with open(path, "rb") as f:
                    out[rel] = f.read()
    return out


@pytest.fixture(scope="module")
def domains(tmp_path_factory):
    """Two domains (KITTI-like and US-like cars) in the stat_norm layout,
    with their label statistics cached by the port."""
    base = tmp_path_factory.mktemp("statnorm")
    roots = {}
    for name, seed, dims in (("a", 1, (1.52, 1.63, 3.88)),
                             ("b", 2, (1.80, 2.00, 5.00))):
        kitti = str(base / f"domain_{name}")
        create_synthetic_kitti(kitti, n_frames=FRAMES, seed=seed,
                               image_files=True, car_dims_mean=dims)
        roots[name] = stat_layout(kitti, str(base / f"stat_{name}"))
        stat.get_dataset_stats(roots[name])
    return base, roots


@pytest.mark.parametrize("split", ["train", "val"])
def test_dataset_stats_equal_tpu3d(domains, split):
    """get_dataset_stats: the same dict, and the same JSON cache, byte for
    byte; the cache is read back unless forced."""
    _, roots = domains
    root = roots["a"]
    cache = os.path.join(root, f"label_stats_{split}.json")
    ours = stat.get_dataset_stats(root, split, force=True)
    with open(cache, "rb") as f:
        ours_bytes = f.read()
    ref = jstat.get_dataset_stats(root, split, force=True)
    with open(cache, "rb") as f:
        assert f.read() == ours_bytes
    assert ours == ref
    with open(cache, "w") as f:
        json.dump({"cached": True}, f)
    assert stat.get_dataset_stats(root, split) == {"cached": True}
    stat.get_dataset_stats(root, split, force=True)


def test_print_stats_equal_tpu3d(domains, capsys):
    _, roots = domains
    stats = {d: stat.get_dataset_stats(r) for d, r in roots.items()}
    stat.print_stats(stats)
    ours = capsys.readouterr().out
    jstat.print_stats(stats)
    assert capsys.readouterr().out == ours
    assert stat.get_stats([1.0, 3.0]) == jstat.get_stats([1.0, 3.0])


CONVERTS = {
    "domain stats": {},
    "align_front": {"align_front": True},
    "avoid_conflict": {"avoid_conflict": True},
    "car sales": {"use_car_sales_stats": True},
    "image size read": {"image_size": None},
}


@pytest.mark.parametrize("case", list(CONVERTS))
def test_convert_trees_equal_tpu3d(domains, case):
    """convert writes tpu3d's tree byte for byte: rescaled velodyne and
    labels, split files, links. The car-sales case maps kitti -> argo
    (Germany's sales statistics to the US's); "image size read" takes the
    image size from the first train image's PNG."""
    base, roots = domains
    kwargs = dict(CONVERTS[case])
    kwargs.setdefault("image_size", (1242, 375))
    if kwargs.get("use_car_sales_stats"):
        src, dst, extra = "kitti", "argo", {}
    else:
        src, dst, extra = "syn_a", "syn_b", {"dst_stats_path": roots["b"]}
    out = {}
    for tag, fn in (("ours", norm.convert), ("ref", jnorm.convert)):
        root = fn(src, dst, spath=roots["a"],
                  dpath=str(base / f"rescaled_{tag}_{case}"), **extra,
                  **kwargs)
        assert root == str(base / f"rescaled_{tag}_{case}" /
                           f"{src}_scaledto_{dst}")
        out[tag] = tree(root)
    assert out["ours"] == out["ref"]
    velo = [k for k in out["ours"] if k.startswith("training/velodyne/")]
    labels = [k for k in out["ours"] if k.startswith("training/label_2/")]
    assert len(velo) == len(labels) == FRAMES
    assert out["ours"]["training/image_2"][0] == "link"


def test_rescaled_stats_reach_the_target(domains):
    """The converted domain's car statistics land on the target's: the
    method's check (the study's step 3)."""
    base, roots = domains
    root = norm.convert("syn_a", "syn_b", spath=roots["a"],
                        dpath=str(base / "rescaled_check"),
                        dst_stats_path=roots["b"], image_size=(1242, 375))
    got = stat.get_dataset_stats(root, force=True)
    want = stat.get_dataset_stats(roots["b"])
    src = stat.get_dataset_stats(roots["a"])
    for k in stat.STAT_SUBJECTS:
        assert abs(got[k]["mean"] - want[k]["mean"]) < 0.05
        assert abs(got[k]["mean"] - want[k]["mean"]) < \
            abs(src[k]["mean"] - want[k]["mean"])


def test_host_functions_equal_tpu3d(domains):
    """single_scale, get_scale_map, car_sales_stats, get_object_mask and the
    path registry give tpu3d's values."""
    import numpy as np

    from tpu3d import kitti as jkitti
    from tpu3d.config import paths as jpaths
    from tpu3d.stat_norm import visualize as jvis
    from tpu3d_torch import kitti
    from tpu3d_torch.config import paths
    from tpu3d_torch.stat_norm import visualize

    _, roots = domains
    assert norm.car_sales_stats() == jnorm.car_sales_stats()
    src, dst = stat.get_dataset_stats(roots["a"]), \
        stat.get_dataset_stats(roots["b"])
    name = open(os.path.join(roots["a"], "train.txt")).readline().strip()
    labels = kitti.read_label(os.path.join(roots["a"], "training", "label_2",
                                           f"{name}.txt"))
    jlabels = jkitti.read_label(os.path.join(roots["a"], "training",
                                             "label_2", f"{name}.txt"))
    for obj, jobj in zip(labels, jlabels):
        for ratio in (0.0, 0.5, 1.0):
            assert np.array_equal(norm.get_scale_map(src, dst)(obj, ratio),
                                  jnorm.get_scale_map(src, dst)(jobj, ratio))
    assert norm.single_scale(1.5, src["height"], dst["height"], 0.3) == \
        jnorm.single_scale(1.5, src["height"], dst["height"], 0.3)
    velo = kitti.load_velo_scan(os.path.join(roots["a"], "training",
                                             "velodyne", f"{name}.bin"))
    calib = kitti.Calibration(os.path.join(roots["a"], "training", "calib",
                                           f"{name}.txt"))
    rect = calib.project_velo_to_rect(velo[:, :3])
    mask = visualize.get_object_mask(rect, labels)
    assert mask.any()
    assert np.array_equal(mask, jvis.get_object_mask(rect, jlabels))
    assert (paths.dataset_path, paths.raw_path_dic, paths.dataset_paths,
            paths.dataset_full_name, paths.datasets) == \
        (jpaths.dataset_path, jpaths.raw_path_dic, jpaths.dataset_paths,
         jpaths.dataset_full_name, jpaths.datasets)
