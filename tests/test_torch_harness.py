"""The port's boundaries: what it imports, where it runs, what it counts."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpu3d.config as jax_config
from tpu3d_torch.config import cfg_from_file, fresh_cfg
from tpu3d_torch.models import PointRCNN
from tpu3d_torch.ops import (ball_query, furthest_point_sample,
                             furthest_point_sample_with_3nn,
                             fused_bn_mlp_pool, fused_gathered_mlp_pool,
                             fused_mlp_pool, nearest_k, three_interpolate,
                             three_nn)
from tpu3d_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax_and_no_tpu3d():
    """Every module of tpu3d_torch, imported in a fresh interpreter, loads
    no jax, flax, optax or tpu3d module, and no msgpack (the checkpoints'
    codec is the port's own); the walk reaches the loader, checkpoint,
    training and eval CLI modules, the evaluator's, the measurement tools
    (roofline, loader bench, trace summary, dispatch probe), the renderers
    and the stat_norm walkthrough."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import tpu3d_torch\n"
        "for m in pkgutil.walk_packages(tpu3d_torch.__path__, "
        "'tpu3d_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'tpu3d'))\n"
        "print('MODULES', len([n for n in sys.modules "
        "if n.startswith('tpu3d_torch')]))\n"
        "print('BAD', bad)\n"
        "print('HAVE', ' '.join(sorted(n for n in sys.modules "
        "if n.startswith('tpu3d_torch'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    n_modules = int(res.stdout.split("MODULES ")[1].split()[0])
    assert n_modules >= 20
    have = set(res.stdout.split("HAVE ")[1].split())
    assert {"tpu3d_torch.kitti.annos", "tpu3d_torch.kitti.boxes",
            "tpu3d_torch.kitti.calibration", "tpu3d_torch.kitti.object3d",
            "tpu3d_torch.datasets.kitti_dataset",
            "tpu3d_torch.datasets.kitti_rcnn_dataset",
            "tpu3d_torch.datasets.loader", "tpu3d_torch.utils.checkpoint",
            "tpu3d_torch.utils.logging", "tpu3d_torch.utils.msgpack_io",
            "tpu3d_torch.tools.generate_gt_database",
            "tpu3d_torch.tools.train_rcnn", "tpu3d_torch.tools.eval_rcnn",
            "tpu3d_torch.evaluate.ap", "tpu3d_torch.evaluate.evaluate",
            "tpu3d_torch.evaluate.native",
            "tpu3d_torch.evaluate.overlaps", "tpu3d_torch.config.paths",
            "tpu3d_torch.stat_norm.stat", "tpu3d_torch.stat_norm.norm",
            "tpu3d_torch.stat_norm.visualize",
            "tpu3d_torch.studies.statnorm_effect",
            "tpu3d_torch.studies.multiclass_cyclist",
            "tpu3d_torch.studies.domain_matrix",
            "tpu3d_torch.tools.generate_aug_scene",
            "tpu3d_torch.tools.generate_multi_data",
            "tpu3d_torch.tools.pointnet2_demo",
            "tpu3d_torch.tools.probe_determinism",
            "tpu3d_torch.tools.roofline", "tpu3d_torch.tools.bench_loader",
            "tpu3d_torch.tools.parse_trace",
            "tpu3d_torch.tools.probe_dispatch", "tpu3d_torch.utils.viz",
            "tpu3d_torch.studies.stat_norm_walkthrough"} <= have


def test_entry_point_defaults_to_cuda():
    """Without device="cpu" an entry point wants the card, and raises on a
    machine without one instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PointRCNN(fresh_cfg())


def test_shipped_config_builds_the_joint_model():
    """configs/default.yaml as shipped builds the joint model (RPN and
    RCNN) with no override; it too wants the card unless given
    device="cpu"."""
    cfg = cfg_from_file(str(ROOT / "configs" / "default.yaml"), fresh_cfg())
    assert cfg.RCNN.ENABLED
    model = PointRCNN(cfg, device="cpu")
    assert hasattr(model, "rcnn_net")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PointRCNN(cfg)


def test_plain_versions_count_no_launches():
    """Only a kernel launch adds to the counts: the plain versions, taken
    for CPU tensors, leave them alone, forward and backward."""
    _build.reset_launches()
    xyz = torch.rand(1, 256, 3)
    _, d2, idx = furthest_point_sample_with_3nn(xyz, 64)
    furthest_point_sample_with_3nn(xyz[:, :100].contiguous(), 16)  # split
    three_nn(xyz, xyz[:, :8].contiguous())
    nearest_k(xyz[:, :32].contiguous(), xyz, 16, max_radius=0.5)
    feats = torch.rand(1, 64, 8, requires_grad=True)
    weight = torch.rand(1, 256, 3, requires_grad=True)
    three_interpolate(feats, idx, weight).sum().backward()
    picks = furthest_point_sample(xyz, 32)
    args = [torch.rand(1, 256, 8), idx[:, :32].contiguous(),
            torch.rand(1, 32, 8), torch.rand(8, 128), torch.rand(128),
            torch.rand(128, 128), torch.rand(128)]
    with torch.no_grad():
        fused_gathered_mlp_pool(*args)
    for i in (0, 2, 3, 4, 5, 6):
        args[i].requires_grad_()
    fused_gathered_mlp_pool(*args).sum().backward()
    slab = [torch.rand(1, 16, 16, 128), torch.rand(128, 128), torch.rand(128),
            torch.rand(128, 128), torch.rand(128)]
    with torch.no_grad():
        fused_mlp_pool(*slab)
        fused_bn_mlp_pool(slab[0], slab[1], slab[3], [torch.rand(128)] * 3,
                          [torch.rand(128)] * 3,
                          [(torch.rand(128), torch.rand(128))] * 3)
    for t in slab:
        t.requires_grad_()
    fused_mlp_pool(*slab).sum().backward()
    bn = [torch.rand(128, requires_grad=True) for _ in range(6)]
    out, _ = fused_bn_mlp_pool(slab[0], slab[1], slab[3], bn[:3], bn[3:])
    out.sum().backward()
    ball_query(xyz[:, :32].contiguous(), xyz, 0.3, 16, method="first")
    assert picks.shape == (1, 32)
    assert feats.grad is not None and weight.grad is not None
    assert all(args[i].grad is not None for i in (0, 2, 3, 4, 5, 6))
    assert all(t.grad is not None for t in slab + bn)
    assert set(_build.LAUNCHES) == {
        "fps3nn", "nearest_k", "three_interpolate", "three_interpolate_bwd",
        "fps", "fused_sa", "fused_sa_train", "fused_sa_bwd", "three_nn",
        "fps_long", "fused_sa_slab", "fused_sa_slab_bn",
        "fused_sa_slab_train", "fused_sa_slab_bwd", "fused_sa_bn_stats0",
        "fused_sa_bn_stats1", "fused_sa_bn_stats2", "fused_sa_bn_final",
        "fused_sa_bn_wave1", "fused_sa_bn_wave2", "fused_sa_bn_apply",
        "group_points_bwd"}
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES


def test_pending_error_names_the_earlier_launch(monkeypatch):
    """A C entry that finds an error already pending on its stream returns
    it as ``PENDING`` + its code; ``launch`` then raises it as pending before
    this launch, names the port's last kernel launched before it, and counts
    no launch. An error of the entry's own launch names that kernel and
    counts it. (The C entries are stubbed: no card here.)"""
    codes = {"fps": 0, "nearest_k": _build.PENDING + 700, "fused_sa": 98}
    monkeypatch.setattr(_build, "kernel",
                        lambda name: lambda *args: codes[name])
    monkeypatch.setattr(_build, "error_name",
                        lambda name, err: {700: "cudaErrorIllegalAddress",
                                           98: "cudaErrorInvalidDeviceFunction"}
                        [err])
    monkeypatch.setattr(_build, "current_stream", lambda: 0)
    _build.reset_launches()
    _build.launch("fps", 1, 2)
    with pytest.raises(RuntimeError) as pending:
        _build.launch("nearest_k", 1, 2)
    msg = str(pending.value)
    assert "cudaErrorIllegalAddress (700) was pending before the launch of " \
        "nearest_k" in msg
    assert "last kernel launched before it was fps" in msg
    with pytest.raises(RuntimeError, match="CUDA kernel fused_sa failed to "
                       "launch: cudaErrorInvalidDeviceFunction"):
        _build.launch("fused_sa", 1)
    assert (_build.LAUNCHES["fps"], _build.LAUNCHES["nearest_k"],
            _build.LAUNCHES["fused_sa"]) == (1, 0, 1)
    _build.reset_launches()


def test_kernel_library_names_follow_sources():
    """A kernel library's file name carries a hash of its source (and of
    the shared headers), so an edited source is rebuilt rather than a
    stale library loaded; every source in csrc/ has its library, and every
    kernel's entry lies in one of them."""
    names = {src: _build._lib_path(src).name for src in _build.SOURCES}
    assert set(names) == {p.stem for p in _build.CSRC.glob("*.cu")}
    for src, lib in names.items():
        assert lib.startswith(src + "-") and lib.endswith(".so")
    assert {src for src, _, _ in _build.KERNELS.values()} == set(names)


def test_config_copy_matches_tpu3d():
    """The port's copy of the config loader gives tpu3d's tree, for the
    defaults and after merging configs/default.yaml."""
    def same(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if hasattr(a[k], "items"):
                same(a[k], b[k], f"{path}.{k}")
            else:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]),
                                              err_msg=f"{path}.{k}")

    same(fresh_cfg(), jax_config.fresh_cfg())
    yaml = str(ROOT / "configs" / "default.yaml")
    same(cfg_from_file(yaml, fresh_cfg()),
         jax_config.cfg_from_file(yaml, jax_config.fresh_cfg()))
