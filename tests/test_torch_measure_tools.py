"""The port's measurement tools on the CPU: the roofline's analytic counts
against tpu3d's, its FlopCounterMode half, the trace summary, the dispatch
probe and the loader bench.

- ``tools/roofline.py``'s walk over the layer specs equals tpu3d's to the
  float for every file in ``configs/``, in both modes, at two batches (the
  same arithmetic in the same order on the same config values);
- ``FlopCounterMode`` over smoke.yaml's joint eval batch counts the
  products torch runs (on the CPU the fused SA ops' plain versions are
  torch too: above zero, and below twice the analytic count);
- ``tools/parse_trace.py`` on a Chrome trace written here (known names,
  durations and counts, so the sums are exact) and on a CPU-only
  torch.profiler trace, which has no device events;
- ``tools/probe_dispatch.probe`` on the CPU: finite, positive times;
- ``tools/bench_loader.py`` at 4 scenes of 2, one thread and one process
  worker, on 4 synthetic frames, in a fresh interpreter.
"""

import glob
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from tpu3d.config import cfg_from_file as jax_cfg_from_file
from tpu3d.config import fresh_cfg as jax_fresh_cfg
from tpu3d.tools import roofline as jax_roofline
from tpu3d_torch.config import cfg_from_file, fresh_cfg
from tpu3d_torch.datasets import create_synthetic_kitti
from tpu3d_torch.tools import parse_trace, probe_dispatch
from tpu3d_torch.tools import roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(ROOT, "configs", "*.yaml")))


@pytest.mark.parametrize("name", CONFIGS)
def test_roofline_counts_equal_tpu3d(name):
    """program_flops and its three parts equal tpu3d's for the config, at
    eval and train, at batches 2 and 16; the renamed key holds tpu3d's
    neighbour count."""
    path = os.path.join(ROOT, "configs", name)
    jcfg = jax_fresh_cfg()
    jax_cfg_from_file(path, target=jcfg)
    cfg = cfg_from_file(path, fresh_cfg())
    for mode in ("eval", "train"):
        rois = (cfg.RCNN.ROI_PER_IMAGE if mode == "train"
                else cfg.TEST.RPN_POST_NMS_TOP_N)
        for batch in (2, 16):
            ours = roofline.program_flops(cfg, mode, batch)
            ref = jax_roofline.program_flops(jcfg, mode, batch)
            assert ours["fwd_matmul_flops"] == ref["fwd_matmul_flops"]
            assert ours["total_matmul_flops"] == ref["total_matmul_flops"]
            assert ours["neighbor_flops"] == ref["vpu_neighbor_flops"]
            assert ours["breakdown_fwd"] == ref["breakdown_fwd"]
            assert ours["total_matmul_flops"] > 0
            assert roofline.backbone_matmul_flops(cfg, batch) == \
                jax_roofline.backbone_matmul_flops(jcfg, batch)
            assert roofline.rcnn_matmul_flops(cfg, batch, rois) == \
                jax_roofline.rcnn_matmul_flops(jcfg, batch, rois)
            assert roofline.neighbor_flops(cfg, batch, rois) == \
                jax_roofline.neighbor_vpu_flops(jcfg, batch, rois)


def test_roofline_main_analytic_rows(capsys):
    """main with --skip-counted on the CPU: tpu3d's rows with the renamed
    keys, mfu_pct = the analytic FLOPs over the given time and 67 TFLOP/s,
    and the card field naming the device."""
    rows = roofline.main(["--eval-ms", "100", "--train-ms", "400",
                          "--skip-counted", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == rows
    ev, tr, breakdown = rows
    assert ev["program"] == "eval_batch8" and tr["program"] == \
        "train_step_batch16"
    cfg = roofline.default_cfg(os.path.join(ROOT, "configs",
                                            "default.yaml"))
    flops = roofline.program_flops(cfg, "train", 16)["total_matmul_flops"]
    assert math.isclose(tr["mfu_pct"],
                        round(100 * flops / 0.4 / 67e12, 2))
    assert ev["card"] == "cpu" and ev["counted_tflop_per_step"] == 0.0
    assert "neighbor_gflop_per_step" in ev
    assert not any(k.startswith(("xla", "hbm", "vpu")) for k in ev)
    assert set(breakdown) == {"breakdown_fwd_eval", "breakdown_fwd_train"}


def test_flop_counter_counts_the_eval_batch():
    """FlopCounterMode over smoke.yaml's joint eval batch (B=2) on the
    CPU: more than zero, at most the analytic matmul count plus the other
    products torch runs (the proposal decode, the ROI transform)."""
    cfg = cfg_from_file(os.path.join(ROOT, "configs", "smoke.yaml"),
                        fresh_cfg())
    got = roofline.counted_flops_eval(cfg, 2, "cpu")["counted_flops"]
    analytic = roofline.program_flops(cfg, "eval", 2)["total_matmul_flops"]
    assert 0 < got
    assert got <= 2 * analytic


def _write_trace(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def _ev(cat, name, dur, ts=0.0):
    return {"ph": "X", "cat": cat, "name": name, "dur": dur, "ts": ts,
            "pid": 0, "tid": 7}


def test_parse_trace_sums_and_buckets(tmp_path, capsys):
    """A written trace: device events summed per name (host events left
    out), the top list by time, the rollup (the port's kernels by csrc
    source, torch's own gather kernel under gather / scatter / index, the
    GEMM, memcpy and memset, NCCL), --like and --steps."""
    events = [
        _ev("kernel", "void (anonymous namespace)::fps_rows_kernel<1, 16>("
            "float const*, int, int, int, int*)", 30.0),
        _ev("kernel", "void (anonymous namespace)::fps_rows_kernel<1, 16>("
            "float const*, int, int, int, int*)", 10.0),
        _ev("kernel", "_ZN12_GLOBAL__N_116nearest_k_kernelILb1EEEvPKf",
            25.0),
        _ev("kernel", "void at::native::vectorized_gather_kernel<16, long>"
            "(char*, char*, long*, int, long, long, long, long, bool)", 6.0),
        _ev("kernel", "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize", 50.0),
        _ev("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL(...)", 4.0),
        _ev("kernel", "void at::native::vectorized_elementwise_kernel<4, "
            "at::native::FillFunctor<float>>(int, ...)", 2.0),
        _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 8.0),
        _ev("gpu_memset", "Memset (Device)", 1.0),
        _ev("cpu_op", "aten::mm", 500.0),
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0.0},
    ]
    trace_dir = tmp_path / "profile"
    trace_dir.mkdir()
    _write_trace(trace_dir / "old.json", [_ev("kernel", "x", 1.0)])
    os.utime(trace_dir / "old.json", (1, 1))
    _write_trace(trace_dir / "trace.json", events)

    out = parse_trace.main([str(tmp_path), "--top", "3", "--steps", "2"])
    text = capsys.readouterr().out
    assert out["path"].endswith("trace.json")
    assert math.isclose(out["total_ms"], 136.0 / 1e3 / 2)
    assert [(parse_trace.kernel_base(name)[0], cnt)
            for name, _, cnt in out["top"]] == [
        ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize", 1),
        ("fps_rows_kernel", 2), ("nearest_k_kernel", 1)]
    groups = out["groups"]
    assert math.isclose(groups["port csrc/fps.cu"], 0.02)
    assert math.isclose(groups["port csrc/nearest_k.cu"], 0.0125)
    assert math.isclose(groups["GEMM (cuBLAS / CUTLASS)"], 0.025)
    assert math.isclose(groups["gather / scatter / index"], 0.003)
    assert math.isclose(groups["copy / memset"], 0.0045)
    assert math.isclose(groups["NCCL"], 0.002)
    assert math.isclose(groups["elementwise"], 0.001)
    assert out["port_counts"] == {"fps_rows_kernel": 2,
                                  "nearest_k_kernel": 1}
    assert "total device time: 0.07 ms/step over 2 steps" in text
    assert "## grouped" in text and "port csrc/fps.cu" in text

    like = parse_trace.main([str(trace_dir / "trace.json"), "--like",
                             "fps_rows"])
    assert math.isclose(like["total_ms"], 0.04)
    assert set(like["groups"]) == {"port csrc/fps.cu"}


def test_parse_trace_on_a_cpu_profile(tmp_path, capsys):
    """A torch.profiler trace of CPU work alone, exported as Chrome JSON:
    no device events, said so, and nothing returned."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    path = tmp_path / "cpu_trace.json"
    prof.export_chrome_trace(str(path))
    assert parse_trace.load_device_ops(str(path)) == []
    assert parse_trace.main([str(tmp_path)]) is None
    assert "no device events" in capsys.readouterr().out


def test_probe_dispatch_on_the_cpu():
    """probe(device="cpu"): the four times finite and positive, the
    staging rate their quotient, the device named."""
    out = probe_dispatch.probe(mb=0.5, iters=4, device="cpu")
    for key in ("sync_round_trip_ms", "async_dispatch_ms", "device_put_ms",
                "detections_pull_ms", "device_put_mb_per_s"):
        assert math.isfinite(out[key]) and out[key] > 0, key
    assert out["device"] == "cpu" and out["device_put_mb"] == 0.5


def test_bench_loader_thread_and_process(tmp_path):
    """bench_loader over 4 synthetic frames at 4 scenes of 2: the serial
    build and both worker modes at one worker, finite positive scenes/s,
    in tpu3d's keys, the JSON line printed last. It runs in a fresh
    interpreter, as from the command line: its process workers fork, and
    this one has JAX's threads."""
    root = str(tmp_path / "data")
    create_synthetic_kitti(root, n_frames=4, image_files=True, seed=3)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "tpu3d_torch.tools.bench_loader",
         "--data_root", root, "--scenes", "4", "--batch_size", "2",
         "--workers", "1", "--npoints", "4096"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.splitlines()[-1])
    assert set(out) == {"serial_scenes_per_sec", "serial_ms_per_scene",
                        "thread_w1_scenes_per_sec",
                        "process_w1_scenes_per_sec"}
    for key, v in out.items():
        assert math.isfinite(v) and v > 0, key
