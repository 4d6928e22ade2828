"""Host <-> device dispatch and transfer probe (counterpart of
``tpu3d/tools/probe_dispatch.py``).

Measures the four numbers that separate a serving loop that waits for
each result from a pipelined one:

  * the sync round trip: a trivial op (sum · 2) on a 128 x 128 tensor on
    the device, then ``.item()``, per call: the floor any ``result =
    model(x); use(result)`` loop pays per request;
  * the amortized asynchronous dispatch: N calls queued, one synchronize:
    what a loop with more than one request in flight pays per request;
  * host -> device staging of ``mb`` MB (``.to(device)`` of a pageable
    float32 buffer, each copy from a freshly dirtied buffer, waited for);
  * the device -> host pull of a detections-sized result, (8, 100, 7)
    boxes and (8, 100) scores, made on the device each time.

    python -m tpu3d_torch.tools.probe_dispatch [--mb 1.5] [--iters 20]
        [--device cuda]

Prints one JSON line, with the device's name where tpu3d gives the
platform.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def probe(mb: float = 1.5, iters: int = 20, device="cuda") -> dict:
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)

    def f(x):
        return x.sum() * 2.0

    x = torch.ones((128, 128), dtype=torch.float32, device=dev)
    float(f(x).item())  # warm-up

    t0 = time.perf_counter()
    for _ in range(iters):
        float(f(x).item())
    sync_rt_ms = (time.perf_counter() - t0) / iters * 1000.0

    _sync(dev)
    t0 = time.perf_counter()
    rs = [f(x) for _ in range(iters * 5)]
    _sync(dev)
    async_ms = (time.perf_counter() - t0) / (iters * 5) * 1000.0
    del rs

    n = int(mb * 1e6 / 4)
    host = np.ones((n,), np.float32)
    reps = max(iters // 4, 3)
    t0 = time.perf_counter()
    for i in range(reps):
        host[i] = i  # a fresh buffer's content each copy
        torch.from_numpy(host).to(dev)
        _sync(dev)
    put_ms = (time.perf_counter() - t0) / reps * 1000.0

    def g(x):
        s = x.sum()
        return (torch.zeros((8, 100, 7), device=dev) + s,
                torch.zeros((8, 100), device=dev) + s)

    g(x)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        boxes, scores = g(x)
        boxes.cpu().numpy(), scores.cpu().numpy()
    pull_ms = (time.perf_counter() - t0) / iters * 1000.0

    return {
        "sync_round_trip_ms": round(sync_rt_ms, 4),
        "async_dispatch_ms": round(async_ms, 4),
        "device_put_ms": round(put_ms, 4),
        "device_put_mb": mb,
        "device_put_mb_per_s": round(mb / (put_ms / 1000.0), 1),
        "detections_pull_ms": round(pull_ms, 4),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else dev.type),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=float, default=1.5,
                    help="staging probe size in MB (default: one eval batch)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = probe(args.mb, args.iters, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
