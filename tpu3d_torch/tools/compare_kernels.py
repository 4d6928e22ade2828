"""Time the gather-form SA backward and FPS of one checkout of the port on
seeded random inputs, to compare two checkouts on the same card in turns.

    python3 tpu3d_torch/tools/compare_kernels.py [--root DIR] [--label NAME]

``--root`` is the checkout whose ``tpu3d_torch`` is imported (default:
this one; run the file as a script, not with ``-m``, so that no other
checkout's package is imported first). It needs only the public
signatures of ``fused_gathered_mlp_pool_backward``,
``furthest_point_sample_with_3nn`` and ``furthest_point_sample``, so an
older checkout unpacked beside this one (``git archive``) can be timed
by this script. Shapes: the backward
at default.yaml's RCNN SA_0 and SA_1 of the train step (1024 rows; M =
128 / 32 centres of S = 64 slots; C3 = 128 / 256) under three routings
of the pooled gradient: every channel live at a slot drawn uniformly
over S ("full spread"), 2% of the channels live there ("sparse"), and
every channel live at slot 0 ("one slot", the shape seeded weights
give); FPS+3NN at default's and double's RPN levels, and the long-row FPS
at (16, 32768) -> 4096. Prints one line per case and a JSON line; needs a
card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs after a warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).parents[2]))
    parser.add_argument("--label", default="this checkout")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    from tpu3d_torch.ops import _build
    from tpu3d_torch.ops.fused_sa import fused_gathered_mlp_pool_backward
    from tpu3d_torch.ops.sampling import (furthest_point_sample,
                                          furthest_point_sample_with_3nn)

    _build.build_all()
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"label": args.label, "root": args.root}
    for level, (M, C3) in (("SA_0", (128, 128)), ("SA_1", (32, 256))):
        R, N, S = 1024, 512, 64

        def randn(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device="cuda") * scale

        ins = (randn(R, N, 128),
               torch.randint(0, N, (R, M, S), generator=g, device="cuda",
                             dtype=torch.int32),
               randn(R, M, 128), randn(128, 128, scale=128 ** -0.5),
               randn(128, scale=0.1), randn(128, C3, scale=128 ** -0.5),
               randn(C3, scale=0.1))
        grad = randn(R, M, C3)
        spread = torch.randint(0, S, grad.shape, generator=g, device="cuda",
                               dtype=torch.int32)
        live = torch.ones_like(grad)
        sparse = torch.where(torch.rand(grad.shape, generator=g,
                                        device="cuda") < 0.02, 1.0, -1.0)
        for case, arg, ppre in (("full spread", spread, live),
                                ("sparse", spread, sparse),
                                ("one slot", torch.zeros_like(spread), live)):
            ms = cuda_ms(lambda: fused_gathered_mlp_pool_backward(
                *ins, grad, arg, ppre), 5)
            out[f"fused_sa_bwd {level} {case}"] = ms
            print(f"{args.label}: fused_sa_bwd {level} {case}: {ms:.3f} ms",
                  flush=True)
        del ins
        torch.cuda.empty_cache()
    for B, N, npoint in ((2, 16384, 4096), (2, 4096, 1024), (16, 16384, 4096),
                         (4, 32768, 4096)):
        xyz = torch.rand(B, N, 3, generator=g, device="cuda") * 40.0
        ms = cuda_ms(lambda: furthest_point_sample_with_3nn(xyz, npoint), 5)
        out[f"fps3nn ({B}, {N}) -> {npoint}"] = ms
        print(f"{args.label}: fps3nn ({B}, {N}) -> {npoint}: {ms:.3f} ms",
              flush=True)
    xyz = torch.rand(16, 32768, 3, generator=g, device="cuda") * 40.0
    ms = cuda_ms(lambda: furthest_point_sample(xyz, 4096), 3)
    out["fps_long (16, 32768) -> 4096"] = ms
    print(f"{args.label}: fps_long (16, 32768) -> 4096: {ms:.3f} ms")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
