"""Print the port's largest differences from tpu3d, per module, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py

The same inputs as the parity tests (tests/test_torch_*.py), which assert
the bounds; this script reports the measured maxima, for PERF.md.
"""

import os
import sys

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from test_torch_rpn import run_pair  # noqa: E402
from tpu3d.ops import furthest_point_sample_with_3nn as jax_fps3nn  # noqa
from tpu3d.ops import three_interpolate as jax_three_interpolate  # noqa
from tpu3d.ops.grouping import nearest_k as jax_nearest_k  # noqa: E402
from tpu3d_torch.models.proposal import proposal_layer  # noqa: E402
from tpu3d_torch.ops import (furthest_point_sample_with_3nn,  # noqa: E402
                             nearest_k, three_interpolate)


def main():
    rng = np.random.default_rng(4096)
    xyz = rng.uniform([-30, -1, 0], [30, 3, 70], (2, 4096, 3)).astype(
        np.float32)
    j = jax.device_get(jax_fps3nn(jnp.asarray(xyz), 1024))
    t = [a.numpy() for a in furthest_point_sample_with_3nn(
        torch.from_numpy(xyz), 1024)]
    rel = np.abs(t[1] - j[1]) / np.maximum(np.abs(j[1]), 1e-30)
    print(f"fps3nn (2, 4096) -> 1024: pick mismatches {(t[0] != j[0]).sum()}, "
          f"nn_idx mismatches {(t[2] != j[2]).sum()}, nn_d2 max rel "
          f"{rel.max():.3e}")

    pts = rng.uniform([-4, -1, 0], [4, 3, 8], (2, 4096, 3)).astype(np.float32)
    centers = pts[:, rng.choice(4096, 1024, replace=False)]
    jd, ji = jax.device_get(jax_nearest_k(jnp.asarray(centers),
                                          jnp.asarray(pts), 32))
    td, ti = nearest_k(torch.from_numpy(centers), torch.from_numpy(pts), 32)
    print(f"nearest_k (1024 x 4096, k 32): id mismatches "
          f"{(ti.numpy() != ji).sum()}, d2 max abs "
          f"{np.abs(td.numpy() - jd).max():.3e}")

    feats = rng.normal(size=(2, 4096, 256)).astype(np.float32)
    idx = rng.integers(0, 4096, (2, 16384, 3)).astype(np.int32)
    w = rng.uniform(0, 1, (2, 16384, 3)).astype(np.float32)
    jo = np.asarray(jax_three_interpolate(jnp.asarray(feats),
                                          jnp.asarray(idx), jnp.asarray(w)))
    to = three_interpolate(torch.from_numpy(feats), torch.from_numpy(idx),
                           torch.from_numpy(w)).numpy()
    print(f"three_interpolate (4096 x 256 -> 16384): max abs "
          f"{np.abs(to - jo).max():.3e}")

    for points in (1024, 4096):
        _, cfg, jout, tout, _ = run_pair(points)
        for key in ("backbone_xyz", "backbone_features", "rpn_cls",
                    "rpn_reg"):
            err = np.abs(tout[key] - jout[key]).max()
            print(f"RPN {points} points, {key}: max abs {err:.3e} "
                  f"(max |value| {np.abs(jout[key]).max():.3e})")
        rois, scores, valid = (a.numpy() for a in proposal_layer(
            torch.tensor(jout["rpn_cls"][..., 0]),
            torch.from_numpy(tout["rpn_reg"]),
            torch.from_numpy(tout["backbone_xyz"]), cfg, "TEST"))
        print(f"RPN {points} points, rois (tpu3d scores): max abs "
              f"{np.abs(rois - jout['rois']).max():.3e}, roi_valid "
              f"mismatches {(tout['roi_valid'] != jout['roi_valid']).sum()}, "
              f"valid {int(jout['roi_valid'].sum())}/{valid.size}")


if __name__ == "__main__":
    main()
