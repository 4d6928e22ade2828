"""PointNet++ set abstraction and feature propagation (counterpart of
``tpu3d/models/pointnet2.py``): the RPN's MSG backbone and the RCNN's
single-scale levels, at eval and in training.

Channels-last like the JAX package: features are (B, N, C), xyz (B, N, 3).
Submodules carry the flax names (``sa_0.mlp_1.dense_0``, ``bn_0`` ...), so
``weights.params_from_jax`` maps the two trees one to one. Every module
takes ``train`` and ``bn_momentum``: at eval BatchNorm normalises with its
running statistics, in training with the batch's, and updates the running
ones with the momentum given at run time.

Grouping follows the JAX package's eval path. Every SA level runs one
nearest-k search shared by its radii, and each radius takes a prefix of it
with ``ball_query_from_nearest``. SA_0 (no features) groups the
candidates' coordinates, which the search returns with them. The levels
with features run the pre-group form of the first layer: with
W = [W_x | W_f],
    W @ [xyz[idx] - c ; f[idx]] = (W_x@xyz + W_f@f)[idx] - W_x@c,
so one per-point matmul and one gather of its output replace the grouped
copy. It is the form the JAX package takes at every RPN level with
features, and at the RCNN's levels, which makes it the one that matches it
most closely.

An RCNN level (``PointnetSAModule``) then takes one of tpu3d's three routes,
chosen from its shapes alone and the same on every device
(``ops/fused_sa.py::sa_route``):

- gather: a no-BN 3-layer MLP over a source table the gather form takes
  (N % 128 == 0, N <= 2048) runs the gather, layers 1-2 and the max-pool as
  one fused op (``fused_gathered_mlp_pool``): SA_0 and SA_1 of default.yaml,
  SA_0 of quickstart.yaml and smoke.yaml;
- slab: the same MLP over any other source table, or an MLP with
  BatchNorm, groups the pre-activations into the (R, M, S, C1) slab, and
  the fused slab op runs layers 1-2 and the max-pool: ``fused_mlp_pool``
  at SA_1 of quickstart.yaml (64 points) and smoke.yaml (32 points),
  ``fused_bn_mlp_pool`` with BatchNorm (an RCNN with ``USE_BN: true``):
  at eval with the running statistics, in training with the batch's, which
  then update the running ones;
- plain: the SharedMLP and a max, otherwise (other widths or group shapes,
  and the GroupAll).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import (ball_query, ball_query_from_nearest,
                   furthest_point_sample, furthest_point_sample_with_3nn,
                   fused_bn_mlp_pool, fused_gathered_mlp_pool, fused_mlp_pool,
                   gather_points, group_points, interpolation_weights,
                   nearest_k, sa_route, three_interpolate)
from ..parallel.mesh import batch_means


class BatchNorm(nn.Module):
    """BatchNorm over the last axis (tpu3d's ``BatchNorm``).

    At eval, from the running statistics, folded into one per-channel
    affine as in the JAX package: x·(scale/√(var+ε)) + (bias −
    mean·scale/√(var+ε)). In training, from the batch's statistics over
    every other axis, with the biased variance E[x²] − mean², and the
    running statistics updated in place to m·running + (1 − m)·batch, where
    ``momentum`` m follows flax's convention (PyTorch's momentum is 1 − m)
    and the running variance takes the biased batch variance, as tpu3d's
    does (``torch.nn.BatchNorm`` would take the unbiased one). Under a
    data-parallel mesh (``parallel.mesh.use_mesh``) the statistics are the
    global batch's: the sums of every rank over the count of every rank's
    rows, as tpu3d's sharded step takes them, so the running statistics
    agree on every rank."""

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def affine(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The eval normalisation as one per-channel (mul, add)."""
        mul = torch.rsqrt(self.var + self.eps) * self.scale
        return mul, self.bias - self.mean * mul

    def forward(self, x: torch.Tensor, train: bool = False,
                momentum: float = 0.9) -> torch.Tensor:
        if not train:
            mul, add = self.affine()
            return x * mul + add
        axes = tuple(range(x.dim() - 1))
        mean, sq = batch_means((x, x * x), axes)
        var = sq - mean * mean
        with torch.no_grad():
            self.mean.copy_(momentum * self.mean + (1 - momentum) * mean)
            self.var.copy_(momentum * self.var + (1 - momentum) * var)
        inv = torch.rsqrt(var + self.eps)
        return ((x - mean) * inv) * self.scale + self.bias


class SharedMLP(nn.Module):
    """Pointwise Dense(+BN)+ReLU layers over the channel axis."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 bn: bool = True, device=None):
        super().__init__()
        self.n = len(channels)
        self.bn = bn
        for i, ch in enumerate(channels):
            self.add_module(f"dense_{i}", nn.Linear(
                in_channels, ch, bias=not bn, device=device))
            if bn:
                self.add_module(f"bn_{i}", BatchNorm(ch, device=device))
            in_channels = ch

    def forward(self, x: torch.Tensor | None,
                pre0: torch.Tensor | None = None, train: bool = False,
                bn_momentum: float = 0.9) -> torch.Tensor:
        """``pre0``, when given, is layer 0's pre-activation, computed by
        the caller with ``dense_0`` (``x`` is then ignored)."""
        for i in range(self.n):
            x = pre0 if (i == 0 and pre0 is not None) else \
                getattr(self, f"dense_{i}")(x)
            if self.bn:
                x = getattr(self, f"bn_{i}")(x, train, bn_momentum)
            x = torch.relu(x)
        return x


class PointnetSAModuleMSG(nn.Module):
    """Multi-scale set abstraction: per-radius ball query from one shared
    nearest-k search, shared MLP, max-pool over the neighbourhood, concat
    across scales (reference: pointnet2_modules.py:19-96)."""

    def __init__(self, radii: Sequence[float], nsamples: Sequence[int],
                 mlps: Sequence[Sequence[int]], in_channels: int,
                 bn: bool = True, device=None):
        super().__init__()
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(s) for s in nsamples)
        for i, mlp in enumerate(mlps):
            self.add_module(f"mlp_{i}", SharedMLP(in_channels + 3, mlp, bn=bn,
                                                  device=device))

    def forward(self, xyz: torch.Tensor, features: torch.Tensor | None,
                new_xyz: torch.Tensor, train: bool = False,
                bn_momentum: float = 0.9) -> torch.Tensor:
        """xyz (B, N, 3), features (B, N, C) or None, new_xyz (B, npoint, 3)
        -> (B, npoint, ΣC_out)."""
        B, N, _ = xyz.shape
        if features is None:
            # the candidates' coordinates come with them, for every scale
            d2, cand, cand_xyz = nearest_k(new_xyz, xyz, max(self.nsamples),
                                           max_radius=max(self.radii),
                                           with_coords=True)
        else:
            d2, cand = nearest_k(new_xyz, xyz, max(self.nsamples),
                                 max_radius=max(self.radii))
            inp = torch.cat([xyz, features], dim=-1)
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radii, self.nsamples)):
            mlp = getattr(self, f"mlp_{i}")
            if features is None:
                # prefix slots, radius hit mask, and the CUDA fill (first
                # hit, else point 0), all elementwise on the candidates
                hit = (d2[..., :nsample] < radius * radius) \
                    & (cand[..., :nsample] < N)
                c_xyz = cand_xyz[..., :nsample, :]
                first = torch.where(hit[..., 0:1, None], c_xyz[..., 0:1, :],
                                    xyz[:, 0][:, None, None, :])
                grouped = (torch.where(hit[..., None], c_xyz, first)
                           - new_xyz[:, :, None, :])
                out = mlp(grouped, train=train, bn_momentum=bn_momentum)
            else:
                idx = ball_query_from_nearest(d2, cand, radius, nsample, N)
                dense0 = mlp.dense_0
                # a layer-0 bias (no-BN MLPs) rides the gathered term once;
                # the center term W_x@c carries none
                x = group_points(dense0(inp), idx)
                x = x - (new_xyz @ dense0.weight[:, :3].T)[:, :, None, :]
                out = mlp(None, pre0=x, train=train, bn_momentum=bn_momentum)
            outs.append(out.amax(dim=2))
        return torch.cat(outs, dim=-1)


class PointnetSAModule(nn.Module):
    """Single-scale set abstraction with its own FPS (reference:
    pointnet2_modules.py:99-119), or GroupAll when ``npoint`` is None."""

    def __init__(self, npoint: int | None, radius: float, nsample: int,
                 mlp: Sequence[int], in_channels: int, bn: bool = True,
                 device=None):
        super().__init__()
        self.npoint = npoint
        self.radius = float(radius)
        self.nsample = int(nsample)
        self.mlp = tuple(int(c) for c in mlp)
        self.mlp_0 = SharedMLP(in_channels + 3, mlp, bn=bn, device=device)

    def group_inputs(self, xyz: torch.Tensor, features: torch.Tensor):
        """FPS centers, ball query and the pre-group layer 0: (new_xyz
        (B, npoint, 3), pre (B, N, C1) per-point pre-activations, idx
        (B, npoint, nsample) i32, center (B, npoint, C1)), where layer 0's
        pre-activation of slot s of center m is pre[idx[m, s]] - center[m]."""
        new_xyz = gather_points(xyz, furthest_point_sample(xyz, self.npoint))
        idx = ball_query(new_xyz, xyz, self.radius, self.nsample)
        dense0 = self.mlp_0.dense_0
        pre = dense0(torch.cat([xyz, features], dim=-1))
        center = new_xyz @ dense0.weight[:, :3].T
        return new_xyz, pre, idx, center

    def forward(self, xyz: torch.Tensor, features: torch.Tensor,
                train: bool = False, bn_momentum: float = 0.9):
        """xyz (B, N, 3), features (B, N, C) -> (new_xyz (B, npoint, 3), or
        None for GroupAll, and features (B, npoint or 1, C_out))."""
        if self.npoint is None:
            grouped = torch.cat([xyz, features], dim=-1)[:, None]
            return None, self.mlp_0(grouped, train=train,
                                    bn_momentum=bn_momentum).amax(dim=2)
        new_xyz, pre, idx, center = self.group_inputs(xyz, features)
        m = self.mlp_0
        route = sa_route((xyz.shape[0], self.npoint, self.nsample,
                          self.mlp[0]), self.mlp, xyz.shape[1], m.bn)
        if route != "plain" and not m.bn:
            w1 = m.dense_1.weight.T.contiguous()
            w2 = m.dense_2.weight.T.contiguous()
        if route == "gather":
            return new_xyz, fused_gathered_mlp_pool(
                pre, idx, center, w1, m.dense_1.bias, w2, m.dense_2.bias)
        x = group_points(pre, idx) - center[:, :, None, :]
        if route == "slab" and m.bn:
            return new_xyz, self._bn_slab(x, train, bn_momentum)
        if route == "slab":
            return new_xyz, fused_mlp_pool(x, w1, m.dense_1.bias, w2,
                                           m.dense_2.bias)
        return new_xyz, m(None, pre0=x, train=train,
                          bn_momentum=bn_momentum).amax(dim=2)

    def _bn_slab(self, x, train, bn_momentum):
        """The slab route with BatchNorm (``fused_bn_mlp_pool``) on the
        grouped slab x: at eval with the running statistics; in training
        with the batch's, which then update the running ones as
        ``BatchNorm.forward`` updates them. The weights go in as views of
        the Dense kernels, so that the CPU's plain version multiplies as
        ``nn.Linear`` does."""
        m = self.mlp_0
        bns = [getattr(m, f"bn_{i}") for i in range(3)]
        args = (x, m.dense_1.weight.T, m.dense_2.weight.T,
                [bn.scale for bn in bns], [bn.bias for bn in bns])
        if not train:
            return fused_bn_mlp_pool(*args, [(bn.mean, bn.var) for bn in bns],
                                     bns[0].eps)
        out, (means, vars_) = fused_bn_mlp_pool(*args, None, bns[0].eps)
        with torch.no_grad():
            for bn, mean, var in zip(bns, means, vars_):
                bn.mean.copy_(bn_momentum * bn.mean + (1 - bn_momentum) * mean)
                bn.var.copy_(bn_momentum * bn.var + (1 - bn_momentum) * var)
        return out


class PointnetFPModule(nn.Module):
    """Feature propagation from the FPS 3-NN cache: inverse-distance
    interpolation, skip concat, shared MLP (reference:
    pointnet2_modules.py:122-160)."""

    def __init__(self, in_channels: int, mlp: Sequence[int], bn: bool = True,
                 device=None):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp, bn=bn, device=device)

    def forward(self, unknown_feats: torch.Tensor | None,
                known_feats: torch.Tensor, cached_nn, train: bool = False,
                bn_momentum: float = 0.9) -> torch.Tensor:
        d2, idx = cached_nn
        # the weights are constants of the coordinates, as in tpu3d
        # (pointnet2.py:504): no gradient flows into them
        weight = interpolation_weights(
            torch.sqrt(torch.clamp(d2, min=0.0))).detach()
        x = three_interpolate(known_feats, idx, weight)
        if unknown_feats is not None:
            x = torch.cat([x, unknown_feats], dim=-1)
        return self.mlp(x, train=train, bn_momentum=bn_momentum)


class Pointnet2MSG(nn.Module):
    """The RPN backbone: MSG set-abstraction encoders and FP decoders from
    cfg.RPN.SA_CONFIG / FP_MLPS (reference: lib/net/pointnet2_msg.py)."""

    def __init__(self, npoints, radii, nsamples, sa_mlps, fp_mlps,
                 input_channels: int = 0, bn: bool = True, device=None):
        super().__init__()
        self.npoints = tuple(int(n) for n in npoints)
        level_c = [input_channels]  # channels of l_features[k]
        for k in range(len(self.npoints)):
            self.add_module(f"sa_{k}", PointnetSAModuleMSG(
                radii[k], nsamples[k], sa_mlps[k], level_c[k], bn=bn,
                device=device))
            level_c.append(sum(m[-1] for m in sa_mlps[k]))
        self.n_fp = len(fp_mlps)
        for i in range(self.n_fp - 1, -1, -1):
            known_c = (fp_mlps[i + 1][-1] if i + 1 < self.n_fp
                       else level_c[i + 1])
            self.add_module(f"fp_{i}", PointnetFPModule(
                known_c + level_c[i], fp_mlps[i], bn=bn, device=device))

    def forward(self, pts_input: torch.Tensor, train: bool = False,
                bn_momentum: float = 0.9):
        """(B, N, 3 + C) -> (xyz (B, N, 3), features (B, N, C_fp0))."""
        xyz = pts_input[..., 0:3].contiguous()
        features = (pts_input[..., 3:].contiguous()
                    if pts_input.shape[-1] > 3 else None)
        l_xyz, l_features, cached_nn = [xyz], [features], []
        for k, npoint in enumerate(self.npoints):
            # FPS and, riding along, each point's 3 nearest picks: the
            # three_nn of FP level k
            fps_idx, nn_d2, nn_idx = furthest_point_sample_with_3nn(
                l_xyz[k], npoint)
            new_xyz = gather_points(l_xyz[k], fps_idx)
            cached_nn.append((nn_d2, nn_idx))
            l_features.append(getattr(self, f"sa_{k}")(
                l_xyz[k], l_features[k], new_xyz, train, bn_momentum))
            l_xyz.append(new_xyz)
        for i in range(self.n_fp - 1, -1, -1):
            l_features[i] = getattr(self, f"fp_{i}")(
                l_features[i], l_features[i + 1], cached_nn[i], train,
                bn_momentum)
        return l_xyz[0], l_features[0]
