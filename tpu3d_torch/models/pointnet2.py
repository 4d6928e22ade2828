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

Every forward takes a ``precision.Precision``, the numerics contract its
entry point resolved for an eval or a train step (f32 by default). Under
the accelerator's contract it rounds where tpu3d's TPU path rounds
(``tpu3d/models/pointnet2.py``):
the scene-frame pre-grouped levels cast their grouped pre-activations to
bf16 after the per-center subtraction (``:380-383``), the canonical RCNN
levels round the per-point pre-activations before the gather
(``:348-352``, ``gather_spec`` ``:389-411``) and their fused routes take
the bf16 kernels (whose layer boundaries round to bf16 and whose output is
bf16), and feature propagation casts its source features to bf16
(``:505-513``). A Dense with a compute dtype (``BF16_INFERENCE``) runs in
bf16 and BatchNorm's folded affine applies in the activation's dtype
(``:90-99``). A bf16 activation into an f32 layer computes in f32, as
flax promotes it. In training (``first_f32``, ``:321-323``) the
scene-frame pre-grouped layer 0 computes in the promoted dtype on inputs
in the features' dtype, so bf16 features round the coordinates first;
BatchNorm takes its batch statistics of a bf16 input in f32 and casts its
output back (``:101-110``); the gathers' backward takes tpu3d's routes
(``ops/grouping.py::gp_route``) and the fused levels their training
forms. Under the f32 contract every step is the f32 one.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import torch
from torch import nn

from ..ops import (ball_query, ball_query_from_nearest,
                   furthest_point_sample, furthest_point_sample_with_3nn,
                   fused_bn_mlp_pool, fused_gathered_mlp_pool, fused_mlp_pool,
                   gather_points, group_points, interpolation_weights,
                   nearest_k, sa_route, three_interpolate)
from ..ops.fused_sa import (fused_bn_mlp_pool_bf16,
                            fused_bn_mlp_pool_bf16_train,
                            fused_gathered_mlp_pool_bf16, fused_mlp_pool_bf16)
from ..ops.grouping import gp_route
from ..ops.interpolate import rounds_weights, three_interpolate_bf16
from ..parallel.mesh import batch_means
from ..precision import F32, Precision, linear, promote_f32


_frozen = threading.local()


@contextlib.contextmanager
def running_stats_frozen():
    """Within it, BatchNorm in training leaves its running statistics as
    they are (on this thread). The backward's recomputation of a
    rematerialised forward (``TRAIN.REMAT``) runs under it, so that the
    statistics take one update a step, in the step's first forward, as
    tpu3d's ``nn.remat`` backbone takes them."""
    before = getattr(_frozen, "on", False)
    _frozen.on = True
    try:
        yield
    finally:
        _frozen.on = before


def fold_running(bn, mean, var, momentum):
    """bn's running statistics m·running + (1 − m)·batch, unless they are
    frozen (``running_stats_frozen``)."""
    if getattr(_frozen, "on", False):
        return
    with torch.no_grad():
        bn.mean.copy_(momentum * bn.mean + (1 - momentum) * mean)
        bn.var.copy_(momentum * bn.var + (1 - momentum) * var)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis (tpu3d's ``BatchNorm``).

    At eval, from the running statistics, folded into one per-channel
    affine as in the JAX package: x·(scale/√(var+ε)) + (bias −
    mean·scale/√(var+ε)). In training, from the batch's statistics over
    every other axis, with the biased variance E[x²] − mean², and the
    running statistics updated in place (``fold_running``, not under
    ``running_stats_frozen``) to m·running + (1 − m)·batch, where
    ``momentum`` m follows flax's convention (PyTorch's momentum is 1 − m)
    and the running variance takes the biased batch variance, as tpu3d's
    does (``torch.nn.BatchNorm`` would take the unbiased one). Under a
    data-parallel mesh (``parallel.mesh.use_mesh``) the statistics are the
    global batch's: the sums of every rank over the count of every rank's
    rows, as tpu3d's sharded step takes them, so the running statistics
    agree on every rank. A bf16 input is promoted to f32 for the
    statistics and the normalisation, and the output cast back to bf16, as
    tpu3d's BatchNorm does in bf16 training."""

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
            # applied in the activation's dtype (bf16 under BF16_INFERENCE
            # or after the accelerator's casts), as tpu3d folds it
            mul, add = self.affine()
            return x * mul.to(x.dtype) + add.to(x.dtype)
        axes = tuple(range(x.dim() - 1))
        xf = promote_f32(x)
        mean, sq = batch_means((xf, xf * xf), axes)
        var = sq - mean * mean
        fold_running(self, mean, var, momentum)
        inv = torch.rsqrt(var + self.eps)
        return (((xf - mean) * inv) * self.scale + self.bias).to(x.dtype)


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
                bn_momentum: float = 0.9,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        """``pre0``, when given, is layer 0's pre-activation, computed by
        the caller with ``dense_0`` (``x`` is then ignored). ``dtype``: the
        Dense layers' compute dtype (``precision.linear``)."""
        for i in range(self.n):
            if i == 0 and pre0 is not None:
                x = pre0
            else:
                dense = getattr(self, f"dense_{i}")
                x = linear(x, dense.weight, dense.bias, dtype)
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
                bn_momentum: float = 0.9,
                precision: Precision = F32) -> torch.Tensor:
        """xyz (B, N, 3), features (B, N, C) or None, new_xyz (B, npoint, 3)
        -> (B, npoint, ΣC_out)."""
        B, N, _ = xyz.shape
        dt = precision.dense_dtype
        lowp = precision.sa_bf16 or dt is not None
        # layer 0's compute dtype: in training the scene frame keeps it in
        # the promoted dtype whatever dt says (tpu3d's first_f32)
        dt0 = None if precision.first_f32 else dt
        if features is None:
            # the candidates' coordinates come with them, for every scale
            d2, cand, cand_xyz = nearest_k(new_xyz, xyz, max(self.nsamples),
                                           max_radius=max(self.radii),
                                           with_coords=True)
        else:
            d2, cand = nearest_k(new_xyz, xyz, max(self.nsamples),
                                 max_radius=max(self.radii))
            # layer 0's input dtype (tpu3d's cdt): bf16 features round the
            # coordinates too
            cdt = dt0 or features.dtype
            inp = torch.cat([xyz.to(cdt), features.to(cdt)], dim=-1)
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
                out = mlp(grouped, train=train, bn_momentum=bn_momentum,
                          dtype=dt)
            else:
                idx = ball_query_from_nearest(d2, cand, radius, nsample, N)
                dense0 = mlp.dense_0
                if lowp:
                    # the gather's backward: tpu3d's precise route, bf16
                    # where its bf16 training allows it (wide tables)
                    route = gp_route(N, dense0.out_features,
                                     idx.shape[1] * nsample, True,
                                     not precision.sa_bf16, precision.sa_bf16)
                    x = _pregroup_lowp(inp, new_xyz.to(cdt), idx, dense0,
                                       dt0, precision.sa_bf16,
                                       route == "gather_mxu_bwd")
                else:
                    # a layer-0 bias (no-BN MLPs) rides the gathered term
                    # once; the center term W_x@c carries none
                    x = group_points(dense0(inp), idx)
                    x = x - (new_xyz @ dense0.weight[:, :3].T)[:, :, None, :]
                out = mlp(None, pre0=x, train=train, bn_momentum=bn_momentum,
                          dtype=dt)
            outs.append(out.amax(dim=2))
        return torch.cat(outs, dim=-1)


def _layer0_terms(inp, center_xyz, dense0, dt):
    """The pre-grouped layer 0's two terms in tpu3d's arithmetic (``pre0``,
    ``gather_spec``), each in the Dense dtype ``dt``: the per-point
    pre-activations Dense(inp) and the per-center Dense([c, 0]), the bias
    in both -> (pre, center)."""
    return (linear(inp, dense0.weight, dense0.bias, dt),
            linear(center_xyz, dense0.weight[:, :3], dense0.bias, dt))


def _pregroup_lowp(inp, center_xyz, idx, dense0, dt, cast, bf16_bwd=False):
    """A scene-frame pre-grouped layer 0 in tpu3d's arithmetic (``pre0``):
    pre gathered exactly, minus its center term, plus the bias back, then,
    with ``cast``, rounded to bf16 after the cancellation. ``bf16_bwd``:
    the gather's backward takes the bf16 form (tpu3d's
    ``gather_mxu_bwd``)."""
    pre, center = _layer0_terms(inp, center_xyz, dense0, dt)
    x = group_points(pre, idx, bf16_bwd) - center[:, :, None, :].to(
        pre.dtype)
    if dense0.bias is not None:
        x = x + dense0.bias.to(x.dtype)
    if cast and x.dtype == torch.float32:
        x = x.to(torch.bfloat16)
    return x


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

    def group_inputs_lowp(self, xyz: torch.Tensor, features: torch.Tensor,
                          dt: torch.dtype | None):
        """``group_inputs`` in tpu3d's arithmetic (``pre0`` /
        ``gather_spec``): layer 0 in the Dense dtype ``dt`` on inputs cast
        to tpu3d's cdt (``dt``, else the features' dtype, so bf16 SA
        features round the coordinates too), its center term with the bias
        (W_x@c + b), and the bias alone -> (new_xyz, pre, idx, center,
        bias or None)."""
        new_xyz = gather_points(xyz, furthest_point_sample(xyz, self.npoint))
        idx = ball_query(new_xyz, xyz, self.radius, self.nsample)
        dense0 = self.mlp_0.dense_0
        cdt = dt or features.dtype
        pre, center = _layer0_terms(
            torch.cat([xyz.to(cdt), features.to(cdt)], dim=-1),
            new_xyz.to(cdt), dense0, dt)
        bias = None if dense0.bias is None else dense0.bias.to(pre.dtype)
        return new_xyz, pre, idx, center, bias

    def forward(self, xyz: torch.Tensor, features: torch.Tensor,
                train: bool = False, bn_momentum: float = 0.9,
                precision: Precision = F32):
        """xyz (B, N, 3), features (B, N, C) -> (new_xyz (B, npoint, 3), or
        None for GroupAll, and features (B, npoint or 1, C_out))."""
        dt = precision.dense_dtype
        if self.npoint is None:
            common = torch.promote_types(xyz.dtype, features.dtype)
            grouped = torch.cat([xyz.to(common), features.to(common)],
                                dim=-1)[:, None]
            return None, self.mlp_0(grouped, train=train,
                                    bn_momentum=bn_momentum,
                                    dtype=dt).amax(dim=2)
        m = self.mlp_0
        route = sa_route((xyz.shape[0], self.npoint, self.nsample,
                          self.mlp[0]), self.mlp, xyz.shape[1], m.bn)
        if precision.sa_bf16 or dt is not None:
            return self._forward_lowp(xyz, features, route, precision, train,
                                      bn_momentum)
        new_xyz, pre, idx, center = self.group_inputs(xyz, features)
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

    def _forward_lowp(self, xyz, features, route, precision, train=False,
                      bn_momentum=0.9):
        """The forward under a bf16 contract, in tpu3d's arithmetic: with
        ``sa_bf16`` the per-point pre-activations rounded to bf16 before the
        gather (whose backward is then the bf16 form) and the fused routes
        on the bf16 kernels, in training their training forms (tpu3d fuses
        only where it casts); otherwise (bf16 Dense alone) the plain route
        with bf16 Dense layers."""
        dt = precision.dense_dtype
        new_xyz, pre, idx, center, bias = self.group_inputs_lowp(
            xyz, features, dt)
        m = self.mlp_0
        fused = precision.sa_bf16 and route != "plain"
        if fused and route == "gather":
            # the kernel subtracts the center term less the restored bias
            if bias is not None:
                center = center - bias
            return new_xyz, fused_gathered_mlp_pool_bf16(
                pre.to(torch.bfloat16), idx, center.to(torch.bfloat16),
                m.dense_1.weight.T, m.dense_1.bias, m.dense_2.weight.T,
                m.dense_2.bias)
        if precision.sa_bf16:
            pre = pre.to(torch.bfloat16)
        x = group_points(pre, idx) - center[:, :, None, :].to(pre.dtype)
        if bias is not None:
            x = x + bias.to(x.dtype)
        if fused and m.bn:
            bns = [getattr(m, f"bn_{i}") for i in range(3)]
            args = (x, m.dense_1.weight.T, m.dense_2.weight.T,
                    [bn.scale for bn in bns], [bn.bias for bn in bns])
            if not train:
                return new_xyz, fused_bn_mlp_pool_bf16(
                    *args, [(bn.mean, bn.var) for bn in bns], bns[0].eps)
            out, stats = fused_bn_mlp_pool_bf16_train(*args, bns[0].eps)
            self._update_stats(bns, stats, bn_momentum)
            return new_xyz, out
        if fused:
            return new_xyz, fused_mlp_pool_bf16(
                x, m.dense_1.weight.T, m.dense_1.bias, m.dense_2.weight.T,
                m.dense_2.bias)
        return new_xyz, m(None, pre0=x, train=train, bn_momentum=bn_momentum,
                          dtype=dt).amax(dim=2)

    @staticmethod
    def _update_stats(bns, stats, bn_momentum):
        """Fold a fused op's batch statistics into the running ones, as
        ``BatchNorm.forward`` folds its own."""
        for bn, mean, var in zip(bns, *stats):
            fold_running(bn, mean, var, bn_momentum)

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
        out, stats = fused_bn_mlp_pool(*args, None, bns[0].eps)
        self._update_stats(bns, stats, bn_momentum)
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
                bn_momentum: float = 0.9,
                precision: Precision = F32) -> torch.Tensor:
        d2, idx = cached_nn
        # the weights are constants of the coordinates, as in tpu3d
        # (pointnet2.py:504): no gradient flows into them
        weight = interpolation_weights(
            torch.sqrt(torch.clamp(d2, min=0.0))).detach()
        if precision.fp_bf16 and known_feats.dtype == torch.float32:
            known_feats = known_feats.to(torch.bfloat16)
        if known_feats.dtype == torch.bfloat16:
            # tpu3d's TPU routes round the weights too; its gather route
            # (and the CPU) keeps them f32 and writes f32
            B, N, C = known_feats.shape
            x = three_interpolate_bf16(
                known_feats, idx, weight,
                precision.accel and rounds_weights(N, C, idx.shape[1]))
        else:
            x = three_interpolate(known_feats, idx, weight)
        if unknown_feats is not None:
            common = torch.promote_types(x.dtype, unknown_feats.dtype)
            x = torch.cat([x.to(common), unknown_feats.to(common)], dim=-1)
        return self.mlp(x, train=train, bn_momentum=bn_momentum,
                        dtype=precision.dense_dtype)


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
                bn_momentum: float = 0.9, precision: Precision = F32):
        """(B, N, 3 + C) -> (xyz (B, N, 3), features (B, N, C_fp0)), the
        features promoted to f32 where the contract left them bf16."""
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
                l_xyz[k], l_features[k], new_xyz, train, bn_momentum,
                precision))
            l_xyz.append(new_xyz)
        for i in range(self.n_fp - 1, -1, -1):
            l_features[i] = getattr(self, f"fp_{i}")(
                l_features[i], l_features[i + 1], cached_nn[i], train,
                bn_momentum, precision)
        return l_xyz[0], promote_f32(l_features[0])
