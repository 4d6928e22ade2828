"""The training numerics contract (``tpu3d_torch/precision.py``) against
tpu3d's on the CPU: how the contract resolves, the gathers' route
predicate, the bf16 training forms of kernels 6, 7 and 8 and of the
grouping's backward, the proposal target's hi/lo pooled block, and the RPN
and the RCNN stage in training.

Inputs are seeded numpy arrays; network weights are drawn with numpy for
the flax tree and carried over with ``params_from_jax``. tpu3d decides its
bf16 Dense layers and its hi/lo table on ``jax.default_backend() ==
"tpu"`` (``models/rpn.py:75``, ``models/rcnn.py:41``,
``models/proposal_target.py:282``): the network tests replace the ``jax``
name in those three modules with a proxy whose ``default_backend()`` says
"tpu", and set ``TPU3D_FORCE_FUSED_SA=1`` for pointnet2's casts and fused
kernels (interpret mode); ``tpu3d/ops`` stays on the CPU, and so do its
interpolation and gathers, so the port's side runs its FP without the
accelerator's weight rounding (``Precision.accel`` off). tpu3d's side is
compiled with XLA's excess precision off (``_exact``): on the CPU XLA
otherwise keeps some bf16 results in f32 where the TPU rounds them.
Tolerances, each with its reason:

- each bf16 plain version against tpu3d's own VJP (``jax.vjp`` of the
  Pallas kernels in interpret mode, or of the one-hot and gather routes):
  outputs and bf16 gradients at the bf16 grade (within 1e-2 of the largest
  value, and equal in all but one value in a hundred: products of bf16
  operands are exact in f32, so the two differ only where an f32 sum in
  another order rounds to the other bf16 neighbour, and a forward value that
  moves by one bf16 step can move the first argmax of a group, rerouting
  that channel's gradient); f32 gradients (the weights', the biases', the
  wide gather's) within 1e-2 of their largest value (1e-6 for the gather:
  the same f32 sums in another order);
- the hi/lo pooled block: its bf16 features, labels and flags equal (one
  gather of the same table), its canonical points within 1e-5 m (the same
  rotation in another order);
- each RPN level in training (train-mode BatchNorm of bf16 activations,
  bf16 Dense layers, the scene-frame layer 0 in f32 on bf16 coordinates)
  fed tpu3d's inputs: output within 3e-3 RMS, gradients within 1.5e-2 RMS
  on average and 5e-2 each (a bf16 rounding that the two packages' f32
  sums put on the other side of a tie moves one value by a bf16 step, and
  the batch statistics spread it), the port's f32 path at least four times
  further: the rounding points are tpu3d's;
- the whole RPN in training: the loss within 1e-2, outputs within 5e-2
  RMS, gradients within 0.5 RMS on average, the f32 path 1.5 times further
  in the outputs and further in the gradients: through eight levels of
  train-mode BatchNorm on small batches each such flipped rounding moves
  the statistics of every later level, so the whole network holds the
  rounding points far more loosely than one level does;
- the RCNN stage in training (no BatchNorm; SA_0 on the gather route,
  SA_1 on the slab route, the GroupAll plain, bf16 Dense layers, f32
  heads): outputs within 1e-5 RMS, gradients within 5e-3 RMS on average
  and 2e-2 each, the f32 path at least ten times further.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from test_torch_rpn import _numpy_variables, _port_cfg
from tpu3d.config.config import cfg_from_file as jax_cfg_from_file
from tpu3d.config.config import fresh_cfg as jax_fresh_cfg
from tpu3d.models import PointRCNN as JaxPointRCNN
from tpu3d.models import proposal_target as jax_pt
from tpu3d.models import rcnn as jax_rcnn
from tpu3d.models import rpn as jax_rpn
from tpu3d.models.rcnn import RCNNNet as JaxRCNNNet
from tpu3d.ops import fused_sa as jax_fused_sa
from tpu3d.ops import grouping as jax_grouping
from tpu3d.ops import interpolate as jax_interpolate
from tpu3d_torch import precision
from tpu3d_torch.config import fresh_cfg
from tpu3d_torch.models import PointRCNN
from tpu3d_torch.models import proposal_target as pt
from tpu3d_torch.ops import (furthest_point_sample_with_3nn, fused_sa,
                            gather_points, grouping, interpolate)
from tpu3d_torch.precision import F32, Precision
from tpu3d_torch.weights import params_from_jax, params_to_jax

T = torch.from_numpy
BF16 = torch.bfloat16
# the card's training contract as tpu3d's CPU computes it under the patch:
# its interpolation on the CPU (no weight rounding, fp_bf16 off)
TPU_TRAIN = Precision(sa_bf16=True, roi_bf16=True, dense_dtype=BF16,
                      first_f32=True)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_close(got, want, flips=1e-2):
    """Within 1e-2 of the largest value, and equal in all but ``flips`` of
    the values."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want)
    scale = max(np.abs(want).max(), 1e-30)
    assert err.max() <= 1e-2 * scale, (err.max(), scale)
    assert (err > 0).mean() <= flips, (err > 0).mean()


def _near(got, want, tol):
    got, want = _f32(got), _f32(want)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, (err, scale)
    return err / scale


# ---------------------------------------------------------------- resolve


def test_precision_resolves_the_training_contract(monkeypatch):
    """``resolve(train=True)`` reads the two keys independently, on the card
    only: BF16_ACTIVATIONS the SA, FP and ROI casts; BF16_MATMULS bf16 Dense
    layers but for the heads and the scene-frame layer 0; BF16_INFERENCE
    unread (but by a fixed RPN's eval contract); both False is f32; the CPU
    is f32 whatever the keys; TRAIN.REMAT raises. From a device's name
    alone: nothing is allocated."""
    monkeypatch.delenv("TPU3D_F32_EVAL", raising=False)
    eval_accel = Precision(sa_bf16=True, fp_bf16=True, roi_bf16=True,
                           accel=True)
    for act in (True, False):
        for mat in (True, False):
            cfg = fresh_cfg()
            cfg.TRAIN.BF16_ACTIVATIONS = act
            cfg.TRAIN.BF16_MATMULS = mat
            cfg.BF16_INFERENCE = True  # not read in training
            got = precision.resolve("cuda", cfg, train=True)
            dense = BF16 if mat else None
            assert got == Precision(
                sa_bf16=act, fp_bf16=act, roi_bf16=act, dense_dtype=dense,
                head_dtype=None, first_f32=mat, accel=act or mat,
                fixed_rpn=precision.resolve("cuda", cfg)), (act, mat)
            assert precision.resolve(torch.device("cpu"), cfg,
                                     train=True) == Precision(
                fixed_rpn=precision.resolve("cpu", cfg))
            cfg.BF16_INFERENCE = False
            assert precision.resolve(torch.device("cpu"), cfg,
                                     train=True) == F32
    cfg = fresh_cfg()
    assert cfg.TRAIN.BF16_ACTIVATIONS and cfg.TRAIN.BF16_MATMULS
    assert precision.resolve("cuda:0", cfg, train=True).dense_dtype == BF16
    monkeypatch.setenv("TPU3D_F32_EVAL", "1")
    cfg.TRAIN.BF16_ACTIVATIONS = cfg.TRAIN.BF16_MATMULS = False
    assert precision.resolve("cuda", cfg, train=True) == F32
    assert precision.resolve("cuda", cfg) == F32 != eval_accel
    cfg.TRAIN.REMAT = True
    for device in ("cuda", "cpu"):
        with pytest.raises(NotImplementedError, match="TRAIN.REMAT"):
            precision.resolve(device, cfg, train=True)
    precision.resolve("cuda", cfg)  # eval does not read it


def test_make_train_step_resolves_once():
    """``make_train_step`` resolves the training contract for the model's
    device and config once and hands it to every forward."""
    from tpu3d_torch.parallel import make_train_step

    cfg = _port_cfg(_tiny_cfg(rcnn=True, points=1024))
    model = PointRCNN(cfg, mode="TRAIN", device="cpu")
    assert make_train_step(cfg, model).precision == F32
    step = make_train_step(cfg, model, precision=TPU_TRAIN)
    assert step.precision == TPU_TRAIN


# ------------------------------------------------------------- the gathers


def test_gp_route_matches_tpu3d():
    """``grouping.gp_route`` equals tpu3d's ``_gp_route("tpu", ...)`` over a
    grid of shapes and flags, and at default.yaml's pre-grouped RPN levels
    only SA_1's gathers (4096 points) take the bf16 backward in bf16
    training; SA_2-3 stay exact."""
    for n in (16, 128, 1024, 2048, 2049, 4096, 16384):
        for c in (3, 15, 16, 32, 128):
            for ms in (8, 12, 512, 4097):
                for precise in (False, True):
                    for exact in (False, True):
                        for bwd in (None, False, True):
                            assert grouping.gp_route(
                                n, c, ms, precise, exact, bwd) == \
                                jax_grouping._gp_route(
                                    "tpu", n, c, ms, precise, exact, bwd), (
                                    n, c, ms, precise, exact, bwd)
    cfg = jax_cfg_from_file("configs/default.yaml", jax_fresh_cfg())
    sa = cfg.RPN.SA_CONFIG
    n = [cfg.RPN.NUM_POINTS] + list(sa.NPOINTS)
    routes = {(k, j): grouping.gp_route(n[k], mlp[0], sa.NPOINTS[k]
                                        * sa.NSAMPLE[k][j], True, False, True)
              for k in (1, 2, 3) for j, mlp in enumerate(sa.MLPS[k])}
    assert routes == {(1, 0): "gather_mxu_bwd", (1, 1): "gather_mxu_bwd",
                      (2, 0): "onehot_exact", (2, 1): "onehot_exact",
                      (3, 0): "onehot_exact", (3, 1): "onehot_exact"}


def _exact(fn, *args):
    """``fn(*args)`` jitted with XLA's excess precision off: on the CPU XLA
    otherwise keeps some bf16 results in f32 between operations, where
    tpu3d's TPU rounds them (a bf16 add, a bf16 Dense output read back in
    f32)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _vjp(fn, args, g):
    """(fn(*args), its VJP at g), by ``jax.vjp``, without excess
    precision."""
    def both(args, g):
        out, pull = jax.vjp(fn, *args)
        return out, pull(g)

    return jax.device_get(_exact(both, args, g))


def test_gather_mxu_backward_matches_tpu3d():
    """The wide-table route (tpu3d's ``_group_points_gather_mxu_vjp``): an
    exact gather forward and the bf16 backward (bf16(g) summed in f32, out
    in the features' f32), with repeated ids, against ``jax.vjp``."""
    rng = np.random.default_rng(31)
    B, N, M, S, C = 2, 2304, 64, 16, 32
    f = rng.normal(size=(B, N, C)).astype(np.float32)
    idx = rng.integers(0, N // 8, size=(B, M, S)).astype(np.int32)
    g = rng.normal(size=(B, M, S, C)).astype(np.float32)
    want, (wd, _) = _vjp(jax_grouping._group_points_gather_mxu_vjp,
                         (f, idx), g)
    ft = T(f).requires_grad_()
    got = grouping.group_points(ft, T(idx), bf16_bwd=True)
    got.backward(T(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert ft.grad.dtype == torch.float32 and str(wd.dtype) == "float32"
    _near(ft.grad.numpy(), wd, 1e-6)
    assert grouping.gp_route(N, C, M * S, True, False) == "gather_mxu_bwd"


def test_onehot_bf16_gather_matches_tpu3d():
    """The canonical small-table route (tpu3d's ``_group_points_onehot``):
    bf16 features gathered exactly, and a bf16 d_features (the bf16
    gradient summed in f32), against ``jax.vjp``."""
    rng = np.random.default_rng(32)
    B, N, M, S, C = 2, 32, 16, 16, 128
    f = rng.normal(size=(B, N, C)).astype(np.float32)
    idx = rng.integers(0, N, size=(B, M, S)).astype(np.int32)
    g = rng.normal(size=(B, M, S, C)).astype(np.float32)
    fb, gb = jnp.asarray(f).astype(jnp.bfloat16), jnp.asarray(g).astype(
        jnp.bfloat16)
    want, (wd, _) = _vjp(jax_grouping._group_points_onehot, (fb, idx), gb)
    ft = T(f).to(BF16).requires_grad_()
    got = grouping.group_points(ft, T(idx))
    got.backward(T(g).to(BF16))
    assert got.dtype == BF16 and ft.grad.dtype == BF16
    np.testing.assert_array_equal(got.detach().float().numpy(), _f32(want))
    _bf16_close(ft.grad.float().numpy(), wd)
    assert grouping.gp_route(N, C, M * S, False, False) == "onehot_bf16"


# ------------------------------------------------------------ kernel 7 bf16


@pytest.mark.parametrize("route", ["onehot", "pallas", "gather_mxu"])
def test_three_interpolate_bf16_backward_matches_tpu3d(route):
    """Kernel 7's bf16 form (bf16(w)·bf16(g) summed in f32, bf16 out) and
    kernel 3's bf16 forward through ``three_interpolate_bf16``'s autograd
    Function, against ``jax.vjp`` of tpu3d's accelerator routes: the one-hot
    route's autodiff (N <= 1024), the Pallas kernels in interpret mode (a
    wide table), and the gather route's MXU backward."""
    rng = np.random.default_rng({"onehot": 41, "pallas": 42,
                                 "gather_mxu": 43}[route])
    B, N, M, C = {"onehot": (2, 256, 512, 64), "pallas": (2, 1152, 256, 128),
                  "gather_mxu": (2, 1152, 256, 24)}[route]
    f = rng.normal(size=(B, N, C)).astype(np.float32)
    idx = rng.integers(0, N, size=(B, M, 3)).astype(np.int32)
    idx[:, :8] = 5  # a source many rows share, and repeated ids in a row
    w = rng.random((B, M, 3)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    round_w = route != "gather_mxu"
    g = rng.normal(size=(B, M, C)).astype(np.float32)
    fb = jnp.asarray(f).astype(jnp.bfloat16)
    gj = jnp.asarray(g).astype(jnp.bfloat16) if round_w else g
    fn = {"onehot": jax_interpolate._three_interpolate_onehot,
          "pallas": lambda a, i, v: jax_interpolate._three_interpolate_pallas(
              a, i, v, True),
          "gather_mxu": jax_interpolate._three_interpolate_gather_mxu_vjp
          }[route]
    want, (wd, _, _) = _vjp(fn, (fb, idx, w), gj)
    ft = T(f).to(BF16).requires_grad_()
    got = interpolate.three_interpolate_bf16(ft, T(idx), T(w), round_w)
    got.backward(T(g).to(got.dtype))
    assert ft.grad.dtype == BF16 and str(wd.dtype) == "bfloat16"
    if round_w:
        _bf16_close(got.detach().float().numpy(), want)
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    _bf16_close(ft.grad.float().numpy(), wd)
    with pytest.raises(NotImplementedError, match="weights"):
        wt = T(w).requires_grad_()
        interpolate.three_interpolate_bf16(T(f).to(BF16), T(idx), wt,
                                           round_w).sum().backward()


# ------------------------------------------------------- kernels 6 and 8 bf16


# (R, M, S, N, C1, C2, C3): default.yaml's RCNN SA_0 (128 -> 128 -> 128,
# S 64) and SA_1 (128 -> 256), smoke's S 16, at small R and M
TRAIN_SHAPES = [(2, 8, 64, 128, 128, 128, 128), (2, 8, 16, 128, 128, 128,
                                                  256)]


def _weights(shape, seed):
    *_, C1, C2, C3 = shape
    rng = np.random.default_rng(seed)
    w1 = (rng.normal(size=(C1, C2)) / np.sqrt(C1)).astype(np.float32)
    w2 = (rng.normal(size=(C2, C3)) / np.sqrt(C2)).astype(np.float32)
    b1 = (0.1 * rng.normal(size=C2)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=C3)).astype(np.float32)
    return rng, w1, b1, w2, b2


def _torch_leaves(*arrays, dtypes):
    return [T(a).to(d).requires_grad_() for a, d in zip(arrays, dtypes)]


def _grads_close(got, want):
    for a, b in zip(got, want):
        b = np.asarray(b)
        if str(b.dtype) == "bfloat16":
            assert a.dtype == BF16
            _bf16_close(a.float().numpy(), b)
        else:
            assert a.dtype == torch.float32
            _near(a.numpy(), b, 1e-2)


@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=str)
def test_fused_gather_bf16_train_matches_tpu3d(shape):
    """Kernel 6's bf16 training form, plain: the forward (pooled bf16 out,
    first argmax, ppre) and, by autograd, d_pre and d_center (bf16) and the
    weights' and biases' f32 gradients, against ``jax.vjp`` of tpu3d's
    ``_fused_nobn2`` (``_nobn2_fwd_kernel`` / ``_nobn2_bwd_kernel`` in
    interpret mode); and the routed plain backward, given tpu3d's argmax
    and ppre, against its VJP."""
    R, M, S, N, C1, C2, C3 = shape
    rng, w1, b1, w2, b2 = _weights(shape, 51)
    pre = rng.normal(size=(R, N, C1)).astype(np.float32)
    idx = rng.integers(0, N, size=(R, M, S)).astype(np.int32)
    center = (0.5 * rng.normal(size=(R, M, C1))).astype(np.float32)
    g = rng.normal(size=(R, M, C3)).astype(np.float32)
    pb = jnp.asarray(pre).astype(jnp.bfloat16)
    cb = jnp.asarray(center).astype(jnp.bfloat16)
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    flat = idx.reshape(R, M * S)
    want, (d_pre, d_c, (dw1, db1, dw2, db2)) = _vjp(
        lambda p, c, wb: jax_fused_sa._fused_nobn2(p, flat, c, wb, S, True),
        (pb, cb, (w1, b1, w2, b2)), gb)
    _, arg, ppre = _exact(lambda p, c: jax_fused_sa._fused_nobn2_fwd_impl(
        p, flat, c, (w1, b1, w2, b2), S, True), pb, cb)
    leaves = _torch_leaves(pre, center, w1, b1, w2, b2,
                           dtypes=(BF16, BF16) + (torch.float32,) * 4)
    out, targ, tppre = fused_sa.fused_gathered_mlp_pool_bf16_train_plain(
        leaves[0], T(idx), *leaves[1:])
    assert out.dtype == BF16
    _bf16_close(out.detach().float().numpy(), want)
    assert (targ.numpy() != np.asarray(arg)).mean() <= 1e-2
    _bf16_close(tppre.detach().numpy(), ppre)
    out.backward(T(g).to(BF16))
    _grads_close([t.grad for t in leaves], (d_pre, d_c, dw1, db1, dw2, db2))
    routed = fused_sa.fused_gathered_mlp_pool_bf16_backward_plain(
        T(pre).to(BF16), T(idx), T(center).to(BF16), T(w1), T(b1), T(w2),
        T(b2), T(g).to(BF16), T(np.array(arg)), T(np.array(ppre)))
    _grads_close(routed, (d_pre, d_c, dw1, db1, dw2, db2))
    # the public op trains through the same form on the CPU
    leaves = _torch_leaves(pre, center, w1, b1, w2, b2,
                           dtypes=(BF16, BF16) + (torch.float32,) * 4)
    op = fused_sa.fused_gathered_mlp_pool_bf16(leaves[0], T(idx),
                                               *leaves[1:])
    assert torch.equal(op, out.detach())


@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=str)
def test_fused_slab_bf16_train_matches_tpu3d(shape):
    """Kernel 8's bf16 training form, plain: the forward and, by autograd,
    d_x0 (bf16) and the weights' and biases' f32 gradients, against
    ``jax.vjp`` of tpu3d's ``_fused_nobn`` (``_nobn_fwd_kernel`` /
    ``_nobn_bwd_kernel`` in interpret mode); and the routed plain backward
    on tpu3d's argmax and ppre."""
    R, M, S, _, C1, C2, C3 = shape
    rng, w1, b1, w2, b2 = _weights(shape, 52)
    x0 = rng.normal(size=(R, M, S, C1)).astype(np.float32)
    g = rng.normal(size=(R, M, C3)).astype(np.float32)
    xb = jnp.asarray(x0).astype(jnp.bfloat16).reshape(R, M * S, C1)
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    want, (dx, (dw1, dw2), (db1, db2)) = _vjp(
        lambda x, w, b: jax_fused_sa._fused_nobn(x, w, b, S, True),
        (xb, (w1, w2), (b1, b2)), gb.reshape(R, M, C3))
    _, arg, ppre = _exact(lambda x: jax_fused_sa._fused_nobn_fwd_impl(
        x, (w1, w2), (b1, b2), S, True), xb)
    leaves = _torch_leaves(x0, w1, b1, w2, b2,
                           dtypes=(BF16,) + (torch.float32,) * 4)
    out, targ, _ = fused_sa.fused_mlp_pool_bf16_train_plain(*leaves)
    _bf16_close(out.detach().float().numpy(), want)
    assert (targ.numpy() != np.asarray(arg)).mean() <= 1e-2
    out.backward(T(g).to(BF16))
    dx = np.asarray(dx).reshape(R, M, S, C1)
    _grads_close([t.grad for t in leaves], (dx, dw1, db1, dw2, db2))
    routed = fused_sa.fused_mlp_pool_bf16_backward_plain(
        T(x0).to(BF16), T(w1), T(b1), T(w2), T(b2), T(g).to(BF16),
        T(np.array(arg)), T(np.array(ppre)))
    _grads_close(routed, (dx, dw1, db1, dw2, db2))


def test_bn_rcnn_bf16_training_raises_off_the_cpu():
    """Kernel 9's bf16 training form is the next slice's: a tensor off the
    CPU raises, naming it; the CPU runs its plain version (bf16 out, the
    three layers' f32 batch statistics, gradients for every input)."""
    rng = np.random.default_rng(53)
    x0 = T(rng.normal(size=(2, 4, 16, 128)).astype(np.float32)).to(BF16)
    w1 = T(rng.normal(size=(128, 128)).astype(np.float32) / 11)
    w2 = T(rng.normal(size=(128, 256)).astype(np.float32) / 11)
    gammas = [torch.ones(c) for c in (128, 128, 256)]
    betas = [torch.zeros(c) for c in (128, 128, 256)]
    with pytest.raises(NotImplementedError, match="kernel 9's bf16 training"):
        fused_sa.fused_bn_mlp_pool_bf16_train(x0.to("meta"), w1, w2, gammas,
                                              betas)
    leaves = [x0.requires_grad_(), w1.requires_grad_(), w2.requires_grad_()]
    out, (means, vars_) = fused_sa.fused_bn_mlp_pool_bf16_train(
        *leaves, gammas, betas)
    assert out.dtype == BF16 and out.shape == (2, 4, 256)
    assert [m.dtype for m in means + vars_] == [torch.float32] * 6
    out.float().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad.float()).all()
               for t in leaves)


# ------------------------------------------------------------- the networks


class _TPUBackend:
    """``jax`` as tpu3d's model modules see it on its accelerator: every
    name delegated, ``default_backend()`` "tpu"."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@contextlib.contextmanager
def _tpu_training():
    """tpu3d's training contract on the CPU: its RPN, RCNN and proposal
    target modules see a TPU backend; pointnet2's casts and fused kernels
    run in interpret mode (TPU3D_FORCE_FUSED_SA=1). tpu3d's ops stay on the
    CPU. Trace fresh inside."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_rpn, jax_rcnn, jax_pt):
            mp.setattr(mod, "jax", _TPUBackend())
        mp.setenv("TPU3D_FORCE_FUSED_SA", "1")
        mp.delenv("TPU3D_F32_EVAL", raising=False)
        yield


def _scenes(seed, B=2, n_pts=512, n_rois=24, n_gt=3):
    """Proposals around a few gt boxes per scene, points in and around
    them, per-point features."""
    rng = np.random.default_rng(seed)
    gts = np.zeros((B, n_gt + 1, 7), np.float32)  # one padding row
    rois = np.zeros((B, n_rois, 7), np.float32)
    pts = np.zeros((B, n_pts, 3), np.float32)
    for b in range(B):
        gts[b, :n_gt] = np.concatenate([
            rng.uniform([-15, 0.5, 10], [15, 1.5, 50], (n_gt, 3)),
            rng.uniform([1.4, 1.5, 3.5], [1.6, 1.8, 4.2], (n_gt, 3)),
            rng.uniform(-np.pi, np.pi, (n_gt, 1))], 1)
        for i in range(n_rois):
            g = gts[b, i % n_gt].copy()
            mag = [0.1, 0.4, 0.9, 2.5][i % 4]
            g[[0, 2]] += rng.normal(size=2) * mag
            g[6] += rng.normal() * 0.1
            rois[b, i] = g
        for i in range(n_pts // 2):
            g = gts[b, i % n_gt]
            pts[b, i] = g[0:3] + rng.uniform(-0.5, 0.5, 3) * g[[5, 3, 4]] * 0.8
            pts[b, i, 1] -= g[3] * 0.5
        pts[b, n_pts // 2:] = rng.uniform([-20, -1, 0], [20, 3, 60],
                                          (n_pts - n_pts // 2, 3))
    feats = rng.normal(size=(B, n_pts, 5)).astype(np.float32)
    return rois, gts, pts, feats


def test_proposal_target_hilo_block_matches_tpu3d(monkeypatch):
    """The proposal target's pooled block under ``roi_bf16`` (one gather of
    the bf16 hi/lo table, hi + lo in f32): on the rois tpu3d's layer sampled
    under its TPU training contract (jitter and augmentation off), the
    port's canonical points within 1e-5 m of tpu3d's, its bf16 features,
    labels and empty flags equal."""
    jcfg = jax_fresh_cfg()
    jcfg.RCNN.ROI_FG_AUG_TIMES = 0
    jcfg.RCNN.ROI_PER_IMAGE = 8
    jcfg.RCNN.NUM_POINTS = 64
    cfg = _port_cfg(jcfg)
    rois, gts, pts, feats = _scenes(61)
    valid = np.ones(rois.shape[:2], bool)
    with _tpu_training():
        want = jax.device_get(_exact(lambda k: jax_pt.proposal_target_layer(
            k, rois, valid, gts, pts, feats, jcfg, aug_data=False),
            jax.random.PRNGKey(4)))
    assert str(want["pts_feature"].dtype) == "bfloat16"
    R = jcfg.RCNN.ROI_PER_IMAGE
    picked = np.linalg.norm(want["roi_boxes3d"].reshape(2, R, 1, 7)
                            - rois[:, None], axis=-1)
    assert picked.min(-1).max() < 1e-6
    order = iter(T(picked.argmin(-1)))
    monkeypatch.setattr(pt, "sample_roi_indices",
                        lambda *a: (next(order), None))
    draws = pt.draw_proposal_target(torch.Generator().manual_seed(0), 2,
                                    rois.shape[1], cfg, False,
                                    torch.device("cpu"))
    got = pt.proposal_target_core(draws, T(rois), T(valid), T(gts), T(pts),
                                  T(feats), cfg, aug_data=False,
                                  roi_bf16=True)
    assert got["pts_feature"].dtype == BF16
    np.testing.assert_array_equal(got["pts_feature"].float().numpy(),
                                  _f32(want["pts_feature"]))
    assert (got["pts_feature"].float().abs().sum(-1) > 0).any()
    np.testing.assert_allclose(got["sampled_pts"].numpy(),
                               want["sampled_pts"], rtol=0, atol=1e-5)
    for key in ("cls_label", "reg_valid_mask"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])


def _rms(got, want):
    """RMS of got - want over RMS of want."""
    got, want = _f32(got), _f32(want)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _dense_scenes(B, N, seed):
    """Points filling a 10 m x 2 m x 10 m box: every ball of every level
    holds many distinct points, which keeps train-mode BatchNorm's batch
    statistics well conditioned."""
    rng = np.random.default_rng(seed)
    return rng.uniform([-5, -1, 10], [5, 1, 20], size=(B, N, 3)).astype(
        np.float32)


@pytest.fixture(scope="module")
def rpn_case():
    """tpu3d's RPN (``_tiny_cfg``, BatchNorm, no dropout) in training under
    its TPU contract on dense scenes: the loss of a fixed random linear
    read-out of its outputs, the outputs, every parameter's gradient and
    each level's inputs and outputs (``capture_intermediates``); and the
    port's model on the same weights."""
    jcfg = _tiny_cfg(rcnn=False, points=1024)
    jcfg.RCNN.ENABLED = False
    jcfg.RPN.DP_RATIO = 0.0
    pts = _dense_scenes(2, 1024, 63)
    jmodel = JaxPointRCNN(cfg=jcfg, mode="TRAIN")
    shapes = jax.eval_shape(lambda p: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, {"pts_input": p}, train=False),
        pts)
    rng = np.random.default_rng(63)
    params, stats = _numpy_variables(shapes, rng)
    keys = ("rpn_cls", "rpn_reg", "backbone_features")
    probe = {k: rng.normal(size=shapes_out).astype(np.float32) for k,
             shapes_out in (("rpn_cls", (2, 1024, 1)),
                            ("rpn_reg", (2, 1024, 76)))}

    def loss_fn(p):
        out, mut = jmodel.apply(
            {"params": p, "batch_stats": stats}, {"pts_input": pts},
            train=True, bn_momentum=0.8, mutable=["batch_stats",
                                                  "intermediates"],
            capture_intermediates=True)
        loss = sum(jnp.sum(out[k] * probe[k]) for k in probe)
        return loss, ({k: out[k] for k in keys},
                      mut["intermediates"]["rpn"]["backbone"])

    with _tpu_training():
        (jloss, (jout, levels)), jgrads = jax.device_get(_exact(
            jax.value_and_grad(loss_fn, has_aux=True), params))
    model = PointRCNN(_port_cfg(jcfg), mode="TRAIN", device="cpu")
    model.load_state_dict(params_from_jax(params, stats))
    return (model, jcfg, pts, params, stats, probe, float(jloss), jout,
            dict(_flat(jgrads)), levels)


def _port_run(model, state, pts, probe, prec):
    """The port's training forward of the RPN under ``prec`` from
    ``state``: (loss of the read-out, outputs, gradients by flax name)."""
    model.load_state_dict(state)
    for p in model.parameters():
        p.grad = None
    out = model({"pts_input": T(pts)}, train=True, bn_momentum=0.8,
                precision=prec)
    loss = sum((out[k] * T(v)).sum() for k, v in probe.items())
    loss.backward()
    grads = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    return (float(loss), {k: v.detach() for k, v in out.items()},
            dict(_flat(grads[0])))


def test_rpn_training_matches_tpu3d(rpn_case):
    """The whole RPN in training (train-mode BatchNorm over bf16
    activations, bf16 Dense layers, f32 heads, the scene-frame layer 0 in
    f32): the loss within 1e-2, each output within 5e-2 RMS of tpu3d's,
    the parameters' gradients within 0.5 RMS on average, and the port's
    f32 path further from tpu3d in the outputs (at least 1.5 times) and in
    the gradients. Through the whole network each bf16 rounding that the
    two packages' f32 sums put on the other side of a tie moves the
    batch statistics of the levels after it, so the per-level test below
    holds the rounding points more tightly."""
    model, _, pts, params, stats, probe, jloss, jout, jgrads, _ = rpn_case
    state = params_from_jax(params, stats)
    loss, out, grads = _port_run(model, state, pts, probe, TPU_TRAIN)
    loss32, out32, grads32 = _port_run(model, state, pts, probe, F32)
    assert out["rpn_cls"].dtype == torch.float32
    np.testing.assert_allclose(loss, jloss, rtol=1e-2)
    for k, v in jout.items():
        err, err32 = _rms(out[k], v), _rms(out32[k], v)
        assert err <= 5e-2 and err32 >= 1.5 * err, (k, err, err32)
    assert set(grads) == set(jgrads)
    err = np.mean([_rms(grads[k], v) for k, v in jgrads.items()])
    err32 = np.mean([_rms(grads32[k], v) for k, v in jgrads.items()])
    assert err <= 0.5 and err32 > err, (err, err32)


RPN_LEVELS = ["sa_0", "sa_1", "sa_2", "sa_3", "fp_3", "fp_2", "fp_1", "fp_0"]


@pytest.mark.parametrize("level", RPN_LEVELS)
def test_rpn_level_training_matches_tpu3d(rpn_case, level):
    """One RPN level in training, fed the inputs tpu3d's whole RPN gave it:
    its output and, for a fixed random cotangent, every parameter's
    gradient and its input features' gradient, against ``jax.vjp`` of
    tpu3d's flax module under the TPU contract: the output within 3e-3
    RMS, the gradients within 1.5e-2 RMS on average and 5e-2 each (a bf16
    rounding the two packages' f32 sums put on the other side of a tie
    moves one value by a bf16 step, and train-mode BatchNorm's backward
    spreads it over the batch), and the port's f32 path at least four times
    further in the output and on average over the gradients."""
    from tpu3d.models import pointnet2 as jp2

    model, jcfg, pts, params, stats, _, _, _, _, levels = rpn_case
    net = model.rpn.backbone
    sa = jcfg.RPN.SA_CONFIG
    xyz = [T(pts)]
    cached = []
    for k, n in enumerate(net.npoints):
        fps, d2, nn_idx = fused_sa_free_fps(xyz[k], n)
        xyz.append(fps)
        cached.append((d2, nn_idx))
    feats = [None] + [levels[f"sa_{k}"]["__call__"][0][1] for k in range(4)]
    kind, k = level.split("_")
    k = int(k)
    jparams = params["rpn"]["backbone"][level]
    jstats = stats["rpn"]["backbone"][level]
    rng = np.random.default_rng(64 + RPN_LEVELS.index(level))
    if kind == "sa":
        jmod = jp2.PointnetSAModuleMSG(
            npoint=sa.NPOINTS[k], radii=tuple(sa.RADIUS[k]),
            nsamples=tuple(sa.NSAMPLE[k]),
            mlps=tuple(tuple(m) for m in sa.MLPS[k]), bn=True,
            dtype=jnp.bfloat16)
        src = feats[k]
        args = (np.asarray(xyz[k]), np.asarray(xyz[k + 1]))

        def jfn(p, f):
            return jmod.apply({"params": p, "batch_stats": jstats}, args[0],
                              f, train=True, bn_momentum=0.8,
                              new_xyz=args[1], mutable=["batch_stats"])[0][1]
    else:
        known = (feats[4] if k == 3
                 else levels[f"fp_{k + 1}"]["__call__"][0])
        src = known
        jmod = jp2.PointnetFPModule(mlp=tuple(jcfg.RPN.FP_MLPS[k]), bn=True,
                                    dtype=jnp.bfloat16)
        d2, nn_idx = (np.asarray(a) for a in cached[k])

        def jfn(p, f):
            return jmod.apply({"params": p, "batch_stats": jstats},
                              np.asarray(xyz[k]), np.asarray(xyz[k + 1]),
                              feats[k], f, train=True, bn_momentum=0.8,
                              cached_nn=(d2, nn_idx),
                              mutable=["batch_stats"])[0]

    with _tpu_training():
        want_shape = jax.eval_shape(jfn, jparams, src)
        cot = rng.normal(size=want_shape.shape).astype(np.float32)
        cot = jnp.asarray(cot).astype(want_shape.dtype)
        want, (jg, jf) = _vjp(jfn, (jparams, src), cot)
    jg = dict(_flat(jg))
    mod = getattr(net, level)
    errs = {}
    for name, prec in (("bf16", TPU_TRAIN), ("f32", F32)):
        model.load_state_dict(params_from_jax(params, stats))
        for p in mod.parameters():
            p.grad = None
        dtype = BF16 if name == "bf16" else torch.float32
        f = None if src is None else T(_f32(src)).to(
            dtype if str(np.asarray(src).dtype) == "bfloat16"
            else torch.float32).requires_grad_()
        if kind == "sa":
            out = mod(xyz[k], f, xyz[k + 1], True, 0.8, prec)
        else:
            skip = None if feats[k] is None else T(_f32(feats[k])).to(
                BF16 if name == "bf16" and str(np.asarray(
                    feats[k]).dtype) == "bfloat16" else torch.float32)
            out = mod(skip, f, cached[k], True, 0.8, prec)
        out.float().backward(T(_f32(cot)))
        grads = dict(_flat(params_to_jax(
            {n: p.grad for n, p in mod.named_parameters()})[0]))
        assert set(grads) == set(jg)
        g_errs = [_rms(grads[n], v) for n, v in jg.items()]
        if f is not None:
            g_errs.append(_rms(f.grad, jf))
        errs[name] = (_rms(out.detach(), want), max(g_errs),
                      float(np.mean(g_errs)))
    (out_e, g_max, g_mean), (out32, _, g_mean32) = errs["bf16"], errs["f32"]
    assert out_e <= 3e-3 and g_mean <= 1.5e-2 and g_max <= 5e-2, errs
    assert out32 >= 4 * out_e and g_mean32 >= 4 * g_mean, errs


def fused_sa_free_fps(xyz, n):
    """The next level's points and each point's three nearest of them
    (the port's FPS + 3-NN, tpu3d's picks)."""
    idx, d2, nn_idx = furthest_point_sample_with_3nn(xyz, n)
    return gather_points(xyz, idx), d2, nn_idx


@pytest.mark.parametrize("name,nsample", [("smoke", 16), ("default", 64)])
def test_rcnn_stage_training_matches_tpu3d(name, nsample):
    """The RCNN stage in training (``RCNNNet``: xyz_up and merge_down in
    bf16, SA_0 on the gather route and SA_1 on the slab route, their bf16
    training kernels (tpu3d's in interpret mode, the port's plain
    versions), the GroupAll plain in bf16, the heads f32) on pooled inputs
    as the hi/lo table gives them (bf16 features, f32 points): a fixed
    random read-out of rcnn_cls and rcnn_reg and every parameter's and the
    input's gradient, against tpu3d under its TPU contract; the configs'
    levels at S = ``nsample`` cut to 128 points per ROI. The outputs within
    1e-5 RMS, the gradients within 5e-3 RMS on average and 2e-2 each, and
    the port's f32 path at least ten times further."""
    jcfg = jax_cfg_from_file(f"configs/{name}.yaml", jax_fresh_cfg())
    c = jcfg.RCNN
    c.NUM_POINTS, c.DP_RATIO = 128, 0.0
    c.SA_CONFIG.NPOINTS = [32, 16, -1]
    c.SA_CONFIG.NSAMPLE = [nsample] * 3
    R, K = 4, c.NUM_POINTS
    rng = np.random.default_rng(71)
    n_ext = int(c.USE_INTENSITY) + int(c.USE_MASK) + int(c.USE_DEPTH)
    C = n_ext + jcfg.RPN.FP_MLPS[0][-1]
    xyz = (rng.normal(size=(R, K, 3)) * [0.8, 0.4, 1.6]).astype(np.float32)
    rest = _f32(jnp.asarray(rng.normal(size=(R, K, C)).astype(
        np.float32)).astype(jnp.bfloat16))
    pts_input = np.concatenate([xyz, rest], -1)
    jnet = JaxRCNNNet(cfg=jcfg)
    shapes = jax.eval_shape(lambda p: jnet.init(
        {"params": jax.random.PRNGKey(0)}, p, train=False), pts_input)
    params, _ = _numpy_variables({"params": shapes["params"],
                                  "batch_stats": {}}, rng)
    probe = rng.normal(size=(2, R)).astype(np.float32)

    def loss_fn(p, x):
        o = jnet.apply({"params": p}, x, train=True)
        return (jnp.sum(o["rcnn_cls"][:, 0] * probe[0])
                + jnp.sum(o["rcnn_reg"].sum(-1) * probe[1])), o

    with _tpu_training():
        (_, jout), (jg, jx) = jax.device_get(_exact(jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True), params, pts_input))
    jg = dict(_flat(jg))
    route = [fused_sa.sa_route((R, c.SA_CONFIG.NPOINTS[k], nsample, 128),
                               c.SA_CONFIG.MLPS[k], n, False)
             for k, n in ((0, K), (1, 32))]
    assert route == ["gather", "slab"]
    model = PointRCNN(_port_cfg(jcfg), mode="TRAIN", device="cpu")
    full = model.state_dict()
    full.update(params_from_jax({"rcnn_net": params}, {}))
    errs = {}
    for run, prec in (("bf16", TPU_TRAIN), ("f32", F32)):
        model.load_state_dict(full)
        x = T(pts_input).requires_grad_()
        o = model.rcnn_net(x[..., :3], x[..., 3:], True, 0.9, None, prec)
        assert o["rcnn_cls"].dtype == torch.float32
        loss = ((o["rcnn_cls"][:, 0] * T(probe[0])).sum()
                + (o["rcnn_reg"].sum(-1) * T(probe[1])).sum())
        loss.backward()
        grads = dict(_flat(params_to_jax(
            {n[len("rcnn_net."):]: p.grad for n, p in
             model.named_parameters() if n.startswith("rcnn_net.")})[0]))
        assert set(grads) == set(jg)
        g = [_rms(grads[n], v) for n, v in jg.items()] + [_rms(x.grad, jx)]
        errs[run] = (max(_rms(o[k].detach(), jout[k])
                         for k in ("rcnn_cls", "rcnn_reg")),
                     float(np.mean(g)), max(g))
    (out_e, g_mean, g_max), (out32, g_mean32, _) = errs["bf16"], errs["f32"]
    assert out_e <= 1e-5 and g_mean <= 5e-3 and g_max <= 2e-2, errs
    assert out32 >= 10 * max(out_e, 1e-6) and g_mean32 >= 10 * g_mean, errs
