"""Fused two-layer MLP + max-pool over grouped points, the RCNN's set
abstraction, at eval and in training, in tpu3d's two fused forms.

Counterpart of ``tpu3d/ops/fused_sa.py::fused_gathered_mlp_pool`` (the
gather form: the group gather of per-point pre-activations runs inside the
kernel), ``fused_mlp_pool`` (the slab form: the caller builds the grouped
(R, M, S, C1) pre-activation in memory) and ``fused_bn_mlp_pool`` at eval
(the slab form with BatchNorm, its running statistics folded into one
per-channel affine per layer). ``sa_route`` is tpu3d's choice among the
two forms and the plain SharedMLP (``models/pointnet2.py``).

Each no-BN op runs, for CUDA tensors, its eval kernel in ``csrc/fused_sa.cu``
when no gradient is needed, and otherwise a ``torch.autograd.Function``
whose forward is the training kernel of the same source (it also keeps
each pooled channel's first argmax slot and the pre-ReLU value there) and
whose backward is ``csrc/fused_sa_bwd.cu``. The BatchNorm op is the slab
eval kernel alone. For CPU tensors each runs its plain version, or the
plain training form under autograd. All compute in f32 (the TPU kernels
round to bf16 at their layer boundaries), so they are held to tpu3d's CPU
path, which is f32 too. The max-pool's gradient goes to the first slot that
reaches the max, as tpu3d's kernels route it.

Kernel notes (in full in the sources): they replace
``tpu3d/ops/fused_sa.py::_nobn2_eval_kernel``, ``_nobn2_fwd_kernel`` and
``_nobn2_bwd_kernel`` (gather form), ``_nobn_eval_kernel``,
``_nobn_fwd_kernel``, ``_nobn_bwd_kernel`` and ``_eval_chain_kernel`` (slab
form). The two Dense layers make them bound by operations; one block per
(row, center) loads its S x C1 group into shared memory (gathered, or read
from the slab), and the backward walks many groups per block, summing the
weight gradients in registers and shared memory before one write per block.
The slab kernel takes each layer as a per-channel affine (mul, add) between
two Dense layers, a_l = ReLU(x_l·mul_l + add_l): mul = 1 and add = (0, b1,
b2) without BatchNorm, the folded running statistics with it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .grouping import group_points


def _chain(x0, w1, b1, w2, b2):
    """Layer 2's pre-activation x2 of a grouped (R, M, S, C1) chunk."""
    x1 = torch.relu(x0) @ w1 + b1
    return torch.relu(x1) @ w2 + b2


def _pool_plain(x0, w1, b1, w2, b2):
    """The chain on a grouped (R, M, S, C1) chunk -> (R, M, C3)."""
    return torch.relu(_chain(x0, w1, b1, w2, b2)).amax(dim=2)


def _first_max(x2):
    """The max over S of ReLU(x2), a grouped chunk's layer-2 pre-activation,
    differentiable by autograd -> (out, argmax i32, ppre), each (R, M, C3).

    The max over the S slots goes through the first slot that reaches it
    (``argmax``), picked explicitly and then gathered, so that autograd
    routes the pooled gradient to that one slot (``amax`` would split it
    among ties). ``ppre`` is the pre-ReLU value there."""
    S = x2.shape[2]
    a2 = torch.relu(x2)
    with torch.no_grad():
        top = a2.amax(dim=2, keepdim=True)
        slots = torch.arange(S, device=x2.device)[:, None]
        arg = torch.where(a2 == top, slots, S).amin(dim=2)
    sel = arg[:, :, None, :]
    return (torch.gather(a2, 2, sel)[:, :, 0], arg.to(torch.int32),
            torch.gather(x2.detach(), 2, sel)[:, :, 0])


def _pool_train_plain(x0, w1, b1, w2, b2):
    """The chain on a grouped chunk, differentiable by autograd, pooled by
    ``_first_max``."""
    return _first_max(_chain(x0, w1, b1, w2, b2))


def _chunked(fn, grouped, R, M, S, width):
    """``fn`` over row chunks of the grouped slab ``grouped(rows)``, each
    (chunk, M, S, width) intermediate near 64 MB (autograd keeps every
    chunk's intermediates), with its outputs concatenated over rows."""
    chunk = max(1, (1 << 24) // (M * S * width))
    outs = [fn(grouped(slice(r0, r0 + chunk)))
            for r0 in range(0, R, chunk)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def _gather_form(pre, idx, center, w1, w2):
    R, M, S = idx.shape
    width = max(w1.shape[1], w2.shape[1])

    def grouped(rows):
        return group_points(pre[rows], idx[rows]) - center[rows][:, :, None, :]

    return grouped, R, M, S, width


def fused_gathered_mlp_pool_plain(pre, idx, center, w1, b1, w2, b2):
    """Plain PyTorch version of the eval kernel: the grouped slab made in
    full, a chunk of rows at a time."""
    return _chunked(lambda x0: _pool_plain(x0, w1, b1, w2, b2),
                    *_gather_form(pre, idx, center, w1, w2))


def fused_gathered_mlp_pool_train_plain(pre, idx, center, w1, b1, w2, b2):
    """Plain PyTorch version of the training kernel, differentiable by
    autograd -> (out (R, M, C3), argmax (R, M, C3) i32, ppre (R, M, C3)),
    the first argmax as ``_pool_train_plain`` takes it."""
    return _chunked(lambda x0: _pool_train_plain(x0, w1, b1, w2, b2),
                    *_gather_form(pre, idx, center, w1, w2))


def fused_gathered_mlp_pool_backward_plain(pre, idx, center, w1, b1, w2, b2,
                                           grad):
    """The gradients of ``fused_gathered_mlp_pool_train_plain`` for the
    output gradient ``grad``, by autograd -> (d_pre, d_center, dW1, db1,
    dW2, db2)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in
                  (pre, center, w1, b1, w2, b2)]
        out = fused_gathered_mlp_pool_train_plain(
            leaves[0], idx, leaves[1], *leaves[2:])[0]
        return torch.autograd.grad(out, leaves, grad)


def _check_tensors(*named):
    """Raise unless each (tensor, name, ndim) is an f32 CUDA tensor of that
    rank, contiguous and 16-byte aligned."""
    for t, name, ndim in named:
        _build.check_cuda_tensor(t, name, torch.float32, ndim)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check(pre, idx, center, w1, b1, w2, b2):
    """Raise unless the CUDA kernels take these tensors; -> (R, N, M, S, C1,
    C2, C3)."""
    _check_tensors((pre, "pre", 3), (center, "center", 3), (w1, "w1", 2),
                   (b1, "b1", 1), (w2, "w2", 2), (b2, "b2", 1))
    _build.check_cuda_tensor(idx, "idx", torch.int32, 3)
    R, N, C1 = pre.shape
    M, S = idx.shape[1], idx.shape[2]
    C2, C3 = w1.shape[1], w2.shape[1]
    if (idx.shape[0] != R or center.shape != (R, M, C1)
            or w1.shape[0] != C1 or b1.shape != (C2,)
            or w2.shape[0] != C2 or b2.shape != (C3,)):
        raise ValueError(
            f"fused_sa shapes disagree: pre {tuple(pre.shape)}, idx "
            f"{tuple(idx.shape)}, center {tuple(center.shape)}, w1 "
            f"{tuple(w1.shape)}, b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, "
            f"b2 {tuple(b2.shape)}")
    if (S not in (16, 32, 64) or C1 % 4 or not 4 <= C1 <= 256
            or C2 not in (128, 256) or C3 not in (128, 256) or R > 65535):
        raise ValueError(
            f"fused_sa takes S in (16, 32, 64), C1 % 4 == 0 and C1 <= 256, "
            f"C2 and C3 in (128, 256), R <= 65535; got R={R}, S={S}, "
            f"C1={C1}, C2={C2}, C3={C3}")
    return R, N, M, S, C1, C2, C3


def _pooled(R, M, C3, device, train):
    """A forward kernel's outputs: out (R, M, C3), and for the training form
    also the argmax slot (i32) and ppre."""
    out = torch.empty(R, M, C3, dtype=torch.float32, device=device)
    if not train:
        return (out,)
    return (out, torch.empty(R, M, C3, dtype=torch.int32, device=device),
            torch.empty(R, M, C3, dtype=torch.float32, device=device))


def _gather_forward(kernel, pre, idx, center, w1, b1, w2, b2, train=False):
    """Launch a forward kernel of the gather form -> ``_pooled``'s
    outputs."""
    R, N, M, S, C1, C2, C3 = _check(pre, idx, center, w1, b1, w2, b2)
    outs = _pooled(R, M, C3, pre.device, train)
    _build.launch(kernel, pre.data_ptr(), idx.data_ptr(), center.data_ptr(),
                  w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                  R, N, M, S, C1, C2, C3, *(t.data_ptr() for t in outs))
    return outs


def fused_gathered_mlp_pool_train(pre, idx, center, w1, b1, w2, b2):
    """The training forward alone -> (out, argmax, ppre) as
    ``fused_gathered_mlp_pool_train_plain`` gives them: the kernel for CUDA
    tensors, else the plain version."""
    if pre.device.type == "cpu":
        return fused_gathered_mlp_pool_train_plain(pre, idx, center, w1, b1,
                                                   w2, b2)
    return _gather_forward("fused_sa_train", pre, idx, center, w1, b1, w2, b2,
                           train=True)


def _bwd_blocks(groups: int) -> int:
    fn = _build.library("fused_sa_bwd").tpu3d_fused_sa_bwd_blocks
    fn.argtypes, fn.restype = [ctypes.c_longlong], ctypes.c_int
    return fn(groups)


def _launch_backward(kernel, head, dims, outs, w1, b1, w2, grad, argmax,
                     ppre):
    """Launch the backward ``kernel`` of either form. ``head`` are the form's
    leading input tensors, ``dims`` its sizes (R, ..., M, S, C3), ``outs``
    the input gradients it writes; both forms then take W1, W1ᵀ, b1, W2ᵀ,
    dval, argmax, the block count and the workspace of the deterministic
    block-partials reduction. -> (dW1, db1, dW2, db2)."""
    R, M = dims[0], dims[-3]
    C1, C2, C3 = w1.shape[0], w1.shape[1], w2.shape[1]
    for t, name in ((grad, "grad"), (ppre, "ppre")):
        _build.check_cuda_tensor(t, name, torch.float32, 3)
    _build.check_cuda_tensor(argmax, "argmax", torch.int32, 3)
    if grad.shape != (R, M, C3) or argmax.shape != grad.shape \
            or ppre.shape != grad.shape:
        raise ValueError(f"{kernel}'s gradient, argmax and ppre must be "
                         f"{(R, M, C3)}")
    dval = torch.where(ppre > 0, grad, 0.0)
    w1t = w1.t().contiguous()
    w2t = w2.t().contiguous()
    blocks = _bwd_blocks(R * M)
    per = C1 * C2 + C3 * C2 + C2
    ws = torch.empty(blocks, per, dtype=torch.float32, device=grad.device)
    sums = torch.empty(per, dtype=torch.float32, device=grad.device)
    _build.launch(kernel, *(t.data_ptr() for t in head), w1.data_ptr(),
                  w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
                  dval.data_ptr(), argmax.data_ptr(), *dims, blocks,
                  *(t.data_ptr() for t in outs), ws.data_ptr(),
                  sums.data_ptr())
    return (sums[:C1 * C2].view(C1, C2), sums[C1 * C2 + C3 * C2:],
            sums[C1 * C2:C1 * C2 + C3 * C2].view(C3, C2).t(),
            dval.sum(dim=(0, 1)))


def fused_gathered_mlp_pool_backward(pre, idx, center, w1, b1, w2, b2, grad,
                                     argmax, ppre):
    """The backward alone, from the output gradient and the training
    forward's argmax and ppre -> (d_pre, d_center, dW1, db1, dW2, db2). The
    kernel for CUDA tensors (C1 = C2 = 128, C3 128 or 256; other widths
    raise), else the plain version by autograd."""
    if pre.device.type == "cpu":
        return fused_gathered_mlp_pool_backward_plain(pre, idx, center, w1,
                                                      b1, w2, b2, grad)
    R, N, M, S, C1, C2, C3 = _check(pre, idx, center, w1, b1, w2, b2)
    if C1 != 128 or C2 != 128:
        raise ValueError(f"the fused_sa backward kernel takes C1 = C2 = 128, "
                         f"got C1={C1}, C2={C2}")
    d_pre = torch.zeros_like(pre)
    d_center = torch.empty_like(center)
    return (d_pre, d_center, *_launch_backward(
        "fused_sa_bwd", (pre, idx, center), (R, N, M, S, C3),
        (d_pre, d_center), w1, b1, w2, grad, argmax, ppre))


class _FusedGatheredMLPPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pre, idx, center, w1, b1, w2, b2):
        if w1.shape != (128, 128):
            raise ValueError(f"the fused_sa backward kernel takes C1 = C2 = "
                             f"128, got w1 {tuple(w1.shape)}")
        out, argmax, ppre = fused_gathered_mlp_pool_train(
            pre, idx, center, w1, b1, w2, b2)
        ctx.save_for_backward(pre, idx, center, w1, b1, w2, b2, argmax, ppre)
        return out

    @staticmethod
    def backward(ctx, grad):
        pre, idx, center, w1, b1, w2, b2, argmax, ppre = ctx.saved_tensors
        d_pre, d_center, dw1, db1, dw2, db2 = fused_gathered_mlp_pool_backward(
            pre, idx, center, w1, b1, w2, b2, grad.contiguous(), argmax, ppre)
        return d_pre, None, d_center, dw1, db1, dw2, db2


def _dispatch(args, plain, train_plain, function, launch):
    """A fused op on ``args``: for CPU tensors its plain version, or its
    plain training form when a gradient is needed; for CUDA tensors the
    ``torch.autograd.Function`` (training kernel and backward) when a
    gradient is needed, else the eval kernel through ``launch``."""
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in args)
    if args[0].device.type == "cpu":
        return train_plain(*args)[0] if grad else plain(*args)
    return function.apply(*args) if grad else launch(*args)[0]


def fused_gathered_mlp_pool(pre: torch.Tensor, idx: torch.Tensor,
                            center: torch.Tensor, w1: torch.Tensor,
                            b1: torch.Tensor, w2: torch.Tensor,
                            b2: torch.Tensor) -> torch.Tensor:
    """pre (R, N, C1) per-point layer-0 pre-activations, idx (R, M, S) i32
    group ids into N, center (R, M, C1) per-center term, w1 (C1, C2), b1
    (C2,), w2 (C2, C3), b2 (C3,) -> (R, M, C3):
        max_s ReLU(ReLU(ReLU(pre[idx] - center) @ w1 + b1) @ w2 + b2).

    Differentiable in every input but idx, with the max-pool's gradient on
    the first slot that reaches the max. The CUDA kernels take f32 tensors
    with S in (16, 32, 64), C1 a multiple of 4 up to 256, C2 and C3 each 128
    or 256, R <= 65535, and ids in [0, N) (an id outside stops the kernel
    with a device fault); the backward kernel takes C1 = C2 = 128. A CUDA
    tensor outside that raises.
    """
    return _dispatch((pre, idx, center, w1, b1, w2, b2),
                     fused_gathered_mlp_pool_plain,
                     fused_gathered_mlp_pool_train_plain,
                     _FusedGatheredMLPPool,
                     lambda *a: _gather_forward("fused_sa", *a))


def fused_gather_supported(n: int) -> bool:
    """Whether the gather form takes an n-point source table (tpu3d's
    ``fused_gather_supported``: its kernel keeps the table in VMEM)."""
    return n % 128 == 0 and n <= 2048


def fused_sa_supported(shape, mlp) -> bool:
    """Whether a fused form takes this (R, M, S, C1) grouped slab and
    3-layer MLP: tpu3d's ``fused_sa_supported``, its shape test alone."""
    if len(mlp) != 3:
        return False
    _, m, s, c1 = shape
    return (s % 8 == 0 and (m * s) % max(s, 128) == 0 and c1 % 128 == 0
            and c1 == mlp[0] and all(c % 128 == 0 for c in mlp))


def sa_route(shape, mlp, n: int, bn: bool) -> str:
    """tpu3d's route for an RCNN set-abstraction level of ``shape`` = (R, M,
    S, C1) grouped slots over ``n`` source points per row: "gather" (the
    gather form, ``fused_gathered_mlp_pool``), "slab" (the slab form,
    ``fused_mlp_pool`` or, with BatchNorm, ``fused_bn_mlp_pool``) or "plain"
    (the SharedMLP and a max).

    It copies ``tpu3d/models/pointnet2.py:300-302``, ``:336-339`` and
    ``:416-419``: a level fuses only where it pre-groups its first layer
    (M·S slots outnumber its n points) and ``fused_sa_supported`` holds; it
    then takes the gather form without BatchNorm when
    ``fused_gather_supported(n)`` holds, else the slab form. tpu3d fuses only
    on the TPU (its ``bf16_ok`` clause); the port takes the TPU's route on
    both devices, as ``sampling.fused_route`` does, and on the CPU each
    route's plain version computes the same function, so the choice moves no
    CPU result."""
    _, m, s, _ = shape
    if m * s <= n or not fused_sa_supported(shape, mlp):
        return "plain"
    return "gather" if not bn and fused_gather_supported(n) else "slab"


# --------------------------------------------------------------------------
# the slab form: x0 (R, M, S, C1), the grouped layer-0 pre-activation, and
# per layer a per-channel affine packed as [mul0 | add0 | mul1 | add1 |
# mul2 | add2]
# --------------------------------------------------------------------------


def nobn_packs(c1: int, b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The no-BN chain's packs: mul = 1, add = (0, b1, b2). Differentiable
    in b1 and b2."""
    ones = b1.new_ones(c1)
    return torch.cat([ones, torch.zeros_like(ones), torch.ones_like(b1), b1,
                      torch.ones_like(b2), b2])


def bn_packs(affines) -> torch.Tensor:
    """The BatchNorm chain's packs from its three layers' eval affines
    ((mul, add) each, as ``models.pointnet2.BatchNorm.affine`` folds the
    running statistics)."""
    return torch.cat([t for mul_add in affines for t in mul_add])


def _slab_chain(x0, packs, w1, w2):
    """The pre-ReLU x2·mul2 + add2 of a grouped (R, M, S, C1) chunk, where
    a_l = ReLU(x_l·mul_l + add_l) and x_{l+1} = a_l W_{l+1}."""
    c1, c2, c3 = x0.shape[-1], w1.shape[1], w2.shape[1]
    m0, a0, m1, a1, m2, a2 = packs.split([c1, c1, c2, c2, c3, c3])
    x1 = (torch.relu(x0 * m0 + a0) @ w1) * m1 + a1
    return (torch.relu(x1) @ w2) * m2 + a2


def _slab_form(x0, w1, w2):
    R, M, S, _ = x0.shape
    return (lambda rows: x0[rows]), R, M, S, max(w1.shape[1], w2.shape[1])


def fused_sa_slab_plain(x0, packs, w1, w2):
    """Plain PyTorch version of the slab eval kernel, a chunk of rows at a
    time: max over S of ReLU(x2·mul2 + add2)."""
    return _chunked(
        lambda x: torch.relu(_slab_chain(x, packs, w1, w2)).amax(dim=2),
        *_slab_form(x0, w1, w2))


def _nobn_slab_chain(x0, w1, b1, w2, b2):
    return _slab_chain(x0, nobn_packs(x0.shape[-1], b1, b2), w1, w2)


def fused_mlp_pool_plain(x0, w1, b1, w2, b2):
    """Plain PyTorch version of the no-BN slab eval kernel."""
    return fused_sa_slab_plain(x0, nobn_packs(x0.shape[-1], b1, b2), w1, w2)


def fused_mlp_pool_train_plain(x0, w1, b1, w2, b2):
    """Plain PyTorch version of the slab form's training kernel,
    differentiable by autograd -> (out, argmax i32, ppre), each
    (R, M, C3)."""
    def pool(x):
        return _first_max(_nobn_slab_chain(x, w1, b1, w2, b2))

    return _chunked(pool, *_slab_form(x0, w1, w2))


def fused_mlp_pool_backward_plain(x0, w1, b1, w2, b2, grad, argmax, ppre):
    """Plain PyTorch version of the slab form's backward kernel -> (d_x0,
    dW1, db1, dW2, db2) for the output gradient ``grad``, routed as the
    kernel routes it: each pooled channel's gradient goes to the training
    forward's slot ``argmax`` where its pre-ReLU value ``ppre`` is > 0.
    Autograd of the recomputed chain; with the plain training forward's
    argmax and ppre it equals autograd of ``fused_mlp_pool_train_plain``."""
    dval = torch.where(ppre > 0, grad, 0.0)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x0, w1, b1, w2, b2)]
        sel = torch.gather(_nobn_slab_chain(*leaves), 2,
                           argmax.long()[:, :, None, :])[:, :, 0]
        return torch.autograd.grad(sel, leaves, dval)


def _check_slab(x0, packs, w1, w2):
    """Raise unless the slab kernels take these tensors; -> (R, M, S,
    C3)."""
    _check_tensors((x0, "x0", 4), (packs, "packs", 1), (w1, "w1", 2),
                   (w2, "w2", 2))
    R, M, S, C1 = x0.shape
    C3 = w2.shape[1]
    if (w1.shape != (128, 128) or w2.shape[0] != 128 or C1 != 128
            or C3 not in (128, 256) or packs.shape != (2 * (256 + C3),)
            or S not in (16, 32, 64) or R > 65535):
        raise ValueError(
            f"fused_sa_slab takes x0 (R <= 65535, M, S in (16, 32, 64), 128),"
            f" w1 (128, 128), w2 (128, C3 in (128, 256)), packs "
            f"(2 (256 + C3),); got x0 {tuple(x0.shape)}, w1 "
            f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}, packs "
            f"{tuple(packs.shape)}")
    return R, M, S, C3


def _slab_forward(kernel, x0, packs, w1, w2, train=False):
    """Launch a forward kernel of the slab form -> ``_pooled``'s
    outputs."""
    R, M, S, C3 = _check_slab(x0, packs, w1, w2)
    outs = _pooled(R, M, C3, x0.device, train)
    _build.launch(kernel, x0.data_ptr(), packs.data_ptr(), w1.data_ptr(),
                  w2.data_ptr(), R, M, S, 128, 128, C3,
                  *(t.data_ptr() for t in outs))
    return outs


def fused_mlp_pool_train(x0, w1, b1, w2, b2):
    """The slab form's training forward alone -> (out, argmax, ppre) as
    ``fused_mlp_pool_train_plain`` gives them: the kernel for CUDA tensors,
    else the plain version."""
    if x0.device.type == "cpu":
        return fused_mlp_pool_train_plain(x0, w1, b1, w2, b2)
    return _slab_forward("fused_sa_slab_train", x0,
                         nobn_packs(x0.shape[-1], b1, b2), w1, w2,
                         train=True)


def fused_mlp_pool_backward(x0, w1, b1, w2, b2, grad, argmax, ppre):
    """The slab form's backward alone, from the output gradient and the
    training forward's argmax and ppre -> (d_x0, dW1, db1, dW2, db2): the
    kernel for CUDA tensors, else the plain version."""
    if x0.device.type == "cpu":
        return fused_mlp_pool_backward_plain(x0, w1, b1, w2, b2, grad,
                                             argmax, ppre)
    _check_tensors((b1, "b1", 1), (b2, "b2", 1))
    R, M, S, C3 = _check_slab(x0, nobn_packs(128, b1, b2), w1, w2)
    d_x0 = torch.empty_like(x0)
    return (d_x0, *_launch_backward(
        "fused_sa_slab_bwd", (x0,), (R, M, S, C3), (d_x0,), w1, b1, w2,
        grad, argmax, ppre))


class _FusedMLPPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, w1, b1, w2, b2):
        out, argmax, ppre = fused_mlp_pool_train(x0, w1, b1, w2, b2)
        ctx.save_for_backward(x0, w1, b1, w2, b2, argmax, ppre)
        return out

    @staticmethod
    def backward(ctx, grad):
        x0, w1, b1, w2, b2, argmax, ppre = ctx.saved_tensors
        return fused_mlp_pool_backward(x0, w1, b1, w2, b2, grad.contiguous(),
                                       argmax, ppre)


def fused_mlp_pool(x0: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x0 (R, M, S, C1) the grouped layer-0 pre-activations, w1 (C1, C2),
    b1 (C2,), w2 (C2, C3), b2 (C3,) -> (R, M, C3):
        max_s ReLU(ReLU(ReLU(x0) @ w1 + b1) @ w2 + b2).

    The slab form of ``fused_gathered_mlp_pool``, for a level whose source
    table the gather form does not take. Differentiable in every input,
    with the max-pool's gradient on the first slot that reaches the max.
    The CUDA kernels read x0 in place as (R, M·S, C1), and take f32
    tensors with C1 = C2 = 128, C3 128 or 256, S in (16, 32, 64) and
    R <= 65535; a CUDA tensor outside that raises.
    """
    return _dispatch((x0, w1, b1, w2, b2), fused_mlp_pool_plain,
                     fused_mlp_pool_train_plain, _FusedMLPPool,
                     lambda x0, w1, b1, w2, b2: _slab_forward(
                         "fused_sa_slab", x0, nobn_packs(x0.shape[-1], b1, b2),
                         w1, w2))


def fused_bn_mlp_pool(x0: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                      affines) -> torch.Tensor:
    """The BatchNorm chain at eval: x0 (R, M, S, C1) the grouped layer-0
    pre-activations (Dense without bias), w1 (C1, C2), w2 (C2, C3), and
    ``affines`` the three BatchNorm layers' (mul, add), the running
    statistics folded in -> (R, M, C3):
        max_s ReLU(ReLU(ReLU(x0·mul0 + add0) @ w1·mul1 + add1) @ w2·mul2
                   + add2).

    tpu3d's ``fused_bn_mlp_pool(stats=...)``. For CUDA tensors the slab eval
    kernel (counted as ``fused_sa_slab_bn``), with the shape limits of
    ``fused_mlp_pool``; it has no backward, so a CUDA call that needs a
    gradient raises (the chain's training form, with batch statistics, is
    not ported). For CPU tensors the plain version, differentiable.
    """
    packs = bn_packs(affines)
    if x0.device.type == "cpu":
        return fused_sa_slab_plain(x0, packs, w1, w2)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x0, w1, w2, packs)):
        raise NotImplementedError(
            "fused_bn_mlp_pool on the card is the eval kernel alone; the "
            "BatchNorm chain's training kernels are not ported")
    return _slab_forward("fused_sa_slab_bn", x0, packs.contiguous(), w1,
                         w2)[0]
