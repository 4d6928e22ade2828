"""Fused grouped gather + two-layer MLP + max-pool, the RCNN's no-BN set
abstraction, at eval and in training.

Counterpart of ``tpu3d/ops/fused_sa.py::fused_gathered_mlp_pool``.
``fused_gathered_mlp_pool`` runs, for CUDA tensors, the eval kernel in
``csrc/fused_sa.cu`` when no gradient is needed, and otherwise a
``torch.autograd.Function`` whose forward is the training kernel of the
same source (it also keeps each pooled channel's first argmax slot and the
pre-ReLU value there) and whose backward is ``csrc/fused_sa_bwd.cu``. For
CPU tensors it runs ``fused_gathered_mlp_pool_plain``, or its training form
``fused_gathered_mlp_pool_train_plain`` under autograd. All compute in f32
(the TPU kernels round to bf16 at their layer boundaries), so they are held
to tpu3d's CPU path, which is f32 too. The max-pool's gradient goes to the
first slot that reaches the max, as tpu3d's kernels route it.

Kernel notes (in full in the sources): they replace
``tpu3d/ops/fused_sa.py::_nobn2_eval_kernel``, ``_nobn2_fwd_kernel`` and
``_nobn2_bwd_kernel``. The two Dense layers make them bound by operations;
one block per (row, center) gathers its S x C1 slab into shared memory, so
the slab never reaches device memory, and the backward walks many groups
per block, summing the weight gradients in registers and shared memory
before one write per block.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .grouping import group_points


def _chunk_rows(M: int, S: int, width: int) -> int:
    """Rows per chunk so that each (chunk, M, S, width) intermediate stays
    near 64 MB."""
    return max(1, (1 << 24) // (M * S * width))


def fused_gathered_mlp_pool_plain(pre, idx, center, w1, b1, w2, b2):
    """Plain PyTorch version of the eval kernel: the grouped slab made in
    full, a chunk of rows at a time."""
    R, M, S = idx.shape
    chunk = _chunk_rows(M, S, max(w1.shape[1], w2.shape[1]))
    outs = []
    for r0 in range(0, R, chunk):
        rows = slice(r0, r0 + chunk)
        x0 = group_points(pre[rows], idx[rows]) - center[rows][:, :, None, :]
        x1 = torch.relu(x0) @ w1 + b1
        x2 = torch.relu(x1) @ w2 + b2
        outs.append(torch.relu(x2).amax(dim=2))
    return torch.cat(outs)


def fused_gathered_mlp_pool_train_plain(pre, idx, center, w1, b1, w2, b2):
    """Plain PyTorch version of the training kernel, differentiable by
    autograd -> (out (R, M, C3), argmax (R, M, C3) i32, ppre (R, M, C3)).

    The max over the S slots goes through the first slot that reaches it
    (``argmax``), picked explicitly and then gathered, so that autograd
    routes the pooled gradient to that one slot (``amax`` would split it
    among ties). ``ppre`` is the pre-ReLU value there. Chunked over rows
    like the eval form (autograd keeps every chunk's intermediates)."""
    R, M, S = idx.shape
    chunk = _chunk_rows(M, S, max(w1.shape[1], w2.shape[1]))
    outs, args, ppres = [], [], []
    slots = torch.arange(S, device=idx.device)[:, None]
    for r0 in range(0, R, chunk):
        rows = slice(r0, r0 + chunk)
        x0 = group_points(pre[rows], idx[rows]) - center[rows][:, :, None, :]
        x1 = torch.relu(x0) @ w1 + b1
        x2 = torch.relu(x1) @ w2 + b2
        a2 = torch.relu(x2)
        with torch.no_grad():
            top = a2.amax(dim=2, keepdim=True)
            arg = torch.where(a2 == top, slots, S).amin(dim=2)
        sel = arg[:, :, None, :]
        outs.append(torch.gather(a2, 2, sel)[:, :, 0])
        args.append(arg.to(torch.int32))
        ppres.append(torch.gather(x2.detach(), 2, sel)[:, :, 0])
    return torch.cat(outs), torch.cat(args), torch.cat(ppres)


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


def _check(pre, idx, center, w1, b1, w2, b2):
    """Raise unless the CUDA kernels take these tensors; -> (R, N, M, S, C1,
    C2, C3)."""
    for t, name, ndim in ((pre, "pre", 3), (center, "center", 3),
                          (w1, "w1", 2), (b1, "b1", 1), (w2, "w2", 2),
                          (b2, "b2", 1)):
        _build.check_cuda_tensor(t, name, torch.float32, ndim)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
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


def _launch_forward(kernel, pre, idx, center, w1, b1, w2, b2, *outs):
    R, N, M, S, C1, C2, C3 = _check(pre, idx, center, w1, b1, w2, b2)
    _build.launch(kernel, pre.data_ptr(), idx.data_ptr(), center.data_ptr(),
                  w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                  R, N, M, S, C1, C2, C3, *(t.data_ptr() for t in outs))


def fused_gathered_mlp_pool_train(pre, idx, center, w1, b1, w2, b2):
    """The training forward alone -> (out, argmax, ppre) as
    ``fused_gathered_mlp_pool_train_plain`` gives them: the kernel for CUDA
    tensors, else the plain version."""
    if pre.device.type == "cpu":
        return fused_gathered_mlp_pool_train_plain(pre, idx, center, w1, b1,
                                                   w2, b2)
    R, M, C3 = idx.shape[0], idx.shape[1], w2.shape[1]
    out = torch.empty(R, M, C3, dtype=torch.float32, device=pre.device)
    argmax = torch.empty(R, M, C3, dtype=torch.int32, device=pre.device)
    ppre = torch.empty(R, M, C3, dtype=torch.float32, device=pre.device)
    _launch_forward("fused_sa_train", pre, idx, center, w1, b1, w2, b2, out,
                    argmax, ppre)
    return out, argmax, ppre


def _bwd_blocks(groups: int) -> int:
    fn = _build.library("fused_sa_bwd").tpu3d_fused_sa_bwd_blocks
    fn.argtypes, fn.restype = [ctypes.c_longlong], ctypes.c_int
    return fn(groups)


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
    for t, name in ((grad, "grad"), (ppre, "ppre")):
        _build.check_cuda_tensor(t, name, torch.float32, 3)
    _build.check_cuda_tensor(argmax, "argmax", torch.int32, 3)
    if grad.shape != (R, M, C3) or argmax.shape != grad.shape \
            or ppre.shape != grad.shape:
        raise ValueError(f"fused_sa's gradient, argmax and ppre must be "
                         f"{(R, M, C3)}")
    dval = torch.where(ppre > 0, grad, 0.0)
    db2 = dval.sum(dim=(0, 1))
    w1t = w1.t().contiguous()
    w2t = w2.t().contiguous()
    blocks = _bwd_blocks(R * M)
    d_pre = torch.zeros_like(pre)
    d_center = torch.empty_like(center)
    per = C1 * C2 + C3 * C2 + C2
    ws = torch.empty(blocks, per, dtype=torch.float32, device=pre.device)
    sums = torch.empty(per, dtype=torch.float32, device=pre.device)
    _build.launch("fused_sa_bwd", pre.data_ptr(), idx.data_ptr(),
                  center.data_ptr(), w1.data_ptr(), w1t.data_ptr(),
                  b1.data_ptr(), w2t.data_ptr(), dval.data_ptr(),
                  argmax.data_ptr(), R, N, M, S, C3, blocks,
                  d_pre.data_ptr(), d_center.data_ptr(), ws.data_ptr(),
                  sums.data_ptr())
    dw1 = sums[:C1 * C2].view(C1, C2)
    dw2 = sums[C1 * C2:C1 * C2 + C3 * C2].view(C3, C2).t()
    db1 = sums[C1 * C2 + C3 * C2:]
    return d_pre, d_center, dw1, db1, dw2, db2


class _FusedGatheredMLPPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pre, idx, center, w1, b1, w2, b2):
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
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (pre, center, w1, b1, w2, b2))
    if pre.device.type == "cpu":
        if grad:
            return fused_gathered_mlp_pool_train_plain(pre, idx, center, w1,
                                                       b1, w2, b2)[0]
        return fused_gathered_mlp_pool_plain(pre, idx, center, w1, b1, w2, b2)
    if grad:
        if w1.shape != (128, 128):
            raise ValueError(f"the fused_sa backward kernel takes C1 = C2 = "
                             f"128, got w1 {tuple(w1.shape)}")
        return _FusedGatheredMLPPool.apply(pre, idx, center, w1, b1, w2, b2)
    out = torch.empty(idx.shape[0], idx.shape[1], w2.shape[1],
                      dtype=torch.float32, device=pre.device)
    _launch_forward("fused_sa", pre, idx, center, w1, b1, w2, b2, out)
    return out
