"""The numerics contract: where a forward, at eval or in training, rounds
to bf16.

tpu3d runs under a bf16 activation contract on its accelerator and in f32
on the CPU, and decides it in several places: the pre-grouped set
abstraction's casts and fused kernels
(``tpu3d/models/pointnet2.py:329-332``, ``:380-383``), the feature
propagation's source features (``:505-508``), the ROI pooling's hi/lo
table (``tpu3d/models/point_rcnn.py:108-109``, in training
``tpu3d/models/proposal_target.py:282-283``), the Dense compute dtype of
``cfg.BF16_INFERENCE`` at eval and of ``cfg.TRAIN.BF16_MATMULS`` in
training (``tpu3d/models/rpn.py:70-81``, ``tpu3d/models/rcnn.py:36-45``),
with the heads and the scene-frame pre-grouped layer 0 kept in f32 in
training (``head_dt``; ``first_f32``, ``pointnet2.py:321-323``), and the
bf16 backward routes of the gathers, which ``cfg.TRAIN.BF16_ACTIVATIONS``
allows in training (``exact = not allow_bf16``, ``pointnet2.py:360-363``).
The port decides it once, at its entry points, into a ``Precision`` that
the modules are handed; none of them reads the device or the environment
for itself.

The card plays the TPU's part: tensors on CUDA take the accelerator's
contract, tensors on the CPU tpu3d's CPU one (f32), so every CPU result is
the f32 one. At eval ``TPU3D_F32_EVAL=1`` returns the card to f32, as it
returns tpu3d's TPU (``docs/PARITY.md``), and ``BF16_INFERENCE`` puts every
Dense in bf16 on any device, as tpu3d's gate does not look at the backend.
In training the two keys ``TRAIN.BF16_ACTIVATIONS`` and
``TRAIN.BF16_MATMULS`` (both True by default, as in tpu3d) each turn on
their half on the card; both False is the f32 contract.

A bf16 product accumulates in f32, as the TPU's matrix unit does: the plain
version multiplies bf16-rounded f32 values in f32 and rounds the result; on
the card cuBLAS takes the bf16 operands with
``allow_bf16_reduced_precision_reduction`` off.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from .config.config import train_numerics

_FALSY = {"", "0", "false", "no", "off"}


def env_flag(name: str) -> bool:
    """tpu3d's ``env_flag``: unset, "", "0", "false", "no" and "off" (any
    case) are off, anything else on."""
    return os.environ.get(name, "").strip().lower() not in _FALSY


@dataclass(frozen=True)
class Precision:
    """Where a forward rounds to bf16.

    ``sa_bf16``: the pre-grouped set abstraction casts its grouped
    pre-activations to bf16 (after the per-center subtraction in scene
    frames, before the gather in canonical ones) and the fused RCNN levels
    run their bf16 kernels; in training it also allows the gathers' bf16
    backward routes (tpu3d's ``allow_bf16``). ``fp_bf16``: feature
    propagation casts its source features to bf16. ``roi_bf16``: ROI
    pooling (the proposal target's in training) gathers one bf16 table
    whose coordinates ride along as a hi/lo pair. ``dense_dtype``: the
    compute dtype of every Dense of the backbones (None: the inputs'
    promoted with the weights', f32 here). ``head_dtype``: the heads'
    (f32 in training, where tpu3d's ``head_dt`` is None). ``first_f32``:
    the scene-frame pre-grouped layer 0 computes in the promoted dtype
    whatever ``dense_dtype`` says (tpu3d's ``first_f32``, training only).
    ``accel``: the card plays the TPU, so bf16 source features take the
    TPU's interpolation routes, which round the weights. ``fixed_rpn``: in
    training, the eval contract under which a fixed RPN (``RPN.FIXED``)
    runs its eval forward, as tpu3d's training step runs it (None: f32)."""

    sa_bf16: bool = False
    fp_bf16: bool = False
    roi_bf16: bool = False
    dense_dtype: torch.dtype | None = None
    head_dtype: torch.dtype | None = None
    first_f32: bool = False
    accel: bool = False
    fixed_rpn: "Precision | None" = None

    @property
    def is_f32(self) -> bool:
        return self == F32


F32 = Precision()


def resolve(device, cfg=None, train: bool = False) -> Precision:
    """The contract of a forward on ``device`` (a ``torch.device`` or its
    name; nothing is allocated) under ``cfg``.

    At eval: on CUDA the accelerator's casts unless ``TPU3D_F32_EVAL`` is
    set; ``BF16_INFERENCE`` adds bf16 Dense compute on any device (the
    heads too). In training, on CUDA, each of the two keys as tpu3d's gates
    read it (``config.train_numerics``): ``TRAIN.BF16_ACTIVATIONS`` the SA,
    FP and ROI casts and the bf16 backward routes, ``TRAIN.BF16_MATMULS``
    bf16 Dense compute but for the heads and the scene-frame pre-grouped
    layer 0; ``BF16_INFERENCE`` is not read but by a fixed RPN, which
    runs its eval forward under the eval contract (``fixed_rpn``). On the
    CPU training is f32, as tpu3d trains on its CPU. ``TRAIN.REMAT`` raises: the recomputed
    backbone is not ported."""
    cuda = torch.device(device).type == "cuda"
    if train:
        act, mat = train_numerics(cfg)
        act, mat = cuda and act, cuda and mat
        dense = torch.bfloat16 if mat else None
        fixed = resolve(device, cfg)
        return Precision(sa_bf16=act, fp_bf16=act, roi_bf16=act,
                         dense_dtype=dense, first_f32=mat,
                         accel=act or mat,
                         fixed_rpn=None if fixed == F32 else fixed)
    accel = cuda and not env_flag("TPU3D_F32_EVAL")
    dense = (torch.bfloat16 if cfg is not None
             and bool(cfg.get("BF16_INFERENCE", False)) else None)
    return Precision(sa_bf16=accel, fp_bf16=accel, roi_bf16=accel,
                     dense_dtype=dense, head_dtype=dense, accel=accel)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None, dtype: torch.dtype | None = None
           ) -> torch.Tensor:
    """flax's ``Dense(dtype)``: with ``dtype`` None the inputs promoted with
    the weights' dtype (a bf16 input into an f32 layer computes in f32);
    with bf16 the product of the bf16 inputs and weights, summed in f32 and
    rounded, then the bias added in bf16."""
    if dtype is None:
        x = x.to(torch.promote_types(x.dtype, weight.dtype))
        return torch.nn.functional.linear(x, weight, bias)
    if dtype != torch.bfloat16:
        raise ValueError(f"Dense compute dtype {dtype} is not bf16 or None")
    xb, wb = x.to(torch.bfloat16), weight.to(torch.bfloat16)
    if x.device.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        y = torch.nn.functional.linear(xb, wb)
    else:
        y = (xb.float() @ wb.float().T).to(torch.bfloat16)
    if bias is not None:
        y = y + bias.to(torch.bfloat16)
    return y


def promote_f32(x: torch.Tensor) -> torch.Tensor:
    """x promoted with f32 (bf16 -> f32; f32 and f64 stay), as tpu3d
    promotes its heads' and backbone's outputs."""
    return x.to(torch.promote_types(x.dtype, torch.float32))
