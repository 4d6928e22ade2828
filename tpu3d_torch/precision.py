"""The eval numerics contract: where the forward rounds to bf16.

tpu3d evaluates under a bf16 activation contract on its accelerator and in
f32 on the CPU, and decides it in several places: the pre-grouped set
abstraction's casts and fused kernels
(``tpu3d/models/pointnet2.py:329-332``, ``:380-383``), the feature
propagation's source features (``:505-508``), the ROI pooling's hi/lo
table (``tpu3d/models/point_rcnn.py:108-109``), and the Dense compute
dtype of ``cfg.BF16_INFERENCE`` (``tpu3d/models/rpn.py:73-77``,
``tpu3d/models/rcnn.py:39-43``). The port decides it once, at its entry
points, into a ``Precision`` that the modules are handed; none of them reads
the device or the environment for itself.

The card plays the TPU's part: tensors on CUDA take the accelerator's
contract, tensors on the CPU tpu3d's CPU one (f32), so every CPU result is
the f32 one. ``TPU3D_F32_EVAL=1`` returns the card to f32, as it returns
tpu3d's TPU (``docs/PARITY.md``). ``BF16_INFERENCE`` puts every Dense in
bf16 on any device, as tpu3d's gate does not look at the backend. Training
stays f32 (the training half of the contract is not ported yet).

A bf16 product accumulates in f32, as the TPU's matrix unit does: the plain
version multiplies bf16-rounded f32 values in f32 and rounds the result; on
the card cuBLAS takes the bf16 operands with
``allow_bf16_reduced_precision_reduction`` off.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

_FALSY = {"", "0", "false", "no", "off"}


def env_flag(name: str) -> bool:
    """tpu3d's ``env_flag``: unset, "", "0", "false", "no" and "off" (any
    case) are off, anything else on."""
    return os.environ.get(name, "").strip().lower() not in _FALSY


@dataclass(frozen=True)
class Precision:
    """Where an eval forward rounds to bf16.

    ``sa_bf16``: the pre-grouped set abstraction casts its grouped
    pre-activations to bf16 (after the per-center subtraction in scene
    frames, before the gather in canonical ones) and the fused RCNN levels
    run their bf16 kernels. ``fp_bf16``: feature propagation casts its
    source features to bf16 and interpolates with bf16 weights.
    ``roi_bf16``: ROI pooling gathers one bf16 table whose coordinates ride
    along as a hi/lo pair. ``dense_dtype``: the compute dtype of every Dense
    (None: the inputs' promoted with the weights', f32 here)."""

    sa_bf16: bool = False
    fp_bf16: bool = False
    roi_bf16: bool = False
    dense_dtype: torch.dtype | None = None

    @property
    def is_f32(self) -> bool:
        return self == F32


F32 = Precision()


def resolve(device, cfg=None, train: bool = False) -> Precision:
    """The contract of a forward on ``device`` (a ``torch.device`` or its
    name; nothing is allocated) under ``cfg``: an eval on CUDA takes the
    accelerator's casts unless ``TPU3D_F32_EVAL`` is set; ``BF16_INFERENCE``
    adds bf16 Dense compute at eval on any device. Training is f32."""
    if train:
        return F32
    accel = (torch.device(device).type == "cuda"
             and not env_flag("TPU3D_F32_EVAL"))
    dense = (torch.bfloat16 if cfg is not None
             and bool(cfg.get("BF16_INFERENCE", False)) else None)
    return Precision(sa_bf16=accel, fp_bf16=accel, roi_bf16=accel,
                     dense_dtype=dense)


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
