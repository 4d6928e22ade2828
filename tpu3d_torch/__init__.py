"""tpu3d_torch — the PyTorch/CUDA port of tpu3d for one NVIDIA H100.

The package imports ``torch`` and ``numpy`` and nothing of JAX or of
``tpu3d``: where it needs host code from there it keeps its own copy.
Entry points run on the card unless the caller passes ``device="cpu"``.
An eval and a train step on the card run tpu3d's bf16 numerics contracts,
the CPU float32 (``precision.py``); TF32 is switched off here for matrix
products and cuDNN convolutions alike: the geometry compares squared
distances of 0.01 m² on coordinates up to 70 m, and TF32 keeps about three
decimal digits.
"""

import torch

from .device import resolve_device

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve_device"]
