"""Device choice for the port's entry points."""

from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Under ``torchrun`` (``LOCAL_RANK`` set) a ``cuda`` without an
    index is this process's card, ``cuda:$LOCAL_RANK``. Raises when CUDA is
    asked for (or left as the default) and no card is present, or the local
    rank has no card of its own, so that nothing falls back to the CPU or
    to a shared card unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpu3d_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"local rank {local} has no card of its own: "
                f"{torch.cuda.device_count()} visible")
        dev = torch.device("cuda", local)
    return dev
