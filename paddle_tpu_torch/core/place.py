"""Device resolution for the port's entry points.

Port of ``paddle_tpu/core/place.py``.  The reference names JAX devices
through Paddle ``Place`` objects and defaults to the accelerator; the
port passes ``torch.device`` values explicitly.  An entry point given
``device=None`` runs on the card: it takes ``cuda`` and raises a clear
error when no CUDA device is present, and it never drops to the CPU
silently.  Passing ``device="cpu"`` asks for the plain PyTorch versions
of the kernels, which is how the tests run.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; ``"gpu"`` is an alias of ``cuda``.  Raises
    ``RuntimeError`` for a CUDA device this process cannot see."""
    if device is None:
        device = "cuda"
    if isinstance(device, str) and device.split(":")[0] == "gpu":
        device = "cuda" + device[3:]
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device by default, but "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "to run the plain PyTorch versions on the CPU")
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"CUDA device {index} requested, "
                f"{torch.cuda.device_count()} present")
        dev = torch.device("cuda", index)
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {device!r}: cuda or cpu")
    return dev
