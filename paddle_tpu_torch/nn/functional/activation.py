"""Activations the port's models call, on ``torch.Tensor``.

Port of ``paddle_tpu/nn/functional/activation.py`` (``relu`` :26,
``relu_`` :30, ``relu6`` :36, ``silu``, ``tanh``).  The reference leaves
them to XLA, the port to PyTorch.  ``relu`` is the reference's
``jnp.maximum(v, 0)`` and ``relu6`` its ``jnp.clip(v, 0, 6)``, so their
gradients at the ties are the reference's: ``torch.maximum`` and
``torch.minimum`` split the gradient evenly between equal operands, which
gives 0.5 at exactly 0 (and at exactly 6 for ``relu6``), where
``torch.relu`` and ``torch.clamp`` give 0 or 1.  None of these ops is on
an O1 list; at O2 their input is cast to the AMP dtype.
"""
from __future__ import annotations

import torch

from ... import amp

__all__ = ["relu", "relu_", "relu6", "silu", "tanh"]


def relu(x):
    """``max(x, 0)``, the gradient 0.5 at exactly 0."""
    (x,) = amp.cast_inputs("relu", x)
    return torch.maximum(x, x.new_zeros(()))


def relu_(x):
    """`relu` written into ``x``; returns ``x``."""
    return x.copy_(relu(x.clone()))


def relu6(x):
    """``min(max(x, 0), 6)``, the gradient 0.5 at exactly 0 and at
    exactly 6."""
    (x,) = amp.cast_inputs("relu6", x)
    return torch.minimum(torch.maximum(x, x.new_zeros(())),
                         x.new_full((), 6.0))


def silu(x):
    """``x * sigmoid(x)``."""
    (x,) = amp.cast_inputs("silu", x)
    return torch.nn.functional.silu(x)


def tanh(x):
    """``tanh(x)``."""
    (x,) = amp.cast_inputs("tanh", x)
    return torch.tanh(x)
