"""``Flatten`` and ``Sequential``: port of ``paddle_tpu/nn/layer/
common.py:126`` and the reference's ``Sequential``, whose children are
named ``0``, ``1``, ... as ``torch.nn.Sequential``'s are
(``features.0.weight``)."""
from __future__ import annotations

import torch
from torch import nn

from ... import amp

__all__ = ["Flatten", "Sequential", "flatten"]

Sequential = nn.Sequential


def flatten(x, start_axis=1, stop_axis=-1):
    """Dims ``start_axis`` to ``stop_axis`` joined into one (the op
    ``flatten``, on neither O1 list)."""
    (x,) = amp.cast_inputs("flatten", x)
    return torch.flatten(x, start_axis, stop_axis)


class Flatten(nn.Module):
    """`flatten` as a layer."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return flatten(x, self.start_axis, self.stop_axis)
