"""LeNet (BASELINE config #1's model).

Port of ``paddle_tpu/vision/models/lenet.py``: two convolutions with ReLU
and 2 x 2 max pooling, then three ``Linear``s with no activation between
them, as in the reference.  The ``Linear`` weights are ``[in, out]``.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import nn as pnn
from ...nn.layer.common import flatten
from ._common import layer_kwargs, name_parameters

__all__ = ["LeNet"]


class LeNet(nn.Module):
    def __init__(self, num_classes=10, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = layer_kwargs(device, dtype, generator)
        self.num_classes = num_classes
        self.features = pnn.Sequential(
            pnn.Conv2D(1, 6, 3, stride=1, padding=1, **kw),
            pnn.ReLU(),
            pnn.MaxPool2D(2, 2),
            pnn.Conv2D(6, 16, 5, stride=1, padding=0, **kw),
            pnn.ReLU(),
            pnn.MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = pnn.Sequential(
                pnn.Linear(400, 120, **kw),
                pnn.Linear(120, 84, **kw),
                pnn.Linear(84, num_classes, **kw),
            )
        name_parameters(self)

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1, -1))
        return x
