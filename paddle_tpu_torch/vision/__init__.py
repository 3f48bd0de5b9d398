"""paddle.vision: the ported models (``models``).

Port of ``paddle_tpu/vision``: LeNet, the ResNet family, VGG and
MobileNetV2 so far; ``small_nets``, ``densenet_googlenet``,
``transforms``, ``datasets`` and ``ops`` are not ported yet.
"""
from . import models
from .models import (LeNet, ResNet, resnet18, resnet34, resnet50, resnet101,
                     resnet152)

__all__ = ["models", "LeNet", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152"]
