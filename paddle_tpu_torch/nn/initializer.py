"""Weight initializers.

Port of ``paddle_tpu/nn/initializer/__init__.py:27-166``:
``calculate_gain``, the fans, ``Constant``, ``Normal``, ``Uniform``,
``XavierNormal``, ``XavierUniform``, ``KaimingNormal`` and
``KaimingUniform``.  Calling one on a tensor fills it in place, from the
``torch.Generator`` given (the global one when None), and returns it.
As in the reference, random values are drawn in f32 and cast to the
tensor's type.  The two packages' generators differ, so the port draws
other values than the reference from the same seed; the distributions are
the same.
"""
from __future__ import annotations

import math

import torch

__all__ = ["Initializer", "Constant", "Normal", "Uniform", "XavierNormal",
           "XavierUniform", "KaimingNormal", "KaimingUniform",
           "calculate_gain", "fans"]


def fans(shape):
    """``(fan_in, fan_out)`` of a parameter shape, the reference's
    ``_fans``: a matrix is ``[in, out]`` (Paddle's Linear), a convolution
    weight ``[out, in, *kernel]`` with the kernel's size as the receptive
    field."""
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    return 1.0


class Initializer:
    def draw(self, vals, generator):
        """Fill ``vals`` (f32, the parameter's shape) in place."""
        raise NotImplementedError

    def __call__(self, param, generator=None):
        with torch.no_grad():
            vals = torch.empty(param.shape, dtype=torch.float32,
                               device=param.device)
            self.draw(vals, generator)
            param.copy_(vals)
        return param


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def draw(self, vals, generator):
        vals.fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def draw(self, vals, generator):
        vals.normal_(self.mean, self.std, generator=generator)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def draw(self, vals, generator):
        vals.uniform_(self.low, self.high, generator=generator)


class _Xavier(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fans(self, shape):
        fi, fo = fans(shape)
        return (self.fan_in if self.fan_in is not None else fi,
                self.fan_out if self.fan_out is not None else fo)


class XavierNormal(_Xavier):
    """N(0, gain * sqrt(2 / (fan_in + fan_out)))."""

    def draw(self, vals, generator):
        fi, fo = self._fans(vals.shape)
        vals.normal_(0.0, self.gain * math.sqrt(2.0 / (fi + fo)),
                     generator=generator)


class XavierUniform(_Xavier):
    """U(-limit, limit), limit = gain * sqrt(6 / (fan_in + fan_out))."""

    def draw(self, vals, generator):
        fi, fo = self._fans(vals.shape)
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        vals.uniform_(-limit, limit, generator=generator)


class _Kaiming(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu", name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _scale(self, shape):
        """gain / sqrt(fan_in); the gain reads ``negative_slope`` only for
        ``nonlinearity="leaky_relu"``, as in the reference."""
        fi = self.fan_in if self.fan_in is not None else fans(shape)[0]
        return calculate_gain(self.nonlinearity,
                              self.negative_slope) / math.sqrt(fi)


class KaimingNormal(_Kaiming):
    """N(0, gain / sqrt(fan_in))."""

    def draw(self, vals, generator):
        vals.normal_(0.0, self._scale(vals.shape), generator=generator)


class KaimingUniform(_Kaiming):
    """U(-limit, limit), limit = gain * sqrt(3 / fan_in)."""

    def draw(self, vals, generator):
        limit = self._scale(vals.shape) * math.sqrt(3.0)
        vals.uniform_(-limit, limit, generator=generator)
