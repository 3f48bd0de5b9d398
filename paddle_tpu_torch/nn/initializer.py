"""Weight initializers.

Port of ``paddle_tpu/nn/initializer/__init__.py:27-219``:
``calculate_gain``, the fans, ``Constant``, ``Normal``,
``TruncatedNormal``, ``Uniform``, ``XavierNormal``, ``XavierUniform``,
``KaimingNormal``, ``KaimingUniform``, ``Assign``, ``Orthogonal``,
``Dirac`` and ``set_global_initializer``.  Calling one on a tensor
fills it in place, from the ``torch.Generator`` given (the global one
when None), and returns it.
As in the reference, random values are drawn in f32 and cast to the
tensor's type.  The two packages' generators differ, so the port draws
other values than the reference from the same seed; the distributions are
the same.  ``Assign`` and ``Dirac`` draw nothing and give the reference's
values exactly.  ``TruncatedNormal`` is the reference's ``mean + std *
z`` with ``z`` a standard normal truncated to ``[a, b]`` (so ``a`` and
``b`` are in units of ``std``, where ``torch.nn.init.trunc_normal_``
truncates the output itself).  The reference stores the initializers of
``set_global_initializer`` and never reads them: the port raises
``NotImplementedError`` when given one, and ``set_global_initializer(None)``
does nothing.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal",
           "KaimingUniform", "Assign", "Orthogonal", "Dirac",
           "set_global_initializer", "calculate_gain", "fans"]


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


class TruncatedNormal(Initializer):
    """``mean + std * z``, ``z`` a standard normal truncated to ``[a,
    b]``."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def draw(self, vals, generator):
        torch.nn.init.trunc_normal_(vals, 0.0, 1.0, self.a, self.b,
                                    generator=generator)
        vals.mul_(self.std).add_(self.mean)


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


class Assign(Initializer):
    """The given value (an array, a list or a tensor), reshaped to the
    parameter's shape."""

    def __init__(self, value, name=None):
        self.value = value

    def __call__(self, param, generator=None):
        v = self.value
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        with torch.no_grad():
            param.copy_(torch.as_tensor(np.asarray(v)).reshape(param.shape))
        return param


class Orthogonal(Initializer):
    """``gain`` times the Q of a QR of a ``(max(rows, cols), min(rows,
    cols))`` normal draw with its signs fixed by R's diagonal, transposed
    when rows < cols; ``cols`` is the product of the other dims."""

    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def draw(self, vals, generator):
        rows = vals.shape[0]
        cols = math.prod(vals.shape[1:]) if vals.dim() > 1 else 1
        flat = torch.empty((max(rows, cols), min(rows, cols)),
                           dtype=torch.float32, device=vals.device)
        flat.normal_(0.0, 1.0, generator=generator)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        vals.copy_(self.gain * q[:rows, :cols].reshape(vals.shape))


class Dirac(Initializer):
    """Ones at the kernel's centre from input channel ``i`` to output
    channel ``g * out / groups + i`` of each group, zeros elsewhere."""

    def __init__(self, groups=1, name=None):
        self.groups = groups

    def draw(self, vals, generator):
        vals.zero_()
        oc, ic = vals.shape[:2]
        centers = tuple(s // 2 for s in vals.shape[2:])
        per = oc // self.groups
        for g in range(self.groups):
            for i in range(min(per, ic)):
                vals[(g * per + i, i) + centers] = 1.0


def set_global_initializer(weight_init, bias_init=None):
    """Refused when given an initializer: the reference stores it and no
    layer ever reads it.  ``None`` for both does nothing."""
    if weight_init is not None or bias_init is not None:
        raise NotImplementedError(
            "set_global_initializer: the reference stores the initializers "
            "and never applies them, so the port refuses them rather than "
            "pick either behaviour")
