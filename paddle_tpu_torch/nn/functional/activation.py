"""Activations on ``torch.Tensor``: port of
``paddle_tpu/nn/functional/activation.py`` (every function of its
``__all__``).  The reference leaves them to XLA, the port to PyTorch.

Each function is the reference's formula op for op, with the reference's
argument names, defaults and ``axis`` conventions, and casts its inputs
through ``amp.cast_inputs`` under the op name the reference dispatches
(``hard_swish``, ``logsigmoid``, ``tanh_shrink``, ...), so that O1's
lists (``softmax`` and ``log_softmax`` are on the black list) and O2
treat it as the reference does.  Where the reference's clip or maximum
meets a tie, JAX splits the gradient between the equal operands:
``relu`` and ``relu6`` keep that (``torch.maximum``/``torch.minimum``
split it too); the others reach ties only on exact inputs.

Where the reference differs from PyTorch, the reference wins: ``gelu``
defaults to the exact form; ``hardsigmoid`` is ``clip(slope * x +
offset, 0, 1)`` with slope 0.1666667 (PyTorch: 1/6); ``rrelu`` is
``leaky_relu`` with the mean slope unless ``training=True`` (PyTorch's
functional defaults to ``training=False`` too, but draws nothing);
``prelu`` broadcasts its weight along the channel axis of
``data_format``; ``maxout`` takes ``groups`` and ``axis`` (a
non-negative axis: the reference's reshape breaks on a negative one).
The two random functions, ``rrelu`` in training and
``gumbel_softmax``, draw from ``generator`` (a ``torch.Generator``; the
global one when None): the reference's JAX key cannot be matched.
"""
from __future__ import annotations

import torch

from ... import amp

__all__ = [
    "relu", "relu_", "relu6", "gelu", "sigmoid", "silu", "swish", "mish",
    "hardswish", "hardsigmoid", "hardtanh", "leaky_relu", "elu", "elu_",
    "selu", "celu", "prelu", "rrelu", "softplus", "softshrink", "hardshrink",
    "softsign", "tanhshrink", "log_sigmoid", "log_softmax", "softmax",
    "softmax_", "glu", "gumbel_softmax", "maxout", "thresholded_relu",
    "tanh", "tanh_", "softmin",
]


def _inplace(x, y):
    """``y`` written into ``x`` (the reference's ``_inplace_update``);
    returns ``x``."""
    return x.copy_(y)


def relu(x, name=None):
    """``max(x, 0)``, the gradient 0.5 at exactly 0."""
    (x,) = amp.cast_inputs("relu", x)
    return torch.maximum(x, x.new_zeros(()))


def relu_(x, name=None):
    """`relu` written into ``x``; returns ``x``."""
    return _inplace(x, relu(x.clone()))


def relu6(x, name=None):
    """``min(max(x, 0), 6)``, the gradient 0.5 at exactly 0 and at
    exactly 6."""
    (x,) = amp.cast_inputs("relu6", x)
    return torch.minimum(torch.maximum(x, x.new_zeros(())),
                         x.new_full((), 6.0))


def gelu(x, approximate=False, name=None):
    """GELU, the exact erf form unless ``approximate`` (the tanh form)."""
    (x,) = amp.cast_inputs("gelu", x)
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def sigmoid(x, name=None):
    (x,) = amp.cast_inputs("sigmoid", x)
    return torch.sigmoid(x)


def silu(x, name=None):
    """``x * sigmoid(x)``."""
    (x,) = amp.cast_inputs("silu", x)
    return torch.nn.functional.silu(x)


def swish(x, name=None):
    """`silu`, as the reference's ``swish``."""
    return silu(x)


def mish(x, name=None):
    """``x * tanh(softplus(x))``."""
    (x,) = amp.cast_inputs("mish", x)
    return x * torch.tanh(torch.nn.functional.softplus(x))


def hardswish(x, name=None):
    """``x * clip(x + 3, 0, 6) / 6``."""
    (x,) = amp.cast_inputs("hard_swish", x)
    return x * torch.clamp(x + 3, 0, 6) / 6


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    """``clip(slope * x + offset, 0, 1)`` (slope 0.1666667, not 1/6)."""
    (x,) = amp.cast_inputs("hard_sigmoid", x)
    return torch.clamp(float(slope) * x + float(offset), 0, 1)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    (x,) = amp.cast_inputs("hard_tanh", x)
    return torch.clamp(x, float(min), float(max))


def leaky_relu(x, negative_slope=0.01, name=None):
    """``x`` where ``x >= 0``, else ``negative_slope * x``."""
    (x,) = amp.cast_inputs("leaky_relu", x)
    return torch.where(x >= 0, x, float(negative_slope) * x)


def elu(x, alpha=1.0, name=None):
    """``x`` where ``x > 0``, else ``alpha * expm1(x)``."""
    (x,) = amp.cast_inputs("elu", x)
    return torch.where(x > 0, x, float(alpha) * torch.expm1(x))


def elu_(x, alpha=1.0, name=None):
    """`elu` written into ``x``; returns ``x``."""
    return _inplace(x, elu(x.clone(), alpha))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    """``scale * (x where x > 0, else alpha * expm1(x))``."""
    (x,) = amp.cast_inputs("selu", x)
    return float(scale) * torch.where(x > 0, x,
                                      float(alpha) * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    """``x`` where ``x > 0``, else ``alpha * expm1(x / alpha)``."""
    (x,) = amp.cast_inputs("celu", x)
    a = float(alpha)
    return torch.where(x > 0, x, a * torch.expm1(x / a))


def prelu(x, weight, data_format="NCHW", name=None):
    """``x`` where ``x >= 0``, else ``weight * x``: one weight for every
    value, or one a channel along dim 1 (``"NCHW"``-like formats) or the
    last dim (the others; dim 0 for inputs of at most one dim)."""
    x, weight = amp.cast_inputs("prelu", x, weight)
    cdim = 1 if data_format == "NCHW" else x.dim() - 1
    if x.dim() <= 1:
        cdim = 0
    if weight.numel() == 1:
        wb = weight.reshape(())
    else:
        shape = [1] * x.dim()
        shape[cdim] = weight.numel()
        wb = weight.reshape(shape)
    return torch.where(x >= 0, x, wb * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None,
          generator=None):
    """Randomized leaky relu.  Not training: `leaky_relu` with the slope
    ``(lower + upper) / 2``.  Training: a slope per value drawn uniform
    in ``[lower, upper)`` from ``generator``."""
    if not training:
        return leaky_relu(x, (lower + upper) / 2.0)
    (x,) = amp.cast_inputs("rrelu", x)
    a = torch.rand(x.shape, generator=generator, device=x.device,
                   dtype=x.dtype) * (float(upper) - float(lower)) \
        + float(lower)
    return torch.where(x >= 0, x, a * x)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """``x`` where ``beta * x > threshold``, else ``softplus(beta * x) /
    beta`` (``softplus(u) = log(1 + exp(u))``)."""
    (x,) = amp.cast_inputs("softplus", x)
    b = float(beta)
    return torch.where(b * x > float(threshold), x,
                       torch.logaddexp(b * x, x.new_zeros(())) / b)


def softshrink(x, threshold=0.5, name=None):
    (x,) = amp.cast_inputs("softshrink", x)
    t = float(threshold)
    return torch.where(x > t, x - t,
                       torch.where(x < -t, x + t, x.new_zeros(())))


def hardshrink(x, threshold=0.5, name=None):
    (x,) = amp.cast_inputs("hard_shrink", x)
    return torch.where(x.abs() > float(threshold), x, x.new_zeros(()))


def softsign(x, name=None):
    """``x / (1 + |x|)``."""
    (x,) = amp.cast_inputs("softsign", x)
    return x / (x.abs() + 1)


def tanhshrink(x, name=None):
    """``x - tanh(x)``."""
    (x,) = amp.cast_inputs("tanh_shrink", x)
    return x - torch.tanh(x)


def tanh(x, name=None):
    """``tanh(x)``."""
    (x,) = amp.cast_inputs("tanh", x)
    return torch.tanh(x)


def tanh_(x, name=None):
    """`tanh` written into ``x``; returns ``x``."""
    return _inplace(x, tanh(x.clone()))


def log_sigmoid(x, name=None):
    """``log(sigmoid(x)) = -softplus(-x)``."""
    (x,) = amp.cast_inputs("logsigmoid", x)
    return torch.nn.functional.logsigmoid(x)


def _as(x, dtype):
    if dtype is None:
        return x
    from ...core import to_torch_dtype
    return x.to(to_torch_dtype(dtype))


def log_softmax(x, axis=-1, dtype=None, name=None):
    """``log(softmax(x))`` over ``axis``, ``x`` first cast to ``dtype``
    when given (before the AMP rule, as the reference casts)."""
    (x,) = amp.cast_inputs("log_softmax", _as(x, dtype))
    return torch.log_softmax(x, dim=int(axis))


def softmax(x, axis=-1, dtype=None, name=None):
    """``exp(x) / sum(exp(x))`` over ``axis``, ``x`` first cast to
    ``dtype`` when given."""
    (x,) = amp.cast_inputs("softmax", _as(x, dtype))
    return torch.softmax(x, dim=int(axis))


def softmax_(x, axis=-1, dtype=None, name=None):
    """`softmax` written into ``x``; returns ``x``."""
    return _inplace(x, softmax(x.clone(), axis, dtype))


def glu(x, axis=-1, name=None):
    """``a * sigmoid(b)`` for the two halves ``a``, ``b`` of ``axis``."""
    (x,) = amp.cast_inputs("glu", x)
    return torch.nn.functional.glu(x, dim=int(axis))


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None,
                   generator=None):
    """``softmax((x + g) / temperature)`` over ``axis`` with standard
    Gumbel noise ``g`` drawn from ``generator``; with ``hard`` the
    one-hot of its argmax in the forward and the soft values' gradient
    (``one_hot - stop_gradient(y) + y``, the reference's order)."""
    (x,) = amp.cast_inputs("gumbel_softmax", x)
    axis = int(axis)
    u = torch.rand(x.shape, generator=generator, device=x.device,
                   dtype=x.dtype)
    tiny = torch.finfo(x.dtype).tiny
    g = -torch.log(-torch.log(u.clamp_min(tiny)))
    y = torch.softmax((x + g) / float(temperature), dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        hard_y = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = hard_y + (-y).detach() + y
    return y


def maxout(x, groups, axis=1, name=None):
    """The largest of each ``groups`` consecutive values of ``axis``: dim
    ``axis`` of ``C`` values becomes ``C / groups``."""
    (x,) = amp.cast_inputs("maxout", x)
    groups, axis = int(groups), int(axis)
    if axis < 0:
        raise ValueError(f"maxout takes a non-negative axis, got {axis} "
                         f"(the reference's reshape needs one)")
    c = x.shape[axis]
    shape = (*x.shape[:axis], c // groups, groups, *x.shape[axis + 1:])
    return x.reshape(shape).amax(dim=axis + 1)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    """``x`` where ``x > threshold``, else ``value``."""
    (x,) = amp.cast_inputs("thresholded_relu", x)
    return torch.where(x > float(threshold), x, x.new_full((), float(value)))


def softmin(x, axis=-1, name=None):
    """``softmax(-x)`` over ``axis``."""
    (x,) = amp.cast_inputs("softmin", x)
    return torch.softmax(-x, dim=int(axis))
