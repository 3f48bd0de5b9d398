"""Convolutions, on ``torch.Tensor``.

Port of ``paddle_tpu/nn/functional/conv.py:21-108`` (``conv1d``,
``conv2d``, ``conv3d``).  The reference lowers them to
``lax.conv_general_dilated``, which XLA compiles; the port calls
``torch.nn.functional.conv{1,2,3}d`` (cuDNN on the card).  Weights are
Paddle's ``[out, in / groups, *kernel]``, as torch's.

Padding takes the reference's forms (``_norm_padding``, :27-42): an int,
one int a spatial dim, ``2 * n`` ints ``[lo0, hi0, lo1, hi1, ...]``, the
layout form ``[[0, 0], [0, 0], [lo, hi], ...]`` (or the pairs alone), and
``"SAME"`` / ``"VALID"`` (`norm_padding` says where the port reads the
layout form as the reference cannot).  torch's convolutions pad
symmetrically and refuse ``padding="same"`` with a stride over 1, so
asymmetric padding, and ``"SAME"`` (XLA's split: the odd element on the
high side), pad the input with zeros first.

The dtype rule is the reference's (:57-79): operands of different dtypes
are promoted to one, f16 is computed in f32 and cast back, and the bias
is added after the convolution.  The op names ``conv1d``/``conv2d``/
``conv3d`` are on the O1 white list.  The transposed convolutions are not
ported yet.
"""
from __future__ import annotations

import torch

from ... import amp

__all__ = ["conv1d", "conv2d", "conv3d"]

_CONV = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d,
         3: torch.nn.functional.conv3d}


def ntuple(v, n):
    """An int repeated ``n`` times, or a sequence of ints as a tuple."""
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(i) for i in v)


def norm_padding(padding, n, channels_last=False):
    """The reference's ``_norm_padding``: ``"SAME"``/``"VALID"``, or one
    ``(lo, hi)`` pair per spatial dim.  ``n`` ints pad both sides of each
    dim, ``2 * n`` ints are ``lo, hi`` pairs in turn, and a list of pairs
    is one a spatial dim or, with ``n + 2`` of them, one a dim of the
    layout (the batch's and the channels' dropped).  The reference reads
    ``2 * n`` entries as pairs in turn whatever they are, so it refuses
    the layout form in 2-D, and it drops the first two pairs of a
    channels-last layout, the channels' among the kept ones: the port
    reads the form as the layout gives it."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if all(isinstance(p, int) for p in padding):
        if len(padding) == n:
            return [(p, p) for p in padding]
        if len(padding) == 2 * n:
            return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
        raise ValueError(f"padding {padding}: {n} or {2 * n} ints")
    pairs = [tuple(int(v) for v in p) for p in padding]
    if len(pairs) == n + 2:
        pairs = pairs[1:-1] if channels_last else pairs[2:]
    if len(pairs) != n or any(len(p) != 2 for p in pairs):
        raise ValueError(f"padding {padding}: one (lo, hi) pair a "
                         f"spatial dim")
    return pairs


def same_pads(sizes, kernel, stride, dilation):
    """XLA's ``SAME`` padding (``lax.padtype_to_pads``): the output is
    ``ceil(size / stride)`` and the padding it needs is split with the odd
    element on the high side."""
    pads = []
    for size, k, s, d in zip(sizes, kernel, stride, dilation):
        out = -(-size // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def pad_spatial(x, pads, value=0.0):
    """``x`` (channels first) padded by ``(lo, hi)`` a spatial dim."""
    flat = [int(v) for lo_hi in reversed(pads) for v in lo_hi]
    return torch.nn.functional.pad(x, flat, value=value)


def channels_first(x, data_format):
    """``x`` with its channels at dim 1 (a view), and whether it had them
    last."""
    last = not data_format.startswith("NC")
    return (x.movedim(-1, 1) if last else x), last


def _conv(x, weight, bias, stride, padding, dilation, groups, data_format,
          nsp, op_name):
    x, weight, bias = amp.cast_inputs(op_name, x, weight, bias)
    stride, dilation = ntuple(stride, nsp), ntuple(dilation, nsp)
    x, last = channels_first(x, data_format)
    pads = norm_padding(padding, nsp, last)
    if pads == "VALID":
        pads = [(0, 0)] * nsp
    elif pads == "SAME":
        pads = same_pads(x.shape[2:], weight.shape[2:], stride, dilation)
    out_dtype = None
    if torch.float16 in (x.dtype, weight.dtype):
        out_dtype = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.float(), weight.float()
    elif x.dtype != weight.dtype:
        common = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.to(common), weight.to(common)
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        x, sym = pad_spatial(x, pads), 0
    out = _CONV[nsp](x, weight, None, stride, sym, dilation, int(groups))
    if out_dtype is not None:
        out = out.to(out_dtype)
    if bias is not None:
        out = out + bias.reshape((-1,) + (1,) * nsp)
    return out.movedim(1, -1) if last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """1-D convolution over ``[N, C, L]`` (``"NCL"``) or ``[N, L, C]``."""
    df = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    return _conv(x, weight, bias, stride, padding, dilation, groups, df, 1,
                 "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution over ``[N, C, H, W]`` (``"NCHW"``) or ``[N, H, W,
    C]``."""
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 2, "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    """3-D convolution over ``[N, C, D, H, W]`` (``"NCDHW"``) or ``[N, D,
    H, W, C]``."""
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 3, "conv3d")
