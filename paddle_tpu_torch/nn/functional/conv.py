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
``conv3d`` are on the O1 white list.

The transposed convolutions (:111-200, ``conv{1,2,3}d_transpose``, also
white-listed) take weights ``[in, out / groups, *kernel]``, torch's
layout too, with groups splitting the input channels.  The reference
convolves the stride-dilated input, padded by ``d·(k−1) − lo`` below and
``d·(k−1) − hi + output_padding`` above, with the flipped kernel, so its
output is the full transposed convolution (``(in − 1)·s + d·(k−1) + 1``
long) from ``lo`` to ``hi − output_padding`` before its end, zeros past
its end.  torch's ``conv_transpose`` pads symmetrically and bounds its
``output_padding`` by the stride, so the port passes it the padding
``min(lo, hi − output_padding)`` (0 when negative) and crops, or pads
with zeros, what is left by that formula; the bias is added after.
String padding raises ``NotImplementedError``: the reference hands it to
XLA with ``lhs_dilation``, which refuses it ("String padding is not
implemented for transposed convolution"), so it computes no size to
copy.  ``output_size`` is never read there: the port accepts it where it
equals the size it computes and raises ``NotImplementedError`` where it
differs.
"""
from __future__ import annotations

import torch

from ... import amp

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CONV = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d,
         3: torch.nn.functional.conv3d}
_CONV_T = {1: torch.nn.functional.conv_transpose1d,
           2: torch.nn.functional.conv_transpose2d,
           3: torch.nn.functional.conv_transpose3d}


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


def _operand_dtypes(x, weight):
    """The reference's dtype rule (:57-79): f16 operands computed in f32
    (the output's dtype returned, to cast back to), mixed operands
    promoted to one; else the output's dtype is None."""
    if torch.float16 in (x.dtype, weight.dtype):
        return x.float(), weight.float(), torch.promote_types(x.dtype,
                                                              weight.dtype)
    if x.dtype != weight.dtype:
        common = torch.promote_types(x.dtype, weight.dtype)
        return x.to(common), weight.to(common), None
    return x, weight, None


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
    x, weight, out_dtype = _operand_dtypes(x, weight)
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


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, data_format, nsp, output_size,
                    op_name):
    if isinstance(padding, str):
        raise NotImplementedError(
            f"{op_name} with padding {padding!r}: the reference passes "
            f"string padding to XLA with lhs_dilation, which refuses it, so "
            f"there is no size to copy")
    x, weight, bias = amp.cast_inputs(op_name, x, weight, bias)
    stride, dilation = ntuple(stride, nsp), ntuple(dilation, nsp)
    opad = ntuple(output_padding or 0, nsp)
    x, last = channels_first(x, data_format)
    pads = norm_padding(padding, nsp, last)
    kernel = weight.shape[2:]
    full = [(n - 1) * s + d * (k - 1) + 1 for n, s, d, k in
            zip(x.shape[2:], stride, dilation, kernel)]
    # the reference's output is full[lo : full - hi + opad]
    want = [(lo, f - hi + o) for (lo, hi), f, o in zip(pads, full, opad)]
    sizes = tuple(b - a for a, b in want)
    if output_size is not None and \
            tuple(ntuple(output_size, nsp)[-nsp:]) != sizes:
        raise NotImplementedError(
            f"{op_name}: output_size {output_size} differs from the size "
            f"{list(sizes)} the padding gives; the reference never reads "
            f"output_size")
    sym = tuple(max(min(lo, hi - o), 0) for (lo, hi), o in zip(pads, opad))
    x, weight, out_dtype = _operand_dtypes(x, weight)
    out = _CONV_T[nsp](x, weight, None, stride, sym, 0, int(groups),
                       dilation)
    # out is full[p : full - p]; crop to want, zeros past full's end
    for ax, ((a, b), p, f) in enumerate(zip(want, sym, full), start=2):
        out = out.narrow(ax, a - p, min(b, f - p) - a)
        if b > f - p:
            widths = [0, 0] * (out.dim() - 1 - ax) + [0, b - (f - p)]
            out = torch.nn.functional.pad(out, widths)
    if out_dtype is not None:
        out = out.to(out_dtype)
    if bias is not None:
        out = out + bias.reshape((-1,) + (1,) * nsp)
    return out.movedim(1, -1) if last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    """1-D transposed convolution over ``[N, C, L]`` or ``[N, L, C]``."""
    df = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, df, 1, output_size,
                           "conv1d_transpose")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    """2-D transposed convolution over ``[N, C, H, W]`` or ``[N, H, W,
    C]``."""
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 2, output_size,
                           "conv2d_transpose")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    """3-D transposed convolution over ``[N, C, D, H, W]`` or ``[N, D, H,
    W, C]``."""
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 3, output_size,
                           "conv3d_transpose")
