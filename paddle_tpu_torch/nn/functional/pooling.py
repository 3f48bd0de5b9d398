"""Pooling, on ``torch.Tensor``.

Port of ``paddle_tpu/nn/functional/pooling.py:23-365``: ``avg_pool``,
``max_pool``, ``adaptive_avg_pool`` and ``adaptive_max_pool`` in 1, 2 and
3 spatial dims, channels first or last.  The reference reduces windows
with ``lax.reduce_window``; the port calls
``torch.nn.functional``'s pools.

* Padding takes the convolutions' forms, ``"SAME"`` (XLA's split) and
  ``"VALID"`` included.  Max pooling pads with -inf, average pooling with
  zeros.  torch pads only symmetrically, by at most half the window, so
  other padding is applied to the input first.
* Average pooling divides each window's sum by the window's size, but by
  the number of input elements it holds when ``exclusive`` and the padding
  is not 0, and always under ``"SAME"`` (the reference's :67-85);
  ``divisor_override`` divides the sum (padding counted as zeros) by the
  given number instead, and refuses string padding, as the reference
  does (:92-100).
* Adaptive pooling's windows run from ``floor(i * in / out)`` to ``ceil((i
  + 1) * in / out)`` (:236-269), torch's windows too; channels-last input
  is pooled channels first (:272-281).  Adaptive max pooling is the
  reference's, one spatial dim at a time with ``torch.amax``, whose
  gradient is shared evenly among tied maxima as ``jnp.max``'s is (torch's
  adaptive max pool gives it all to one).

The reference accepts ``ceil_mode`` and ignores it (its ``_pool`` never
reads the flag), so ``max_pool2d(2, 2, ceil_mode=True)`` on a 5 x 5 input
gives 2 x 2 there where torch gives 3 x 3: the port raises
``NotImplementedError`` for ``ceil_mode=True`` rather than pick either.
``return_mask=True`` and ``max_unpool*d`` are not ported yet and raise.
None of these ops is on an O1 list; at O2 their input is cast to the AMP
dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ... import amp
from .conv import channels_first, norm_padding, ntuple, pad_spatial, \
    same_pads

__all__ = ["avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d",
           "max_pool2d", "max_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d", "max_unpool1d", "max_unpool2d",
           "max_unpool3d"]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}
_ADAPTIVE_AVG = {1: TF.adaptive_avg_pool1d, 2: TF.adaptive_avg_pool2d,
                 3: TF.adaptive_avg_pool3d}


def _not_ported(what):
    raise NotImplementedError(f"{what} is not ported yet")


def _pool(x, kind, kernel, stride, padding, ceil_mode, exclusive, nsp,
          data_format, op_name, divisor=None):
    if ceil_mode:
        raise NotImplementedError(
            "ceil_mode=True: the reference accepts the flag and ignores it "
            "(its windows are always floored), so the port refuses it")
    if divisor is not None and isinstance(padding, str):
        raise NotImplementedError(
            "divisor_override with string padding is not supported")
    (x,) = amp.cast_inputs(op_name, x)
    kernel = ntuple(kernel, nsp)
    stride = ntuple(stride if stride is not None else kernel, nsp)
    x, last = channels_first(x, data_format)
    pads = norm_padding(padding, nsp, last)
    same = pads == "SAME"
    if pads == "VALID":
        pads = [(0, 0)] * nsp
    elif same:
        pads = same_pads(x.shape[2:], kernel, stride, (1,) * nsp)
    # torch's own padding: symmetric, at most half the window
    native = all(lo == hi and 2 * lo <= k
                 for (lo, hi), k in zip(pads, kernel))
    sym = tuple(lo for lo, _ in pads) if native else 0
    if kind == "max":
        if not native:
            x = pad_spatial(x, pads, -math.inf)
        out = _MAX[nsp](x, kernel, stride, sym)
    else:
        by_count = divisor is None and (same or exclusive) \
            and any(lo or hi for lo, hi in pads)
        extra = {} if divisor is None \
            else {"divisor_override": int(divisor)}
        if native:
            out = _AVG[nsp](x, kernel, stride, sym,
                            count_include_pad=not by_count, **extra)
        else:
            out = _AVG[nsp](pad_spatial(x, pads), kernel, stride, **extra)
            if by_count:    # the share of each window inside the input
                ones = x.new_ones((1, 1) + tuple(x.shape[2:]),
                                  dtype=torch.float32)
                share = _AVG[nsp](pad_spatial(ones, pads), kernel, stride)
                out = (out.float() / share).to(out.dtype)
    return out.movedim(1, -1) if last else out


def _df1(data_format):
    return "NCW" if data_format in ("NCL", "NCW") else "NWC"


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, "avg", kernel_size, stride, padding, ceil_mode,
                 exclusive, 1, _df1(data_format), "avg_pool1d")


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, "avg", kernel_size, stride, padding, ceil_mode,
                 exclusive, 2, data_format, "avg_pool2d", divisor_override)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, "avg", kernel_size, stride, padding, ceil_mode,
                 exclusive, 3, data_format, "avg_pool3d", divisor_override)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    if return_mask:
        _not_ported("max_pool1d(return_mask=True)")
    return _pool(x, "max", kernel_size, stride, padding, ceil_mode, True, 1,
                 _df1(data_format), "max_pool1d")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask:
        _not_ported("max_pool2d(return_mask=True)")
    return _pool(x, "max", kernel_size, stride, padding, ceil_mode, True, 2,
                 data_format, "max_pool2d")


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    if return_mask:
        _not_ported("max_pool3d(return_mask=True)")
    return _pool(x, "max", kernel_size, stride, padding, ceil_mode, True, 3,
                 data_format, "max_pool3d")


def _adaptive_max(x, output_size):
    """The reference's adaptive max (:236-269), one spatial dim at a
    time: a reshape where the output divides the input, else a slice a
    window."""
    for ax, n_out in enumerate(output_size, start=2):
        n_in = x.shape[ax]
        if n_in == n_out:
            continue
        if n_in % n_out == 0:
            x = x.unflatten(ax, (n_out, n_in // n_out)).amax(ax + 1)
        else:
            starts = [i * n_in // n_out for i in range(n_out)]
            ends = [-(-(i + 1) * n_in // n_out) for i in range(n_out)]
            x = torch.cat([x.narrow(ax, a, b - a).amax(ax, keepdim=True)
                           for a, b in zip(starts, ends)], ax)
    return x


def _adaptive(x, output_size, kind, nsp, data_format, op_name):
    (x,) = amp.cast_inputs(op_name, x)
    x, last = channels_first(x, data_format)
    size = ntuple(output_size, nsp)
    out = _adaptive_max(x, size) if kind == "max" \
        else _ADAPTIVE_AVG[nsp](x, size)
    return out.movedim(1, -1) if last else out


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, "avg", 1, "NCW", "adaptive_avg_pool1d")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, "avg", 2, data_format,
                     "adaptive_avg_pool2d")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, "avg", 3, data_format,
                     "adaptive_avg_pool3d")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    if return_mask:
        _not_ported("adaptive_max_pool1d(return_mask=True)")
    return _adaptive(x, output_size, "max", 1, "NCW", "adaptive_max_pool1d")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    if return_mask:
        _not_ported("adaptive_max_pool2d(return_mask=True)")
    return _adaptive(x, output_size, "max", 2, "NCHW", "adaptive_max_pool2d")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    if return_mask:
        _not_ported("adaptive_max_pool3d(return_mask=True)")
    return _adaptive(x, output_size, "max", 3, "NCDHW",
                     "adaptive_max_pool3d")


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    _not_ported("max_unpool1d")


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    _not_ported("max_unpool2d")


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    _not_ported("max_unpool3d")
