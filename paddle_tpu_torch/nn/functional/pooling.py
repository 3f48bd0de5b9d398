"""Pooling, on ``torch.Tensor``.

Port of ``paddle_tpu/nn/functional/pooling.py:23-450``: ``avg_pool``,
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

* ``ceil_mode`` is accepted and ignored, as in the reference (its
  ``_pool`` never reads the flag): windows are always floored, so
  ``max_pool2d(2, 2, ceil_mode=True)`` on a 5 x 5 input gives 2 x 2 where
  torch's ceil would give 3 x 3, and SqueezeNet's and GoogLeNet's feature
  maps (which pass ``ceil_mode=True``) have the reference's sizes: loaded
  weights compute the same function.
* ``return_mask=True`` (:134-233, :302-368) returns with the pooled
  values the flat index of each window's first maximum (numpy's
  ``argmax`` tie rule, which ``torch.argmax`` shares) in the unpadded
  input's spatial coordinates, computed on the input's device.  Fixed
  windows take one padding a spatial dim (string padding counts as 0, as
  there) and are floored; the reference reads every 2-D input as NCHW
  whatever its ``data_format`` (:211-219), so a 2-D channels-last input
  raises here, as a 1-D channels-last one does there; 3-D channels-last
  is permuted around the call, as there.
* ``max_unpool1d/2d/3d`` (:370-450) scatter the values back to the
  positions a mask records, into ``output_size`` (its last spatial dims)
  or else the size ``(in - 1) * stride - 2 * padding + kernel``; an index
  past that size raises ``ValueError`` (the one host read of these ops).
  The reference's 1-D unpool reads its input as NCL whatever its
  ``data_format``: the port raises for ``"NLC"``.

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


def _pool(x, kind, kernel, stride, padding, ceil_mode, exclusive, nsp,
          data_format, op_name, divisor=None):
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


def _mask_pads(padding, nsp):
    """The mask's padding, the reference's ``_norm(padding, n)``: one
    value a spatial dim, both sides; string padding counts as 0."""
    if isinstance(padding, str):
        return (0,) * nsp
    pads = ntuple(padding, nsp)
    if len(pads) != nsp:
        raise NotImplementedError(
            f"return_mask=True with padding {padding}: the mask takes one "
            f"padding a spatial dim")
    return pads


def _window_argmax(x, kernel, stride, pads):
    """The flat input index of each floored window's first maximum over
    ``x`` (channels first), in unpadded coordinates, int64."""
    nsp = len(kernel)
    xp = pad_spatial(x, [(p, p) for p in pads], -math.inf)
    for ax, (k, s) in enumerate(zip(kernel, stride), start=2):
        xp = xp.unfold(ax, k, s)
    out_shape = xp.shape[:2 + nsp]
    loc = xp.reshape(out_shape + (-1,)).argmax(-1)
    sizes = x.shape[2:]
    flat = torch.zeros_like(loc)
    for d in range(nsp):
        inner = math.prod(kernel[d + 1:])
        local = loc // inner % kernel[d]
        start = torch.arange(out_shape[2 + d], device=x.device) * stride[d]
        start = start.reshape((-1,) + (1,) * (nsp - 1 - d))
        flat = flat * sizes[d] + start + local - pads[d]
    return flat


def _max_mask(x, kernel_size, stride, padding, nsp):
    kernel = ntuple(kernel_size, nsp)
    stride = ntuple(stride if stride is not None else kernel, nsp)
    return _window_argmax(x, kernel, stride, _mask_pads(padding, nsp))


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    out = _pool(x, "max", kernel_size, stride, padding, ceil_mode, True, 1,
                _df1(data_format), "max_pool1d")
    if not return_mask:
        return out
    if data_format != "NCL":
        raise NotImplementedError(
            "max_pool1d(return_mask=True) takes NCL only, as the reference")
    return out, _max_mask(x, kernel_size, stride, padding, 1)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    out = _pool(x, "max", kernel_size, stride, padding, ceil_mode, True, 2,
                data_format, "max_pool2d")
    if not return_mask:
        return out
    if data_format != "NCHW":
        raise NotImplementedError(
            f"max_pool2d(return_mask=True) with {data_format}: the "
            f"reference's mask reads every input as NCHW, so a "
            f"channels-last mask is refused rather than copied")
    return out, _max_mask(x, kernel_size, stride, padding, 2)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    out = _pool(x, "max", kernel_size, stride, padding, ceil_mode, True, 3,
                data_format, "max_pool3d")
    if not return_mask:
        return out
    xc, last = channels_first(x, data_format)
    mask = _max_mask(xc, kernel_size, stride, padding, 3)
    return out, (mask.movedim(1, -1) if last else mask)


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


def _adaptive_max_mask(x, output_size):
    """The flat input index of each adaptive window's first maximum (the
    reference's ``_adaptive_max_mask``, :302-350): every window is
    gathered at the widest window's length a dim, the excess entries
    -inf, which keeps the valid entries in the window's row-major
    order."""
    nsp = len(output_size)
    sizes = x.shape[2:]
    view = x
    starts, lengths = [], []
    for d, (n_in, n_out) in enumerate(zip(sizes, output_size)):
        i = torch.arange(n_out, device=x.device)
        start = i * n_in // n_out
        length = -(-(i + 1) * n_in // n_out) - start
        width = int(length.max())
        t = torch.arange(width, device=x.device)
        idx = torch.minimum(start[:, None] + t, start[:, None]
                            + length[:, None] - 1)
        ax = 2 + 2 * d
        view = view.index_select(ax, idx.reshape(-1)).unflatten(
            ax, (n_out, width))
        valid = (t < length[:, None]).reshape(
            (n_out, width) + (1,) * (nsp - 1 - d))
        view = view.masked_fill(~valid, -math.inf)
        starts.append(start)
        lengths.append(width)
    perm = [0, 1] + [2 + 2 * d for d in range(nsp)] \
        + [3 + 2 * d for d in range(nsp)]
    view = view.permute(perm)
    loc = view.reshape(view.shape[:2 + nsp] + (-1,)).argmax(-1)
    flat = torch.zeros_like(loc)
    for d in range(nsp):
        local = loc // math.prod(lengths[d + 1:]) % lengths[d]
        start = starts[d].reshape((-1,) + (1,) * (nsp - 1 - d))
        flat = flat * sizes[d] + start + local
    return flat


def _adaptive_max_pool(x, output_size, return_mask, nsp, op_name):
    out = _adaptive(x, output_size, "max", nsp, "NC" + "DHW"[-nsp:],
                    op_name)
    if not return_mask:
        return out
    return out, _adaptive_max_mask(x, ntuple(output_size, nsp))


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_max_pool(x, output_size, return_mask, 1,
                              "adaptive_max_pool1d")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_max_pool(x, output_size, return_mask, 2,
                              "adaptive_max_pool2d")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_max_pool(x, output_size, return_mask, 3,
                              "adaptive_max_pool3d")


def _unpool(x, indices, kernel_size, stride, padding, output_size, nsp,
            op_name):
    """``x`` (channels first) scattered into zeros at ``indices``."""
    (x,) = amp.cast_inputs(op_name, x)
    kernel = ntuple(kernel_size, nsp)
    stride = ntuple(stride if stride is not None else kernel, nsp)
    pads = _mask_pads(padding, nsp)
    if output_size is not None:
        sizes = tuple(int(v) for v in ntuple(output_size, nsp)[-nsp:])
    else:
        sizes = tuple((n - 1) * s - 2 * p + k for n, s, p, k in
                      zip(x.shape[2:], stride, pads, kernel))
    total = math.prod(sizes)
    top = int(indices.max()) if indices.numel() else -1
    if top >= total:
        raise ValueError(
            f"{op_name}: index {top} outside the {'x'.join(map(str, sizes))} "
            f"output; pass output_size with the pooled input's spatial "
            f"shape")
    n, c = x.shape[:2]
    out = x.new_zeros((n, c, total)).scatter(
        2, indices.reshape(n, c, -1).long(), x.reshape(n, c, -1))
    return out.reshape((n, c) + sizes)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    if data_format != "NCL":
        raise NotImplementedError(
            "max_unpool1d takes NCL only: the reference reads every input "
            "as NCL whatever its data_format")
    return _unpool(x, indices, kernel_size, stride, padding, output_size,
                   1, "max_unpool1d")


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    x, last = channels_first(x, data_format)
    indices, _ = channels_first(indices, data_format)
    out = _unpool(x, indices, kernel_size, stride, padding, output_size, 2,
                  "max_unpool2d")
    return out.movedim(1, -1) if last else out


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    x, last = channels_first(x, data_format)
    indices, _ = channels_first(indices, data_format)
    out = _unpool(x, indices, kernel_size, stride, padding, output_size, 3,
                  "max_unpool3d")
    return out.movedim(1, -1) if last else out
