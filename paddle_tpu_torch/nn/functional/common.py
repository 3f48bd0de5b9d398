"""Dropout, padding, resizing, lookups and the other common functionals,
on ``torch.Tensor``.

Port of ``paddle_tpu/nn/functional/common.py:204-751``.  The reference
leaves every one of them to XLA; here each is plain PyTorch, op for op
with the reference's composite where PyTorch has no equal:

* ``interpolate`` resizes as ``jax.image.resize`` does (:345-355):
  ``"nearest"`` is PyTorch's ``"nearest-exact"``; the linear family
  (``"linear"``, ``"bilinear"``, ``"trilinear"`` and ``"area"``, which
  the reference maps to linear, :331-333) and ``"bicubic"`` (Keys' cubic,
  a = -0.5) antialias when they shrink, which is PyTorch's bilinear or
  bicubic with ``antialias=True``, taken one spatial axis at a time (the
  reference's resize is separable, and PyTorch antialiases 4-D input
  only).  ``align_corners=True`` and ``align_mode=1`` go through the
  reference's own ``_resize_linear_by_pos`` (:364-403), positions in
  f64 as the reference's x64 mode takes them.
* ``pad`` reads Paddle's pad lists as ``_norm_pad`` (:267-291) does;
  ``"constant"`` is ``torch.nn.functional.pad`` over any dims, and
  ``"replicate"``, ``"reflect"`` and ``"circular"`` (jnp's ``edge``,
  ``reflect`` and ``wrap``) gather each padded dim by index, so the
  batch and channel dims of the full form pad too.
* ``embedding`` with ``padding_idx`` zeroes the looked-up rows of that id
  (:556-558), so their gradient is 0 as well.
* ``grid_sample`` and ``affine_grid`` default to ``align_corners=True``
  (:631, :649) and follow the reference's formulas, reflection included;
  ``affine_grid`` forms its base grid in f64 (the reference's x64
  linspace) and returns theta's dtype.
* ``class_center_sample`` is the reference's single-process
  simplification (:590-604): the label's classes first, then the lowest
  other ones.

The random ones (``dropout`` with ``axis`` or ``mode``, ``dropout2d``,
``dropout3d``, ``alpha_dropout``, ``feature_alpha_dropout``) draw their
keep masks from the ``generator`` given (the global one when None).

Each casts its floating inputs through ``amp.cast_inputs`` under the op
name the reference dispatches (``"pad3d"``, ``"interpolate"``,
``"one_hot_v2"``, ``"label_smooth"``, ...); none is on an O1 list, so
only O2 casts them.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ... import amp

__all__ = ["dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "feature_alpha_dropout", "pad", "zeropad2d", "interpolate",
           "upsample", "cosine_similarity", "pixel_shuffle",
           "pixel_unshuffle", "unfold", "fold", "one_hot", "embedding",
           "label_smooth", "bilinear", "class_center_sample",
           "channel_shuffle", "pairwise_distance", "affine_grid",
           "grid_sample", "temporal_shift"]


def _keep(shape, p, x, generator):
    """A keep mask of ``shape`` (each entry kept with probability
    ``1 - p``), drawn from ``generator`` on ``x``'s device."""
    return torch.rand(shape, generator=generator, device=x.device) >= p


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Dropout (:204-229).  ``upscale_in_train`` (inverted dropout) scales
    the kept values by ``1/(1-p)`` in training and is the identity in
    eval; ``downscale_in_infer`` keeps them as they are in training and
    multiplies by ``1 - p`` in eval.  With ``axis`` one draw covers every
    position along the other dims."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            (x,) = amp.cast_inputs("dropout_infer", x)
            return x * (1.0 - p)
        return x
    (x,) = amp.cast_inputs("dropout", x)
    if p == 1.0:
        return torch.zeros_like(x)
    shape = x.shape
    if axis is not None:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    keep = _keep(shape, p, x, generator).to(x.dtype)
    if mode == "upscale_in_train":
        return x * keep / (1.0 - p)
    return x * keep


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None,
              generator=None):
    """Whole channels of ``[N, C, H, W]`` (or NHWC) dropped together."""
    axis = (0, 1) if data_format == "NCHW" else (0, 3)
    return dropout(x, p, axis=axis, training=training, generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None,
              generator=None):
    """Whole channels of ``[N, C, D, H, W]`` (or NDHWC) dropped
    together."""
    axis = (0, 1) if data_format == "NCDHW" else (0, 4)
    return dropout(x, p, axis=axis, training=training, generator=generator)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def _alpha_dropout(x, p, mask_shape, generator):
    """The reference's ``_alpha_dropout_body`` (:243-252): dropped values
    set to alpha' = -alpha * scale, then the affine map ``a v + b`` that
    keeps a unit normal's mean and variance."""
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    keep = _keep(mask_shape, p, x, generator)
    a = ((1.0 - p) * (1.0 + p * alpha_p ** 2)) ** -0.5
    b = -a * p * alpha_p
    return a * torch.where(keep, x, alpha_p) + b


def alpha_dropout(x, p=0.5, training=True, name=None, generator=None):
    """SELU's alpha dropout (:254-264), each value drawn alone."""
    if not training or p == 0.0:
        return x
    (x,) = amp.cast_inputs("alpha_dropout", x)
    return _alpha_dropout(x, p, x.shape, generator)


def feature_alpha_dropout(x, p=0.5, training=True, name=None,
                          generator=None):
    """Alpha dropout over whole feature maps (dim 1) (:738-751)."""
    if not training or p == 0.0:
        return x
    (x,) = amp.cast_inputs("feature_alpha_dropout", x)
    shape = (x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2)
    return _alpha_dropout(x, p, shape, generator)


def _norm_pad(pad, ndim, data_format):
    """Paddle's pad list (``[left, right, top, bottom, ...]`` from the
    last dim backwards) as ``(before, after)`` per dim (:267-284)."""
    if torch.is_tensor(pad):
        pad = pad.tolist()
    pad = [int(p) for p in pad]
    widths = [(0, 0)] * ndim
    npairs = len(pad) // 2
    if data_format.startswith("NC") and npairs == ndim - 2:
        dims = list(range(ndim - 1, 1, -1))
    elif npairs == ndim - 2:  # channels last: the spatial dims
        dims = list(range(ndim - 2, 0, -1))
    else:
        dims = list(range(ndim - 1, ndim - 1 - npairs, -1))
    for i, d in enumerate(dims):
        widths[d] = (pad[2 * i], pad[2 * i + 1])
    return widths


def _pad_index(n, before, after, mode):
    """The source index of each position of a dim of ``n`` padded by
    ``before`` and ``after``, as jnp.pad's ``edge``, ``reflect`` and
    ``wrap`` take it."""
    i = np.arange(-before, n + after)
    if mode == "replicate":
        return np.clip(i, 0, n - 1)
    if mode == "circular":
        return np.mod(i, n)
    period = 2 * (n - 1)
    m = np.mod(i, period) if period else np.zeros_like(i)
    return np.where(m < n, m, period - m)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Pad by Paddle's pad list: one pair per dim for every dim (the full
    form, in dim order, :288-291), or pairs for the spatial dims (from
    the last backwards) or the last dims (`_norm_pad`).  ``mode``:
    ``"constant"`` (with ``value``), ``"reflect"``, ``"replicate"`` or
    ``"circular"``."""
    if isinstance(pad, (list, tuple)) and len(pad) == 2 * x.dim():
        widths = [(int(pad[2 * i]), int(pad[2 * i + 1]))
                  for i in range(x.dim())]
    else:
        widths = _norm_pad(pad, x.dim(), data_format)
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"unknown pad mode {mode!r}")
    (x,) = amp.cast_inputs("pad3d", x)
    if mode == "constant":
        if torch.is_tensor(value):
            value = float(value.item())
        flat = [w for pair in reversed(widths) for w in pair]
        return TF.pad(x, flat, value=float(value))
    for d, (before, after) in enumerate(widths):
        if before or after:
            idx = _pad_index(x.shape[d], before, after, mode)
            x = x.index_select(d, torch.from_numpy(idx).to(x.device))
    return x


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def _resize_by_pos(v, out_sp, pos_of):
    """The reference's ``_resize_linear_by_pos`` (:364-390): a separable
    linear resize of the spatial dims of channels-first ``v``, where
    ``pos_of(n_in, n_out)`` gives the f64 source positions."""
    out = v
    for k, n_out in enumerate(out_sp):
        ax = 2 + k
        n_in = out.shape[ax]
        if n_in == n_out:
            continue
        if n_out == 1:
            lo = hi = np.zeros(1, np.int64)
            w = np.zeros(1)
        else:
            pos = np.clip(pos_of(n_in, n_out), 0.0, n_in - 1.0)
            lo = np.floor(pos).astype(np.int64)
            hi = np.minimum(lo + 1, n_in - 1)
            w = pos - lo
        shape = [1] * out.dim()
        shape[ax] = n_out
        w = torch.from_numpy(w).to(out.device, out.dtype).reshape(shape)
        lo_v = out.index_select(ax, torch.from_numpy(lo).to(out.device))
        hi_v = out.index_select(ax, torch.from_numpy(hi).to(out.device))
        out = lo_v * (1 - w) + hi_v * w
    return out


def _resize_antialiased(v, out_sp, mode):
    """``jax.image.resize``'s linear or cubic resize of channels-first
    ``v``: one pass per spatial dim, in order, each PyTorch's 4-D
    ``antialias=True`` resize of that dim alone; bf16 and f16 in f32,
    rounded once at the end."""
    out = v.float() if v.dtype in (torch.bfloat16, torch.float16) else v
    for k, n_out in enumerate(out_sp):
        ax = 2 + k
        n_in = out.shape[ax]
        if n_in == n_out:
            continue
        moved = out.movedim(ax, -1)
        lead = moved.shape[:-1]
        flat = moved.reshape(-1, 1, 1, n_in)
        flat = TF.interpolate(flat, size=(1, n_out), mode=mode,
                              align_corners=False, antialias=True)
        out = flat.reshape(*lead, n_out).movedim(-1, ax)
    return out.to(v.dtype)


_MODES = {"nearest": "nearest", "bilinear": "linear", "trilinear": "linear",
          "linear": "linear", "bicubic": "cubic", "area": "linear"}


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial dims to ``size`` or ``int(dim * scale_factor)``
    (:312-362), as ``jax.image.resize`` with the reference's align
    variants; ``align_corners`` and ``align_mode`` apply to the linear
    family only."""
    nsp = x.dim() - 2
    cf = data_format.startswith("NC")
    sp_shape = x.shape[2:] if cf else x.shape[1:-1]
    if size is not None:
        if torch.is_tensor(size):
            size = size.tolist()
        sizes = size if isinstance(size, (list, tuple)) else [size] * nsp
        out_sp = [int(s.item()) if torch.is_tensor(s) else int(s)
                  for s in sizes]
    elif isinstance(scale_factor, (list, tuple)):
        out_sp = [int(s * f) for s, f in zip(sp_shape, scale_factor)]
    else:
        out_sp = [int(s * float(scale_factor)) for s in sp_shape]
    jmode = _MODES[mode.lower()]
    linear_family = mode.lower() in ("linear", "bilinear", "trilinear")
    (x,) = amp.cast_inputs("interpolate", x)
    v = x if cf else x.movedim(-1, 1)
    if jmode == "nearest":
        out = TF.interpolate(v, size=out_sp, mode="nearest-exact")
    elif align_corners and linear_family:
        out = _resize_by_pos(v, out_sp,
                             lambda n_in, n_out: np.linspace(0.0, n_in - 1.0,
                                                             n_out))
    elif int(align_mode) == 1 and linear_family:
        out = _resize_by_pos(v, out_sp,
                             lambda n_in, n_out: np.arange(n_out)
                             * (n_in / n_out))
    else:
        out = _resize_antialiased(
            v, out_sp, "bicubic" if jmode == "cubic" else "bilinear")
    return out if cf else out.movedim(1, -1)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    """``sum(a b) / max(|a| |b|, eps)`` along ``axis`` (:412-421)."""
    a, b = amp.cast_inputs("cosine_similarity", x1, x2)
    an = torch.sqrt((a * a).sum(dim=axis))
    bn = torch.sqrt((b * b).sum(dim=axis))
    return (a * b).sum(dim=axis) / torch.clamp_min(an * bn, eps)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    (v,) = amp.cast_inputs("pixel_shuffle", x)
    r = int(upscale_factor)
    if data_format != "NCHW":
        v = v.permute(0, 3, 1, 2)
    n, c, h, w = v.shape
    v = v.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    v = v.reshape(n, c // (r * r), h * r, w * r)
    return v if data_format == "NCHW" else v.permute(0, 2, 3, 1)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    (v,) = amp.cast_inputs("pixel_unshuffle", x)
    r = int(downscale_factor)
    if data_format != "NCHW":
        v = v.permute(0, 3, 1, 2)
    n, c, h, w = v.shape
    v = v.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
    v = v.reshape(n, c * r * r, h // r, w // r)
    return v if data_format == "NCHW" else v.permute(0, 2, 3, 1)


def _pairs(v, n=2):
    return [v] * n if isinstance(v, int) else list(v)


def _pads4(paddings):
    """``[top, left, bottom, right]`` from an int, a pair or four."""
    pd = [paddings] * 4 if isinstance(paddings, int) else list(paddings)
    return [pd[0], pd[1], pd[0], pd[1]] if len(pd) == 2 else pd


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col (:436-461): ``[N, C*kh*kw, L]``, channel-major, after
    padding ``[top, left, bottom, right]``."""
    (v,) = amp.cast_inputs("unfold", x)
    pd = _pads4(paddings)
    v = TF.pad(v, (pd[1], pd[3], pd[0], pd[2]))
    return TF.unfold(v, _pairs(kernel_sizes), dilation=_pairs(dilations),
                     stride=_pairs(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im (:464-492): each kernel offset's columns added into the
    padded output at its strided positions, then the padding cut off."""
    (v,) = amp.cast_inputs("fold", x)
    os_, ks = _pairs(output_sizes), _pairs(kernel_sizes)
    st, dl = _pairs(strides), _pairs(dilations)
    pd = _pads4(paddings)
    n, ckk, _ = v.shape
    c = ckk // (ks[0] * ks[1])
    oh = (os_[0] + pd[0] + pd[2] - dl[0] * (ks[0] - 1) - 1) // st[0] + 1
    ow = (os_[1] + pd[1] + pd[3] - dl[1] * (ks[1] - 1) - 1) // st[1] + 1
    v = v.reshape(n, c, ks[0], ks[1], oh, ow)
    out = v.new_zeros((n, c, os_[0] + pd[0] + pd[2], os_[1] + pd[1] + pd[3]))
    for i in range(ks[0]):
        for j in range(ks[1]):
            hi, wj = i * dl[0], j * dl[1]
            out[:, :, hi:hi + oh * st[0]:st[0],
                wj:wj + ow * st[1]:st[1]] += v[:, :, i, j]
    return out[:, :, pd[0]:out.shape[2] - pd[2], pd[1]:out.shape[3] - pd[3]]


def one_hot(x, num_classes, name=None):
    """f32 one-hot rows (op ``one_hot_v2``, not differentiable)."""
    n = int(num_classes.item()) if torch.is_tensor(num_classes) \
        else int(num_classes)
    return TF.one_hot(x.long(), n).float()


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Row lookup ``weight[x]``; the rows looked up for ``padding_idx``
    are zeros (:556-558), so that id's row gets no gradient.  ``sparse``
    is accepted and the gradient is dense, as in the reference."""
    (weight,) = amp.cast_inputs("embedding", weight)
    out = TF.embedding(x, weight)
    if padding_idx is None:
        return out
    return torch.where((x != int(padding_idx))[..., None], out, 0.0)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``(1 - epsilon) label + epsilon / classes``, or ``+ epsilon *
    prior_dist`` (:566-576)."""
    if prior_dist is not None:
        label, prior_dist = amp.cast_inputs("label_smooth", label,
                                            prior_dist)
        return (1 - epsilon) * label + epsilon * prior_dist
    (label,) = amp.cast_inputs("label_smooth", label)
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] W[o] x2[b] + bias`` (:579-587)."""
    a, b, w, bb = amp.cast_inputs("bilinear", x1, x2, weight, bias)
    out = torch.einsum("bi,oij,bj->bo", a, w, b)
    return out if bb is None else out + bb


def class_center_sample(label, num_classes, num_samples, group=None):
    """The reference's single-process simplification (:590-604): the
    label's classes, then the lowest others up to ``num_samples``, sorted;
    returns the label remapped into them (-1 where absent) and the
    sampled classes, on the label's device.  Computed on the host."""
    arr = label.detach().cpu().numpy()
    pos = np.unique(arr)
    if len(pos) >= num_samples:
        sampled = pos[:num_samples]
    else:
        rest = np.setdiff1d(np.arange(num_classes), pos)
        sampled = np.concatenate([pos, rest[:num_samples - len(pos)]])
    sampled.sort()
    lookup = np.full(max(int(num_classes), int(arr.max()) + 1), -1, np.int64)
    lookup[sampled] = np.arange(len(sampled))
    return (torch.from_numpy(lookup[arr]).to(label.device),
            torch.from_numpy(sampled.astype(np.int64)).to(label.device))


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    (v,) = amp.cast_inputs("channel_shuffle", x)
    g = int(groups)
    if data_format == "NCHW":
        n, c, h, w = v.shape
        return v.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(
            n, c, h, w)
    n, h, w, c = v.shape
    return v.reshape(n, h, w, g, c // g).transpose(3, 4).reshape(n, h, w, c)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """``sum(|x - y + epsilon|^p)^(1/p)`` over the last dim (:619-627)."""
    a, b = amp.cast_inputs("pairwise_distance", x, y)
    d = a - b + epsilon
    return (d.abs() ** p).sum(dim=-1, keepdim=keepdim) ** (1.0 / p)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """``[N, 2, 3]`` affine maps to an ``[N, H, W, 2]`` sampling grid
    (:630-645)."""
    (th,) = amp.cast_inputs("affine_grid", theta)
    H, W = int(out_shape[-2]), int(out_shape[-1])
    if align_corners:
        ys, xs = np.linspace(-1.0, 1.0, H), np.linspace(-1.0, 1.0, W)
    else:
        ys = (np.arange(H) * 2 + 1) / H - 1
        xs = (np.arange(W) * 2 + 1) / W - 1
    gx, gy = np.meshgrid(xs, ys)
    base = torch.from_numpy(np.stack([gx, gy, np.ones_like(gx)], axis=-1))
    out = torch.einsum("hwk,nik->nhwi", base.to(th.device), th.double())
    return out.to(th.dtype)


def _reflect(f, n, align):
    """The reference's reflection of source coordinates (:666-675)."""
    span = 2 * (n - 1) if align else 2 * n
    off = 0 if align else 0.5
    f = -torch.abs(torch.remainder(f + off, span) - span / 2) + span / 2 - off
    return f.clamp(0, n - 1)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample NCHW ``x`` at the normalised ``(x, y)`` coordinates of an
    ``[N, Hg, Wg, 2]`` grid (:648-712): bilinear or nearest (rounding half
    to even), with ``"zeros"``, ``"border"`` or ``"reflection"``
    padding."""
    v, g = amp.cast_inputs("grid_sample", x, grid)
    n, _, H, W = v.shape
    gx, gy = g[..., 0], g[..., 1]
    if align_corners:
        fx, fy = (gx + 1) * (W - 1) / 2, (gy + 1) * (H - 1) / 2
    else:
        fx, fy = ((gx + 1) * W - 1) / 2, ((gy + 1) * H - 1) / 2
    if padding_mode == "border":
        fx, fy = fx.clamp(0, W - 1), fy.clamp(0, H - 1)
    elif padding_mode == "reflection":
        fx, fy = _reflect(fx, W, align_corners), _reflect(fy, H, align_corners)
    batch = torch.arange(n, device=v.device)[:, None, None]

    def at(yy, xx, ok=None):
        yi = yy.clamp(0, H - 1).long()
        xi = xx.clamp(0, W - 1).long()
        val = v[batch, :, yi, xi].permute(0, 3, 1, 2)     # N C Hg Wg
        if padding_mode == "zeros" and ok is not None:
            val = val * ok.to(val.dtype)[:, None]
        return val

    if mode == "nearest":
        ok = (fy > -0.5) & (fy < H - 0.5) & (fx > -0.5) & (fx < W - 0.5)
        return at(torch.round(fy), torch.round(fx), ok)

    def inside(yy, xx):
        return (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)

    y0, x0 = torch.floor(fy), torch.floor(fx)
    wy1, wx1 = (fy - y0)[:, None], (fx - x0)[:, None]
    return (at(y0, x0, inside(y0, x0)) * (1 - wy1) * (1 - wx1)
            + at(y0, x0 + 1, inside(y0, x0 + 1)) * (1 - wy1) * wx1
            + at(y0 + 1, x0, inside(y0 + 1, x0)) * wy1 * (1 - wx1)
            + at(y0 + 1, x0 + 1, inside(y0 + 1, x0 + 1)) * wy1 * wx1)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM (:715-735): within each group of ``seg_num`` frames, the first
    ``c * shift_ratio`` channels move one frame back, the next as many
    one frame on, zeros filling in."""
    (v,) = amp.cast_inputs("temporal_shift", x)
    if data_format != "NCHW":
        v = v.movedim(-1, 1)
    nt, c, h, w = v.shape
    seg = int(seg_num)
    v = v.reshape(nt // seg, seg, c, h, w)
    k = int(c * shift_ratio)
    left = torch.cat([v[:, 1:, :k], torch.zeros_like(v[:, :1, :k])], dim=1)
    right = torch.cat([torch.zeros_like(v[:, :1, k:2 * k]),
                       v[:, :-1, k:2 * k]], dim=1)
    out = torch.cat([left, right, v[:, :, 2 * k:]], dim=2).reshape(
        nt, c, h, w)
    return out if data_format == "NCHW" else out.movedim(1, -1)
