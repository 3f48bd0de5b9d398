"""Batch norm and the other norms, on ``torch.Tensor``.

Port of ``paddle_tpu/nn/functional/norm.py:124-321`` (``batch_norm``,
``instance_norm``, ``group_norm``, ``local_response_norm``,
``normalize``, ``spectral_norm``).
The reference computes it as an XLA composite; the port calls
``torch.nn.functional.batch_norm`` (cuDNN on the card) in training and
the reference's composite in inference.

* Training (``use_global_stats`` false; ``None`` means ``not training``,
  :128-129): the batch's mean and biased variance over every dim but the
  channels', in f32 for bf16 and f16 input; the normalised value is cast
  back to the input's type before the affine step (:137-150).  The
  running statistics are updated in place with Paddle's momentum, ``new =
  momentum * old + (1 - momentum) * batch``, the variance's with the
  unbiased batch variance (:155-160); torch's ``momentum`` weighs the
  batch instead, so ``1 - momentum`` is passed to it.  Like torch, and
  unlike the reference, it refuses a batch with one value a channel.
* Inference (:170-186): ``(x - mean) * rsqrt(var + epsilon)`` with the
  running statistics cast to the input's type, then the affine step.

Training is the op ``batch_norm`` (the O1 black list: f32 under
``auto_cast``), inference ``batch_norm_infer`` (on neither list).

The other norms are the reference's composites, op for op:

* ``instance_norm`` (:189-236): each sample's and channel's mean and
  biased variance over the spatial dims, taken in f32 and cast to the
  input's dtype (or the given running statistics, not updated, with
  ``use_input_stats=False``); channels-last input is normalised over its
  own spatial dims.  ``group_norm`` (:239-268) takes its statistics over
  each group's channels and positions in the input's dtype.  Both are on
  the O1 black list.
* ``local_response_norm`` (:271-291): ``x / (k + alpha * s / size) **
  beta`` with ``s`` the sum of squares over ``size`` neighbouring
  channels, the channel axis padded ``(size // 2, size - 1 - size //
  2)``; the last axis for channels-last formats.
* ``normalize`` (:294-299): ``x / max(||x||_p, epsilon)`` along ``axis``.
* ``spectral_norm`` (:302-321): ``weight / sigma``, ``sigma`` from
  ``power_iters`` power-iteration steps from the given ``u``/``v`` (which
  stay as they are) on the weight reshaped to ``[shape[dim], -1]``.
"""
from __future__ import annotations

import torch

from ... import amp

__all__ = ["batch_norm", "instance_norm", "group_norm",
           "local_response_norm", "normalize", "spectral_norm"]


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch norm over the channel dim (1 for ``"NC..."`` layouts of more
    than one dim, else the last).  ``running_mean``/``running_var`` are
    updated in place in training."""
    caxis = 1 if data_format.startswith("NC") and x.dim() > 1 \
        else x.dim() - 1
    if use_global_stats is None:
        use_global_stats = not training
    if use_global_stats:
        x, mean, var, weight, bias = amp.cast_inputs(
            "batch_norm_infer", x, running_mean, running_var, weight, bias)
        shape = [1] * x.dim()
        shape[caxis] = -1
        out = (x - mean.reshape(shape).to(x.dtype)) * torch.rsqrt(
            var.reshape(shape).to(x.dtype) + epsilon)
        if weight is not None:
            out = out * weight.reshape(shape)
        if bias is not None:
            out = out + bias.reshape(shape)
        return out
    x, mean, var, weight, bias = amp.cast_inputs(
        "batch_norm", x, running_mean, running_var, weight, bias)
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    xf = xf.movedim(caxis, 1)
    mean_f, var_f = mean.to(xf.dtype), var.to(xf.dtype)
    # the affine step inside the call where it runs in the input's type
    inside = all(t is None or t.dtype == x.dtype for t in (weight, bias)) \
        and xf.dtype == x.dtype
    out = torch.nn.functional.batch_norm(
        xf, mean_f, var_f, weight if inside else None,
        bias if inside else None, True, 1.0 - momentum, epsilon)
    for own, new in ((running_mean, mean_f), (running_var, var_f)):
        if new is not own:
            with torch.no_grad():
                own.copy_(new)
    out = out.movedim(1, caxis).to(x.dtype)
    if not inside:
        shape = [1] * x.dim()
        shape[caxis] = -1
        if weight is not None:
            out = out * weight.reshape(shape)
        if bias is not None:
            out = out + bias.reshape(shape)
    return out


def _channel_shape(x, caxis=1):
    shape = [1] * x.dim()
    shape[caxis] = -1
    return shape


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9,
                  epsilon=1e-05, data_format="NCHW", name=None):
    """Instance norm over each sample's and channel's spatial dims."""
    if not use_input_stats and (running_mean is None
                                or running_var is None):
        raise ValueError("instance_norm(use_input_stats=False) requires "
                         "both running_mean and running_var")
    stats = () if use_input_stats else (running_mean, running_var)
    x, weight, bias, *stats = amp.cast_inputs("instance_norm", x, weight,
                                              bias, *stats)
    last = not data_format.startswith("NC")
    if last:
        x = x.movedim(-1, 1)
    shape = _channel_shape(x)
    if stats:
        mean = stats[0].reshape(shape).to(x.dtype)
        var = stats[1].reshape(shape).to(x.dtype)
    else:
        axes = tuple(range(2, x.dim()))
        var, mean = torch.var_mean(x.float(), axes, correction=0,
                                   keepdim=True)
        mean, var = mean.to(x.dtype), var.to(x.dtype)
    out = _affine((x - mean) * torch.rsqrt(var + epsilon), weight, bias,
                  shape)
    return out.movedim(1, -1) if last else out


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Group norm: statistics over each group of ``C / num_groups``
    channels and every position, in the input's dtype."""
    x, weight, bias = amp.cast_inputs("group_norm", x, weight, bias)
    last = not data_format.startswith("NC")
    if last:
        x = x.movedim(-1, 1)
    g = x.unflatten(1, (int(num_groups), -1))
    var, mean = torch.var_mean(g, tuple(range(2, g.dim())), correction=0,
                               keepdim=True)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).flatten(1, 2)
    out = _affine(out, weight, bias, _channel_shape(x))
    return out.movedim(1, -1) if last else out


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """Local response norm across ``size`` neighbouring channels."""
    (x,) = amp.cast_inputs("lrn", x)
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    half = size // 2
    sq = (x * x).movedim(ch, -1)
    padded = torch.nn.functional.pad(sq, (half, size - 1 - half))
    acc = torch.zeros_like(sq)
    for i in range(size):
        acc = acc + padded[..., i:i + sq.shape[-1]]
    return x / torch.pow(k + alpha * acc.movedim(-1, ch) / size, beta)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    (x,) = amp.cast_inputs("normalize", x)
    p = float(p)
    norm = torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=int(axis),
                               keepdim=True), 1.0 / p)
    return x / torch.clamp_min(norm, epsilon)


def spectral_norm(x, weight_u, weight_v, dim=0, power_iters=1,
                  epsilon=1e-12, name=None):
    """``x`` divided by its largest singular value, estimated by power
    iteration from ``weight_u``/``weight_v`` (left unchanged)."""
    x, u, v = amp.cast_inputs("spectral_norm", x, weight_u, weight_v)
    mat = x.movedim(int(dim), 0).reshape(x.shape[dim], -1)
    for _ in range(int(power_iters)):
        v = mat.T @ u
        v = v / (torch.linalg.vector_norm(v) + epsilon)
        u = mat @ v
        u = u / (torch.linalg.vector_norm(u) + epsilon)
    return x / (u @ mat @ v)
