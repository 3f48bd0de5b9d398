"""Batch norm, on ``torch.Tensor``.

Port of ``paddle_tpu/nn/functional/norm.py:124-186`` (``batch_norm``).
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
"""
from __future__ import annotations

import torch

from ... import amp

__all__ = ["batch_norm"]


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
