"""Softmax cross-entropy from logits and integer labels: the hand-written
CUDA kernels and their plain versions.

Port of ``paddle_tpu/ops/pallas_kernels.py`` ``fused_softmax_cross_entropy``
(:880), whose Pallas bodies ``_xent_fwd_kernel`` (:759) and
``_xent_bwd_kernel`` (:802) become ``paddle_tpu_torch/csrc/softmax_xent.cu``.

Per row of logits ``[rows, V]``: ``loss = lse - logits[label]`` with the
f32 log-sum-exp ``lse`` saved for the backward; a label < 0 gives loss 0
and a zero gradient (the caller relabels its ignore index to -1); a label
>= V picks nothing, so its loss is ``lse``, as in the reference for
labels past its vocab padding (it pads V to a block multiple with -1e30
and would pick that padding for a label in between).  The
backward is ``(softmax - onehot) * g`` in the logits' type, with ``g``
the upstream gradient of each row's loss.  Labels are int64, torch's
index type, and the kernels read them as they are.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel or raises.  `fused_softmax_cross_entropy` is the differentiable
entry point.
"""
from __future__ import annotations

import torch

from . import cuda_lib

__all__ = ["softmax_xent_fwd_ref", "softmax_xent_fwd",
           "softmax_xent_bwd_ref", "softmax_xent_bwd",
           "fused_softmax_cross_entropy"]


def softmax_xent_fwd_ref(logits, labels):
    """Plain forward over ``[rows, V]`` logits and int64 ``[rows]``
    labels: ``(loss, lse)``, both f32 ``[rows]``."""
    x = logits.float()
    V = x.shape[-1]
    lse = torch.logsumexp(x, dim=-1)
    hit = (labels >= 0) & (labels < V)
    picked = x.gather(-1, torch.where(hit, labels, 0)[:, None])[:, 0]
    picked = torch.where(hit, picked, 0.0)
    loss = torch.where(labels >= 0, lse - picked, 0.0)
    return loss, lse


def softmax_xent_bwd_ref(logits, labels, lse, g):
    """Plain backward: ``dx = (exp(x - lse) - onehot) * g * [label >= 0]``
    in the logits' type; ``lse`` and ``g`` are f32 ``[rows]``."""
    x = logits.float()
    p = torch.exp(x - lse[:, None])
    col = torch.arange(x.shape[-1], device=x.device)
    onehot = (col[None, :] == labels[:, None]).to(p.dtype)
    scale = torch.where(labels >= 0, g, 0.0)
    return ((p - onehot) * scale[:, None]).to(logits.dtype)


def _check(name, logits, labels, extra=()):
    if logits.dim() != 2:
        raise ValueError(f"{name}: logits must be [rows, V], got "
                         f"{tuple(logits.shape)}")
    rows = logits.shape[0]
    if labels.dtype != torch.int64 or tuple(labels.shape) != (rows,) \
            or labels.device != logits.device:
        raise ValueError(f"{name}: labels must be int64 [{rows}] on "
                         f"{logits.device}, got {labels.dtype} "
                         f"{tuple(labels.shape)} on {labels.device}")
    for tname, t in extra:
        if t.dtype != torch.float32 or tuple(t.shape) != (rows,) \
                or t.device != logits.device:
            raise ValueError(f"{name}: {tname} must be f32 [{rows}] on "
                             f"{logits.device}")
    for tname, t in (("logits", logits), ("labels", labels), *extra):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")


def softmax_xent_fwd(logits, labels):
    """``(loss, lse)`` as in `softmax_xent_fwd_ref`, through the forward
    kernel for CUDA tensors."""
    if logits.device.type == "cpu":
        return softmax_xent_fwd_ref(logits, labels)
    if logits.device.type != "cuda":
        raise RuntimeError(f"softmax xent: no kernel for device "
                           f"{logits.device}")
    code = cuda_lib.dtype_code(logits.dtype)
    _check("softmax xent", logits, labels)
    rows, V = logits.shape
    loss = torch.zeros(rows, dtype=torch.float32, device=logits.device)
    lse = torch.zeros(rows, dtype=torch.float32, device=logits.device)
    if rows and V:
        rc = cuda_lib.library().ptt_softmax_xent_fwd(
            logits.data_ptr(), labels.data_ptr(), loss.data_ptr(),
            lse.data_ptr(), rows, V, code, logits.device.index,
            cuda_lib.stream_handle(logits.device))
        cuda_lib.check(rc, "softmax_xent_fwd")
        softmax_xent_fwd.launches += 1
    return loss, lse


def softmax_xent_bwd(logits, labels, lse, g):
    """``dx`` as in `softmax_xent_bwd_ref`, through the backward kernel
    for CUDA tensors."""
    if logits.device.type == "cpu":
        return softmax_xent_bwd_ref(logits, labels, lse, g)
    if logits.device.type != "cuda":
        raise RuntimeError(f"softmax xent bwd: no kernel for device "
                           f"{logits.device}")
    code = cuda_lib.dtype_code(logits.dtype)
    _check("softmax xent bwd", logits, labels, (("lse", lse), ("g", g)))
    rows, V = logits.shape
    dx = torch.empty_like(logits)
    if rows and V:
        rc = cuda_lib.library().ptt_softmax_xent_bwd(
            logits.data_ptr(), labels.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dx.data_ptr(), rows, V, code, logits.device.index,
            cuda_lib.stream_handle(logits.device))
        cuda_lib.check(rc, "softmax_xent_bwd")
        softmax_xent_bwd.launches += 1
    return dx


class _SoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = softmax_xent_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return softmax_xent_bwd(logits, labels, lse,
                                g.float().contiguous()), None


def fused_softmax_cross_entropy(logits, labels):
    """Per-example softmax cross-entropy, differentiable in ``logits``
    ``[..., V]``; ``labels`` ``[...]`` int64, < 0 ignored.  Returns the
    f32 loss of shape ``[...]``."""
    V = logits.shape[-1]
    x = logits.reshape(-1, V).contiguous()
    lbl = labels.reshape(-1).to(torch.int64).contiguous()
    if torch.is_grad_enabled() and logits.requires_grad:
        loss = _SoftmaxXent.apply(x, lbl)
    else:
        loss = softmax_xent_fwd(x, lbl)[0]
    return loss.reshape(logits.shape[:-1])


#: kernel launches since the last reset (chip_smoke.py reads them)
softmax_xent_fwd.launches = 0
softmax_xent_bwd.launches = 0
