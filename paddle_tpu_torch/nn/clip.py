"""Gradient clipping, Paddle's rules.

Port of ``paddle_tpu/nn/clip.py``: ``ClipGradByValue`` (:24, each
gradient clamped to ``[min, max]``), ``ClipGradByNorm`` (:38, each
gradient scaled by ``min(clip_norm / max(norm, 1e-12), 1)`` with its own
L2 norm) and ``ClipGradByGlobalNorm`` (:56): the global norm ``total =
sqrt(sum over grads of sum(g*g))`` in f32, and every gradient scaled by
``clip_norm / max(total, clip_norm)``, so the gradients are always
multiplied (by 1 when the norm is within bounds).  That is not
``torch.nn.utils.clip_grad_norm_``'s rule (which divides by ``total +
1e-6``), so the port keeps its own.  A parameter with ``need_clip =
False`` is left out of the norms and of the scaling.

Each clip is multi-tensor: the norms come from ``torch._foreach_norm``
(in f32), the scaling from one ``torch._foreach_mul_`` (an f32 product
rounded to the gradient's dtype, as the reference casts back), and the
clamp from ``torch._foreach_clamp_min_``/``_max_``.  ``group_name`` and
``auto_skip_clip`` are accepted, as in the reference, which keeps the
first and does not read the second.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


def _clipped(params):
    return [p for p in params
            if p.grad is not None and getattr(p, "need_clip", True)]


def _norms(grads):
    """Each gradient's L2 norm in f32, stacked."""
    return torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float32))


class ClipGradBase:
    def __call__(self, params):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    @torch.no_grad()
    def __call__(self, params):
        grads = [p.grad for p in _clipped(params)]
        if grads:
            torch._foreach_clamp_min_(grads, self.min)
            torch._foreach_clamp_max_(grads, self.max)
        return params


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def __call__(self, params):
        grads = [p.grad for p in _clipped(params)]
        if grads:
            scale = torch.clamp_max(
                self.clip_norm / torch.clamp_min(_norms(grads), 1e-12), 1.0)
            torch._foreach_mul_(grads, list(scale.unbind()))
        return params


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm=1.0, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    @torch.no_grad()
    def __call__(self, params):
        grads = [p.grad for p in _clipped(params)]
        if not grads:
            return params
        total = torch.sqrt(_norms(grads).square().sum())
        scale = self.clip_norm / torch.clamp_min(total, self.clip_norm)
        torch._foreach_mul_(grads, scale)
        return params
