"""Gradient clipping by global norm, Paddle's rule.

Port of ``paddle_tpu/nn/clip.py`` ``ClipGradByGlobalNorm`` (:55-82): the
global norm ``total = sqrt(sum over grads of sum(g*g))`` in f32, and
every gradient scaled by ``clip_norm / max(total, clip_norm)``, so the
gradients are always multiplied (by 1 when the norm is within bounds).
That is not ``torch.nn.utils.clip_grad_norm_``'s rule (which divides by
``total + 1e-6``), so the port keeps its own.  A parameter with
``need_clip = False`` is left out of the norm and of the scaling.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm=1.0):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def __call__(self, params):
        clipped = [p for p in params
                   if p.grad is not None and getattr(p, "need_clip", True)]
        if not clipped:
            return params
        total = torch.sqrt(sum(p.grad.float().square().sum()
                               for p in clipped))
        scale = self.clip_norm / torch.clamp_min(total, self.clip_norm)
        for p in clipped:
            p.grad.copy_(p.grad.float() * scale)
        return params
