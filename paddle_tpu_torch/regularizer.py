"""Regularizers: ``L1Decay`` and ``L2Decay``.

Port of ``paddle_tpu/regularizer.py``.  Each carries a coefficient that
the optimizers read: ``L2Decay`` is the weight-decay coefficient of the
update (``g + coeff*p``, or AdamW's decoupled term), ``L1Decay`` adds
``coeff*sign(p)`` to every gradient after the clip
(``optimizer.Optimizer.step``).
"""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff


class L1Decay(WeightDecayRegularizer):
    pass


class L2Decay(WeightDecayRegularizer):
    pass
