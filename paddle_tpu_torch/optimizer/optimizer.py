"""Optimizers with Paddle's API: ``SGD``, ``Adam`` and ``AdamW``.

Port of ``paddle_tpu/optimizer/optimizer.py``: the ``Optimizer`` base
(:60) with Paddle's signature (``learning_rate``, ``parameters``,
``weight_decay``, ``grad_clip``), ``step`` in the reference's order
(:141-177: clip, then apply, then count the step) and ``clear_grad``;
``SGD`` (:382) and the Adam family (:444-551), whose update is the
reference's op for op in f32:

    m = b1*m + (1-b1)*g,  v = b2*v + (1-b2)*g*g,
    upd = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)  (+ wd*p, AdamW)
    p = p - lr*upd

with ``t`` the number of steps applied so far plus one.  ``Adam`` adds
``wd*p`` to the gradient instead.  The decay mask is the reference's
(:522-526): a parameter decays unless ``apply_decay_param_fun(name)``
is false or it carries ``no_weight_decay = True``.  ``name`` is the
parameter's ``param_name`` (a torch tensor's ``.name`` is taken): the
port's GPT sets it to the structured name (``gpt.h.0.ln_1.bias``).

The reference has no Pallas kernel here, so this is plain PyTorch: a
loop of in-place f32 tensor ops per parameter under ``torch.no_grad``.
The moments are f32.  Learning-rate schedulers, parameter groups, L1
decay and ``minimize`` are not ported yet and raise.
"""
from __future__ import annotations

import torch

__all__ = ["Optimizer", "SGD", "Adam", "AdamW"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        if isinstance(learning_rate, bool) \
                or not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers (optimizer/lr.py) are not ported "
                "yet; pass a float")
        if parameters is None:
            raise ValueError("parameters must be given (the model's "
                             "parameters())")
        parameters = list(parameters)
        if parameters and isinstance(parameters[0], dict):
            raise NotImplementedError("parameter groups are not ported yet")
        if weight_decay is not None \
                and not isinstance(weight_decay, (int, float)):
            raise NotImplementedError(
                "regularizer objects (L1Decay/L2Decay) are not ported yet; "
                "pass a float")
        self._learning_rate = float(learning_rate)
        self._parameter_list = parameters
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._step_count = 0

    def get_lr(self):
        return self._learning_rate

    def _decay_coeff(self):
        return 0.0 if self._weight_decay is None \
            else float(self._weight_decay)

    def _params_with_grad(self):
        return [p for p in self._parameter_list
                if p.grad is not None and p.requires_grad]

    @torch.no_grad()
    def step(self):
        """Clip the gradients, apply the update, count the step."""
        params = self._params_with_grad()
        if not params:
            return
        if self._grad_clip is not None:
            self._grad_clip(params)
        self._apply(params)
        self._step_count += 1

    def _apply(self, params):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        raise NotImplementedError("Optimizer.minimize (static graphs) is "
                                  "not ported yet; call loss.backward() "
                                  "and step()")


class SGD(Optimizer):
    """``p = p - lr*(g + wd*p)`` in f32 (optimizer.py:382-402)."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _apply(self, params):
        wd, lr = self._decay_coeff(), self._learning_rate
        for p in params:
            pf = p.float()
            g = p.grad.float() + wd * pf
            p.copy_(pf - lr * g)


class _AdamBase(Optimizer):
    def __init__(self, learning_rate, beta1, beta2, epsilon, parameters,
                 weight_decay, grad_clip, decoupled, apply_decay_param_fun):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        if callable(beta1) or callable(beta2):
            raise NotImplementedError("scheduled betas are not ported yet")
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._decoupled = decoupled
        self._apply_decay_param_fun = apply_decay_param_fun
        self._moments = {}

    def _decays(self, p):
        fun = self._apply_decay_param_fun
        return ((fun is None or fun(getattr(p, "param_name", None)))
                and getattr(p, "no_weight_decay", False) is False)

    def _apply(self, params):
        wd, lr = self._decay_coeff(), self._learning_rate
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        t = self._step_count + 1
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        for p in params:
            if id(p) not in self._moments:
                self._moments[id(p)] = (
                    torch.zeros_like(p, dtype=torch.float32),
                    torch.zeros_like(p, dtype=torch.float32))
            m, v = self._moments[id(p)]
            dm = wd if self._decays(p) else 0.0
            pf = p.float()
            g = p.grad.float()
            if not self._decoupled and dm != 0.0:
                g = g + dm * pf
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if self._decoupled and dm != 0.0:
                upd = upd + dm * pf
            p.copy_(pf - lr * upd)


class Adam(_AdamBase):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, apply_decay_param_fun=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, False,
                         apply_decay_param_fun)


class AdamW(_AdamBase):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None):
        if lr_ratio is not None:
            raise NotImplementedError("AdamW lr_ratio is not ported yet")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, True,
                         apply_decay_param_fun)
