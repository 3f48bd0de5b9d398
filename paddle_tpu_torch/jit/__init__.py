"""paddle.jit: ``to_static`` on CUDA graphs (see ``trace``).

Port of ``paddle_tpu/jit/__init__.py``: ``to_static``, ``not_to_static``,
``TracedFunction``, ``enable_to_static``, ``ignore_module`` and ``grad``.
``save`` and ``load`` raise ``NotImplementedError``: they need the ctypes
kernels as ``torch.library`` custom ops before ``torch.export`` can carry
them.
"""
from __future__ import annotations

import torch

from .trace import TracedFunction, not_to_static, to_static

__all__ = ["to_static", "not_to_static", "save", "load", "TracedFunction",
           "enable_to_static", "ignore_module", "grad"]


def enable_to_static(flag=True):
    """``True`` is what the port does anyway.  The reference stores the
    flag and nothing reads it (``jit/__init__.py:29-34``), so ``False``
    raises rather than pretend to switch capture off."""
    if not flag:
        raise NotImplementedError(
            "enable_to_static(False) is not ported: the reference ignores "
            "the flag, and the port does not pretend to honour it")


def ignore_module(modules):
    """A no-op, as in the reference."""


def save(layer, path, input_spec=None, **configs):
    raise NotImplementedError(
        "jit.save is not ported yet: it needs the CUDA kernels as "
        "torch.library custom ops, so that torch.export can carry them")


def load(path, **configs):
    raise NotImplementedError(
        "jit.load is not ported yet: it needs the CUDA kernels as "
        "torch.library custom ops, so that torch.export can carry them")


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """``paddle.grad`` (the reference's ``core/autograd.py:31-47``):
    gradients of ``outputs`` with respect to ``inputs``, without touching
    ``.grad``, through ``torch.autograd.grad``.  An input the outputs do
    not reach gets zeros, or None with ``allow_unused``.  The graph is
    kept with ``retain_graph`` or ``create_graph``.  ``no_grad_vars``
    (constants chosen after the forward) has no counterpart in torch's
    autograd and raises ``NotImplementedError``."""
    if no_grad_vars:
        raise NotImplementedError("grad(no_grad_vars=...) is not ported")
    if isinstance(outputs, torch.Tensor):
        outputs = [outputs]
    if isinstance(inputs, torch.Tensor):
        inputs = [inputs]
    if isinstance(grad_outputs, torch.Tensor):
        grad_outputs = [grad_outputs]
    keep = bool(retain_graph) or bool(create_graph)
    grads = torch.autograd.grad(outputs, inputs, grad_outputs=grad_outputs,
                                retain_graph=keep,
                                create_graph=create_graph, allow_unused=True)
    return [g if g is not None else
            (None if allow_unused else torch.zeros_like(t))
            for g, t in zip(grads, inputs)]
