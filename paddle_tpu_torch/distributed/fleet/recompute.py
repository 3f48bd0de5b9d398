"""Activation recompute (gradient checkpointing).

Port of ``paddle_tpu/distributed/fleet/recompute.py`` (``recompute``
:22-75), over ``torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)``: the forward keeps only the function's inputs,
and the backward runs the function again to rebuild what it needs.

The replay happens inside ``backward()``, which two things of the port
would otherwise see differently from the first forward:

* the O1 state: ``amp.auto_cast`` is the port's own stack, not
  ``torch.autocast``, and ``backward()`` usually runs after the
  ``auto_cast`` block has closed.  The state in force at the first
  forward is captured and re-entered for the replay, so the replay casts
  exactly as the forward did;
* the model's own ``torch.Generator`` (dropout masks are drawn from it,
  not from the default generators ``checkpoint`` saves): its state is
  saved before the first forward and set again for the replay, so the
  replay draws the same masks; the state that stood when the replay
  began is restored after it, so later draws do not change.

The memory guard's global switch (``remat_enabled()`` in the reference)
is not ported yet: recompute is on only where a model asks for it.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ... import amp

__all__ = ["recompute"]


def _generators(function):
    """The ``torch.Generator``s of the modules ``function`` runs (a module,
    or a bound method of one), each once."""
    owner = function if isinstance(function, torch.nn.Module) \
        else getattr(function, "__self__", None)
    if not isinstance(owner, torch.nn.Module):
        return []
    found = {}
    for mod in owner.modules():
        gen = getattr(mod, "generator", None)
        if isinstance(gen, torch.Generator):
            found.setdefault(id(gen), gen)
    return list(found.values())


def recompute(function, *args, use_reentrant=True, preserve_rng_state=True,
              **kwargs):
    """Run ``function(*args, **kwargs)`` keeping only its inputs for the
    backward, which runs it again.  ``preserve_rng_state`` replays the
    same random draws (the default generators' and the modules' own);
    ``use_reentrant`` is accepted for Paddle's signature, and the replay
    is always PyTorch's non-reentrant one.  Without grad mode it is a
    plain call."""
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    amp_state = amp.current_state()
    gens = _generators(function) if preserve_rng_state else []
    at_forward = [g.get_state() for g in gens]
    calls = []

    def run(*inputs):
        if not calls:
            calls.append(1)
            return function(*inputs, **kwargs)
        at_replay = [g.get_state() for g in gens]
        for g, state in zip(gens, at_forward):
            g.set_state(state)
        try:
            with amp.restore_state(amp_state):
                return function(*inputs, **kwargs)
        finally:
            for g, state in zip(gens, at_replay):
                g.set_state(state)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state)
