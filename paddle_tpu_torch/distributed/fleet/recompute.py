"""Activation recompute (gradient checkpointing).

Port of ``paddle_tpu/distributed/fleet/recompute.py`` (``recompute``
:22-75 and ``recompute_sequential`` :76-93), over
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the
forward keeps only the function's inputs, and the backward runs the
function again to rebuild what it needs.

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
  began is restored after it, so later draws do not change.  Under
  ``jit.to_static``'s capture a generator's state cannot be taken and
  set again: a function whose modules drew nothing in the eager
  (discovery) run is captured without it, and one that drew (dropout >
  0) raises ``NotImplementedError``.

The memory guard's global switch (``remat_enabled()`` in the reference)
is not ported yet: recompute is on only where a model asks for it.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ... import amp
from ...core.place import capturing

__all__ = ["recompute", "recompute_sequential"]


def _owner(function):
    """The module ``function`` is (or is a bound method of), or None."""
    owner = function if isinstance(function, torch.nn.Module) \
        else getattr(function, "__self__", None)
    return owner if isinstance(owner, torch.nn.Module) else None


def _generators(owner):
    """The ``torch.Generator``s of the modules under ``owner``, each
    once."""
    if owner is None:
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
    owner = _owner(function)
    gens = _generators(owner) if preserve_rng_state else []
    if gens and capturing():
        # a CUDA graph cannot take a generator's state and set it again
        # (the states are host numbers, the graph's offsets its own):
        # capture a function whose modules drew nothing in the eager
        # (discovery) run, and refuse one that drew
        if getattr(owner, "_recompute_draws", True):
            raise NotImplementedError(
                "recompute of a function that draws from its modules' "
                "generators (dropout > 0) under jit.to_static's capture is "
                "not ported yet")
        gens = []
    at_forward = [g.get_state() for g in gens]
    calls = []

    def run(*inputs):
        if not calls:
            calls.append(1)
            out = function(*inputs, **kwargs)
            if gens:
                owner._recompute_draws = any(
                    not torch.equal(g.get_state(), s)
                    for g, s in zip(gens, at_forward))
            return out
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


def recompute_sequential(ctx, functions, *args, **kwargs):
    """``recompute_sequential({"segments": k}, Sequential(...), input)``:
    the layers of ``functions`` cut into runs of ``len // k`` (at least
    1), each run recomputed as one function of the previous run's
    output.  A run of modules is wrapped in a ``torch.nn.Sequential``, so
    that their generators replay too."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    seg_size = max(len(layers) // max(segments, 1), 1)
    x = args[0]
    for i in range(0, len(layers), seg_size):
        seg = layers[i:i + seg_size]
        if all(isinstance(l, torch.nn.Module) for l in seg):
            run = torch.nn.Sequential(*seg)
        else:
            def run(t, seg=seg):
                for l in seg:
                    t = l(t)
                return t
        x = recompute(run, x, **kwargs)
    return x
