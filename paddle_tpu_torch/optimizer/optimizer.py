"""Optimizers with Paddle's API, each a multi-tensor update.

Port of ``paddle_tpu/optimizer/optimizer.py``: the ``Optimizer`` base
(:61-380) and ``SGD``, ``Momentum``, ``Adam``, ``AdamW``, ``Adamax``,
``Adagrad``, ``Adadelta``, ``RMSProp`` and ``Lamb`` (:382-817).

The base keeps the reference's contract:

* ``learning_rate`` is a float or an ``lr.LRScheduler``, read at every
  step (``get_lr``, ``set_lr``, ``set_lr_scheduler``);
* ``parameters`` is a list of tensors or of groups (``{"params": [...],
  ...}``), which are flattened into one list as the reference flattens
  them (:73-79): a group's other keys are kept in ``_param_groups`` and
  not read;
* ``weight_decay`` is a float, an ``L2Decay`` (the decay coefficient) or
  an ``L1Decay`` (``coeff*sign(p)`` added to every gradient after the
  clip, :158-166);
* ``step`` runs the pre-step hooks (`register_pre_step_hook`) unless
  `run_pre_step_hooks` already ran them, returns without a change if a
  hook set the ``_skip_apply`` latch, then clips, adds the L1 term,
  applies the update and counts the step (:140-168);
* ``state_dict`` holds ``{name}_{accumulator}`` for every accumulator,
  ``global_step``, ``LR_Scheduler`` (a scheduler's own state) and
  ``__param_names__``, the parameters' names in order, by which
  ``set_state_dict`` maps saved state onto the parameters by position
  (:287-345), so a fresh optimizer takes over a saved one, and the
  reference's saved state too;
* ``minimize(loss, parameters=, no_grad_set=)`` runs ``loss.backward()``
  and one step restricted to those parameters (:179-219).  The port has
  no static graphs: a ``startup_program`` or a loss that is not a tensor
  raises ``NotImplementedError``.

A parameter's name is its ``param_name`` (the port's models set it to the
structured name, ``gpt.h.0.ln_1.bias``; a tensor's ``.name`` is torch's
own), else ``param_{i}`` by its place in the list.  ``Adam``/``AdamW``
pass it to ``apply_decay_param_fun``.

The reference issues one fused dispatch over every parameter a step.  The
port's counterpart is ``torch._foreach_*``: the parameters are grouped by
(device, dtype, decay flag), and each step of the formula is one
``_foreach`` call over a group, in the reference's order of operations,
in f32, with the same code on the CPU and the card.  Accumulators are f32
for bf16/f16 parameters.  A bf16 parameter is read into an f32 copy and
the result is rounded back into it, as the reference rounds (:549); there
are no f32 master weights (the reference keeps none: ``_master_weights``,
:86, is never written).  Groups are split into chunks of at most
`CHUNK_ELEMENTS` elements, which bounds the f32 temporaries.
``torch._fused_adamw_`` and ``torch.optim`` are not used: they round in
their own order and hold the decay mask differently.

The learning rate and the step count live on the device, as the
reference's do (:64-85): each parameter device has a 0-d f32
``_lr_tensor`` and an int64 ``_step_count`` (the first parameter's device
under those names, every device in ``_dev_state``).  Every update reads
the rate there (``p - lr*upd`` as a multiply and a subtract; the Adam
family folds it into its bias correction, `_AdamBase`), and the
scalar factors that depend on the step (``1 - b1**t`` of Adam, AdamW,
Adamax and Lamb, and the counters of ``extra.py``) are computed from the
step tensor in f32, as the reference's traced update computes them
(``1.0 - b1**(step + 1)``).  `_sync_lr` writes the rate with one
``fill_`` when it changed (``set_lr``, ``set_lr_scheduler``, a
scheduler's step), and ``step`` advances the count with ``add_(1)``.
``get_lr`` still returns a Python float.

Under ``jit.to_static``'s capture the step is recorded into a CUDA graph:
``step`` then does not write the rate (a write inside the graph would
replay the capture's value) but registers `_sync_lr` with the traced
function, which calls it before every replay, so a replay reads the
scheduler's current rate; the ``add_(1)`` is in the graph, so each replay
advances the count.  A callable (scheduled) beta is read on the host at
each step and raises ``NotImplementedError`` under capture.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from ..core.place import capturing
from ..jit import trace as _trace
from ..regularizer import L1Decay
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb",
           "register_pre_step_hook", "run_pre_step_hooks"]

#: the most elements one multi-tensor chunk covers: each f32 temporary
#: list of an update is at most this many floats (256 MiB), or one
#: tensor where a tensor is larger.  Chunks of 2^26 kept the AdamW step
#: over GPT-1.3B's parameters as fast as 2^28 (PERF.md, the sweep of
#: ``scripts/torch_optimizer_compare.py --sweep``) and add a third of
#: the memory to the peak
CHUNK_ELEMENTS = 1 << 26

# Pre-step hooks: callables(optimizer, params) run at the top of every
# step() (gradient poisoning in fault drills, non-finite sentinels).
_pre_step_hooks = []
_hooks_ran = threading.local()


def register_pre_step_hook(fn):
    """Register ``fn(optimizer, params)`` to run before each update.
    Returns a zero-argument remover."""
    _pre_step_hooks.append(fn)

    def remove():
        try:
            _pre_step_hooks.remove(fn)
        except ValueError:
            pass
    return remove


def run_pre_step_hooks(optimizer, params):
    """Run the hooks ahead of ``step()`` (``amp.debugging.
    skip_step_on_nonfinite`` does, so that an injected fault lands before
    its check); the next ``step()`` then does not run them again."""
    for hook in list(_pre_step_hooks):
        hook(optimizer, params)
    _hooks_ran.flag = True


def steps_f32(step):
    """``t = step + 1`` in f32 from the int64 step tensor, as the
    reference's ``(step + 1).astype(f32)``."""
    return (step + 1).to(torch.float32)


def bias_correction(beta_, t):
    """``1 - beta**t`` in f32 on ``t``'s device (``beta_`` a float)."""
    return 1.0 - torch.pow(beta_, t)


def as_f32(tensors):
    """The list itself when every tensor is f32, else f32 copies."""
    if all(t.dtype == torch.float32 for t in tensors):
        return tensors
    return [t.float() for t in tensors]


def store(params, values):
    """Round the f32 results back into the parameters (a no-op when the
    update ran in place on f32 parameters)."""
    if values is not params:
        torch._foreach_copy_(params, values)


def chunks(params, flags=None):
    """Indices of ``params`` by (device, dtype, flag), in order, each
    group cut into runs of at most `CHUNK_ELEMENTS` elements (a larger
    tensor is a run of its own)."""
    groups = OrderedDict()
    for i, p in enumerate(params):
        key = (p.device, p.dtype, None if flags is None else flags[i])
        groups.setdefault(key, []).append(i)
    for key, idx in groups.items():
        run, size = [], 0
        for i in idx:
            n = params[i].numel()
            if run and size + n > CHUNK_ELEMENTS:
                yield key[2], run
                run, size = [], 0
            run.append(i)
            size += n
        if run:
            yield key[2], run


class Optimizer:
    """The base (module docstring).  ``multi_precision`` is accepted and
    not read: there are no f32 master weights."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if isinstance(learning_rate, bool) or not isinstance(
                learning_rate, (int, float, LRScheduler)):
            raise TypeError(f"learning_rate must be a float or an "
                            f"LRScheduler, got {learning_rate!r}")
        if parameters is None:
            raise ValueError("parameters must be given (the model's "
                             "parameters())")
        parameters = list(parameters)
        self._param_groups = None
        if parameters and isinstance(parameters[0], dict):
            self._param_groups = parameters
            parameters = [p for g in parameters for p in g["params"]]
        self._learning_rate = learning_rate
        self._parameter_list = parameters
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._accumulators = OrderedDict()  # name -> {param name: tensor}
        # device -> (0-d f32 learning rate, 0-d int64 step count)
        self._dev_state = OrderedDict()
        self._lr_last = None
        self._device_state(parameters[0].device if parameters
                           else torch.device("cpu"))
        self._skip_apply = False
        self._names = {}
        for p in parameters:
            self._name(p)

    # ---- names ----
    def _name(self, p):
        name = self._names.get(id(p))
        if name is None:
            name = getattr(p, "param_name", None) \
                or f"param_{len(self._names)}"
            while name in self._names.values():
                name = f"{name}_{len(self._names)}"
            self._names[id(p)] = name
        return name

    # ---- lr handling ----
    def _current_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return float(self._learning_rate)

    def get_lr(self):
        return self._current_lr()

    def set_lr(self, value):
        self._learning_rate = float(value)
        self._sync_lr()

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler
        self._sync_lr()

    def _sync_lr(self):
        """Write the current rate into every device's rate tensor (one
        ``fill_`` each), skipped while it is unchanged (:103-114)."""
        lr = self._current_lr()
        if lr == self._lr_last:
            return
        self._lr_last = lr
        for lr_t, _ in self._dev_state.values():
            lr_t.fill_(lr)

    # ---- device state ----
    def _device_state(self, device):
        """``(lr, step)``: the 0-d rate and step tensors on ``device``,
        made at first use (the step copied from the first device's)."""
        st = self._dev_state.get(device)
        if st is None:
            lr = torch.full((), self._current_lr(), dtype=torch.float32,
                            device=device)
            if self._dev_state:
                step = self._step_count.to(device, copy=True)
            else:
                step = torch.zeros((), dtype=torch.int64, device=device)
            st = self._dev_state[device] = (lr, step)
        return st

    @property
    def _lr_tensor(self):
        """The rate tensor of the first parameter device."""
        return next(iter(self._dev_state.values()))[0]

    @property
    def _step_count(self):
        """The step-count tensor of the first parameter device."""
        return next(iter(self._dev_state.values()))[1]

    def _advance(self):
        """Count one applied step on every device (a device op, so a
        replayed step counts too)."""
        for _, step in self._dev_state.values():
            step.add_(1)

    # ---- accumulators ----
    def _acc(self, name, param, init=0.0):
        d = self._accumulators.setdefault(name, {})
        key = self._name(param)
        if key not in d:
            dtype = torch.float32 if param.dtype in (
                torch.bfloat16, torch.float16) else param.dtype
            t = torch.empty_like(param, dtype=dtype,
                                 memory_format=torch.contiguous_format)
            d[key] = t.fill_(init)     # a float or a 0-d device tensor
        return d[key]

    def _accs(self, name, params, init=0.0):
        return [self._acc(name, p, init) for p in params]

    def _params_with_grad(self):
        return [p for p in self._parameter_list
                if p.grad is not None and p.requires_grad]

    # ---- main API ----
    def _sync_lr_for_step(self):
        """The rate write of a step: now when eager; under capture,
        registered with the traced function to run before each replay
        (and before the capture)."""
        rec = _trace.recording()
        if rec is not None:
            rec.add_pre_replay(self._sync_lr)
        if not capturing():
            self._sync_lr()

    @torch.no_grad()
    def step(self):
        """Run the pre-step hooks, clip the gradients, add the L1 term,
        apply the update, count the step."""
        self._sync_lr_for_step()
        params = self._params_with_grad()
        if not params:
            return
        if getattr(_hooks_ran, "flag", False):
            _hooks_ran.flag = False            # a sentinel already ran them
        else:
            for hook in list(_pre_step_hooks):
                hook(self, params)
        if self._skip_apply:
            # a hook asked this step to be a no-op: gradients and the step
            # count stay as they are (bias corrections count applied steps)
            self._skip_apply = False
            return
        if self._grad_clip is not None:
            self._grad_clip(params)
        l1 = self._l1_coeff()
        if l1:
            grads = [p.grad for p in params]
            signs = torch._foreach_sign([p.detach() for p in params])
            for p, g in zip(params, torch._foreach_add(grads, signs,
                                                       alpha=l1)):
                p.grad = g
        self._apply(params)
        self._advance()

    #: whether the L2 coefficient is added to the gradients ahead of the
    #: update (AdamW decays in the update, Adamax not at all)
    _coupled_decay = True

    def _flags(self, params):
        """A flag a parameter, by which `_apply` groups them and which it
        passes to `_update` (None: one flag for all).  A parameter flagged
        False takes no coupled decay."""
        return None

    def _scalars(self, device):
        """The step's scalar factors on ``device``, computed once a step
        and a device and passed to `_update`: the rate tensor here."""
        return self._device_state(device)[0]

    def _apply(self, params):
        """Walk ``params`` by `chunks`: f32 views of a chunk's parameters
        and gradients, the coupled decay ``g + wd*p`` added to the
        gradients, `_update` on the f32 values in place, then `store`."""
        scalars = {}
        wd = self._decay_coeff() if self._coupled_decay else 0.0
        for flag, idx in chunks(params, self._flags(params)):
            ps = [params[i] for i in idx]
            dev = ps[0].device
            if dev not in scalars:
                scalars[dev] = self._scalars(dev)
            s = scalars[dev]
            pf = as_f32(ps)
            gf = as_f32([p.grad for p in ps])
            if wd and flag is not False:
                gf = torch._foreach_add(gf, pf, alpha=wd)
            self._update(ps, pf, gf, flag, s)
            store(ps, pf)

    def _update(self, ps, pf, gf, flag, s):
        """Update the f32 parameter values ``pf`` of parameters ``ps`` from
        the f32 gradients ``gf`` and the step's scalars ``s``."""
        raise NotImplementedError

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` and one ``step()`` over ``parameters`` (the
        constructor's list by default) less ``no_grad_set``, for this call
        only.  Returns ``(None, None)``."""
        if startup_program is not None or not isinstance(loss,
                                                         torch.Tensor):
            raise NotImplementedError(
                "Optimizer.minimize on a static graph is not ported yet; "
                "pass the loss tensor of an eager forward")
        scoped = self._parameter_list
        if parameters is not None:
            scoped = list(parameters)
        if no_grad_set:
            excl = {id(t) for t in no_grad_set}
            scoped = [p for p in scoped if id(p) not in excl]
        loss.backward()
        if scoped is not self._parameter_list:
            prev, self._parameter_list = self._parameter_list, scoped
            try:
                self.step()
            finally:
                self._parameter_list = prev
        else:
            self.step()
        return None, None

    # ---- state dict ----
    def state_dict(self):
        """The accumulators by ``{name}_{accumulator}`` (the tensors
        themselves), ``global_step``, ``LR_Scheduler`` and the parameter
        names in order (``__param_names__``)."""
        out = {}
        for acc_name, d in self._accumulators.items():
            for pname, t in d.items():
                out[f"{pname}_{acc_name}"] = t
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        out["global_step"] = self._step_count.detach().clone()
        out["__param_names__"] = [self._name(p)
                                  for p in self._parameter_list
                                  if p.requires_grad]
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """Load a `state_dict` (tensors or numpy arrays; the reference's
        too).  With ``__param_names__``, saved parameter i's accumulators
        go to this optimizer's parameter i, whatever the names; without
        it, accumulators are matched by name into the existing ones."""
        def value(src, like):
            src = src if isinstance(src, torch.Tensor) \
                else torch.tensor(np.asarray(src))
            return src.to(device=like.device, dtype=like.dtype)

        saved_names = state_dict.get("__param_names__")
        if saved_names is not None:
            cur = [p for p in self._parameter_list if p.requires_grad]
            by_len = sorted(saved_names, key=len, reverse=True)
            pos = {n: i for i, n in enumerate(saved_names)}
            for key, src in state_dict.items():
                if key in ("LR_Scheduler", "global_step",
                           "__param_names__"):
                    continue
                for n in by_len:          # the longest prefix wins
                    if key.startswith(n + "_"):
                        i = pos[n]
                        if i < len(cur):
                            t = self._acc(key[len(n) + 1:], cur[i])
                            t.copy_(value(src, t))
                        break
        else:
            for acc_name, d in self._accumulators.items():
                for pname, t in d.items():
                    key = f"{pname}_{acc_name}"
                    if key in state_dict:
                        t.copy_(value(state_dict[key], t))
        if "LR_Scheduler" in state_dict and isinstance(
                self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        if "LR_Scheduler" in state_dict or "global_step" in state_dict:
            self._sync_lr()
        if "global_step" in state_dict:
            src = state_dict["global_step"]
            src = src if isinstance(src, torch.Tensor) \
                else torch.as_tensor(np.array(src))
            for _, step in self._dev_state.values():
                step.copy_(src.reshape(()).to(torch.int64))

    set_dict = set_state_dict

    # ---- regularizers ----
    def _decay_coeff(self):
        """The L2 coefficient of the update's decay term (0 for
        ``L1Decay``, whose term `step` adds to the gradients)."""
        wd = self._weight_decay
        if wd is None or isinstance(wd, L1Decay):
            return 0.0
        if hasattr(wd, "_coeff"):
            return float(wd._coeff)
        return float(wd)

    def _l1_coeff(self):
        wd = self._weight_decay
        return float(wd._coeff) if isinstance(wd, L1Decay) else 0.0


class SGD(Optimizer):
    """``p = p - lr*(g + wd*p)`` (optimizer.py:382-414)."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _update(self, ps, pf, gf, flag, lr):
        torch._foreach_sub_(pf, torch._foreach_mul(gf, lr))


class Momentum(Optimizer):
    """``v = mu*v + g``, ``p = p - lr*v`` (Nesterov: ``p - lr*(g +
    mu*v)``), with ``g = g + wd*p`` (optimizer.py:417-471)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update(self, ps, pf, gf, flag, lr):
        mu = float(self._momentum)
        vs = self._accs("velocity", ps)
        torch._foreach_mul_(vs, mu)
        torch._foreach_add_(vs, gf)
        upd = torch._foreach_add(gf, vs, alpha=mu) if self._nesterov \
            else vs
        torch._foreach_sub_(pf, torch._foreach_mul(upd, lr))


def beta(b):
    """A beta: a float, or a callable returning one (a schedule, read on
    the host: refused under capture, where it would be frozen)."""
    if callable(b):
        if capturing():
            raise NotImplementedError(
                "a callable (scheduled) beta under jit.to_static's capture "
                "is not ported yet: it is read on the host at each step, "
                "and a CUDA graph would replay the capture's value")
        return float(b())
    return float(b)


class _AdamBase(Optimizer):
    """The Adam family's update (optimizer.py:518-568):

        g = g + wd*p                         (Adam: coupled decay)
        m = b1*m + (1-b1)*g,  v = b2*v + (1-b2)*g*g,
        upd = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)
        upd = upd + wd*p                     (AdamW: decoupled decay)
        p = p - lr*upd

    with ``t`` the number of steps applied so far plus one and the betas
    read once a step (a callable beta is a schedule).  The device rate is
    folded into the first bias correction, ``(lr / (1 - b1^t)) * m``, and
    AdamW's decay term into one product, ``upd + (lr*wd)*p``, then ``p =
    p - upd``: the same formula with the rate on the device and no more
    passes over memory than a host rate takes (a separate ``lr*upd``
    would add one over every moment-sized list).  The decay stays inside
    the rounded sum, as in the reference's order, whose rounding this
    differs from by an ulp of the update (a factor ``1 - lr*wd`` on ``p``
    would round to the f32 values next to 1 and quantise the decay).  A
    parameter decays unless
    ``apply_decay_param_fun(name)`` is false or it carries
    ``no_weight_decay = True`` (:522-526)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, lazy_mode=False,
                 multi_precision=False, use_multi_tensor=True,
                 decoupled=False, apply_decay_param_fun=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._decoupled = decoupled
        self._coupled_decay = not decoupled
        self._apply_decay_param_fun = apply_decay_param_fun

    def _flags(self, params):
        fun = self._apply_decay_param_fun
        return [bool((fun is None or fun(self._name(p)))
                     and getattr(p, "no_weight_decay", False) is False)
                for p in params]

    def _scalars(self, device):
        b1, b2 = beta(self._beta1), beta(self._beta2)
        lr, step = self._device_state(device)
        t = steps_f32(step)
        wd = self._decay_coeff() if self._decoupled else 0.0
        return (lr / bias_correction(b1, t), b1, b2,
                bias_correction(b2, t), lr * wd if wd else None)

    def _update(self, ps, pf, gf, decays, s):
        lr_bc1, b1, b2, bc2, lr_wd = s
        ms = self._accs("moment1", ps)
        vs = self._accs("moment2", ps)
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gf, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gf, gf, value=1 - b2)
        upd = torch._foreach_mul(ms, lr_bc1)
        den = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, float(self._epsilon))
        torch._foreach_div_(upd, den)
        del den
        if lr_wd is not None and decays:
            torch._foreach_addcmul_(upd, pf, [lr_wd] * len(pf))
        torch._foreach_sub_(pf, upd)


class Adam(_AdamBase):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, decoupled=False, **kw)


class AdamW(_AdamBase):
    """Adam with decoupled weight decay (0.01 by default).  ``lr_ratio``
    is accepted and not used, as in the reference (optimizer.py:579-586),
    which takes it and applies one learning rate to every parameter."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, decoupled=True,
                         apply_decay_param_fun=apply_decay_param_fun, **kw)


class Adamax(Optimizer):
    """``m = b1*m + (1-b1)*g``, ``u = max(b2*u, |g|)``, ``p = p -
    lr*m/(1 - b1^t)/(u + eps)``; no weight decay, as in the reference
    (optimizer.py:589-630)."""

    _coupled_decay = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _scalars(self, device):
        lr, step = self._device_state(device)
        return lr, bias_correction(float(self._beta1), steps_f32(step))

    def _update(self, ps, pf, gf, flag, s):
        lr, bc1 = s
        b1, b2 = float(self._beta1), float(self._beta2)
        ms = self._accs("moment", ps)
        us = self._accs("inf_norm", ps)
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gf, alpha=1 - b1)
        torch._foreach_mul_(us, b2)
        torch._foreach_maximum_(us, torch._foreach_abs(gf))
        upd = torch._foreach_div(ms, bc1)
        torch._foreach_div_(upd, torch._foreach_add(us, float(self._epsilon)))
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(pf, upd)


class Adagrad(Optimizer):
    """``a = a + g*g``, ``p = p - lr*g/(sqrt(a) + eps)`` with ``g = g +
    wd*p`` (optimizer.py:633-667)."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _update(self, ps, pf, gf, flag, lr):
        accs = self._accs("moment", ps, self._init_acc)
        torch._foreach_addcmul_(accs, gf, gf)
        den = torch._foreach_sqrt(accs)
        torch._foreach_add_(den, float(self._epsilon))
        upd = torch._foreach_mul(gf, lr)
        torch._foreach_div_(upd, den)
        torch._foreach_sub_(pf, upd)


class Adadelta(Optimizer):
    """``s = rho*s + (1-rho)*g*g``, ``upd = sqrt(u + eps)/sqrt(s +
    eps)*g``, ``u = rho*u + (1-rho)*upd*upd``, ``p = p - lr*upd`` with
    ``g = g + wd*p`` (optimizer.py:670-708)."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon, self._rho = epsilon, rho

    def _update(self, ps, pf, gf, flag, lr):
        eps, rho = float(self._epsilon), float(self._rho)
        sqs = self._accs("avg_squared_grad", ps)
        ups = self._accs("avg_squared_update", ps)
        torch._foreach_mul_(sqs, rho)
        torch._foreach_addcmul_(sqs, gf, gf, value=1 - rho)
        upd = torch._foreach_add(ups, eps)
        torch._foreach_sqrt_(upd)
        den = torch._foreach_add(sqs, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, gf)
        torch._foreach_mul_(ups, rho)
        torch._foreach_addcmul_(ups, upd, upd, value=1 - rho)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(pf, upd)


class RMSProp(Optimizer):
    """``s = rho*s + (1-rho)*g*g``; centered: ``a = rho*a + (1-rho)*g``
    and ``d = sqrt(s - a*a + eps)``, else ``d = sqrt(s + eps)``; ``v =
    mu*v + lr*g/d``, ``p = p - v``; with ``g = g + wd*p``
    (optimizer.py:711-762)."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _update(self, ps, pf, gf, flag, lr):
        rho, eps = float(self._rho), float(self._epsilon)
        mss = self._accs("mean_square", ps)
        moms = self._accs("momentum", ps)
        mgs = self._accs("mean_grad", ps)
        torch._foreach_mul_(mss, rho)
        torch._foreach_addcmul_(mss, gf, gf, value=1 - rho)
        if self._centered:
            torch._foreach_mul_(mgs, rho)
            torch._foreach_add_(mgs, gf, alpha=1 - rho)
            den = torch._foreach_addcmul(mss, mgs, mgs, value=-1)
            torch._foreach_add_(den, eps)
        else:
            den = torch._foreach_add(mss, eps)
        torch._foreach_sqrt_(den)
        upd = torch._foreach_mul(gf, lr)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(moms, float(self._momentum))
        torch._foreach_add_(moms, upd)
        torch._foreach_sub_(pf, moms)


class Lamb(Optimizer):
    """Adam's moments, then ``r = (m/(1 - b1^t))/(sqrt(v/(1 - b2^t)) +
    eps) + wd*p`` and ``p = p - lr*ratio*r`` with the trust ratio
    ``|p|/|r|`` (1 where either norm is 0), each parameter its own
    (optimizer.py:765-817).  ``exclude_from_weight_decay_fn(p)`` (given
    the parameter) takes a parameter out of the decay."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None, **kw):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _flags(self, params):
        return [not (self._exclude_fn and self._exclude_fn(p))
                for p in params]

    def _scalars(self, device):
        lr, step = self._device_state(device)
        t = steps_f32(step)
        return (lr, bias_correction(float(self._beta1), t),
                bias_correction(float(self._beta2), t))

    def _update(self, ps, pf, gf, decays, s):
        lr, bc1, bc2 = s
        b1, b2 = float(self._beta1), float(self._beta2)
        wd = float(self._lamb_wd)
        ms = self._accs("moment1", ps)
        vs = self._accs("moment2", ps)
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gf, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gf, gf, value=1 - b2)
        r = torch._foreach_div(ms, bc1)
        den = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, float(self._epsilon))
        torch._foreach_div_(r, den)
        del den
        if decays and wd != 0.0:
            torch._foreach_add_(r, pf, alpha=wd)
        w_norm = torch.stack(torch._foreach_norm(pf))
        r_norm = torch.stack(torch._foreach_norm(r))
        ratio = torch.where((w_norm > 0) & (r_norm > 0),
                            w_norm / r_norm, 1.0)
        torch._foreach_mul_(r, list((lr * ratio).unbind()))
        torch._foreach_sub_(pf, r)
