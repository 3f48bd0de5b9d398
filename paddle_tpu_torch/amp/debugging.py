"""paddle.amp.debugging: non-finite checks that name the tensor at fault.

Port of ``paddle_tpu/amp/debugging.py``: ``NonFiniteError``,
``check_numerics`` (:107), ``first_nonfinite`` (:95), ``last_nonfinite``
(:89) and ``skip_step_on_nonfinite`` (:121-146), the shared skip-step
sentinel: it runs the optimizer's pre-step hooks first (so an injected
fault lands before the check), checks the gradients, and steps only when
all are finite.  The reports are kept here; the reference also emits them
as observability events, and the port has no observability layer yet.

The operator-stats functions ride on the reference's dispatch registry,
which the port does not have, and its tensor checker is a switch the
registry reads: those functions raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

__all__ = ["enable_operator_stats_collection",
           "disable_operator_stats_collection", "collect_operator_stats",
           "check_numerics", "enable_tensor_checker",
           "disable_tensor_checker", "DebugMode", "NonFiniteError",
           "first_nonfinite", "last_nonfinite", "skip_step_on_nonfinite"]


class DebugMode:
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 4


class NonFiniteError(FloatingPointError):
    """NaN/Inf detected; names the offending tensor and producing op."""

    def __init__(self, var_name="", op_type="", kind="nan/inf"):
        self.var_name = var_name
        self.op_type = op_type
        self.kind = kind
        where = ":".join(p for p in (op_type, var_name) if p) or "<tensor>"
        super().__init__(f"{kind} detected in {where}")


_last_nonfinite = {"report": None}


def _not_ported(what):
    raise NotImplementedError(
        f"amp.debugging.{what} needs the dispatch registry, which is not "
        f"ported yet")


def enable_operator_stats_collection():
    _not_ported("enable_operator_stats_collection")


def disable_operator_stats_collection():
    _not_ported("disable_operator_stats_collection")


def collect_operator_stats():
    _not_ported("collect_operator_stats")


def enable_tensor_checker(config=None):
    _not_ported("enable_tensor_checker")


def disable_tensor_checker():
    _not_ported("disable_tensor_checker")


def _kind_of(t):
    """'nan', 'inf', 'nan/inf' or None for a tensor."""
    t = t.detach()
    has_nan = bool(torch.isnan(t).any())
    has_inf = bool(torch.isinf(t).any())
    if has_nan and has_inf:
        return "nan/inf"
    if has_nan:
        return "nan"
    if has_inf:
        return "inf"
    return None


def _record(var_name, op_type, kind):
    report = {"var_name": var_name, "op_type": op_type, "kind": kind}
    _last_nonfinite["report"] = report
    return report


def last_nonfinite():
    """The most recent non-finite report (``{var_name, op_type, kind}``)
    or None."""
    return _last_nonfinite["report"]


def first_nonfinite(named_tensors):
    """Scan ``named_tensors`` (a dict name -> tensor, or an iterable of
    (name, tensor)) and return the first offending report, else None."""
    items = named_tensors.items() if hasattr(named_tensors, "items") \
        else named_tensors
    for name, t in items:
        if t is None:
            continue
        kind = _kind_of(t)
        if kind is not None:
            return _record(name, "", kind)
    return None


def check_numerics(tensor, op_type="", var_name="",
                   debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT):
    """``(has_nan, has_inf)`` as bool tensors; a non-finite tensor is
    recorded, and raises `NonFiniteError` in ``CHECK_NAN_INF_AND_ABORT``
    mode."""
    kind = _kind_of(tensor)
    if kind is not None:
        _record(var_name, op_type, kind)
        if debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
            raise NonFiniteError(var_name, op_type, kind)
    return (torch.tensor(kind in ("nan", "nan/inf")),
            torch.tensor(kind in ("inf", "nan/inf")))


def skip_step_on_nonfinite(optimizer, named_grads=None):
    """Step ``optimizer`` unless a gradient about to be applied is
    non-finite.  ``named_grads`` overrides the gradients checked (by
    default the optimizer's parameters with a gradient, after its
    pre-step hooks ran).  Returns True (and records the first offending
    name) when the step was skipped, else False."""
    from ..optimizer import optimizer as opt_mod
    if named_grads is None:
        params = optimizer._params_with_grad()
        opt_mod.run_pre_step_hooks(optimizer, params)
        named_grads = [(optimizer._name(p), p.grad) for p in params]
    if first_nonfinite(named_grads) is not None:
        # not stepping: clear the hooks-already-ran latch so the next
        # independent step() runs its hooks
        opt_mod._hooks_ran.flag = False
        return True
    optimizer.step()
    return False
