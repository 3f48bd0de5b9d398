"""Structured serving-tier errors: load shedding, watchdog, failover.

Ported whole from ``paddle_tpu/inference/serving/errors.py``.  The
engine of this slice raises none of them yet (shedding, the watchdog and
replica failover are not ported); they are the contract later slices
raise.

These are the serving fleet's *contract* errors — every one carries
machine-readable fields (not just a message) so a front-end can turn
them into protocol responses (429 / 503 / retry hints) and tests can
assert on the cause instead of parsing strings:

  * :class:`RequestRejected` — admission shed the request
    (``PADDLE_TPU_SERVE_SHED_DEPTH``): overload degrades to a fast,
    structured rejection instead of a TTFT collapse;
  * :class:`ServingStepTimeout` — the decode watchdog
    (``PADDLE_TPU_SERVE_STEP_DEADLINE_MS``) saw a step exceed its
    wall-clock deadline; the batch was already rolled back
    (refcount-aware ``truncate()``) and requeued before this raised;
  * :class:`ServingUnavailable` — no healthy replica can take work
    (every replica is UNHEALTHY and none has reached its probation
    window).
"""
from __future__ import annotations

__all__ = ["ServingError", "RequestRejected", "ServingStepTimeout",
           "ServingUnavailable"]


class ServingError(RuntimeError):
    """Base class for structured serving-tier errors."""


class RequestRejected(ServingError):
    """Admission shed this request (the 429 path).

    ``reason`` is a stable machine-readable string (``"overloaded"``),
    ``queue_depth`` the waiting-queue depth that tripped the bound,
    ``shed_depth`` the configured bound, ``request_id`` the id the
    request would have been assigned.  ``to_response()`` renders the
    dict a protocol front-end would serialize.
    """

    def __init__(self, reason, queue_depth=None, shed_depth=None,
                 request_id=None):
        super().__init__(
            f"request rejected ({reason}): queue depth {queue_depth} "
            f">= shed bound {shed_depth}")
        self.reason = str(reason)
        self.queue_depth = queue_depth
        self.shed_depth = shed_depth
        self.request_id = request_id

    def to_response(self):
        return {"code": 429, "reason": self.reason,
                "queue_depth": self.queue_depth,
                "shed_depth": self.shed_depth,
                "request_id": self.request_id}


class ServingStepTimeout(ServingError):
    """The decode watchdog marked a step as hung.

    By the time this raises the engine has already rolled the step back
    (every reserved KV slot released with the refcount-aware
    ``truncate()``) and requeued the affected requests with their
    committed progress — stepping again, or failing over to another
    replica, replays them deterministically.
    """

    def __init__(self, step, elapsed_ms, deadline_ms, requests=()):
        requests = list(requests)
        super().__init__(
            f"serving step {step} exceeded its deadline: "
            f"{elapsed_ms:.1f} ms > {deadline_ms:.1f} ms "
            f"({len(requests)} request(s) rolled back and requeued)")
        self.step = int(step)
        self.elapsed_ms = float(elapsed_ms)
        self.deadline_ms = float(deadline_ms)
        self.requests = requests


class ServingUnavailable(ServingError):
    """No healthy (or probation-eligible) replica can take work."""
