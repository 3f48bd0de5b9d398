"""Async step pipeline primitives: lazy fetch handles and the bounded
in-flight window.

Port of ``paddle_tpu/core/pipeline.py``.  A dispatched step returns
before the device has finished it; reading one of its outputs on the
host is the synchronisation point.

* `FetchHandle` holds a live device tensor; its first host read
  (``numpy()``, ``float()``, ``item()``) waits for the step that
  produced it and copies it back.  ``shape`` and ``dtype`` never wait.
* `InFlightWindow` bounds the steps dispatched and not yet waited on
  (``PADDLE_TPU_PIPELINE_DEPTH``, default 2).  Every dispatch admits its
  outputs; while more than ``depth - 1`` older steps are outstanding the
  oldest is waited on before the newest returns.  Depth 1 waits on every
  step before control returns, the fully synchronous loop.

On the card the window records one CUDA event on the current stream for
each admitted step and waits on the oldest one with ``synchronize()``.
A step whose outputs all lie on the CPU has finished when it returns, so
admitting it waits for nothing; the window still counts the waits it
would make (``waits``), so a CPU run shows the card's schedule.
"""
from __future__ import annotations

import os
import threading
from collections import deque

import torch

__all__ = ["ENV_PIPELINE_DEPTH", "pipeline_depth", "FetchHandle",
           "InFlightWindow", "get_window", "drain"]

ENV_PIPELINE_DEPTH = "PADDLE_TPU_PIPELINE_DEPTH"
_DEFAULT_DEPTH = 2


def pipeline_depth():
    """Max dispatched-but-unsynchronised steps (at least 1).  Read at each
    call, so a test can change the variable between steps."""
    try:
        d = int(os.environ.get(ENV_PIPELINE_DEPTH, _DEFAULT_DEPTH))
    except ValueError:
        return _DEFAULT_DEPTH
    return max(1, d)


def _cuda_event(values):
    """One CUDA event recorded on the current stream of the first CUDA
    tensor's device, or None when no value lies on a card."""
    for v in values:
        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(v.device))
            return ev
    return None


class FetchHandle:
    """A fetch that has been dispatched but not synchronised: the live
    device tensor, copied to the host at its first read."""

    __slots__ = ("_value", "label", "step", "_host")

    def __init__(self, value, label=None, step=None):
        self._value = value
        self.label = label
        self.step = step
        self._host = None

    @property
    def shape(self):
        return tuple(self._value.shape)

    @property
    def dtype(self):
        return self._value.dtype

    @property
    def value(self):
        """The live device tensor (no synchronisation)."""
        return self._value

    def is_ready(self):
        if self._value.device.type != "cuda":
            return True
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self._value.device))
        return ev.query()

    def block_until_ready(self):
        if self._value.device.type == "cuda":
            torch.cuda.current_stream(self._value.device).synchronize()
        return self

    def numpy(self):
        """The sync point: the device-to-host copy at the first read."""
        if self._host is None:
            v = self._value.detach()
            if v.dtype == torch.bfloat16:
                v = v.float()
            self._host = v.cpu().numpy()
        return self._host

    def tensor(self):
        """The device tensor itself (no host transfer)."""
        return self._value

    def item(self):
        return self.numpy().item()

    def __array__(self, dtype=None, copy=None):
        h = self.numpy()
        return h.astype(dtype) if dtype is not None else h

    def __float__(self):
        return float(self.numpy())

    def __int__(self):
        return int(self.numpy())

    def __bool__(self):
        return bool(self.numpy())

    def __len__(self):
        return int(self._value.shape[0])

    def __repr__(self):
        state = "ready" if self.is_ready() else "in-flight"
        return (f"FetchHandle({self.label or 'fetch'}, "
                f"shape={self.shape}, dtype={self.dtype}, {state})")


class InFlightWindow:
    """Bounded window of dispatched-but-unsynchronised steps.

    ``admit(values)`` registers one dispatch's outputs; while more than
    ``depth - 1`` older dispatches remain, the oldest is waited on.  With
    depth 1 the admitted dispatch itself is waited on before ``admit``
    returns.  ``waits`` counts the steps waited on (by ``admit`` and
    ``drain``)."""

    def __init__(self, depth=None):
        self._depth = depth  # None: read the variable at each admit
        self._lock = threading.Lock()
        self._tickets = deque()
        self.waits = 0

    def _resolve_depth(self):
        return self._depth if self._depth is not None else pipeline_depth()

    def __len__(self):
        with self._lock:
            return len(self._tickets)

    def _wait(self, ticket):
        self.waits += 1
        if ticket[0] is not None:
            ticket[0].synchronize()

    def admit(self, values, label=None, step=None):
        """Register one dispatch; wait on the oldest steps past the
        bound."""
        depth = self._resolve_depth()
        ticket = (_cuda_event(tuple(values)), label, step)
        with self._lock:
            self._tickets.append(ticket)
        while True:
            with self._lock:
                if len(self._tickets) <= depth - 1:
                    break
                oldest = self._tickets.popleft()
            self._wait(oldest)

    def drain(self):
        """Wait on every outstanding step (loop exit, shutdown)."""
        while True:
            with self._lock:
                if not self._tickets:
                    break
                oldest = self._tickets.popleft()
            self._wait(oldest)


_window = None
_window_lock = threading.Lock()


def get_window():
    """The process-wide in-flight window every dispatcher admits into."""
    global _window
    if _window is None:
        with _window_lock:
            if _window is None:
                _window = InFlightWindow()
    return _window


def drain():
    """Synchronise all in-flight steps."""
    if _window is not None:
        _window.drain()

