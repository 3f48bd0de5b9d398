"""to_static: a step captured into a CUDA graph, replayed at each call.

Port of ``paddle_tpu/jit/trace.py`` (``TracedFunction``, ``to_static``,
``not_to_static``).  The reference traces the step into a pure function
and compiles it with XLA; the port records the step's launches into a
``torch.cuda.CUDAGraph`` and replays them.  Per call signature (the key
is the argument tree with each tensor's shape, dtype and device, as the
reference's ``_tree_key``):

1. the first call runs eagerly (the discovery run) and returns its
   result.  On a card it runs on the capture stream of the device, which
   the current stream waits for, so that it warms up what a capture must
   find made: the kernel library is loaded, cuBLAS handles exist,
   optimizer moments are born, and the wrappers' per-stream caches
   (``ops.cuda_lib.tickets``) belong to the capture stream;
2. the second call captures the function into a CUDA graph on that
   stream: the tensor arguments are copied into static buffers first,
   then the graph replays once and the call returns that result;
3. every later call copies its tensor arguments into the static buffers,
   runs the pre-replay hooks, replays, and returns new tensors (one device
   copy of each output, as the reference returns new arrays: the engine
   keeps ``pipeline_depth - 1`` steps of outputs in flight, and a replay
   overwrites its static outputs).  Each replay's outputs are admitted to
   the in-flight window (``core.pipeline``).

Where the step runs: the device of the first CUDA tensor among the
arguments; for a function without one (a closure such as ``step()``), the
first CUDA tensor among the discovery run's outputs, else the device of
the first CUDA parameter of a module the discovery run called.  Without
any, the function runs eagerly at every call (the CPU's path: there are
no graphs there), with the same cache keys and the same gradient rule.

What a replay keeps of Python: nothing.  Side effects of the function
(a Python counter, a host-side list) happen once, at capture; the state
of the optimizers and of the serving engine therefore lives in tensors.
Three things are carried across on purpose:

* the optimizers' learning rate: an optimizer whose ``step`` runs in the
  discovery or the capture registers its ``_sync_lr`` with the traced
  function (`recording`), which calls it before the capture and before
  every replay, so a scheduler's change reaches the graph;
* the kernel wrappers' launch counters: the change of every
  ``*launches`` counter of ``ops.KERNELS`` across the capture is added at
  each later replay, so counters read what as many eager calls read;
* random numbers: every CUDA ``torch.Generator`` passed as ``generator=``
  in the discovery run is registered with the graph
  (``CUDAGraph.register_generator_state``), so each replay draws new
  numbers and advances the generator, as eager calls would; the default
  generator is registered by PyTorch.

Gradients follow the reference's compiled semantics: a parameter whose
``.grad`` was born during the discovery run starts every later call with
``.grad = None`` (``trace.py:281-282``), so after a call it holds that
call's gradient (with ``clear_grad()`` inside the step, ``None``), as the
reference writes each compiled call's gradients back (``:453-461``).  A
replay writes them into the tensors that the capture's backward made, and
each call sets the parameters' ``.grad`` to those again: an optimizer
stepped outside the function reads them even after its ``clear_grad()``
dropped them, and the next call overwrites them in place.

A CUDA call captures or raises: a host read inside the function
(``.item()``, ``.cpu()``, ``bool()`` of a tensor) or a pageable
host-to-device copy raises a ``RuntimeError`` that names the function
and the line of the operation, chained to the capture's own error.  It
never falls back to eager execution.  ``full_graph=False`` and
``backend="sot"`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import functools
import gc
import linecache
import os
import time
import warnings

import torch
from torch.utils import _pytree as pytree

from ..core.place import capturing

__all__ = ["TracedFunction", "to_static", "not_to_static", "recording"]

#: traced functions whose discovery run or capture is under way
_recording = []


def recording():
    """The `TracedFunction` whose discovery run or capture is running,
    else None: optimizers register their pre-replay hook with it."""
    return _recording[-1] if _recording else None


def _tree_key(tree):
    """The cache key: the tree structure, then each tensor leaf's shape,
    dtype and device, and each other leaf's repr."""
    leaves, spec = pytree.tree_flatten(tree)
    parts = [str(spec)]
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            parts.append(f"T{tuple(leaf.shape)}:{leaf.dtype}:{leaf.device}")
        else:
            parts.append(f"V{leaf!r}")
    return "|".join(parts)


def _first_cuda(values):
    for v in values:
        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
            return v.device
    return None


def _launch_counters():
    """Every ``*launches`` counter of the kernel wrappers, by (wrapper,
    attribute)."""
    from .. import ops
    out = {}
    for fn in ops.KERNELS.values():
        for name, value in vars(fn).items():
            if name.endswith("launches") and isinstance(value, int):
                out[(fn, name)] = value
    return out


class _GeneratorRecorder(torch.overrides.TorchFunctionMode):
    """Notes every CUDA generator passed as ``generator=`` to a torch
    function while it is on (the discovery run)."""

    def __init__(self, found):
        super().__init__()
        self.found = found

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        gen = kwargs.get("generator")
        if isinstance(gen, torch.Generator) and gen.device.type == "cuda":
            self.found.setdefault(id(gen), gen)
        return func(*args, **kwargs)


class _Entry:
    """One call signature: its discovery facts and, on a card, its
    graph."""

    def __init__(self):
        self.device = None          # None: eager at every call
        self.grad_slots = []        # params whose .grad the step makes
        self.grads = []             # their .grad at the capture's end
        self.pre_replay = []        # hooks run before capture and replays
        self.generators = []        # CUDA generators to register
        self.graph = None
        self.static_in = None       # flat leaves of the static arguments
        self.static_out = None      # flat leaves of the captured outputs
        self.out_spec = None
        self.deltas = {}            # launch counters' change per replay
        self.capture_s = None       # seconds the capture took
        self.pool_bytes = None      # memory_reserved growth at capture
        self.replays = 0


class TracedFunction:
    """The callable that `to_static` returns (see the module doc).
    ``replays``, ``captures`` and ``eager_calls`` count what its calls
    did; ``_cache`` holds one entry per call signature."""

    def __init__(self, fn, input_spec=None):
        self._fn = fn
        self._orig_fn = fn
        self._input_spec = input_spec
        self._cache = {}
        self._streams = {}
        self._entry = None          # the entry being discovered/captured
        self.replays = 0
        self.captures = 0
        self.eager_calls = 0
        functools.update_wrapper(self, fn, updated=[])

    @property
    def forward(self):
        return self

    def _name(self):
        return getattr(self._orig_fn, "__qualname__", repr(self._orig_fn))

    def add_pre_replay(self, hook):
        """Run ``hook()`` before the capture and before every replay of
        the signature being discovered or captured (once per hook)."""
        entry = self._entry
        if entry is not None and hook not in entry.pre_replay:
            entry.pre_replay.append(hook)

    def __call__(self, *args, **kwargs):
        if capturing():
            return self._fn(*args, **kwargs)   # nested: inside a capture
        key = _tree_key((args, kwargs))
        entry = self._cache.get(key)
        if entry is None:
            entry = self._cache[key] = _Entry()
            return self._discover(entry, args, kwargs)
        if entry.device is None:
            for p in entry.grad_slots:
                p.grad = None
            self.eager_calls += 1
            return self._fn(*args, **kwargs)
        if entry.graph is None:
            return self._capture(entry, args, kwargs)
        return self._replay(entry, args, kwargs)

    def analyze_program(self, *args, **kwargs):
        raise NotImplementedError(
            "TracedFunction.analyze_program is not ported yet: the "
            "port's static analysis comes with static/ and dy2static")

    # ------------------------------------------------------------------
    def _stream(self, device):
        s = self._streams.get(device)
        if s is None:
            s = self._streams[device] = torch.cuda.Stream(device)
        return s

    def _discover(self, entry, args, kwargs):
        """The first call of a signature: eager, on the capture stream of
        the device where one is known, noting the parameters whose
        gradients it makes, the generators it draws from and the
        optimizers that step in it."""
        leaves = pytree.tree_flatten((args, kwargs))[0]
        dev = _first_cuda(leaves)
        if dev is None and torch.cuda.is_available():
            dev = torch.device("cuda", torch.cuda.current_device())
        seen = {}                   # id -> (param, grad was None)

        gens = {}

        def note_params(module, inputs):
            for p in module.parameters(recurse=False):
                if id(p) not in seen:
                    seen[id(p)] = (p, p.grad is None)

        handle = torch.nn.modules.module.register_module_forward_pre_hook(
            note_params)
        _recording.append(self)
        self._entry = entry
        try:
            with _GeneratorRecorder(gens):
                if dev is not None:
                    cur = torch.cuda.current_stream(dev)
                    s = self._stream(dev)
                    s.wait_stream(cur)
                    with torch.cuda.stream(s):
                        result = self._fn(*args, **kwargs)
                    cur.wait_stream(s)
                else:
                    result = self._fn(*args, **kwargs)
        finally:
            handle.remove()
            _recording.pop()
            self._entry = None
        self.eager_calls += 1
        entry.grad_slots = [p for p, was_none in seen.values()
                            if was_none and p.grad is not None]
        entry.generators = list(gens.values())
        entry.device = (_first_cuda(leaves)
                        or _first_cuda(pytree.tree_flatten(result)[0])
                        or _first_cuda(p for p, _ in seen.values()))
        return result

    def _capture(self, entry, args, kwargs):
        """The second call: static arguments, the pre-replay hooks, then
        the capture and one replay."""
        dev = entry.device
        leaves, spec = pytree.tree_flatten((args, kwargs))
        static = [l.detach().clone().requires_grad_(l.requires_grad)
                  if isinstance(l, torch.Tensor) else l for l in leaves]
        sargs, skwargs = pytree.tree_unflatten(static, spec)
        for p in entry.grad_slots:
            p.grad = None
        for hook in entry.pre_replay:
            hook()
        graph = torch.cuda.CUDAGraph()
        for gen in entry.generators:
            graph.register_generator_state(gen)
        s = self._stream(dev)
        before = _launch_counters()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        _recording.append(self)
        self._entry = entry
        cur = torch.cuda.current_stream(dev)
        # no garbage collection during the capture: collecting a dead
        # graph (an engine's, a traced function's) destroys it, a CUDA
        # call that invalidates the capture under way
        collecting = gc.isenabled()
        gc.disable()
        try:
            s.wait_stream(cur)
            with torch.cuda.device(dev):
                with torch.cuda.graph(graph, stream=s):
                    out = self._fn(*sargs, **skwargs)
        except Exception as e:
            _recover(graph, dev, cur, s, entry.generators)
            raise _capture_error(self._name(), e) from e
        finally:
            if collecting:
                gc.enable()
            _recording.pop()
            self._entry = None
        entry.capture_s = time.perf_counter() - t0
        entry.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        after = _launch_counters()
        entry.deltas = {k: v - before.get(k, 0) for k, v in after.items()
                        if v != before.get(k, 0)}
        entry.grads = [p.grad for p in entry.grad_slots]
        out_leaves, entry.out_spec = pytree.tree_flatten(out)
        entry.static_in = static
        entry.static_out = out_leaves
        entry.graph = graph
        self.captures += 1
        # the capture ran the wrappers' Python once: this replay is the
        # launches they counted
        return self._run(entry, add_counts=False)

    def _replay(self, entry, args, kwargs):
        leaves = pytree.tree_flatten((args, kwargs))[0]
        for st, l in zip(entry.static_in, leaves):
            if isinstance(st, torch.Tensor) and st.data_ptr() != \
                    l.data_ptr():
                st.copy_(l, non_blocking=True)
        for hook in entry.pre_replay:
            hook()
        return self._run(entry, add_counts=True)

    def _run(self, entry, add_counts):
        from ..core.pipeline import get_window
        with torch.cuda.device(entry.device):
            entry.graph.replay()
            outs = [o.detach().clone() if isinstance(o, torch.Tensor)
                    else o for o in entry.static_out]
        for p, g in zip(entry.grad_slots, entry.grads):
            p.grad = g
        entry.replays += 1
        self.replays += 1
        if add_counts:
            for (fn, name), d in entry.deltas.items():
                setattr(fn, name, getattr(fn, name) + d)
        get_window().admit(o for o in outs if isinstance(o, torch.Tensor))
        return pytree.tree_unflatten(outs, entry.out_spec)


def _recover(graph, dev, cur, stream, generators):
    """Undo what a capture whose end raised (a CUDA error invalidated it)
    leaves behind: ``torch.cuda.graph`` did not restore the current
    stream, the caching allocator still routes the capture stream's
    allocations to the graph's pool, and the generators' states are still
    in capture mode (every later draw would raise).  A capture of nothing
    on the same stream closes the generators' states."""
    torch.cuda.set_stream(cur)
    try:
        torch._C._cuda_endAllocateToPool(dev.index, graph.pool())
    except RuntimeError:
        pass                        # the capture ended cleanly
    closer = torch.cuda.CUDAGraph()
    for gen in generators:
        closer.register_generator_state(gen)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # "the CUDA Graph is empty"
        with torch.cuda.device(dev):
            with torch.cuda.graph(closer, stream=stream):
                pass
    torch.cuda.set_stream(cur)


def _torch_frame(filename):
    return os.sep + "torch" + os.sep in filename or \
        filename.endswith(os.path.join("jit", "trace.py"))


def _capture_error(name, error):
    """A RuntimeError naming the function and the line of the operation
    that broke the capture (the innermost frame outside torch and this
    module of the first error raised)."""
    root = error
    while root.__context__ is not None:
        root = root.__context__
    where = ""
    tb = root.__traceback__
    frame = None
    while tb is not None:
        if not _torch_frame(tb.tb_frame.f_code.co_filename):
            frame = tb
        tb = tb.tb_next
    if frame is not None:
        code = frame.tb_frame.f_code
        line = linecache.getline(code.co_filename, frame.tb_lineno).strip()
        where = f" at {code.co_filename}:{frame.tb_lineno} ({line})"
    msg = str(root).strip().splitlines()[0] if str(root).strip() else ""
    return RuntimeError(
        f"to_static({name}): the CUDA graph capture failed{where}: "
        f"{type(root).__name__}: {msg}.  A host read inside the function "
        f"(.item(), .cpu(), bool() of a tensor) or a pageable host-to-"
        f"device copy cannot be captured; move it out of the function")


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=True, **kwargs):
    """``paddle.jit.to_static``, as a decorator or a call: a
    `TracedFunction` over ``function``; a layer gets its ``forward``
    replaced by one.  Wrapping a `TracedFunction` again returns it (with
    a new ``input_spec``, a new one over its original function), as the
    reference does.  ``full_graph=False`` and ``backend="sot"`` (the
    reference's SOT capture) raise ``NotImplementedError``;
    ``build_strategy`` and other keywords are taken and not read, as the
    reference takes them."""

    def decorate(fn):
        if not full_graph or backend == "sot":
            raise NotImplementedError(
                "to_static(full_graph=False) / backend='sot' is not ported "
                "yet: SOT comes with core/lazy.py")
        if isinstance(fn, TracedFunction):
            if input_spec is None:
                return fn
            fn = fn._orig_fn
        if isinstance(fn, torch.nn.Module):
            fwd = fn.forward
            if isinstance(fwd, TracedFunction):
                if input_spec is None:
                    return fn
                fwd = fwd._orig_fn
            fn.forward = TracedFunction(fwd, input_spec)
            return fn
        return TracedFunction(fn, input_spec)

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    """Mark ``fn`` (the reference's marker; nothing reads it)."""
    fn._not_to_static = True
    return fn
