"""paddle.amp: ``auto_cast`` at levels O1 and O2, ``decorate`` and
``GradScaler``, for the port's functionals.

Port of ``paddle_tpu/amp/__init__.py`` (``auto_cast`` :105, the rule of
``_amp_caster`` :76-96, ``decorate`` :129, ``GradScaler`` :143-250) with
the reference's op lists, copied from
``paddle_tpu/ops/_generated.py:1196-1198``.  Inside ``auto_cast()`` at O1
an op on the white list casts its floating inputs to the AMP dtype, an op
on the black list casts them to f32, and any other op leaves them as they
are; at O2 every op off the black list casts them to the AMP dtype.  The
port's functionals consult it by the reference's op names (see
`cast_inputs`): ``linear``, ``linear_act``, ``matmul_v2`` (the tied LM
head), ``scaled_dot_product_attention``, ``layer_norm``, ``rms_norm``,
``cross_entropy``, ``embedding``, ``dropout`` and the others of
``nn.functional``.  The reference casts the inputs of every dispatched
op; the port's models add residuals and reshape with plain torch ops,
whose dtypes follow from the functionals' (``tests/test_torch_amp_o2.py``
holds each GPT block's output dtype to the reference's under O2).

``torch.autocast`` is not used: it does not reach the ctypes kernels
and keeps other lists.

``decorate(level="O2")`` casts every floating parameter and buffer of
the models to the AMP dtype in place.  No f32 master weights are kept:
the reference's docstring says the optimizers keep them, but its update
rounds the f32 math back into the low-precision parameter, and the
port's optimizers do the same.  ``master_weight`` and ``save_dtype`` are
accepted and not read, as in the reference.

``GradScaler`` is the reference's dynamic loss scaling: ``scale``
multiplies the loss, ``unscale_`` divides the gradients and checks them
for inf/NaN (two multi-tensor passes, ``torch._foreach_mul_`` and
``torch._foreach_norm`` of the largest magnitude, and one host read a
step), ``step`` skips the update on a non-finite gradient and then calls
``update``, which grows the scale after ``incr_every_n_steps`` good
steps and shrinks it (to at least 1) after ``decr_every_n_nan_or_inf``
bad ones.  As in the reference,
``unscale_`` does not mark the optimizer, so ``step`` unscales again, and
``step`` runs ``update`` itself.  ``auto_cast()``'s default dtype is
float16, as the reference's: every kernel has an f16 route, and the
scaler guards f16 steps (``chip_smoke.py`` phases 41-42).
"""
from __future__ import annotations

import contextlib

import torch

from ..core import to_torch_dtype
from ..core.place import capturing

__all__ = ["auto_cast", "decorate", "GradScaler", "cast_inputs",
           "current_state", "restore_state"]

#: the reference's O1 lists (ops/_generated.py AMP_WHITE_LIST and
#: AMP_BLACK_LIST)
WHITE_LIST = frozenset({
    "addmm", "bmm", "conv1d", "conv1d_transpose", "conv2d",
    "conv2d_transpose", "conv3d", "conv3d_transpose", "einsum", "inner",
    "linear", "linear_act", "linear_act_int8", "lora_segment_act",
    "matmul_v2", "mm", "mv", "scaled_dot_product_attention"})
BLACK_LIST = frozenset({
    "batch_norm", "c_softmax_with_cross_entropy", "cross_entropy",
    "elementwise_pow", "erf", "exp", "fused_residual_layer_norm",
    "group_norm", "hsigmoid_loss", "instance_norm", "layer_norm", "log",
    "log10", "log1p", "log2", "log_softmax", "logsumexp",
    "multi_margin_loss", "p_norm", "reduce_mean", "reduce_prod",
    "reduce_sum", "rms_norm", "softmax", "softmax_with_cross_entropy",
    "square", "std", "variance"})


class _AmpState:
    def __init__(self, enable, dtype, white, black, level="O1"):
        self.enable = enable
        self.dtype = dtype
        self.white = white
        self.black = black
        self.level = level


_amp_stack = []


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="float16", use_promote=True):
    """Cast the inputs of the port's functionals by the O1 or O2 rule
    while the context is open (level O0 casts nothing).  Custom lists
    move op names between the lists, as the reference's do."""
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"level must be O0, O1 or O2, got {level!r}")
    white, black = set(WHITE_LIST), set(BLACK_LIST)
    if custom_white_list:
        white |= set(custom_white_list)
        black -= set(custom_white_list)
    if custom_black_list:
        black |= set(custom_black_list)
        white -= set(custom_black_list)
    _amp_stack.append(_AmpState(bool(enable) and level != "O0",
                                to_torch_dtype(dtype), frozenset(white),
                                frozenset(black), level))
    try:
        yield
    finally:
        _amp_stack.pop()


def current_state():
    """The AMP state in force now (None outside any ``auto_cast``), for
    `restore_state` to re-enter later: recompute captures it at the first
    forward and replays the block's forward under it during backward,
    which runs outside the ``auto_cast`` block."""
    return _amp_stack[-1] if _amp_stack else None


@contextlib.contextmanager
def restore_state(state):
    """Run the body under a state `current_state` returned (None: no
    casting, whatever ``auto_cast`` is open around it)."""
    _amp_stack.append(state if state is not None else _AmpState(
        False, None, frozenset(), frozenset()))
    try:
        yield
    finally:
        _amp_stack.pop()


def decorate(models, optimizers=None, level="O1", dtype="float16",
             master_weight=None, save_dtype=None, **kwargs):
    """``paddle.amp.decorate``: O2 casts every floating parameter and
    buffer of ``models`` (one module or a list) to ``dtype`` in place, so
    an optimizer built before keeps its parameters; O1 leaves them as
    they are.  Returns ``models``, or ``(models, optimizers)``."""
    if level == "O2":
        target = to_torch_dtype(dtype)
        items = models if isinstance(models, (list, tuple)) else [models]
        with torch.no_grad():
            for m in items:
                for t in list(m.parameters()) + list(m.buffers()):
                    if t.is_floating_point() and t.dtype != target:
                        t.data = t.data.to(target)
    if optimizers is None:
        return models
    return models, optimizers


def cast_inputs(op_name, *tensors):
    """The AMP rule for one op inside an enabled ``auto_cast``: its
    floating tensors cast to f32 (black list), or to the AMP dtype (the
    white list at O1, every other op at O2); returned unchanged
    otherwise.  ``None`` entries pass through."""
    st = _amp_stack[-1] if _amp_stack else None
    if st is None or not st.enable:
        return tensors
    if op_name in st.black:
        target = torch.float32
    elif st.level == "O2" or op_name in st.white:
        target = st.dtype
    else:
        return tensors
    return tuple(t.to(target) if t is not None and t.is_floating_point()
                 and t.dtype != target else t for t in tensors)


class GradScaler:
    """Dynamic loss scaling, the reference's (amp/__init__.py:143-250).
    The scale is a host float, and `scale` multiplies by its copy in a 0-d
    f32 tensor on the loss's device, made at the first call there and
    written (one ``fill_``) wherever `update` or `load_state_dict` changes
    the scale: a step captured by ``jit.to_static`` with
    ``scaler.scale(loss).backward()`` inside and ``scaler.step(opt);
    scaler.update()`` outside reads the current scale at every replay."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._scale_t = {}          # device -> 0-d f32 copy of the scale

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    def scale(self, var):
        """``var * scale`` (the scale's f32 tensor on ``var``'s device)."""
        if not self._enable:
            return var
        t = self._scale_t.get(var.device)
        if t is None:
            _refuse_capture("GradScaler.scale's first call on a device")
            t = self._scale_t[var.device] = torch.full(
                (), self._scale, dtype=torch.float32, device=var.device)
        return var * t

    def _set_scale(self, value):
        if value != self._scale:
            self._scale = value
            for t in self._scale_t.values():
                t.fill_(value)

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide the optimizer's gradients by the scale (a product by its
        inverse in f32, rounded to each gradient's dtype) and note whether
        any is inf or NaN (each gradient's largest magnitude in f32: an
        inf stays inf and a NaN propagates; one host read a step); the
        first such gradient is recorded by name
        (``debugging.last_nonfinite``)."""
        if not self._enable:
            return
        _refuse_capture("GradScaler.unscale_")
        params = optimizer._params_with_grad()
        self._found_inf = False
        if not params:
            return
        grads = [p.grad for p in params]
        torch._foreach_mul_(grads, 1.0 / self._scale)
        peaks = torch._foreach_norm(grads, float("inf"), dtype=torch.float32)
        device = peaks[0].device
        if not bool(torch.isfinite(torch.stack(
                [t.to(device) for t in peaks])).all()):
            from .debugging import first_nonfinite
            first_nonfinite([(optimizer._name(p), p.grad) for p in params])
            self._found_inf = True

    def step(self, optimizer):
        """`unscale_`, the optimizer's step unless a gradient was inf or
        NaN, then `update`.  It unscales even after an explicit
        `unscale_`, as the reference does."""
        if not self._enable:
            optimizer.step()
            return
        _refuse_capture("GradScaler.step")
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def update(self):
        if not self._dynamic:
            return
        _refuse_capture("GradScaler.update")
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._set_scale(max(self._scale * self._decr_ratio, 1.0))
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._set_scale(self._scale * self._incr_ratio)
                self._good_steps = 0

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n_steps,
                "decr_every_n_nan_or_inf": self._decr_every_n,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._set_scale(float(state.get("scale", self._scale)))
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)

    set_state_dict = load_state_dict


def _refuse_capture(what):
    """`GradScaler` reads ``found_inf`` on the host at each step, as the
    reference's does (``paddle_tpu/amp/__init__.py:189-197``), and keeps
    its scale on the host, so a CUDA graph can hold neither: refuse them
    under ``jit.to_static``'s capture (only `scale` of a device whose
    scale tensor exists can be captured)."""
    if capturing():
        raise RuntimeError(
            f"{what} under jit.to_static's capture: the scaler reads "
            "found_inf and keeps its scale on the host, which a CUDA graph "
            "cannot replay; keep unscale_/step/update outside the captured "
            "step, or run the scaled step eagerly")


from . import debugging  # noqa: E402,F401
