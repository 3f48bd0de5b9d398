"""paddle.amp ``auto_cast`` at level O1, for the port's functionals.

Port of ``paddle_tpu/amp/__init__.py`` (``auto_cast`` :105, the O1 rule
of ``_amp_caster`` :76-96) with the reference's op lists, copied from
``paddle_tpu/ops/_generated.py:1196-1198``.  Inside ``auto_cast()`` an
op on the white list casts its floating inputs to the AMP dtype, an op
on the black list casts them to f32, and any other op leaves them as
they are.  The port's functionals that the GPT path runs consult it by
the reference's op names: ``linear``, ``linear_act``, ``matmul_v2``
(the tied LM head), ``scaled_dot_product_attention``, ``layer_norm``
and ``cross_entropy`` (see `cast_inputs`).

``torch.autocast`` is not used: it does not reach the ctypes kernels
and keeps other lists.  O2 and ``decorate(level="O2")`` raise
``NotImplementedError``; ``GradScaler`` is not ported (bf16 needs no
loss scaling).
"""
from __future__ import annotations

import contextlib

import torch

from ..core import to_torch_dtype

__all__ = ["auto_cast", "decorate", "cast_inputs", "current_state",
           "restore_state"]

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
    def __init__(self, enable, dtype, white, black):
        self.enable = enable
        self.dtype = dtype
        self.white = white
        self.black = black


_amp_stack = []


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="float16", use_promote=True):
    """Cast the inputs of the port's functionals by the O1 lists while
    the context is open (level O0 casts nothing).  Custom lists move op
    names between the lists, as the reference's do."""
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"level must be O0, O1 or O2, got {level!r}")
    if level == "O2":
        raise NotImplementedError("auto_cast level O2 is not ported yet")
    white, black = set(WHITE_LIST), set(BLACK_LIST)
    if custom_white_list:
        white |= set(custom_white_list)
        black -= set(custom_white_list)
    if custom_black_list:
        black |= set(custom_black_list)
        white -= set(custom_black_list)
    _amp_stack.append(_AmpState(bool(enable) and level == "O1",
                                to_torch_dtype(dtype), frozenset(white),
                                frozenset(black)))
    try:
        yield
    finally:
        _amp_stack.pop()


def current_state():
    """The O1 state in force now (None outside any ``auto_cast``), for
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


def decorate(models, optimizers=None, level="O1", dtype="float16"):
    """``paddle.amp.decorate``: O1 leaves models and optimizers as they
    are (the reference does the same); O2 is not ported."""
    if level == "O2":
        raise NotImplementedError("amp.decorate level O2 is not ported yet")
    return models if optimizers is None else (models, optimizers)


def cast_inputs(op_name, *tensors):
    """The O1 rule for one op: its floating tensors cast to the AMP dtype
    (white list) or to f32 (black list) inside an enabled ``auto_cast``;
    returned unchanged otherwise.  ``None`` entries pass through."""
    st = _amp_stack[-1] if _amp_stack else None
    if st is None or not st.enable:
        return tensors
    if op_name in st.white:
        target = st.dtype
    elif op_name in st.black:
        target = torch.float32
    else:
        return tensors
    return tuple(t.to(target) if t is not None and t.is_floating_point()
                 and t.dtype != target else t for t in tensors)
