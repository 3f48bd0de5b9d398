"""The functionals GPT serving and training call, on ``torch.Tensor``.

Port of ``paddle_tpu/nn/functional/common.py`` (``linear`` :31,
``linear_act`` :54, ``embedding`` :523, ``dropout``),
``nn/functional/norm.py`` (``layer_norm`` :22),
``nn/functional/loss.py`` (``cross_entropy`` :38, its fused hard-label
path), ``nn/functional/flash_attention.py``
(``scaled_dot_product_attention`` with the composite ``_sdpa_ref``
:27-54) and ``ops/_generated.py`` (``matmul`` :305).  Weights keep
Paddle's ``[in, out]`` layout.  The reference routes ``layer_norm``,
``linear_act`` and ``cross_entropy`` through its Pallas kernels; here
they call the port's differentiable kernel entry points, which take the
plain versions for CPU tensors and launch the CUDA kernels (forward and
backward) for CUDA tensors.  Plain GEMMs and lookups stay PyTorch ops,
as the reference left them to XLA.  Each functional the reference's AMP
lists name casts its inputs by the O1 rule (``amp.cast_inputs``).
"""
from __future__ import annotations

import torch

from .. import amp
from .. import ops
from ..ops.tiles import NEG_INF

__all__ = ["linear", "linear_act", "matmul", "embedding", "layer_norm",
           "dropout", "scaled_dot_product_attention", "cross_entropy"]


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]``."""
    x, weight, bias = amp.cast_inputs("linear", x, weight, bias)
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def linear_act(x, weight, bias, act="none"):
    """``act(x @ weight + bias)`` through the matmul-epilogue kernels."""
    x, weight, bias = amp.cast_inputs("linear_act", x, weight, bias)
    return ops.linear_act(x.contiguous(), weight, bias, act)


def matmul(x, y, transpose_x=False, transpose_y=False):
    """``paddle.matmul`` (op ``matmul_v2``) over the last two dims."""
    x, y = amp.cast_inputs("matmul_v2", x, y)
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def embedding(x, weight):
    """Row lookup: ``weight[x]``."""
    return torch.nn.functional.embedding(x, weight)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """Layer norm over the last dim with ``weight`` and ``bias``, through
    the layer-norm kernels.  Other forms (no affine parameters, several
    axes) are not ported yet."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    if len(tuple(normalized_shape)) != 1 or weight is None or bias is None:
        raise NotImplementedError(
            "layer_norm without affine parameters or over several axes "
            "is not ported yet")
    x, weight, bias = amp.cast_inputs("layer_norm", x, weight, bias)
    return ops.layer_norm(x.contiguous(), weight, bias, epsilon)


def dropout(x, p=0.5, training=True, generator=None):
    """Inverted dropout (Paddle's ``upscale_in_train``): zero each value
    with probability ``p`` and scale the rest by ``1/(1-p)``.  The mask
    is drawn from ``generator`` (the model's own), not the global RNG."""
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


def _sdpa_composite(q, k, v, is_causal):
    """The reference's ``_sdpa_ref`` (flash_attention.py:27-54), op for
    op, over ``[b, s, h, d]``: scores in f32 (the bf16 products are exact
    in f32) scaled after the product; masked scores -1e30; an f32
    softmax; the probabilities cast to the input type; rows with no
    visible key zeroed; the PV product accumulated in f32 and cast."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = 1.0 / d ** 0.5
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    scores = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * scale
    if is_causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if is_causal:
        visible = (scores > -1e29).any(dim=-1, keepdim=True)
        probs = torch.where(visible, probs, 0.0)
    # a bf16 product accumulates in f32 and rounds once, as the
    # reference's preferred_element_type=f32 einsum then astype
    out = torch.matmul(probs, vt)
    return out.transpose(1, 2).to(q.dtype)


def scaled_dot_product_attention(q, k, v, is_causal=False,
                                 use_flash=True):
    """Dense attention over ``[b, s, h, d]``.

    ``use_flash=False`` is the reference's ``sdp_kernel(
    enable_flash=False)``: the composite ``_sdpa_ref`` on any device.
    ``use_flash=True`` is the flash-attention kernel's path, which is not
    ported yet: it runs the composite on CPU tensors and raises on CUDA
    tensors."""
    q, k, v = amp.cast_inputs("scaled_dot_product_attention", q, k, v)
    if use_flash and q.device.type != "cpu":
        raise NotImplementedError(
            "dense flash attention (the flash-attention kernel) is not "
            "ported yet; train with use_flash_attention=False or serve "
            "through the paged cache")
    return _sdpa_composite(q, k, v, is_causal)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Hard-label softmax cross-entropy over the last dim through the
    softmax cross-entropy kernels, as the reference's fused path does
    (loss.py:57-72): labels equal to ``ignore_index`` are relabelled to
    -1 (zero loss and gradient), and ``"mean"`` divides the sum by the
    number of valid labels (at least 1).  Soft labels, class weights,
    label smoothing and other axes are not ported yet."""
    if soft_label or weight is not None or label_smoothing != 0.0 \
            or not use_softmax or axis not in (-1, input.dim() - 1):
        raise NotImplementedError(
            "cross_entropy with soft labels, class weights, label "
            "smoothing, use_softmax=False or another axis is not ported "
            "yet")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, got "
                         f"{reduction!r}")
    (input,) = amp.cast_inputs("cross_entropy", input)
    lab = label
    if lab.dim() == input.dim() and lab.shape[-1] == 1:
        lab = lab.squeeze(-1)
    valid = lab != ignore_index
    loss = ops.fused_softmax_cross_entropy(
        input, torch.where(valid, lab, -1).to(torch.int64))
    if reduction == "mean":
        return loss.sum() / valid.sum().to(loss.dtype).clamp_min(1.0)
    if reduction == "sum":
        return loss.sum()
    return loss
