"""The functionals GPT, LLaMA, BERT and ERNIE serving and training call,
on ``torch.Tensor``.

Port of ``paddle_tpu/nn/functional/common.py`` (``linear`` :31,
``linear_act`` :54, ``linear_act_int8`` :130, ``lora_segment_act`` :80, ``embedding`` :523,
``dropout``),
``nn/functional/activation.py`` (``silu``, ``tanh``),
``nn/functional/norm.py`` (``layer_norm`` :22,
``fused_residual_layer_norm`` :58, ``rms_norm`` :103),
``nn/functional/loss.py`` (``cross_entropy`` :38, its fused hard-label
path), ``nn/functional/flash_attention.py``
(``scaled_dot_product_attention`` :85 with its routing, the composite
``_sdpa_ref`` :27-54, ``flash_attention`` :124 and ``sdp_kernel`` :216)
and ``ops/_generated.py`` (``matmul`` :305).  Weights keep Paddle's
``[in, out]`` layout.  The reference routes ``layer_norm``,
``fused_residual_layer_norm``, ``linear_act``, ``linear_act_int8``,
``rms_norm`` (with a weight), ``lora_segment_act``, ``cross_entropy``
and dense attention
without dropout through its Pallas kernels; here
they call the port's kernel entry points (differentiable, but for the
int8 epilogue), which take the plain versions for CPU tensors and launch
the CUDA kernels (forward and backward) for CUDA tensors.  Plain GEMMs
and lookups stay PyTorch ops, as the reference left them to XLA.  Each
functional the reference's AMP lists name casts its inputs by the O1
rule (``amp.cast_inputs``).
"""
from __future__ import annotations

import threading

import torch

from .. import amp
from .. import ops
from ..ops.tiles import NEG_INF, min_rows

__all__ = ["linear", "linear_act", "linear_act_int8", "lora_segment_act",
           "matmul",
           "embedding", "layer_norm", "fused_residual_layer_norm",
           "rms_norm", "silu", "tanh", "dropout",
           "scaled_dot_product_attention", "flash_attention", "sdp_kernel",
           "cross_entropy"]


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]``."""
    x, weight, bias = amp.cast_inputs("linear", x, weight, bias)
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def linear_act(x, weight, bias, act="none"):
    """``act(x @ weight + bias)`` through the matmul-epilogue kernels."""
    x, weight, bias = amp.cast_inputs("linear_act", x, weight, bias)
    return ops.linear_act(x.contiguous(), weight, bias, act)


def linear_act_int8(x, weight_q, weight_scale, bias=None, act="none"):
    """``act((x @ weight_q) * weight_scale + bias)`` through the int8
    matmul-epilogue kernel: ``weight_q`` ``[in, out]`` int8 codes,
    ``weight_scale`` ``[out]`` f32, applied to the f32 accumulator after
    the product.  A missing bias is f32 zeros, as in the reference.  The
    op is on the O1 white list: under ``auto_cast`` its floating inputs
    (x, the scale and the bias; the codes are not floating) are cast to
    the AMP dtype, as the reference casts them, and the scale is read back
    in f32 by the kernel, as the reference's ``astype(f32)`` reads it."""
    if bias is None:
        bias = torch.zeros(weight_q.shape[-1], dtype=torch.float32,
                           device=x.device)
    x, weight_q, weight_scale, bias = amp.cast_inputs(
        "linear_act_int8", x, weight_q, weight_scale, bias)
    return ops.fused_linear_act_int8(x.contiguous(), weight_q,
                                     weight_scale.float(), bias, act)


def lora_segment_act(z, x, lora_a, lora_b, block_adapter=None, act="none"):
    """``act(z + (x @ A[a]) @ B[a])``, the segmented LoRA SGMV epilogue.

    ``z`` is the base pre-activation for ``x`` (``[..., N]`` and ``[...,
    K]``).  ``lora_a``/``lora_b`` are either one adapter's factors (``[K,
    r]``/``[r, N]``: fine-tuning's single segment) or stacked factors
    (``[L, K, r]``/``[L, r, N]``) routed per row block by
    ``block_adapter`` (``[num_blocks]`` int32, the block height ``rows //
    num_blocks``; id ``L`` is the null adapter, whose rows come out as
    ``act(z)``).  Any scale (alpha / r) must be folded into ``lora_b``.
    On the O1 white list: under ``auto_cast`` it runs in the AMP dtype."""
    z, x, lora_a, lora_b = amp.cast_inputs("lora_segment_act", z, x, lora_a,
                                           lora_b)
    if lora_a.dim() == 2:
        lora_a, lora_b = lora_a[None], lora_b[None]
    z2 = z.reshape(-1, z.shape[-1])
    x2 = x.reshape(-1, x.shape[-1])
    rows = z2.shape[0]
    if block_adapter is not None:
        out = ops.lora_segment_epilogue(z2, x2, lora_a, lora_b,
                                        block_adapter=block_adapter, act=act)
    else:
        # one segment: pad the rows to a legal block height with zeros
        # (x = 0 there, so their delta is 0) and slice them off after
        bm = min_rows(z2.dtype)
        pad = (-rows) % bm
        if pad:
            z2 = torch.nn.functional.pad(z2, (0, 0, 0, pad))
            x2 = torch.nn.functional.pad(x2, (0, 0, 0, pad))
        blk = torch.zeros((rows + pad) // bm, dtype=torch.int32,
                          device=z2.device)
        out = ops.lora_segment_epilogue(z2, x2, lora_a, lora_b,
                                        block_adapter=blk, act=act)[:rows]
    return out.reshape(z.shape)


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


def fused_residual_layer_norm(x, residual, normalized_shape, weight=None,
                              bias=None, epsilon=1e-5):
    """``layer_norm(x + residual)`` over the last dim with ``weight`` and
    ``bias``, the post-norm sublayer epilogue (norm.py:58-99), through the
    fused residual layer-norm kernel forward and the layer-norm backward
    kernel on the saved sum.  The add runs in f32; ``x`` and the residual
    share a dtype on the card.  It is on the O1 black list, so under
    ``auto_cast`` it runs in f32.  Other forms (no affine parameters,
    several axes) are not ported yet."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    if len(tuple(normalized_shape)) != 1 or weight is None or bias is None:
        raise NotImplementedError(
            "fused_residual_layer_norm without affine parameters or over "
            "several axes is not ported yet")
    x, residual, weight, bias = amp.cast_inputs(
        "fused_residual_layer_norm", x, residual, weight, bias)
    return ops.layer_norm_residual(x.contiguous(), residual.contiguous(),
                                   weight, bias, epsilon)


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMS norm over the last dim, routed as the reference routes it
    (norm.py:103-121): with a ``weight``, the RMS-norm kernels forward and
    backward (``ops.rms_norm``); without one, the reference's composite,
    which it never sends to its kernel either: the mean of squares and
    rsqrt in f32 for bf16/f16 input, the product rounded to the input's
    type.  ``rms_norm`` is on the O1 black list, so under ``auto_cast``
    it runs in f32."""
    if weight is None:
        (x,) = amp.cast_inputs("rms_norm", x)
        xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    x, weight = amp.cast_inputs("rms_norm", x, weight)
    return ops.rms_norm(x.contiguous(), weight, epsilon)


def silu(x):
    """``x * sigmoid(x)``; the reference leaves it to XLA, the port to
    PyTorch."""
    return torch.nn.functional.silu(x)


def tanh(x):
    """``tanh(x)``; the reference leaves it to XLA, the port to
    PyTorch."""
    return torch.tanh(x)


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


def _sdpa_composite(q, k, v, is_causal, bias=None, dropout_p=0.0,
                    generator=None):
    """The reference's ``_sdpa_ref`` (flash_attention.py:27-54), op for
    op, over ``[b, s, h, d]``: scores in f32 (the bf16 products are exact
    in f32) scaled after the product; the mask ``bias`` added; masked
    scores -1e30; an f32 softmax; the probabilities cast to the input
    type; rows with no visible key zeroed; with ``dropout_p`` > 0 each
    probability kept with probability ``1 - dropout_p`` (the mask drawn
    from ``generator``) and the kept ones divided by ``1 - dropout_p`` in
    the probabilities' type; the PV product accumulated in f32 and
    cast."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = 1.0 / d ** 0.5
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    scores = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    if is_causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if bias is not None or is_causal:
        visible = (scores > -1e29).any(dim=-1, keepdim=True)
        probs = torch.where(visible, probs, 0.0)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0)
    # a bf16 product accumulates in f32 and rounds once, as the
    # reference's preferred_element_type=f32 einsum then astype
    out = torch.matmul(probs, vt)
    return out.transpose(1, 2).to(q.dtype)


_sdp_override = threading.local()


class sdp_kernel:
    """Backend selection for dense attention, the reference's
    ``sdp_kernel`` (flash_attention.py:216-242): ``enable_flash=False``
    sends `scaled_dot_product_attention` to the composite even where the
    flash kernel qualifies; ``True`` (the default) leaves the choice to
    the routing rule.  ``enable_math`` and ``enable_mem_efficient`` are
    accepted, as the reference accepts them: the composite is the math
    path, and the flash kernel is the memory-efficient one."""

    def __init__(self, enable_math=True, enable_flash=True,
                 enable_mem_efficient=True):
        self._enable_flash = bool(enable_flash)

    def __enter__(self):
        self._prev = getattr(_sdp_override, "enable_flash", None)
        _sdp_override.enable_flash = self._enable_flash
        return self

    def __exit__(self, *exc):
        _sdp_override.enable_flash = self._prev
        return False


def _flash_allowed():
    return getattr(_sdp_override, "enable_flash", None) is not False


#: the reference's cap on one (batch, head)'s K + V, with head_dim padded
#: to 128 lanes: a TPU VMEM limit (its kernel stages all of K and V).  The
#: CUDA kernel streams K/V tiles and needs no cap; it is kept so that a
#: call routes here as it routes in the reference.
_FLASH_KV_BYTES = 8 * 1024 * 1024


def _use_flash(head_dim, seqlen_k, dtype):
    """The reference's ``_use_pallas`` (flash_attention.py:57-82) without
    its TPU probe: f32 or bf16, head_dim <= 256, K + V under 8 MB."""
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    kv_bytes = 2 * seqlen_k * max(head_dim, 128) * dtype.itemsize
    return head_dim <= 256 and kv_bytes <= _FLASH_KV_BYTES


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, generator=None):
    """Dense attention over ``[b, s, h, d]``, routed as the reference
    routes it on its chip: with no mask and no dropout, f32 or bf16,
    head_dim <= 256 and K + V under 8 MB, inside ``sdp_kernel(
    enable_flash=True)`` (the default), it is the flash-attention kernel
    (``ops.flash_attention``: the plain version on CPU tensors, the CUDA
    kernels on the card); otherwise the composite ``_sdpa_ref``.

    Attention dropout (``dropout_p`` > 0 in training) always takes the
    composite, as in the reference (flash_attention.py:97-111), with its
    keep mask drawn from ``generator`` (the model's own; the global
    generator when None).  The reference dispatches that branch as
    ``scaled_dot_product_attention_drop``, which is on neither O1 list,
    so under ``auto_cast`` its inputs are not cast."""
    drop = float(dropout_p) if training else 0.0
    if drop > 0.0:
        return _sdpa_composite(query, key, value, is_causal, attn_mask,
                               drop, generator)
    query, key, value = amp.cast_inputs("scaled_dot_product_attention",
                                        query, key, value)
    if attn_mask is None and _flash_allowed() and _use_flash(
            query.shape[-1], key.shape[1], query.dtype):
        return ops.flash_attention(query, key, value, causal=is_causal)
    return _sdpa_composite(query, key, value, is_causal, attn_mask)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """``paddle.nn.functional.flash_attention``: attention over
    ``[b, s, h, d]`` through `scaled_dot_product_attention`; returns
    ``(out, None)`` (no softmax is returned, as in the reference)."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training)
    return out, None


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
