"""Flash attention, forward and backward: the hand-written CUDA kernels
and their plain versions.

Port of ``paddle_tpu/ops/pallas_kernels.py`` ``flash_attention`` (:497),
whose Pallas bodies ``_attn_fwd_kernel`` (:78), ``_attn_bwd_dq_kernel``
(:128) and ``_attn_bwd_dkv_kernel`` (:170) become
``paddle_tpu_torch/csrc/flash_attention.cu``.

Over ``[B, S, H, D]`` (Paddle's layout, the reference's public face):
scores in f32 scaled after the product; row ``r`` sees key ``c`` iff
``c < Sk`` and, when causal, ``c <= r + (Sk - Sq)`` (bottom-right
aligned); ``out`` in the input's type and ``lse`` f32 ``[B, H, Sq]``;
a row that sees no key gives ``out = 0`` and ``lse = -1e30``.  The
backward takes ``lse`` with those rows set to 1e30 and ``delta =
rowsum(dout * out)`` (`flash_bwd_stats`, plain torch as the reference
leaves it to XLA), so ring attention can hand in its own.

The kernels read q, k, v and dout through their (batch, seq, head)
strides, so the views ``qkv.unbind(2)`` gives go in without a copy; the
last dim must be contiguous.  They take head_dim up to 256, the
reference's routing limit.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel or raises.  `flash_attention` is the differentiable entry point:
a ``torch.autograd.Function`` whose backward launches the dq and the
dk/dv kernels.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .tiles import NEG_INF

__all__ = ["MAX_HEAD_DIM", "flash_attention_ref", "flash_attention_bwd_ref",
           "flash_bwd_stats", "fused_flash_attention_fwd",
           "fused_flash_attention_bwd_dq", "fused_flash_attention_bwd_dkv",
           "flash_attention"]

#: the widest head the kernels take (they are built for 64, 128 and 256)
MAX_HEAD_DIM = 256
#: the backward's lse for a row that sees no key: exp(s - lse) = 0
_EMPTY_LSE = 1e30


def _scale(q, scale):
    return 1.0 / q.shape[-1] ** 0.5 if scale is None else float(scale)


def _scores(q, k, causal, scale):
    """f32 scores ``[B, H, Sq, Sk]`` and the visibility mask ``[Sq, Sk]``."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask.tril(sk - sq)
    return s, mask


def flash_attention_ref(q, k, v, causal=False, scale=None):
    """Plain forward, the kernels' masked math in f32: ``(out, lse)`` with
    ``out`` ``[B, Sq, H, D]`` in ``q``'s type and ``lse`` f32
    ``[B, H, Sq]``."""
    s, mask = _scores(q, k, causal, _scale(q, scale))
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, 1.0, l)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) \
        / l_safe.transpose(1, 2)
    lse = torch.where(l == 0, NEG_INF, m + torch.log(l_safe))
    return out.to(q.dtype), lse.squeeze(-1)


def flash_bwd_stats(out, dout, lse):
    """The backward's row inputs, as the reference's ``_flash_bwd`` forms
    them outside its kernels: ``(lse with rows that saw no key set to
    1e30, delta = rowsum(dout * out))``, both f32 ``[B, H, Sq]``."""
    delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)
    lse = torch.where(lse <= NEG_INF / 2, _EMPTY_LSE, lse)
    return lse.contiguous(), delta.contiguous()


def flash_attention_bwd_ref(q, k, v, dout, lse, delta, causal=False,
                            scale=None):
    """Plain backward from `flash_bwd_stats`'s ``lse`` and ``delta``:
    ``p = exp(s - lse)``, ``ds = p * (dout.v - delta) * scale``; returns
    ``(dq, dk, dv)`` in the types of q, k and v."""
    scale = _scale(q, scale)
    s, mask = _scores(q, k, causal, scale)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    do = dout.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(name, q, k, v, *extra):
    """Shapes, types and layout the kernels take; returns the dtype code."""
    code = cuda_lib.dtype_code(q.dtype)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be [B, S, H, D]")
    B, _, H, D = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) \
            != (B, H, D):
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: the kernels take head_dim up to "
                         f"{MAX_HEAD_DIM}, got {D}")
    if B * H > 65535:
        raise ValueError(f"{name}: batch * heads {B * H} exceeds the "
                         f"grid's 65535")
    for tname, t in (("q", q), ("k", k), ("v", v), *extra):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: {tname} must be {q.dtype} on "
                             f"{q.device}, got {t.dtype} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {tname}'s last dim must be "
                             f"contiguous")
    return code


def _check_stats(name, q, lse, delta):
    want = (q.shape[0], q.shape[2], q.shape[1])
    for tname, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != want \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be a contiguous f32 "
                             f"{list(want)} tensor on {q.device}")


def _strides(*tensors):
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _device_or_raise(name, q):
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {q.device}")


def fused_flash_attention_fwd(q, k, v, causal=False, scale=None):
    """``(out, lse)`` as in `flash_attention_ref`, through the forward
    kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, scale)
    _device_or_raise("flash attention", q)
    code = _check("flash attention", q, k, v)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    out = torch.empty(B, Sq, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    if out.numel():
        rc = cuda_lib.library().ptt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, H, Sq, Sk, D, _strides(q, k, v),
            _scale(q, scale), int(bool(causal)), code, q.device.index,
            cuda_lib.stream_handle(q.device))
        cuda_lib.check(rc, "flash_attention_fwd")
        fused_flash_attention_fwd.launches += 1
    return out, lse


def fused_flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=False,
                                 scale=None):
    """``dq`` as in `flash_attention_bwd_ref`, through the dq kernel for
    CUDA tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, dout, lse, delta, causal,
                                       scale)[0]
    _device_or_raise("flash attention bwd dq", q)
    code = _check("flash attention bwd dq", q, k, v, ("dout", dout))
    if dout.shape != q.shape:
        raise ValueError("flash attention bwd dq: dout must match q")
    _check_stats("flash attention bwd dq", q, lse, delta)
    B, Sq, H, D = q.shape
    dq = torch.empty(B, Sq, H, D, dtype=q.dtype, device=q.device)
    if dq.numel():
        rc = cuda_lib.library().ptt_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, Sq,
            k.shape[1], D, _strides(q, k, v, dout), _scale(q, scale),
            int(bool(causal)), code, q.device.index,
            cuda_lib.stream_handle(q.device))
        cuda_lib.check(rc, "flash_attention_bwd_dq")
        fused_flash_attention_bwd_dq.launches += 1
    return dq


def fused_flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=False,
                                  scale=None):
    """``(dk, dv)`` as in `flash_attention_bwd_ref`, through the dk/dv
    kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, dout, lse, delta, causal,
                                       scale)[1:]
    _device_or_raise("flash attention bwd dkv", q)
    code = _check("flash attention bwd dkv", q, k, v, ("dout", dout))
    if dout.shape != q.shape:
        raise ValueError("flash attention bwd dkv: dout must match q")
    _check_stats("flash attention bwd dkv", q, lse, delta)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    dk = torch.empty(B, Sk, H, D, dtype=k.dtype, device=k.device)
    dv = torch.empty(B, Sk, H, D, dtype=v.dtype, device=v.device)
    if dk.numel():
        rc = cuda_lib.library().ptt_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, Sq, Sk, D, _strides(q, k, v, dout), _scale(q, scale),
            int(bool(causal)), code, q.device.index,
            cuda_lib.stream_handle(q.device))
        cuda_lib.check(rc, "flash_attention_bwd_dkv")
        fused_flash_attention_bwd_dkv.launches += 1
    return dk, dv


def _last_dim_contiguous(t):
    return t if t.stride(-1) == 1 else t.contiguous()


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = fused_flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = _last_dim_contiguous(dout.to(q.dtype))
        lse, delta = flash_bwd_stats(out, dout, lse)
        args = (q, k, v, dout, lse, delta, ctx.causal, ctx.scale)
        dq = fused_flash_attention_bwd_dq(*args)
        dk, dv = fused_flash_attention_bwd_dkv(*args)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """Differentiable flash attention over ``[B, S, H, D]``: the forward
    kernel, and for the gradient the dq and dk/dv kernels.  Without
    autograd it is one forward call that saves nothing."""
    q, k, v = (_last_dim_contiguous(t) for t in (q, k, v))
    scale = _scale(q, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, bool(causal), scale)
    return fused_flash_attention_fwd(q, k, v, causal, scale)[0]


#: kernel launches since the last reset (chip_smoke.py reads them)
fused_flash_attention_fwd.launches = 0
fused_flash_attention_bwd_dq.launches = 0
fused_flash_attention_bwd_dkv.launches = 0
