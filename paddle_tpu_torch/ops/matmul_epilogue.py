"""Matmul with a fused bias + activation epilogue: ``act(x @ w + b)``.

Port of ``paddle_tpu/ops/pallas_fused.py`` ``fused_linear_act`` (:379),
whose bodies ``_me_fwd_kernel`` (:266) and ``_me_bwd_kernel`` (:278)
become ``paddle_tpu_torch/csrc/matmul_epilogue.cu``.  The forward's
product runs inside that kernel (bf16: ``wgmma`` fed by TMA through an
mbarrier ring, or by element-wise staging where TMA cannot describe the
operands; f32: CUDA-core tiles; split-K where the output tiles are too
few to fill the card, see `split_k`); no library GEMM stands in for it.  The
backward kernel computes ``dz = g * act'(z)`` and the bias gradient;
``dx = dz @ w^T`` and ``dw = x^T @ dz`` are plain ``torch.matmul``, as
the reference leaves them to XLA (pallas_fused.py:363-370).  ``w`` keeps
Paddle's ``[in, out]`` layout.  `linear_act` is the differentiable entry
point.

Weight-only int8 (`fused_linear_act_int8`) is the port of the
reference's ``fused_linear_act_int8`` (:516), whose forward body
``_me_int8_fwd_kernel`` (:406) is the same source's int8 path: ``w_q``
``[K, N]`` int8 codes, ``scale`` ``[N]`` f32 applied to the f32
accumulator after the dot, then the bias and the activation.  Serving
runs it without gradients; its backward is not ported yet.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import math

import torch

from . import cuda_lib

__all__ = ["ACTIVATIONS", "act_f32", "act_grad_f32", "linear_act_ref",
           "split_k", "tma_route", "fused_linear_act", "linear_act_bwd_ref",
           "bwd_vector_route", "fused_linear_act_bwd", "linear_act",
           "linear_act_int8_ref", "fused_linear_act_int8"]

#: the reference's activation names (pallas_fused.py:47), in the order of
#: the kernel's activation codes
ACTIVATIONS = ("none", "relu", "gelu", "gelu_tanh", "silu")

_SQRT_2 = 2.0 ** 0.5
_INV_SQRT_2PI = 0.3989422804014327     # 1/sqrt(2*pi)
_GELU_C = 0.7978845608028654           # sqrt(2/pi)
_GELU_A = 0.044715


def act_f32(z, act):
    """The reference's ``_act_f32`` (pallas_fused.py:55) on f32 ``z``."""
    if act == "none":
        return z
    if act == "relu":
        return torch.clamp_min(z, 0.0)
    if act == "gelu":
        return 0.5 * z * (1.0 + torch.erf(z / _SQRT_2))
    if act == "gelu_tanh":
        t = torch.tanh(_GELU_C * (z + _GELU_A * z * z * z))
        return 0.5 * z * (1.0 + t)
    if act == "silu":
        return z * torch.sigmoid(z)
    raise ValueError(f"act must be one of {ACTIVATIONS}, got {act!r}")


def act_grad_f32(z, act):
    """The reference's ``_act_grad_f32`` (pallas_fused.py:70) on f32 ``z``."""
    if act == "none":
        return torch.ones_like(z)
    if act == "relu":
        return (z > 0.0).to(z.dtype)
    if act == "gelu":
        phi = _INV_SQRT_2PI * torch.exp(-0.5 * z * z)
        return 0.5 * (1.0 + torch.erf(z / _SQRT_2)) + z * phi
    if act == "gelu_tanh":
        u = _GELU_C * (z + _GELU_A * z * z * z)
        t = torch.tanh(u)
        du = _GELU_C * (1.0 + 3.0 * _GELU_A * z * z)
        return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * du
    if act == "silu":
        s = torch.sigmoid(z)
        return s * (1.0 + z * (1.0 - s))
    raise ValueError(f"act must be one of {ACTIVATIONS}, got {act!r}")


def _check_act(act):
    if act not in ACTIVATIONS:
        raise ValueError(f"act must be one of {ACTIVATIONS}, got {act!r}")


def linear_act_ref(x, w, b, act="none", return_z=False):
    """Plain PyTorch ``act(x @ w + b)``: f32 product, f32 epilogue, one
    cast to ``x``'s type.  With ``return_z`` also the pre-activation."""
    _check_act(act)
    z = torch.matmul(x.float(), w.float()) + b.float()
    out = act_f32(z, act).to(x.dtype)
    return (out, z.to(x.dtype)) if return_z else out


#: the forward kernels' output tile, the depth of a K slice and the tiles
#: an SM holds at once: f32 (CUDA cores) 64 x 64, 32, 6 (registers);
#: bf16 (wgmma) 128 x 128, 64, 1 (shared memory); the least slices a
#: split-K chunk sums (4) and the most chunks (16)
_F32_TILE, _F32_SLICE, _F32_TILES_PER_SM = 64, 32, 6
_WG_TILE, _WG_SLICE, _WG_TILES_PER_SM = 128, 64, 1
_MIN_SLICES, _MAX_SPLITS = 4, 16


def split_k(M, K, N, sm_count, wgmma=False):
    """How many K chunks a forward launch sums separately (split-K): 1
    when its output tiles fill the card's ``sm_count`` SMs, else enough
    chunks for about one full wave of blocks (never more), each chunk at
    least 4 slices deep.  f32 (64x64 tiles, 6 an SM, slices of 32): a
    serving step's 368 rows give 192 tiles at N = 2048 (4 chunks on 132
    SMs) and 768 at fc1's N = 8192 (1).  bf16 (``wgmma``: 128x128 tiles,
    one an SM, slices of 64): 48 tiles at N = 2048 (2 chunks), 192 at
    fc1's (1); a decode step's 4 rows 64 at N = 8192 (2), 16 at N = 2048
    (8)."""
    tile, slice_, per_sm = ((_WG_TILE, _WG_SLICE, _WG_TILES_PER_SM)
                            if wgmma else
                            (_F32_TILE, _F32_SLICE, _F32_TILES_PER_SM))
    tiles = -(-M // tile) * -(-N // tile)
    slices = -(-K // slice_)
    return max(1, min(per_sm * sm_count // max(tiles, 1),
                      slices // _MIN_SLICES, _MAX_SPLITS))


def _split_scratch(M, K, N, device, dtype):
    """(chunks, f32 partial-sum scratch [chunks, M, N] or None)."""
    splits = split_k(M, K, N, cuda_lib.sm_count(device.index),
                     wgmma=dtype == torch.bfloat16)
    if splits == 1:
        return 1, None
    return splits, torch.empty(splits, M, N, dtype=torch.float32,
                               device=device)


def tma_route(x, w, K, N):
    """Whether a bf16 forward stages x ``[M, K]`` and w ``[K, N]`` by TMA
    tile loads: the kernel's rule (``ptt_matmul_epilogue_tma_route``),
    16-byte aligned bases and row strides for both; else element by
    element."""
    return (K > 0 and N > 0 and x.data_ptr() % 16 == 0
            and K * x.element_size() % 16 == 0 and w.data_ptr() % 16 == 0
            and N * w.element_size() % 16 == 0)


def _count_route(wrapper, x, w, K, N):
    """Count a bf16 launch under the staging route the kernel takes."""
    if x.dtype != torch.bfloat16:
        return
    if tma_route(x, w, K, N):
        wrapper.tma_launches += 1
    else:
        wrapper.elementwise_launches += 1


def fused_linear_act(x, w, b, act="none", return_z=False):
    """``act(x @ w + b)`` for x ``[..., K]``, w ``[K, N]``, b ``[N]``.
    With ``return_z`` the pre-activation ``z`` is written as well and
    ``(out, z)`` is returned (the training slice saves it)."""
    _check_act(act)
    if x.device.type == "cpu":
        return linear_act_ref(x, w, b, act, return_z)
    if x.device.type != "cuda":
        raise RuntimeError(f"matmul epilogue: no kernel for device {x.device}")
    code = cuda_lib.dtype_code(x.dtype)
    K = x.shape[-1]
    if w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"matmul epilogue: w must be [{K}, N], "
                         f"got {tuple(w.shape)}")
    N = w.shape[1]
    if tuple(b.shape) != (N,):
        raise ValueError(f"matmul epilogue: b must be [{N}], "
                         f"got {tuple(b.shape)}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(
                f"matmul epilogue: {name} is {t.dtype} on {t.device}, "
                f"expected {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"matmul epilogue: {name} must be contiguous")
    M = math.prod(x.shape[:-1])
    out = torch.empty(*x.shape[:-1], N, dtype=x.dtype, device=x.device)
    z = torch.empty_like(out) if return_z else None
    if M and N:
        splits, partial = _split_scratch(M, K, N, x.device, x.dtype)
        rc = cuda_lib.library().ptt_matmul_epilogue_fwd(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            z.data_ptr() if z is not None else None,
            partial.data_ptr() if partial is not None else None, M, K, N,
            splits, ACTIVATIONS.index(act), code, x.device.index,
            cuda_lib.stream_handle(x.device))
        cuda_lib.check(rc, "matmul_epilogue")
        fused_linear_act.launches += 1
        _count_route(fused_linear_act, x, w, K, N)
    return (out, z) if return_z else out


def linear_act_bwd_ref(z, g, act):
    """Plain backward of the epilogue: ``dz = g * act'(z)`` in f32, written
    in ``z``'s type, and ``db``, the column sums of the f32 ``dz``, in
    ``z``'s type.  ``z`` and ``g`` are ``[..., N]``."""
    _check_act(act)
    n = z.shape[-1]
    dz = g.reshape(-1, n).float() * act_grad_f32(z.reshape(-1, n).float(),
                                                 act)
    return dz.to(z.dtype).reshape(z.shape), dz.sum(dim=0).to(z.dtype)


def bwd_vector_route(z, g, dz):
    """Whether the backward kernel on these tensors takes the vector route:
    the kernel's rule (``ptt_matmul_epilogue_bwd_vector_route``), rows of
    whole 16-byte vectors and z, g and dz 16-byte aligned; else the
    element-wise route."""
    N = z.shape[-1]
    return (N > 0 and N * z.element_size() % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in (z, g, dz)))


def fused_linear_act_bwd(z, g, act):
    """``(dz, db)`` as in `linear_act_bwd_ref`, through the backward
    kernel for CUDA tensors; its launches are also counted by route."""
    _check_act(act)
    if z.device.type == "cpu":
        return linear_act_bwd_ref(z, g, act)
    if z.device.type != "cuda":
        raise RuntimeError(f"matmul epilogue bwd: no kernel for device "
                           f"{z.device}")
    code = cuda_lib.dtype_code(z.dtype)
    if g.shape != z.shape or g.dtype != z.dtype or g.device != z.device:
        raise ValueError(f"matmul epilogue bwd: g must match z "
                         f"{tuple(z.shape)} {z.dtype}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    if not (z.is_contiguous() and g.is_contiguous()):
        raise ValueError("matmul epilogue bwd: z and g must be contiguous")
    N = z.shape[-1]
    M = z.numel() // N if N else 0
    dz = torch.empty_like(z)
    if not (M and N):
        return dz, torch.zeros(N, dtype=z.dtype, device=z.device)
    db = torch.empty(N, dtype=z.dtype, device=z.device)
    lib = cuda_lib.library()
    ptrs = (z.data_ptr(), g.data_ptr(), dz.data_ptr())
    nparts = lib.ptt_matmul_epilogue_bwd_parts(*ptrs, M, N, code,
                                               z.device.index)
    partial = torch.empty(nparts, N, dtype=torch.float32, device=z.device)
    tickets = cuda_lib.tickets(z.device, -(-N // 128))
    rc = lib.ptt_matmul_epilogue_bwd(
        *ptrs, db.data_ptr(), partial.data_ptr(), tickets.data_ptr(), M, N,
        nparts, ACTIVATIONS.index(act), code, z.device.index,
        cuda_lib.stream_handle(z.device))
    cuda_lib.check(rc, "matmul_epilogue_bwd")
    fused_linear_act_bwd.launches += 1
    if bwd_vector_route(z, g, dz):
        fused_linear_act_bwd.vector_launches += 1
    else:
        fused_linear_act_bwd.elementwise_launches += 1
    return dz, db


class _LinearAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, act):
        out, z = fused_linear_act(x, w, b, act, return_z=True)
        ctx.act = act
        ctx.save_for_backward(x, w, z)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, z = ctx.saved_tensors
        dz, db = fused_linear_act_bwd(z, g.contiguous(), ctx.act)
        dz2 = dz.reshape(-1, dz.shape[-1])
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(dz, w.t())
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x.reshape(-1, x.shape[-1]).t(), dz2)
        return dx, dw, db if ctx.needs_input_grad[2] else None, None


def linear_act(x, w, b, act="none"):
    """Differentiable ``act(x @ w + b)``: the forward kernel (saving the
    pre-activation ``z``), and for the gradient the backward kernel plus
    two plain GEMMs.  Without autograd it is one forward call that saves
    nothing."""
    _check_act(act)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        return _LinearAct.apply(x, w, b, act)
    return fused_linear_act(x, w, b, act)


def linear_act_int8_ref(x, w_q, scale, b, act="none"):
    """Plain PyTorch ``act((x @ w_q) * scale + b)``, the reference's
    composite (``nn/functional/common.py:150-155``) op for op: the f32
    product of ``x`` and the widened codes, then ``* scale + b`` in f32,
    the activation in f32 and one cast to ``x``'s type."""
    _check_act(act)
    z = torch.matmul(x.float(), w_q.float())
    z = z * scale.float() + b.float()
    return act_f32(z, act).to(x.dtype)


def fused_linear_act_int8(x, w_q, scale, b, act="none"):
    """``act((x @ w_q) * scale + b)`` for x ``[..., K]`` (f32 or bf16),
    w_q ``[K, N]`` int8, scale ``[N]`` f32 and b ``[N]`` (f32 or bf16).
    Inference only: an input that requires grad raises."""
    _check_act(act)
    if scale is None or b is None:
        raise ValueError("int8 matmul epilogue needs the per-channel scale "
                         "and the bias")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, b)):
        raise NotImplementedError(
            "int8 matmul epilogue: the backward is not ported yet")
    if w_q.dtype != torch.int8:
        raise ValueError(f"int8 matmul epilogue: w_q must be int8, got "
                         f"{w_q.dtype}")
    if x.device.type == "cpu":
        return linear_act_int8_ref(x, w_q, scale, b, act)
    if x.device.type != "cuda":
        raise RuntimeError(f"int8 matmul epilogue: no kernel for device "
                           f"{x.device}")
    code = cuda_lib.dtype_code(x.dtype)
    K = x.shape[-1]
    if w_q.dim() != 2 or w_q.shape[0] != K:
        raise ValueError(f"int8 matmul epilogue: w_q must be [{K}, N], "
                         f"got {tuple(w_q.shape)}")
    N = w_q.shape[1]
    for name, t in (("scale", scale), ("b", b)):
        if tuple(t.shape) != (N,):
            raise ValueError(f"int8 matmul epilogue: {name} must be [{N}], "
                             f"got {tuple(t.shape)}")
    if scale.dtype != torch.float32:
        raise ValueError(f"int8 matmul epilogue: scale must be float32, "
                         f"got {scale.dtype}")
    b_code = cuda_lib.dtype_code(b.dtype)
    for name, t in (("x", x), ("w_q", w_q), ("scale", scale), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"int8 matmul epilogue: {name} is on "
                             f"{t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"int8 matmul epilogue: {name} must be "
                             f"contiguous")
    M = math.prod(x.shape[:-1])
    out = torch.empty(*x.shape[:-1], N, dtype=x.dtype, device=x.device)
    if M and N:
        splits, partial = _split_scratch(M, K, N, x.device, x.dtype)
        rc = cuda_lib.library().ptt_matmul_epilogue_int8_fwd(
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), b.data_ptr(),
            out.data_ptr(),
            partial.data_ptr() if partial is not None else None, M, K, N,
            splits, ACTIVATIONS.index(act), code, b_code, x.device.index,
            cuda_lib.stream_handle(x.device))
        cuda_lib.check(rc, "matmul_epilogue_int8")
        fused_linear_act_int8.launches += 1
        _count_route(fused_linear_act_int8, x, w_q, K, N)
    return out


#: kernel launches since the last reset (chip_smoke.py reads them); the
#: bf16 forwards' also by staging route, the backward's by route
fused_linear_act.launches = 0
fused_linear_act_bwd.launches = 0
fused_linear_act_bwd.vector_launches = 0
fused_linear_act_bwd.elementwise_launches = 0
fused_linear_act_int8.launches = 0
for _fn in (fused_linear_act, fused_linear_act_int8):
    _fn.tma_launches = 0
    _fn.elementwise_launches = 0
del _fn
