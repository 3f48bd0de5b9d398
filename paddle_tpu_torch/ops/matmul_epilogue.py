"""Matmul with a fused bias + activation epilogue: ``act(x @ w + b)``.

Port of ``paddle_tpu/ops/pallas_fused.py`` ``fused_linear_act`` (:379),
whose forward body ``_me_fwd_kernel`` (:266) becomes
``paddle_tpu_torch/csrc/matmul_epilogue.cu``.  The product runs inside
that kernel (WMMA tensor-core tiles for bf16, CUDA-core f32 tiles for
f32); no library GEMM stands in for it.  ``w`` keeps Paddle's ``[in,
out]`` layout.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import math

import torch

from . import cuda_lib

__all__ = ["ACTIVATIONS", "act_f32", "linear_act_ref", "fused_linear_act"]

#: the reference's activation names (pallas_fused.py:47), in the order of
#: the kernel's activation codes
ACTIVATIONS = ("none", "relu", "gelu", "gelu_tanh", "silu")

_SQRT_2 = 2.0 ** 0.5
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
        lib = cuda_lib.library()
        rc = lib.ptt_matmul_epilogue_fwd(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            z.data_ptr() if z is not None else None, M, K, N,
            ACTIVATIONS.index(act), code, x.device.index,
            cuda_lib.stream_handle(x.device))
        cuda_lib.check(rc, "matmul_epilogue")
        fused_linear_act.launches += 1
    return (out, z) if return_z else out


#: kernel launches since the last reset (chip_smoke.py reads it)
fused_linear_act.launches = 0
