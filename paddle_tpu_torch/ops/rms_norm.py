"""RMSNorm, forward and backward: the hand-written CUDA kernels and their
plain versions.

Port of ``paddle_tpu/ops/pallas_kernels.py`` ``fused_rms_norm`` (:746),
whose Pallas bodies ``_rms_fwd_kernel`` (:648) and ``_rms_bwd_kernel``
(:658) become ``paddle_tpu_torch/csrc/rms_norm.cu``.  The forward returns
``x * rsqrt(mean(x^2) + eps) * gamma`` computed in f32 and rounded once to
the input's type, plus the f32 ``rstd`` (one per row); the backward reuses
it.  `rms_norm` is the differentiable entry point: a
``torch.autograd.Function`` whose backward is the backward kernel.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from . import cuda_lib

__all__ = ["rms_norm_ref", "fused_rms_norm", "rms_norm_bwd_ref",
           "fused_rms_norm_bwd", "rms_norm"]

#: row blocks of the backward's first pass (each leaves one f32 row of
#: dgamma partial sums for the second pass)
_BWD_BLOCKS = 512


def rms_norm_ref(x, gamma, eps=1e-6):
    """Plain PyTorch RMS norm over the last dim, the TPU kernel's op order
    in f32: mean of squares, rsqrt, then ``x * rstd * gamma`` rounded once
    to ``x``'s type.  Returns ``(out, rstd)``; ``rstd`` is f32 ``[rows]``."""
    n = x.shape[-1]
    xf = x.reshape(-1, n).float()
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    out = xf * rstd * gamma.float()
    return out.to(x.dtype).reshape(x.shape), rstd.squeeze(-1)


def _check_gamma(gamma, n, x):
    if gamma.device != x.device or gamma.dtype != x.dtype \
            or tuple(gamma.shape) != (n,) or not gamma.is_contiguous():
        raise ValueError(
            f"rms norm: gamma must be a contiguous [{n}] {x.dtype} tensor "
            f"on {x.device}, got {tuple(gamma.shape)} {gamma.dtype} on "
            f"{gamma.device}")


def fused_rms_norm(x, gamma, eps=1e-6):
    """RMS norm over the last dim of ``x`` with ``gamma`` ``[N]``:
    ``(out, rstd)`` as in `rms_norm_ref`."""
    if x.device.type == "cpu":
        return rms_norm_ref(x, gamma, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"rms norm: no kernel for device {x.device}")
    n = x.shape[-1]
    code = cuda_lib.dtype_code(x.dtype)
    _check_gamma(gamma, n, x)
    if not x.is_contiguous():
        raise ValueError("rms norm: x must be contiguous")
    rows = x.numel() // n if n else 0
    out = torch.empty_like(x)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows and n:
        rc = cuda_lib.library().ptt_rms_norm_fwd(
            x.data_ptr(), gamma.data_ptr(), out.data_ptr(), rstd.data_ptr(),
            rows, n, float(eps), code, x.device.index,
            cuda_lib.stream_handle(x.device))
        cuda_lib.check(rc, "rms_norm")
        fused_rms_norm.launches += 1
    return out, rstd


def rms_norm_bwd_ref(x, gamma, rstd, dout):
    """Plain backward of `rms_norm_ref` from its saved f32 ``rstd``, the
    TPU kernel's arithmetic in f32: ``(dx, dgamma)`` with dx in ``x``'s
    type and dgamma in ``gamma``'s."""
    n = x.shape[-1]
    xhat = x.reshape(-1, n).float() * rstd[:, None]
    do = dout.reshape(-1, n).float()
    dxhat = do * gamma.float()
    m = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (dxhat - xhat * m) * rstd[:, None]
    dgamma = (do * xhat).sum(dim=0)
    return dx.to(x.dtype).reshape(x.shape), dgamma.to(gamma.dtype)


def fused_rms_norm_bwd(x, gamma, rstd, dout):
    """``(dx, dgamma)`` as in `rms_norm_bwd_ref`, through the backward
    kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return rms_norm_bwd_ref(x, gamma, rstd, dout)
    if x.device.type != "cuda":
        raise RuntimeError(f"rms norm bwd: no kernel for device {x.device}")
    n = x.shape[-1]
    code = cuda_lib.dtype_code(x.dtype)
    _check_gamma(gamma, n, x)
    rows = x.numel() // n if n else 0
    if dout.shape != x.shape or dout.dtype != x.dtype \
            or dout.device != x.device:
        raise ValueError(f"rms norm bwd: dout must match x "
                         f"{tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(dout.shape)} {dout.dtype}")
    if rstd.dtype != torch.float32 or tuple(rstd.shape) != (rows,) \
            or rstd.device != x.device:
        raise ValueError(f"rms norm bwd: rstd must be f32 [{rows}] on "
                         f"{x.device}")
    for name, t in (("x", x), ("dout", dout), ("rstd", rstd)):
        if not t.is_contiguous():
            raise ValueError(f"rms norm bwd: {name} must be contiguous")
    dx = torch.empty_like(x)
    dgamma = torch.zeros(n, dtype=gamma.dtype, device=x.device)
    if rows and n:
        nblk = min(rows, _BWD_BLOCKS)
        partial = torch.empty(nblk, n, dtype=torch.float32, device=x.device)
        rc = cuda_lib.library().ptt_rms_norm_bwd(
            x.data_ptr(), gamma.data_ptr(), rstd.data_ptr(), dout.data_ptr(),
            dx.data_ptr(), dgamma.data_ptr(), partial.data_ptr(), rows, n,
            nblk, code, x.device.index, cuda_lib.stream_handle(x.device))
        cuda_lib.check(rc, "rms_norm_bwd")
        fused_rms_norm_bwd.launches += 1
    return dx, dgamma


class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, eps):
        out, rstd = fused_rms_norm(x, gamma, eps)
        ctx.save_for_backward(x, gamma, rstd)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, gamma, rstd = ctx.saved_tensors
        dx, dgamma = fused_rms_norm_bwd(x, gamma, rstd, dout.contiguous())
        return dx, dgamma, None


def rms_norm(x, gamma, eps=1e-6):
    """Differentiable RMS norm over the last dim: the forward kernel, and
    the backward kernel for the gradient.  Without autograd (no input
    needs a gradient, or grad mode off) it is one forward call."""
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad):
        return _RmsNorm.apply(x, gamma, float(eps))
    return fused_rms_norm(x, gamma, eps)[0]


#: kernel launches since the last reset (chip_smoke.py reads them)
fused_rms_norm.launches = 0
fused_rms_norm_bwd.launches = 0
