"""Layer norm, forward and backward, and the fused residual add + layer
norm forward: the hand-written CUDA kernels and their plain versions.

Port of ``paddle_tpu/ops/pallas_kernels.py`` ``fused_layer_norm`` (:639),
whose Pallas bodies ``_ln_fwd_kernel`` (:522) and ``_ln_bwd_kernel``
(:536) become ``paddle_tpu_torch/csrc/layer_norm.cu``, and of
``paddle_tpu/ops/pallas_fused.py`` ``fused_layer_norm_residual`` (:200),
whose ``_ln_res_fwd_kernel`` (:101) joins them there.  The forward
returns the normalised rows in the input's type plus the f32 statistics
``mu`` and ``rstd`` (one per row); the backward reuses them.  The
residual forward also returns ``s = x + residual`` (added in f32, stored
in x's type), and its backward is the layer-norm backward on that ``s``,
whose ``dx`` is the gradient of x and of the residual alike.
`layer_norm` and `layer_norm_residual` are the differentiable entry
points: ``torch.autograd.Function``s whose backward is the backward
kernel.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel or raises.  The forward, the backward and the residual forward
kernels have two routes each (`vector_route`): rows in 16-byte vectors
held in registers, or, for rows off 16 bytes and rows wider than
`VECTOR_MAX_WIDTH`, one value at a time; the wrappers count their
launches by route (``vector_launches``, ``scalar_launches``).
"""
from __future__ import annotations

import torch

from . import cuda_lib

__all__ = ["layer_norm_ref", "fused_layer_norm", "layer_norm_bwd_ref",
           "fused_layer_norm_bwd", "layer_norm", "layer_norm_residual_ref",
           "fused_layer_norm_residual", "layer_norm_residual",
           "vector_route", "VECTOR_MAX_WIDTH"]

#: first-pass blocks of the backward an SM at most (each leaves one f32
#: row of dgamma/dbeta partial sums for the second pass): the scratch's
#: rows; the vector route runs as many as the SMs hold at once (3 an SM
#: in f32 and 2 in bf16 at 2048 on the H100), the scalar route this many
_BWD_BLOCKS_PER_SM = 4
#: the widest row the vector routes hold in registers
#: (``csrc/layer_norm.cu`` ``kMaxVectorWidth``)
VECTOR_MAX_WIDTH = 8192


def vector_route(n, *tensors):
    """Whether a layer-norm kernel on rows of ``n`` values takes the vector
    route: the kernels' rule (``ptt_layer_norm_vector_route``,
    ``ptt_layer_norm_residual_vector_route``), rows of 16-byte multiples no
    wider than `VECTOR_MAX_WIDTH` and every pointer (forward: x, gamma,
    beta, out; backward: x, gamma, dout, dx; residual forward: x, the
    residual, gamma, beta, out, s) 16-byte aligned; else the scalar
    route."""
    isz = tensors[0].element_size()
    return (0 < n <= VECTOR_MAX_WIDTH and n * isz % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def _count_route(wrapper, n, *tensors):
    """Count a launch under the route the kernel takes."""
    if vector_route(n, *tensors):
        wrapper.vector_launches += 1
    else:
        wrapper.scalar_launches += 1


def layer_norm_ref(x, gamma, beta, eps=1e-5):
    """Plain PyTorch layer norm over the last dim, the TPU kernel's op
    order in f32: mean, then mean of squared deviations, then rsqrt.
    Returns ``(out, mu, rstd)``; ``mu``/``rstd`` are f32 ``[rows]``."""
    n = x.shape[-1]
    xf = x.reshape(-1, n).float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = (xc * rstd) * gamma.float() + beta.float()
    return (out.to(x.dtype).reshape(x.shape), mu.squeeze(-1),
            rstd.squeeze(-1))


def _check_vec(name, t, n, x):
    if t.device != x.device or t.dtype != x.dtype \
            or tuple(t.shape) != (n,) or not t.is_contiguous():
        raise ValueError(
            f"layer norm: {name} must be a contiguous [{n}] {x.dtype} "
            f"tensor on {x.device}, got {tuple(t.shape)} {t.dtype} on "
            f"{t.device}")


def fused_layer_norm(x, gamma, beta, eps=1e-5):
    """Layer norm over the last dim of ``x`` with ``gamma``/``beta``
    ``[N]``: ``(out, mu, rstd)`` as in `layer_norm_ref`."""
    if x.device.type == "cpu":
        return layer_norm_ref(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"layer norm: no kernel for device {x.device}")
    n = x.shape[-1]
    code = cuda_lib.dtype_code(x.dtype)
    _check_vec("gamma", gamma, n, x)
    _check_vec("beta", beta, n, x)
    if not x.is_contiguous():
        raise ValueError("layer norm: x must be contiguous")
    rows = x.numel() // n if n else 0
    out = torch.empty_like(x)
    mu = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows and n:
        lib = cuda_lib.library()
        code = lib.ptt_layer_norm_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            out.data_ptr(), mu.data_ptr(), rstd.data_ptr(), rows, n,
            float(eps), code, x.device.index,
            cuda_lib.stream_handle(x.device))
        cuda_lib.check(code, "layer_norm")
        fused_layer_norm.launches += 1
        _count_route(fused_layer_norm, n, x, gamma, beta, out)
    return out, mu, rstd


def layer_norm_bwd_ref(x, gamma, mu, rstd, dout):
    """Plain backward of `layer_norm_ref` from its saved f32 ``mu`` /
    ``rstd``, the TPU kernel's arithmetic in f32: ``(dx, dgamma,
    dbeta)`` with dx in ``x``'s type and dgamma/dbeta in ``gamma``'s."""
    n = x.shape[-1]
    xf = x.reshape(-1, n).float()
    do = dout.reshape(-1, n).float()
    xhat = (xf - mu[:, None]) * rstd[:, None]
    dxhat = do * gamma.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (dxhat - m1 - xhat * m2) * rstd[:, None]
    dgamma = (do * xhat).sum(dim=0)
    dbeta = do.sum(dim=0)
    return (dx.to(x.dtype).reshape(x.shape), dgamma.to(gamma.dtype),
            dbeta.to(gamma.dtype))


def fused_layer_norm_bwd(x, gamma, mu, rstd, dout):
    """``(dx, dgamma, dbeta)`` as in `layer_norm_bwd_ref`, through the
    backward kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return layer_norm_bwd_ref(x, gamma, mu, rstd, dout)
    if x.device.type != "cuda":
        raise RuntimeError(f"layer norm bwd: no kernel for device {x.device}")
    n = x.shape[-1]
    code = cuda_lib.dtype_code(x.dtype)
    _check_vec("gamma", gamma, n, x)
    rows = x.numel() // n if n else 0
    if dout.shape != x.shape or dout.dtype != x.dtype \
            or dout.device != x.device:
        raise ValueError(f"layer norm bwd: dout must match x "
                         f"{tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(dout.shape)} {dout.dtype}")
    for name, t in (("mu", mu), ("rstd", rstd)):
        if t.dtype != torch.float32 or tuple(t.shape) != (rows,) \
                or t.device != x.device:
            raise ValueError(f"layer norm bwd: {name} must be f32 "
                             f"[{rows}] on {x.device}")
    for name, t in (("x", x), ("dout", dout), ("mu", mu), ("rstd", rstd)):
        if not t.is_contiguous():
            raise ValueError(f"layer norm bwd: {name} must be contiguous")
    dx = torch.empty_like(x)
    dgamma = torch.zeros(n, dtype=gamma.dtype, device=x.device)
    dbeta = torch.zeros(n, dtype=gamma.dtype, device=x.device)
    if rows and n:
        nblk = min(rows, _BWD_BLOCKS_PER_SM
                   * cuda_lib.sm_count(x.device.index))
        partial = torch.empty(2, nblk, n, dtype=torch.float32,
                              device=x.device)
        rc = cuda_lib.library().ptt_layer_norm_bwd(
            x.data_ptr(), gamma.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
            dout.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
            dbeta.data_ptr(), partial.data_ptr(), rows, n, nblk, code,
            x.device.index, cuda_lib.stream_handle(x.device))
        cuda_lib.check(rc, "layer_norm_bwd")
        fused_layer_norm_bwd.launches += 1
        _count_route(fused_layer_norm_bwd, n, x, gamma, dout, dx)
    return dx, dgamma, dbeta


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        out, mu, rstd = fused_layer_norm(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mu, rstd)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, gamma, mu, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = fused_layer_norm_bwd(x, gamma, mu, rstd,
                                                 dout.contiguous())
        return dx, dgamma, dbeta, None


def layer_norm(x, gamma, beta, eps=1e-5):
    """Differentiable layer norm over the last dim: the forward kernel,
    and the backward kernel for the gradient.  Without autograd (no
    input needs a gradient, or grad mode off) it is one forward call."""
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _LayerNorm.apply(x, gamma, beta, float(eps))
    return fused_layer_norm(x, gamma, beta, eps)[0]


def layer_norm_residual_ref(x, residual, gamma, beta, eps=1e-5):
    """Plain PyTorch ``layer_norm(x + residual)`` over the last dim, the
    TPU kernel's op order in f32: the sum ``s`` in f32, its mean, the mean
    of squared deviations, rsqrt, then ``(s - mu) * rstd * gamma + beta``
    cast once.  Returns ``(out, s, mu, rstd)``: ``out`` and ``s`` in x's
    type, ``mu``/``rstd`` f32 ``[rows]``."""
    n = x.shape[-1]
    sf = x.reshape(-1, n).float() + residual.reshape(-1, n).float()
    mu = sf.mean(dim=-1, keepdim=True)
    sc = sf - mu
    var = (sc * sc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = (sc * rstd) * gamma.float() + beta.float()
    return (out.to(x.dtype).reshape(x.shape),
            sf.to(x.dtype).reshape(x.shape), mu.squeeze(-1),
            rstd.squeeze(-1))


def fused_layer_norm_residual(x, residual, gamma, beta, eps=1e-5):
    """``layer_norm(x + residual)`` over the last dim with ``gamma`` /
    ``beta`` ``[N]``: ``(out, s, mu, rstd)`` as in
    `layer_norm_residual_ref`.  On the card x, the residual, gamma and
    beta share one dtype."""
    if x.device.type == "cpu":
        return layer_norm_residual_ref(x, residual, gamma, beta, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"layer norm residual: no kernel for device "
                           f"{x.device}")
    n = x.shape[-1]
    code = cuda_lib.dtype_code(x.dtype)
    _check_vec("gamma", gamma, n, x)
    _check_vec("beta", beta, n, x)
    if residual.shape != x.shape or residual.dtype != x.dtype \
            or residual.device != x.device:
        raise ValueError(f"layer norm residual: the residual must match x "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}, got "
                         f"{tuple(residual.shape)} {residual.dtype} on "
                         f"{residual.device}")
    if not x.is_contiguous() or not residual.is_contiguous():
        raise ValueError("layer norm residual: x and the residual must be "
                         "contiguous")
    rows = x.numel() // n if n else 0
    out = torch.empty_like(x)
    s = torch.empty_like(x)
    mu = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows and n:
        rc = cuda_lib.library().ptt_layer_norm_residual_fwd(
            x.data_ptr(), residual.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), out.data_ptr(), s.data_ptr(), mu.data_ptr(),
            rstd.data_ptr(), rows, n, float(eps), code, x.device.index,
            cuda_lib.stream_handle(x.device))
        cuda_lib.check(rc, "layer_norm_residual")
        fused_layer_norm_residual.launches += 1
        _count_route(fused_layer_norm_residual, n, x, residual, gamma, beta,
                     out, s)
    return out, s, mu, rstd


class _LayerNormResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, gamma, beta, eps):
        out, s, mu, rstd = fused_layer_norm_residual(x, residual, gamma,
                                                     beta, eps)
        ctx.save_for_backward(s, gamma, mu, rstd)
        return out

    @staticmethod
    def backward(ctx, dout):
        s, gamma, mu, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = fused_layer_norm_bwd(s, gamma, mu, rstd,
                                                 dout.contiguous())
        return dx, dx, dgamma, dbeta, None   # d(x) == d(residual)


def layer_norm_residual(x, residual, gamma, beta, eps=1e-5):
    """Differentiable ``layer_norm(x + residual)`` over the last dim: the
    fused forward kernel, and the layer-norm backward kernel on the saved
    sum for the gradient.  Without autograd it is one forward call."""
    if torch.is_grad_enabled() and (
            x.requires_grad or residual.requires_grad
            or gamma.requires_grad or beta.requires_grad):
        return _LayerNormResidual.apply(x, residual, gamma, beta,
                                        float(eps))
    return fused_layer_norm_residual(x, residual, gamma, beta, eps)[0]


#: kernel launches since the last reset (chip_smoke.py reads them), and
#: each kernel's by route
fused_layer_norm.launches = 0
fused_layer_norm_bwd.launches = 0
fused_layer_norm_residual.launches = 0
for _fn in (fused_layer_norm, fused_layer_norm_bwd,
            fused_layer_norm_residual):
    _fn.vector_launches = _fn.scalar_launches = 0
