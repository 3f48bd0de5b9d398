"""Layer norm forward: the hand-written CUDA kernel and its plain version.

Port of ``paddle_tpu/ops/pallas_kernels.py`` ``fused_layer_norm`` (:639),
whose Pallas body ``_ln_fwd_kernel`` (:522) becomes
``paddle_tpu_torch/csrc/layer_norm.cu``.  Both return the normalised
rows in the input's type plus the f32 statistics ``mu`` and ``rstd``
(one per row) that the training slice's backward will reuse.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from . import cuda_lib

__all__ = ["layer_norm_ref", "fused_layer_norm"]


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


def fused_layer_norm(x, gamma, beta, eps=1e-5):
    """Layer norm over the last dim of ``x`` with ``gamma``/``beta``
    ``[N]``: ``(out, mu, rstd)`` as in `layer_norm_ref`."""
    if x.device.type == "cpu":
        return layer_norm_ref(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"layer norm: no kernel for device {x.device}")
    n = x.shape[-1]
    code = cuda_lib.dtype_code(x.dtype)
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.device != x.device or t.dtype != x.dtype \
                or tuple(t.shape) != (n,) or not t.is_contiguous():
            raise ValueError(
                f"layer norm: {name} must be a contiguous [{n}] "
                f"{x.dtype} tensor on {x.device}, got {tuple(t.shape)} "
                f"{t.dtype} on {t.device}")
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
    return out, mu, rstd


#: kernel launches since the last reset (chip_smoke.py reads it)
fused_layer_norm.launches = 0
