"""The functionals GPT serving calls, on ``torch.Tensor``.

Port of ``paddle_tpu/nn/functional/common.py`` (``linear`` :31,
``linear_act`` :54, ``embedding`` :523) and ``nn/functional/norm.py``
(``layer_norm`` :22).  Weights keep Paddle's ``[in, out]`` layout.  The
reference routes ``layer_norm`` and ``linear_act`` through its Pallas
gate; here they call the port's kernel wrappers, which take the plain
version for CPU tensors and launch the CUDA kernel for CUDA tensors.
Plain GEMMs and lookups stay PyTorch ops, as the reference left them to
XLA.
"""
from __future__ import annotations

import torch

from ..ops import fused_layer_norm, fused_linear_act
from ..ops.tiles import NEG_INF

__all__ = ["linear", "linear_act", "embedding", "layer_norm", "dropout",
           "scaled_dot_product_attention"]


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]``."""
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def linear_act(x, weight, bias, act="none"):
    """``act(x @ weight + bias)`` through the matmul-epilogue kernel."""
    return fused_linear_act(x.contiguous(), weight, bias, act)


def embedding(x, weight):
    """Row lookup: ``weight[x]``."""
    return torch.nn.functional.embedding(x, weight)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """Layer norm over the last dim with ``weight`` and ``bias``, through
    the layer-norm kernel.  Other forms (no affine parameters, several
    axes) are not ported yet."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    if len(tuple(normalized_shape)) != 1 or weight is None or bias is None:
        raise NotImplementedError(
            "layer_norm without affine parameters or over several axes "
            "is not ported yet")
    return fused_layer_norm(x.contiguous(), weight, bias, epsilon)[0]


def dropout(x, p=0.5, training=True):
    if not training or p == 0.0:
        return x
    return torch.nn.functional.dropout(x, p, training=True)


def scaled_dot_product_attention(q, k, v, is_causal=False):
    """Dense attention over ``[b, s, h, d]``: the flash-attention kernel's
    path in the reference, which this slice does not port.  It runs the
    plain composite on CPU tensors and raises on CUDA tensors."""
    if q.device.type != "cpu":
        raise NotImplementedError(
            "dense attention (the flash-attention kernel) is not ported "
            "yet; serve through the paged cache")
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    qt, kt, vt = (t.transpose(1, 2).float() for t in (q, k, v))
    s = torch.matmul(qt, kt.transpose(-1, -2)) / d ** 0.5
    if is_causal:
        mask = torch.ones(sq, sk, dtype=torch.bool).tril(sk - sq)
        s = s.masked_fill(~mask, NEG_INF)
    out = torch.matmul(torch.softmax(s, dim=-1), vt)
    return out.transpose(1, 2).to(q.dtype)
