"""The layers GPT, LLaMA, BERT and ERNIE are built from, as
``torch.nn.Module``s.

Port of ``paddle_tpu/nn/layer/{common,norm,layers}.py``: ``Linear``,
``Embedding``, ``LayerNorm``, ``RMSNorm``, ``Dropout`` and ``LayerList``.
Parameter names and shapes match the reference's ``state_dict``
(``Linear.weight`` is ``[in, out]``), and so do the default
initialisers: Xavier-normal Linear weights with zero biases, N(0, 1)
embeddings, LayerNorm ones and zeros, RMSNorm ones.  Every layer takes
its ``device``, ``dtype`` and the ``torch.Generator`` its initial values
are drawn from.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from . import functional as F

__all__ = ["Linear", "Embedding", "LayerNorm", "RMSNorm", "Dropout",
           "LayerList"]

LayerList = nn.ModuleList


def _param(shape, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight`` ``[in, out]``.  After
    ``quantization.convert_to_int8`` the weight is the int8 buffers
    ``weight_q``/``weight_scale`` and the layer runs the int8 epilogue.
    After ``inference.serving.lora.convert_to_lora`` it has ``lora_A``
    and ``lora_B`` and, unless merged, adds their delta through the
    segmented SGMV epilogue as one segment."""

    def __init__(self, in_features, out_features, bias=True, *, device,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = _param((in_features, out_features), device, dtype)
        self.bias = _param((out_features,), device, dtype) if bias else None
        with torch.no_grad():
            std = math.sqrt(2.0 / (in_features + out_features))
            self.weight.normal_(0.0, std, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        w_q = getattr(self, "weight_q", None)
        if w_q is not None:
            return F.linear_act_int8(x, w_q, self.weight_scale, self.bias)
        y = F.linear(x, self.weight, self.bias)
        if getattr(self, "lora_A", None) is not None \
                and not getattr(self, "lora_merged", False):
            y = F.lora_segment_act(y, x, self.lora_A,
                                   self.lora_B * self.lora_scaling)
        return y

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}"


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, *, device,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.weight = _param((num_embeddings, embedding_dim), device, dtype)
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, x):
        return F.embedding(x, self.weight)


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, *, device,
                 dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                              device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape,
                                             device=device, dtype=dtype))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)

    def forward_fused(self, x, residual):
        """``layer_norm(x + residual)``, the post-norm sublayer epilogue
        (norm.py:43-50), through the fused residual layer-norm kernel."""
        return F.fused_residual_layer_norm(x, residual,
                                           self.normalized_shape,
                                           self.weight, self.bias,
                                           self.epsilon)


class RMSNorm(nn.Module):
    """RMS norm over the last dim with a ``weight`` ``[hidden_size]``
    starting at 1 (norm.py:53-63)."""

    def __init__(self, hidden_size, epsilon=1e-6, *, device,
                 dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class Dropout(nn.Module):
    """Dropout with probability ``p`` in training, its masks drawn from
    ``generator``; the identity in eval mode, which is how serving
    runs."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training,
                         generator=self.generator)
