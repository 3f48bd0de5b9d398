"""The Transformer family: port of ``paddle_tpu/nn/layer/transformer.py``.

``MultiHeadAttention`` (:21) with the reference's cache protocol
(``Cache`` for incremental self-attention, ``StaticCache`` of the
projected encoder memory for cross-attention, ``gen_cache``),
``TransformerEncoderLayer`` (:104) and ``TransformerEncoder`` (:167),
``TransformerDecoderLayer`` (:232) and ``TransformerDecoder`` (:313), and
``Transformer`` (:348) with ``generate_square_subsequent_mask`` (:388).

They call the port's functionals, so the kernels run where the reference
runs its Pallas kernels:

* attention is ``F.scaled_dot_product_attention`` with ``is_causal=False``
  (:65-68): with no mask and no dropout (encoder self-attention,
  cross-attention without ``memory_mask``, the cached decoding steps with
  one query row) the flash-attention kernels, forward and backward;
  with a mask (the decoder's causal ``tgt_mask``, an additive ``-inf``
  bias) or attention dropout, the composite, as in the reference;
* the feed-forward block's first product, its bias and the activation are
  ``F.linear_act`` (:126-134), the matmul-epilogue kernel forward and its
  backward kernel; without biases (``bias_attr=False``) it is
  ``activation(linear1(x))``;
* post-norm sublayers (``normalize_before=False``, the default) add the
  residual inside ``LayerNorm.forward_fused`` (:149, :157, :279, :292,
  :300), the fused residual layer-norm kernel with the layer-norm backward
  kernel; pre-norm sublayers and the stacks' final norms are
  ``LayerNorm``, the layer-norm kernels.

Every layer of a stack starts as a copy of the one given, values
included (``_clone_layer`` :202-229 adds ``0 * p``); the copies share the
model's ``torch.Generator``.  ``enable_recompute`` on a stack runs each
layer through ``distributed.fleet.recompute``; the reference's memory
guard (``remat_enabled()``) is not ported, so it does not turn recompute
on here.  ``need_weights`` is accepted and no weights are returned, as in
the reference.  ``weight_attr``/``bias_attr``: ``None``, an
``nn.initializer`` initializer, or ``bias_attr=False`` (no biases);
others raise.  Linear weights are ``[in, out]``, and parameter names equal
the reference's.
"""
from __future__ import annotations

import collections
import copy

import torch
from torch import nn

from ...core import resolve_device
from .. import functional as F
from .. import initializer as I
from ..layers import Dropout, LayerList, LayerNorm, Linear
from .common import attr_initializer

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _linear(n_in, n_out, weight_attr, bias_attr, device, dtype, generator):
    """A ``Linear`` under Paddle's attributes (`attr_initializer`): an
    initializer replaces the default draw, ``bias_attr=False`` drops the
    bias."""
    w_init, b_init = attr_initializer(weight_attr), attr_initializer(bias_attr)
    if w_init is False:
        raise NotImplementedError("weight_attr=False is not ported yet")
    lin = Linear(n_in, n_out, bias=b_init is not False, device=device,
                 dtype=dtype, generator=generator)
    for p, init in ((lin.weight, w_init), (lin.bias, b_init)):
        if isinstance(init, I.Initializer):
            init(p, generator)
    return lin


class MultiHeadAttention(nn.Module):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype,
                  generator=generator)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.generator = generator
        self.q_proj = _linear(embed_dim, embed_dim, weight_attr, bias_attr,
                              **kw)
        self.k_proj = _linear(kdim or embed_dim, embed_dim, weight_attr,
                              bias_attr, **kw)
        self.v_proj = _linear(vdim or embed_dim, embed_dim, weight_attr,
                              bias_attr, **kw)
        self.out_proj = _linear(embed_dim, embed_dim, weight_attr, bias_attr,
                                **kw)

    def _shape(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._shape(self.q_proj(query))
        if isinstance(cache, MultiHeadAttention.StaticCache):
            # the projected encoder memory, used as it is
            k, v = cache.k, cache.v
            new_cache = cache
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
            if cache is not None:
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                new_cache = MultiHeadAttention.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0,
            is_causal=False, training=self.training,
            generator=self.generator)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        return out if cache is None else (out, new_cache)

    def gen_cache(self, key, value=None, type=None):
        """``type=StaticCache``: k and v projected from the memory ``key``
        (and ``value``); otherwise ``Cache(key, value)`` as given, or an
        empty incremental cache ``[b, 0, heads, head_dim]`` when ``value``
        is None."""
        if type is MultiHeadAttention.StaticCache:
            value = key if value is None else value
            return MultiHeadAttention.StaticCache(
                self._shape(self.k_proj(key)), self._shape(self.v_proj(value)))
        if value is not None:
            return MultiHeadAttention.Cache(key, value)
        empty = key.new_zeros(key.shape[0], 0, self.num_heads, self.head_dim)
        return MultiHeadAttention.Cache(empty, empty)


_ACTIVATIONS = {"relu": F.relu, "gelu": F.gelu}


class _SublayerBase(nn.Module):
    """The attention (the decoder's, with ``cross``, also cross-attention),
    the feed-forward block, the norms and dropouts that the encoder and
    decoder layers share."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout, activation,
                 attn_dropout, act_dropout, normalize_before, weight_attr,
                 bias_attr, layer_norm_eps, cross, device, dtype, generator):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype,
                  generator=generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        n_norms = 3 if cross else 2
        for name in ("self_attn", "cross_attn")[:n_norms - 1]:
            setattr(self, name, MultiHeadAttention(
                d_model, nhead, attn_dropout, weight_attr=weight_attr,
                bias_attr=bias_attr, **kw))
        self.linear1 = _linear(d_model, dim_feedforward, weight_attr,
                               bias_attr, **kw)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.linear2 = _linear(dim_feedforward, d_model, weight_attr,
                               bias_attr, **kw)
        for i in range(1, n_norms + 1):
            setattr(self, f"norm{i}", LayerNorm(
                d_model, layer_norm_eps, device=kw["device"], dtype=dtype))
        for i in range(1, n_norms + 1):
            setattr(self, f"dropout{i}", Dropout(dropout,
                                                 generator=generator))
        self.activation = _ACTIVATIONS[activation]
        self._act_name = activation

    def _ffn(self, src):
        # the bias and the activation run in the first product's epilogue
        if self.linear1.bias is not None:
            h = F.linear_act(src, self.linear1.weight, self.linear1.bias,
                             act=self._act_name)
        else:
            h = self.activation(self.linear1(src))
        return self.linear2(self.dropout(h))

    def _sublayer(self, norm, drop, x, fn):
        """``x`` through ``fn`` with dropout and the residual: pre-norm
        ``x + drop(fn(norm(x)))``, post-norm ``norm(x + drop(fn(x)))`` with
        the add inside the fused residual layer norm.  ``fn`` may return
        ``(out, cache)``; the cache is passed on."""
        out = fn(norm(x) if self.normalize_before else x)
        cache = None
        if isinstance(out, tuple):
            out, cache = out
        out = drop(out)
        out = x + out if self.normalize_before else norm.forward_fused(out, x)
        return out, cache


class TransformerEncoderLayer(_SublayerBase):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__(d_model, nhead, dim_feedforward, dropout, activation,
                         attn_dropout, act_dropout, normalize_before,
                         weight_attr, bias_attr, layer_norm_eps, False,
                         device, dtype, generator)

    def forward(self, src, src_mask=None, cache=None):
        src, new_cache = self._sublayer(
            self.norm1, self.dropout1, src,
            lambda x: self.self_attn(x, x, x, src_mask, cache=cache))
        src, _ = self._sublayer(self.norm2, self.dropout2, src, self._ffn)
        return src if cache is None else (src, new_cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerDecoderLayer(_SublayerBase):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__(d_model, nhead, dim_feedforward, dropout, activation,
                         attn_dropout, act_dropout, normalize_before,
                         weight_attr, bias_attr, layer_norm_eps, True,
                         device, dtype, generator)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        """``cache``: ``(Cache of the self-attention, StaticCache of the
        projected memory)``, as ``gen_cache`` makes it."""
        inc, static = (None, None) if cache is None else cache
        tgt, inc = self._sublayer(
            self.norm1, self.dropout1, tgt,
            lambda x: self.self_attn(x, x, x, tgt_mask, cache=inc))
        tgt, static = self._sublayer(
            self.norm2, self.dropout2, tgt,
            lambda x: self.cross_attn(x, memory, memory, memory_mask,
                                      cache=static))
        tgt, _ = self._sublayer(self.norm3, self.dropout3, tgt, self._ffn)
        return tgt if cache is None else (tgt, (inc, static))

    def gen_cache(self, memory):
        return (self.self_attn.gen_cache(memory),
                self.cross_attn.gen_cache(
                    memory, type=MultiHeadAttention.StaticCache))


def _clone_layer(layer):
    """A deep copy of ``layer`` with the values of its parameters (the
    reference's ``_clone_layer`` copies them, :202-229) that shares its
    generators."""
    memo = {id(m.generator): m.generator for m in layer.modules()
            if isinstance(getattr(m, "generator", None), torch.Generator)}
    return copy.deepcopy(layer, memo)


class _Stack(nn.Module):
    def __init__(self, layer, num_layers, norm):
        super().__init__()
        self.layers = LayerList([layer if i == 0 else _clone_layer(layer)
                                 for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm
        self.enable_recompute = False

    def _run(self, x, args, cache):
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is not None:
                x, c = layer(x, *args, cache=cache[i])
                new_caches.append(c)
            elif self.enable_recompute:
                from ...distributed.fleet.recompute import recompute
                x = recompute(layer, x, *args)
            else:
                x = layer(x, *args)
        if self.norm is not None:
            x = self.norm(x)
        return x if cache is None else (x, new_caches)


class TransformerEncoder(_Stack):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__(encoder_layer, num_layers, norm)

    def forward(self, src, src_mask=None, cache=None):
        return self._run(src, (src_mask,), cache)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoder(_Stack):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__(decoder_layer, num_layers, norm)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        return self._run(tgt, (memory, tgt_mask, memory_mask), cache)

    def gen_cache(self, memory, do_zip=False):
        caches = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*caches)) if do_zip else caches


class Transformer(nn.Module):
    """Encoder and decoder stacks; with ``normalize_before`` each ends in
    a ``LayerNorm``."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype, generator=generator)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)

        def final_norm():
            return LayerNorm(d_model, device=device, dtype=dtype) \
                if normalize_before else None

        self.encoder = custom_encoder if custom_encoder is not None else \
            TransformerEncoder(TransformerEncoderLayer(*args, **kw),
                               num_encoder_layers, final_norm())
        self.decoder = custom_decoder if custom_decoder is not None else \
            TransformerDecoder(TransformerDecoderLayer(*args, **kw),
                               num_decoder_layers, final_norm())
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """``[length, length]`` f32: 0 on and below the diagonal, ``-inf``
        above it, on ``device`` (the CUDA device by default)."""
        return torch.triu(torch.full((length, length), float("-inf"),
                                     device=resolve_device(device)), 1)
