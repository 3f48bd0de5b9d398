"""LLaMA decoder LM (the reference's BASELINE config #5, LLaMA-2 7B class).

Port of ``paddle_tpu/models/llama.py``: RMSNorm, rotary position
embeddings, grouped-query attention (GQA) and the SwiGLU MLP, with no
biases and an untied LM head.  Parameter and buffer names and shapes match
the reference's ``state_dict`` (``llama.embed_tokens.weight``,
``llama.layers.{i}.self_attn.q_proj.weight`` ``[hidden, heads*head_dim]``,
..., and the rope tables ``llama.rope_cos``/``llama.rope_sin``), so
``convert.load_reference_state`` carries its weights over unchanged.

The two RMS norms of each layer and the final one run through the
RMS-norm kernels, forward and backward; attention through
``F.scaled_dot_product_attention``, which routes it to the flash-attention
kernels as the reference routes it; the loss through the softmax
cross-entropy kernels.  The rope tables are persistent buffers held in the
model's dtype, as the reference's ``astype`` casts its buffers: in a bf16
model every op of `apply_rotary_pos_emb` rounds to bf16.

Dense KV cache (``use_cache=True``, as ``generate`` uses it): a list of
per-layer ``(k, v)`` ``[b, past + s, kv_heads, head_dim]``, holding the
rotated keys and values before GQA repeats their heads.
``use_recompute=True`` wraps each layer in ``distributed.fleet.recompute``
when there is no cache.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .. import nn as pnn
from ..core import resolve_device, to_torch_dtype
from ..distributed.fleet import recompute
from ..nn import functional as F
from .generation import GenerationMixin

__all__ = ["LlamaConfig", "LLAMA_7B", "apply_rotary_pos_emb",
           "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer", "LlamaModel",
           "LlamaForCausalLM"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 0     # 0 -> same as num_attention_heads
    intermediate_size: int = 11008
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    use_recompute: bool = False

    def __post_init__(self):
        if not self.num_key_value_heads:
            self.num_key_value_heads = self.num_attention_heads


#: 7B preset, the reference's `LLAMA_7B`
LLAMA_7B = dict(vocab_size=32000, hidden_size=4096, num_hidden_layers=32,
                num_attention_heads=32, intermediate_size=11008,
                max_position_embeddings=4096)


def _rope_tables(head_dim, max_pos, theta):
    """cos and sin ``[max_pos, head_dim]`` of the rotary angles, computed
    in f64 and rounded to f32 (the reference's tables, bit for bit)."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                           / head_dim))
    t = np.arange(max_pos, dtype=np.float64)
    freqs = np.outer(t, inv)                       # [S, D/2]
    emb = np.concatenate([freqs, freqs], axis=-1)  # [S, D]
    return (np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32))


def _rotate_half(x):
    d = x.shape[-1]
    return torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin):
    """q/k: ``[b, s, h, d]``; cos/sin: ``[s, d]`` broadcast over batch and
    heads.  Types promote as in the reference (bf16 q times f32 tables
    gives f32)."""
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin


class LlamaAttention(nn.Module):
    def __init__(self, cfg, **kw):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.num_kv_heads = cfg.num_key_value_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        h = cfg.hidden_size
        self.q_proj = pnn.Linear(h, self.num_heads * self.head_dim, False,
                                 **kw)
        self.k_proj = pnn.Linear(h, self.num_kv_heads * self.head_dim, False,
                                 **kw)
        self.v_proj = pnn.Linear(h, self.num_kv_heads * self.head_dim, False,
                                 **kw)
        self.o_proj = pnn.Linear(h, h, False, **kw)

    def forward(self, x, cos, sin, cache=None, use_cache=False):
        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        q, k = apply_rotary_pos_emb(q, k, cos, sin)
        if cache is not None:
            # the cache holds the kv heads before GQA repeats them, rotated
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        new_cache = (k, v)
        if self.num_kv_heads != self.num_heads:
            rep = self.num_heads // self.num_kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        out = self.o_proj(out.reshape(b, s, -1))
        return (out, new_cache) if use_cache else out


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, cfg, **kw):
        super().__init__()
        h, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = pnn.Linear(h, f, False, **kw)
        self.up_proj = pnn.Linear(h, f, False, **kw)
        self.down_proj = pnn.Linear(f, h, False, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg, *, device, dtype, generator):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        norm = dict(epsilon=cfg.rms_norm_eps, device=device, dtype=dtype)
        self.input_layernorm = pnn.RMSNorm(cfg.hidden_size, **norm)
        self.self_attn = LlamaAttention(cfg, **kw)
        self.post_attention_layernorm = pnn.RMSNorm(cfg.hidden_size, **norm)
        self.mlp = LlamaMLP(cfg, **kw)

    def forward(self, x, cos, sin, cache=None, use_cache=False):
        if use_cache:
            a, new_cache = self.self_attn(self.input_layernorm(x), cos, sin,
                                          cache, True)
            x = x + a
            return x + self.mlp(self.post_attention_layernorm(x)), new_cache
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, cache)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, cfg, *, device, dtype, generator):
        super().__init__()
        self.config = cfg
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.embed_tokens = pnn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                          **kw)
        self.layers = pnn.LayerList([LlamaDecoderLayer(cfg, **kw)
                                     for _ in range(cfg.num_hidden_layers)])
        self.norm = pnn.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                device=device, dtype=dtype)
        cos, sin = _rope_tables(cfg.hidden_size // cfg.num_attention_heads,
                                cfg.max_position_embeddings, cfg.rope_theta)
        self.register_buffer("rope_cos", torch.from_numpy(cos).to(
            device=device, dtype=dtype))
        self.register_buffer("rope_sin", torch.from_numpy(sin).to(
            device=device, dtype=dtype))

    def forward(self, input_ids, cache=None, use_cache=False):
        s = input_ids.shape[1]
        past = 0 if cache is None else cache[0][0].shape[1]
        x = self.embed_tokens(input_ids)
        cos = self.rope_cos[past:past + s]
        sin = self.rope_sin[past:past + s]
        new_caches = []
        for i, layer in enumerate(self.layers):
            layer_cache = None if cache is None else cache[i]
            if use_cache:
                x, c = layer(x, cos, sin, layer_cache, True)
                new_caches.append(c)
            elif self.config.use_recompute and layer_cache is None:
                x = recompute(layer, x, cos, sin)
            else:
                # a supplied cache takes part even when no updated one is
                # asked for
                x = layer(x, cos, sin, layer_cache)
        x = self.norm(x)
        return (x, new_caches) if use_cache else x


class LlamaForCausalLM(nn.Module, GenerationMixin):
    """LLaMA with an untied LM head ``lm_head.weight`` ``[hidden, vocab]``.

    ``device=None`` places it on the CUDA device and raises when there is
    none; ``device="cpu"`` runs the plain versions of the kernels.  The
    initial weights are drawn on the device from ``torch.Generator(device)``
    seeded with ``seed``, in ``dtype`` (a bf16 7B model never passes
    through host memory or f32).  Every parameter carries its structured
    name (``llama.layers.0.mlp.up_proj.weight``) as ``.param_name``, which
    the optimizers pass to ``apply_decay_param_fun``.
    """

    def __init__(self, cfg, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        device = resolve_device(device)
        dtype = to_torch_dtype(dtype)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        self.config = cfg
        self.llama = LlamaModel(cfg, device=device, dtype=dtype,
                                generator=gen)
        self.lm_head = pnn.Linear(cfg.hidden_size, cfg.vocab_size, False,
                                  device=device, dtype=dtype, generator=gen)
        for name, p in self.named_parameters():
            p.param_name = name

    def forward(self, input_ids, labels=None, cache=None, use_cache=False):
        """Logits ``[b, s, vocab]``; with ``labels``, ``(loss, logits)``,
        the loss the mean cross-entropy of each position's logits against
        the next label (``ignore_index=-100``); with ``use_cache=True``,
        ``(logits, new_cache)``."""
        if use_cache:
            hidden, new_cache = self.llama(input_ids, cache, True)
            return self.lm_head(hidden), new_cache
        logits = self.lm_head(self.llama(input_ids, cache))
        if labels is None:
            return logits
        v = logits.shape[-1]
        loss = F.cross_entropy(logits[:, :-1, :].reshape(-1, v),
                               labels[:, 1:].reshape(-1), reduction="mean")
        return loss, logits
