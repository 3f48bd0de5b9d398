"""GPT decoder-only LM (the GPT-3 1.3B class of the reference).

Port of ``paddle_tpu/models/gpt.py``.  Parameter names and shapes match
the reference's ``state_dict`` (``gpt.wte.weight``,
``gpt.h.{i}.attn.qkv_proj.weight`` ``[hidden, 3*hidden]``, ...), so
``convert.load_reference_state`` carries its weights over unchanged.

Serving: with a paged cache view (anything with an ``attend`` method,
see ``inference/serving/attention.py``) each layer scatters its K/V into
the pool and runs ragged paged attention (the paged view's decode mode:
paged decode attention), and the per-row positions come from the view.
With multi-LoRA on, the view's ``lora`` state adds each q-block's adapter
delta after the qkv, out, fc1 and fc2 projections through the SGMV
epilogue; fc1 then runs as a plain GEMM with its activation deferred into
that epilogue.

Dense attention (``cache=None``, or the dense KV cache: a list of
per-layer ``(k, v)`` that ``use_cache=True`` returns extended, as
``generate`` uses it) goes through ``F.scaled_dot_product_attention``
inside ``sdp_kernel(enable_flash=use_flash_attention)``, as in the
reference: with ``True`` (the default) the flash-attention kernels,
with ``False`` the composite ``_sdpa_ref``.  ``use_recompute=True``
wraps each block in ``distributed.fleet.recompute`` when there is no
cache.  ``use_scan_layers=True`` is accepted: the reference's scan is a
compile-time lever whose value is the unrolled stack's, and the port runs
the same loop over the blocks either way (recompute as set).
``GPTPretrainingCriterion`` is the shifted next-token loss
through the softmax cross-entropy kernels.

``fc1`` runs through the matmul-epilogue kernels with ``gelu_tanh``, the
three layer norms through the layer-norm kernels, forward and backward.
After ``quantization.convert_to_int8`` every ``Linear`` (qkv, out, fc1,
fc2) runs the int8 matmul-epilogue kernel; the tied LM head stays float
(an untied ``lm_head``, a ``Linear``, is converted too).
A model starts in training mode, as the reference's ``Layer`` does (the
serving engine switches it to eval); dropout masks come from the
model's own ``torch.Generator``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .. import nn as pnn
from ..core import resolve_device, to_torch_dtype
from ..distributed.fleet import recompute
from ..nn import functional as F
from .generation import GenerationMixin

__all__ = ["GPTConfig", "GPT_1P3B", "GPTAttention", "GPTMLP", "GPTBlock",
           "GPTModel", "GPTForCausalLM", "GPTPretrainingCriterion"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 0      # 0 -> 4*hidden
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.0
    use_flash_attention: bool = True
    use_recompute: bool = False
    tie_word_embeddings: bool = True
    use_scan_layers: bool = False

    def __post_init__(self):
        if not self.intermediate_size:
            self.intermediate_size = 4 * self.hidden_size


#: 1.3B preset (GPT-3 XL shape), the reference's `GPT_1P3B`
GPT_1P3B = dict(vocab_size=50304, hidden_size=2048, num_hidden_layers=24,
                num_attention_heads=16, max_position_embeddings=2048)


class GPTAttention(nn.Module):
    def __init__(self, cfg, **kw):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.use_flash = cfg.use_flash_attention
        self.qkv_proj = pnn.Linear(cfg.hidden_size, 3 * cfg.hidden_size,
                                   **kw)
        self.out_proj = pnn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)

    def forward(self, x, cache=None, use_cache=False):
        b, s, h = x.shape
        qkv = self.qkv_proj(x)
        # multi-LoRA serving: each q-block's adapter delta follows the
        # projection through the SGMV epilogue (null rows unchanged)
        lora = getattr(cache, "lora", None)
        if lora is not None and lora.active(self.qkv_proj):
            qkv = lora.apply(qkv, x, self.qkv_proj)
        q, k, v = qkv.reshape(b, s, 3, self.num_heads,
                              self.head_dim).unbind(dim=2)
        if cache is not None and hasattr(cache, "attend"):
            # the paged serving cache: the layer view scatters K/V into
            # the pool and attends through the block tables
            attn = cache.attend(q, k, v, use_flash=self.use_flash).reshape(
                b, s, h)
            out = self.out_proj(attn)
            if lora is not None and lora.active(self.out_proj):
                out = lora.apply(out, attn, self.out_proj)
            return (out, cache) if use_cache else out
        if cache is not None:
            # dense decode: extend K/V with the cached prefix; the causal
            # mask is bottom-right aligned, so new rows see everything
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        with F.sdp_kernel(enable_flash=self.use_flash):
            attn = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        out = self.out_proj(attn.reshape(b, s, h))
        return (out, (k, v)) if use_cache else out


class GPTMLP(nn.Module):
    def __init__(self, cfg, **kw):
        super().__init__()
        self.fc1 = pnn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.fc2 = pnn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x, lora=None):
        # fc1's bias + gelu fold into the matmul-epilogue kernel (its int8
        # twin once convert_to_int8 has run)
        w_q = getattr(self.fc1, "weight_q", None)
        if w_q is not None:
            h = F.linear_act_int8(x, w_q, self.fc1.weight_scale,
                                  self.fc1.bias, act="gelu_tanh")
        elif lora is not None and lora.active(self.fc1):
            # the activation is deferred past the adapter delta: the SGMV
            # epilogue computes act(z + delta) in one pass
            z = F.linear(x, self.fc1.weight, self.fc1.bias)
            h = lora.apply(z, x, self.fc1, act="gelu_tanh")
        else:
            h = F.linear_act(x, self.fc1.weight, self.fc1.bias,
                             act="gelu_tanh")
        y = self.fc2(h)
        if lora is not None and lora.active(self.fc2):
            y = lora.apply(y, h, self.fc2)
        return y


class GPTBlock(nn.Module):
    #: the block's MLP (MoE-GPT's block swaps in its expert MLP)
    mlp_cls = GPTMLP

    def __init__(self, cfg, *, device, dtype, generator):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.ln_1 = pnn.LayerNorm(cfg.hidden_size, device=device, dtype=dtype)
        self.attn = GPTAttention(cfg, **kw)
        self.ln_2 = pnn.LayerNorm(cfg.hidden_size, device=device, dtype=dtype)
        self.mlp = self.mlp_cls(cfg, **kw)
        self.dropout = pnn.Dropout(cfg.hidden_dropout_prob,
                                   generator=generator)

    def forward(self, x, cache=None, use_cache=False):
        lora = getattr(cache, "lora", None)
        if use_cache:
            a, new_cache = self.attn(self.ln_1(x), cache, True)
            x = x + self.dropout(a)
            return x + self.dropout(self.mlp(self.ln_2(x), lora=lora)), \
                new_cache
        x = x + self.dropout(self.attn(self.ln_1(x), cache))
        return x + self.dropout(self.mlp(self.ln_2(x), lora=lora))


class GPTModel(nn.Module):
    block_cls = GPTBlock

    def __init__(self, cfg, *, device, dtype, generator):
        super().__init__()
        self.config = cfg
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.wte = pnn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.wpe = pnn.Embedding(cfg.max_position_embeddings,
                                 cfg.hidden_size, **kw)
        self.h = pnn.LayerList([self.block_cls(cfg, **kw)
                                for _ in range(cfg.num_hidden_layers)])
        self.ln_f = pnn.LayerNorm(cfg.hidden_size, device=device, dtype=dtype)

    def forward(self, input_ids, cache=None, use_cache=False):
        b, s = input_ids.shape
        pos = getattr(cache, "position_ids", None)
        if pos is None:
            # the paged view supplies each row's positions; a dense cache
            # continues from its length
            past = 0 if cache is None else cache[0][0].shape[1]
            pos = torch.arange(past, past + s, device=input_ids.device)
        x = self.wte(input_ids) + self.wpe(pos)
        new_caches = []
        for i, blk in enumerate(self.h):
            layer_cache = None if cache is None else cache[i]
            if use_cache:
                x, c = blk(x, layer_cache, True)
                new_caches.append(c)
            elif self.config.use_recompute and layer_cache is None:
                x = recompute(blk, x)
            else:
                x = blk(x, layer_cache)
        x = self.ln_f(x)
        return (x, new_caches) if use_cache else x


class GPTForCausalLM(nn.Module, GenerationMixin):
    """GPT with its LM head tied to the token embedding, or, with
    ``tie_word_embeddings=False``, its own ``lm_head`` (a ``Linear``
    ``[hidden, vocab]`` without bias, as in the reference's gpt.py:208).

    ``device=None`` places it on the CUDA device and raises when there
    is none; ``device="cpu"`` runs the plain versions of the kernels.
    The initial weights, and then the dropout masks, are drawn from
    ``torch.Generator(device)`` seeded with ``seed``.  Every parameter
    carries its structured name (``gpt.h.0.ln_1.bias``) as
    ``.param_name`` (a tensor's ``.name`` is torch's own), which the
    optimizers pass to ``apply_decay_param_fun``.
    """

    model_cls = GPTModel

    def __init__(self, cfg, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        device = resolve_device(device)
        dtype = to_torch_dtype(dtype)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        self.config = cfg
        self.gpt = self.model_cls(cfg, device=device, dtype=dtype,
                                  generator=gen)
        self.lm_head = None if cfg.tie_word_embeddings else pnn.Linear(
            cfg.hidden_size, cfg.vocab_size, bias=False, device=device,
            dtype=dtype, generator=gen)
        for name, p in self.named_parameters():
            p.param_name = name

    @property
    def device(self):
        return self.gpt.wte.weight.device

    @property
    def dtype(self):
        return self.gpt.wte.weight.dtype

    def logits(self, hidden):
        """The LM head: ``hidden @ wte.weight^T`` when tied, else
        ``lm_head(hidden)``."""
        if self.lm_head is not None:
            return self.lm_head(hidden)
        return F.matmul(hidden, self.gpt.wte.weight, transpose_y=True)

    def forward(self, input_ids, cache=None, use_cache=False):
        """Logits ``[b, s, vocab]``; with ``use_cache=True``, ``(logits,
        new_cache)``, the dense cache a list of per-layer ``(k, v)``
        ``[b, past + s, heads, head_dim]``."""
        if use_cache:
            hidden, new_cache = self.gpt(input_ids, cache, True)
            return self.logits(hidden), new_cache
        return self.logits(self.gpt(input_ids, cache))


class GPTPretrainingCriterion(nn.Module):
    """Shifted next-token LM loss (``ignore_index=-100`` for padding), the
    reference's ``GPTPretrainingCriterion`` (gpt.py:230-237)."""

    def forward(self, logits, labels):
        v = logits.shape[-1]
        logits = logits[:, :-1, :].reshape(-1, v)
        labels = labels[:, 1:].reshape(-1)
        return F.cross_entropy(logits, labels, reduction="mean")
