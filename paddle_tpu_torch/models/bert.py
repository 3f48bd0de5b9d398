"""BERT encoder and masked-LM head (the reference's BASELINE config #3,
BERT-base MLM).

Port of ``paddle_tpu/models/bert.py``.  Parameter names and shapes match
the reference's ``state_dict`` (``bert.embeddings.word_embeddings.weight``,
``bert.encoder.{i}.attention.qkv.weight`` ``[hidden, 3*hidden]``,
``cls.transform.weight``, ``cls.ln.weight``, ...), so
``convert.load_reference_state`` carries its weights over unchanged.

Each post-norm ``BertLayer`` adds its two sublayer outputs to the residual
stream inside the fused residual layer-norm kernel
(``LayerNorm.forward_fused``), forward and backward, and runs fc1's bias
and tanh-GELU in the matmul-epilogue kernels; the embeddings' and the MLM
head's layer norms run the layer-norm kernels, the MLM transform the
epilogue, and the loss the softmax cross-entropy kernels.  Attention goes
through ``F.scaled_dot_product_attention``: with attention dropout on (the
configuration's default, 0.1, in training) the reference's composite,
in eval or at dropout 0 the flash-attention kernels without causality.
A model starts in training mode, as the reference's ``Layer`` does; its
dropout masks, hidden and attention alike, come from the model's own
``torch.Generator``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .. import nn as pnn
from ..core import resolve_device, to_torch_dtype
from ..nn import functional as F

__all__ = ["BertConfig", "BertEmbeddings", "BertSelfAttention", "BertLayer",
           "BertModel", "TiedMLMHead", "BertForMaskedLM"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    use_scan_layers: bool = False


class BertEmbeddings(nn.Module):
    def __init__(self, cfg, *, device, dtype, generator):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.word_embeddings = pnn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                             **kw)
        self.position_embeddings = pnn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, **kw)
        self.token_type_embeddings = pnn.Embedding(cfg.type_vocab_size,
                                                   cfg.hidden_size, **kw)
        self.layer_norm = pnn.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                        device=device, dtype=dtype)
        self.dropout = pnn.Dropout(cfg.hidden_dropout_prob,
                                   generator=generator)

    def _sum(self, input_ids, token_type_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        return x

    def forward(self, input_ids, token_type_ids=None):
        return self.dropout(self.layer_norm(self._sum(input_ids,
                                                      token_type_ids)))


class BertSelfAttention(nn.Module):
    def __init__(self, cfg, *, device, dtype, generator):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.attn_drop_p = cfg.attention_probs_dropout_prob
        self.generator = generator
        self.qkv = pnn.Linear(cfg.hidden_size, 3 * cfg.hidden_size, **kw)
        self.out = pnn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)

    def forward(self, x, attn_mask=None):
        b, s, h = x.shape
        q, k, v = self.qkv(x).reshape(b, s, 3, self.num_heads,
                                      self.head_dim).unbind(dim=2)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.attn_drop_p,
            training=self.training, generator=self.generator)
        return self.out(out.reshape(b, s, h))


class BertLayer(nn.Module):
    def __init__(self, cfg, *, device, dtype, generator):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.attention = BertSelfAttention(cfg, **kw)
        self.ln1 = pnn.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                 device=device, dtype=dtype)
        self.fc1 = pnn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.fc2 = pnn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)
        self.ln2 = pnn.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                 device=device, dtype=dtype)
        self.dropout = pnn.Dropout(cfg.hidden_dropout_prob,
                                   generator=generator)

    def forward(self, x, attn_mask=None):
        # post-norm: each residual add runs inside the fused layer-norm
        # kernel; fc1's bias and gelu fold into the matmul epilogue
        x = self.ln1.forward_fused(
            self.dropout(self.attention(x, attn_mask)), x)
        h = F.linear_act(x, self.fc1.weight, self.fc1.bias,
                         act="gelu_tanh")
        return self.ln2.forward_fused(self.dropout(self.fc2(h)), x)


class BertModel(nn.Module):
    def __init__(self, cfg, *, device, dtype, generator):
        super().__init__()
        if cfg.use_scan_layers:
            raise NotImplementedError("use_scan_layers is not ported yet")
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg, **kw)
        self.encoder = pnn.LayerList([BertLayer(cfg, **kw)
                                      for _ in range(cfg.num_hidden_layers)])

    def forward(self, input_ids, token_type_ids=None, attn_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        for layer in self.encoder:
            x = layer(x, attn_mask)
        return x


class TiedMLMHead(nn.Module):
    """transform -> tanh-GELU -> layer norm -> logits tied to the word
    embedding; the masked-LM head of the BERT family (ERNIE reuses it).
    With ``labels`` it returns ``(loss, logits)``, the mean cross-entropy
    over the labels that are not -100."""

    def __init__(self, cfg, *, device, dtype, generator):
        super().__init__()
        self.transform = pnn.Linear(cfg.hidden_size, cfg.hidden_size,
                                    device=device, dtype=dtype,
                                    generator=generator)
        self.ln = pnn.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                device=device, dtype=dtype)

    def forward(self, hidden, word_embedding_weight, labels=None):
        hidden = self.ln(F.linear_act(hidden, self.transform.weight,
                                      self.transform.bias, act="gelu_tanh"))
        logits = F.matmul(hidden, word_embedding_weight, transpose_y=True)
        if labels is None:
            return logits
        v = logits.shape[-1]
        loss = F.cross_entropy(logits.reshape(-1, v), labels.reshape(-1),
                               ignore_index=-100, reduction="mean")
        return loss, logits


def root_kwargs(device, dtype, seed):
    """The keywords an entry point builds its modules with: ``device=None``
    is the CUDA device (raising when there is none), ``device="cpu"`` runs
    the plain versions of the kernels; the initial weights, and then the
    dropout masks, are drawn from ``torch.Generator(device)`` seeded with
    ``seed``."""
    device = resolve_device(device)
    return dict(device=device, dtype=to_torch_dtype(dtype),
                generator=torch.Generator(device=device).manual_seed(
                    int(seed)))


class EncoderRoot(nn.Module):
    """The BERT family's entry points: every parameter carries its
    structured name (``bert.encoder.0.ln1.bias``) as ``.param_name`` (a
    tensor's ``.name`` is torch's own), which the optimizers pass to
    ``apply_decay_param_fun``."""

    def name_parameters(self):
        for name, p in self.named_parameters():
            p.param_name = name

    @property
    def device(self):
        return next(self.parameters()).device

    @property
    def dtype(self):
        return next(self.parameters()).dtype


class BertForMaskedLM(EncoderRoot):
    """BERT with the tied masked-LM head: logits ``[b, s, vocab]``, or
    ``(loss, logits)`` with ``labels`` (-100: not a masked position).
    ``device``, ``dtype`` and ``seed`` as in `root_kwargs`."""

    def __init__(self, cfg, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        kw = root_kwargs(device, dtype, seed)
        self.config = cfg
        self.bert = BertModel(cfg, **kw)
        self.cls = TiedMLMHead(cfg, **kw)
        self.name_parameters()

    def forward(self, input_ids, token_type_ids=None, labels=None):
        hidden = self.bert(input_ids, token_type_ids)
        return self.cls(hidden, self.bert.embeddings.word_embeddings.weight,
                        labels)
