"""ERNIE: the BERT encoder with task-type embeddings and a pooled [CLS]
head.

Port of ``paddle_tpu/models/ernie.py``.  It reuses the BERT blocks
(``BertLayer``, ``TiedMLMHead``), so the encoder runs the same kernels:
the fused residual layer norm twice a layer, the matmul epilogue for fc1,
and attention through ``F.scaled_dot_product_attention`` (the flash
kernels without causality in eval).  Two points where it differs from
BERT, as the reference does: the embeddings sum word, position, token
type and task type before their layer norm and apply **no** dropout
(ernie.py:43-54); and ``task_type_ids=None`` means task 0 for every
token, while ``use_task_id=False`` builds no task table at all.
Parameter names and shapes match the reference's ``state_dict``
(``ernie.embeddings.task_type_embeddings.weight``, ``ernie.pooler.weight``,
``classifier.weight``, ...).
"""
from __future__ import annotations

import torch

from .. import nn as pnn
from ..nn import functional as F
from .bert import (BertConfig, BertEmbeddings, BertLayer, EncoderRoot,
                   TiedMLMHead, root_kwargs)

__all__ = ["ErnieConfig", "ErnieEmbeddings", "ErnieModel",
           "ErnieForMaskedLM", "ErnieForSequenceClassification"]


class ErnieConfig(BertConfig):
    def __init__(self, task_type_vocab_size=3, use_task_id=True,
                 num_labels=2, **kw):
        super().__init__(**kw)
        self.task_type_vocab_size = task_type_vocab_size
        self.use_task_id = use_task_id
        self.num_labels = num_labels


class ErnieEmbeddings(BertEmbeddings):
    """LayerNorm(word + position + token type + task type), without
    dropout."""

    def __init__(self, cfg, *, device, dtype, generator):
        super().__init__(cfg, device=device, dtype=dtype, generator=generator)
        self.task_type_embeddings = None
        if cfg.use_task_id:
            self.task_type_embeddings = pnn.Embedding(
                cfg.task_type_vocab_size, cfg.hidden_size, device=device,
                dtype=dtype, generator=generator)

    def forward(self, input_ids, token_type_ids=None, task_type_ids=None):
        x = self._sum(input_ids, token_type_ids)
        if self.task_type_embeddings is not None:
            if task_type_ids is None:
                task_type_ids = torch.zeros_like(input_ids)
            x = x + self.task_type_embeddings(task_type_ids)
        return self.layer_norm(x)


class ErnieModel(torch.nn.Module):
    """The encoder and the tanh pooler over the first token: returns
    ``(hidden [b, s, h], pooled [b, h])``."""

    def __init__(self, cfg, *, device, dtype, generator):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.config = cfg
        self.embeddings = ErnieEmbeddings(cfg, **kw)
        self.encoder = pnn.LayerList([BertLayer(cfg, **kw)
                                      for _ in range(cfg.num_hidden_layers)])
        self.pooler = pnn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)

    def forward(self, input_ids, token_type_ids=None, task_type_ids=None,
                attn_mask=None):
        x = self.embeddings(input_ids, token_type_ids, task_type_ids)
        for layer in self.encoder:
            x = layer(x, attn_mask)
        return x, F.tanh(self.pooler(x[:, 0]))


class ErnieForMaskedLM(EncoderRoot):
    """ERNIE with the tied masked-LM head: logits, or ``(loss, logits)``
    with ``labels``.  ``device``, ``dtype`` and ``seed`` as in
    ``models.bert.root_kwargs``."""

    def __init__(self, cfg, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        kw = root_kwargs(device, dtype, seed)
        self.config = cfg
        self.ernie = ErnieModel(cfg, **kw)
        self.cls = TiedMLMHead(cfg, **kw)
        self.name_parameters()

    def forward(self, input_ids, token_type_ids=None, task_type_ids=None,
                attn_mask=None, labels=None):
        hidden, _ = self.ernie(input_ids, token_type_ids, task_type_ids,
                               attn_mask)
        return self.cls(hidden, self.ernie.embeddings.word_embeddings.weight,
                        labels)


class ErnieForSequenceClassification(EncoderRoot):
    """ERNIE with a dropout and a linear classifier over the pooled
    output: logits ``[b, num_labels]``, or ``(loss, logits)`` with
    ``labels``."""

    def __init__(self, cfg, dropout_prob=0.1, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        kw = root_kwargs(device, dtype, seed)
        self.config = cfg
        self.ernie = ErnieModel(cfg, **kw)
        self.dropout = pnn.Dropout(dropout_prob, generator=kw["generator"])
        self.classifier = pnn.Linear(cfg.hidden_size, cfg.num_labels, **kw)
        self.name_parameters()

    def forward(self, input_ids, token_type_ids=None, task_type_ids=None,
                attn_mask=None, labels=None):
        _, pooled = self.ernie(input_ids, token_type_ids, task_type_ids,
                               attn_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        loss = F.cross_entropy(logits, labels.reshape(-1), reduction="mean")
        return loss, logits
