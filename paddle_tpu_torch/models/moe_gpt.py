"""MoE-GPT: GPT with every block's MLP a dropless top-k mixture of experts.

Port of ``paddle_tpu/models/moe_gpt.py``: ``MoEGPTConfig`` (:50), the
expert MLP ``_moe_mlp_compute`` (:57-86) and ``MoEMLP`` (:178), the
blocks and model (:240, :260, ``aux_loss`` :299), ``MoEGPTForCausalLM``
(:312) and ``MoEGPTPretrainingCriterion`` (:342).  The skeleton is the
port's GPT (attention, layer norms, tied LM head, recompute, the serving
engine's paged view and ``generate()``); only the MLP differs:

  * the router scores each token against ``num_experts`` experts in f32
    (``x`` and the router weight cast to f32, as the reference does) and
    keeps the top ``top_k``, renormalised to sum to 1; ties keep the lower
    expert index, as ``jax.lax.top_k`` does (a stable descending sort);
  * routing is dropless (`distributed.auto_parallel.moe_dispatch`): every
    assignment gets a row of a block-aligned grouped buffer;
  * the stacked experts ``w1 [E, H, I]``, ``w2 [E, I, H]`` run through the
    grouped-matmul kernels (`ops.grouped`), ``gelu_tanh`` after ``w1``.

The expert MLP consults no AMP list: ``moe_mlp_dropless`` is on neither of
the reference's O1 lists, so under ``auto_cast`` the experts run in the
type they are given (f32 after the black-listed layer norm), and nothing
here goes through a white-listed functional.  The ``ep`` (expert-parallel)
island of the reference is not ported: the port has no ``ep`` mesh axis.
Each ``MoEMLP`` keeps its last forward's load-balance loss (``aux_loss``)
and per-expert token counts (``counts``, on the device).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..distributed.auto_parallel import moe_dispatch as md
from ..ops import grouped
from .gpt import (GPTBlock, GPTConfig, GPTForCausalLM, GPTModel,
                  GPTPretrainingCriterion)

__all__ = ["MoEGPTConfig", "MoEMLP", "MoEGPTBlock", "MoEGPTModel",
           "MoEGPTForCausalLM", "MoEGPTPretrainingCriterion", "route",
           "moe_mlp_compute"]


@dataclass
class MoEGPTConfig(GPTConfig):
    num_experts: int = 4
    top_k: int = 2
    #: weight on the Switch-style load-balance auxiliary loss
    router_aux_weight: float = 0.01


def route(x, router, top_k):
    """``(probs [N, E] f32, top-k weights renormalised, top-k expert ids)``
    for flat tokens ``x`` [N, H]: the router's f32 softmax, and its top
    ``top_k`` taken from a stable descending sort (ties keep the lower
    index)."""
    logits = torch.matmul(x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = vals[:, :top_k], idx[:, :top_k]
    return probs, topv / topv.sum(dim=-1, keepdim=True), topi


def moe_mlp_compute(x, router, w1, b1, w2, b2, *, top_k, num_experts):
    """The dropless MoE MLP on flat tokens ``x`` [N, H]: route, grouped
    expert FFN (``gelu_tanh`` after ``w1``), combine.  Returns ``(y [N, H],
    aux, counts [E])``, ``aux`` the Switch load-balance term
    ``E * sum_e(frac_e * mean_prob_e)``."""
    N = x.shape[0]
    probs, topv, topi = route(x, router, top_k)
    bm, nb, rows_total = grouped.grouped_layout(N * top_k, num_experts,
                                                x.dtype)
    rows, gid, counts = md.dropless_plan(topi, num_experts, bm, nb)
    xd = md.dropless_dispatch(x, rows, top_k, rows_total)
    h = grouped.grouped_linear_act(xd, w1, b1, block_group=gid,
                                   act="gelu_tanh")
    y_rows = grouped.grouped_linear_act(h, w2, b2, block_group=gid)
    y = md.dropless_combine(y_rows, rows, topv)
    frac = counts.float() / max(N * top_k, 1)
    aux = num_experts * torch.sum(frac * probs.mean(dim=0))
    return y.to(x.dtype), aux, counts


def _xavier_normal(shape, device, dtype, generator):
    """The reference's ``XavierNormal`` with its fans
    (``paddle_tpu/nn/initializer/__init__.py:27-38``): for a 3-D
    ``[E, H, I]`` fan_in = H * I and fan_out = E * I."""
    if len(shape) == 2:
        fan_in, fan_out = shape
    else:
        fan_in = shape[1] * shape[2]
        fan_out = shape[0] * shape[2]
    p = nn.Parameter(torch.empty(shape, device=device, dtype=dtype))
    with torch.no_grad():
        p.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                  generator=generator)
    return p


class MoEMLP(nn.Module):
    """Dropless top-k mixture-of-experts FFN with stacked parameters
    ``router [H, E]``, ``w1 [E, H, I]``, ``b1 [E, I]``, ``w2 [E, I, H]``,
    ``b2 [E, H]`` (the reference's names and shapes)."""

    def __init__(self, cfg, *, device, dtype, generator):
        super().__init__()
        H, Iv, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
        self.num_experts = E
        self.top_k = cfg.top_k
        kw = dict(device=device, dtype=dtype)
        self.router = _xavier_normal((H, E), generator=generator, **kw)
        self.w1 = _xavier_normal((E, H, Iv), generator=generator, **kw)
        self.b1 = nn.Parameter(torch.zeros(E, Iv, **kw))
        self.w2 = _xavier_normal((E, Iv, H), generator=generator, **kw)
        self.b2 = nn.Parameter(torch.zeros(E, H, **kw))
        self.aux_loss = None
        self.counts = None

    def forward(self, x, lora=None):
        if lora is not None:
            # the reference's expert MLP has no adapter site
            raise NotImplementedError(
                "multi-LoRA serving of MoE-GPT's expert MLP is not ported "
                "yet (the reference has no LoRA site there)")
        y, self.aux_loss, self.counts = moe_mlp_compute(
            x.reshape(-1, x.shape[-1]), self.router, self.w1, self.b1,
            self.w2, self.b2, top_k=self.top_k,
            num_experts=self.num_experts)
        return y.reshape(x.shape)


class MoEGPTBlock(GPTBlock):
    mlp_cls = MoEMLP


class MoEGPTModel(GPTModel):
    block_cls = MoEGPTBlock

    def aux_loss(self):
        """Sum of the blocks' router load-balance losses (None before the
        first forward).  Under recompute the backward's replay overwrites
        each block's ``aux_loss``; a loss built from the first forward's
        values keeps its graph to the routers."""
        losses = [blk.mlp.aux_loss for blk in self.h
                  if blk.mlp.aux_loss is not None]
        return sum(losses[1:], losses[0]) if losses else None


class MoEGPTForCausalLM(GPTForCausalLM):
    """MoE-GPT with the LM head tied to the token embedding; ``device``,
    ``dtype`` and ``seed`` as `GPTForCausalLM`'s, and what the serving
    engine calls (``.gpt``, ``.logits``, ``.config``, ``.device``,
    ``.dtype``) the same."""

    model_cls = MoEGPTModel

    def aux_loss(self):
        return self.gpt.aux_loss()


class MoEGPTPretrainingCriterion(GPTPretrainingCriterion):
    """The shifted LM loss plus ``aux_weight`` (default the config's
    ``router_aux_weight``) times the model's router load-balance loss."""

    def __init__(self, model=None, aux_weight=None):
        super().__init__()
        # kept out of the module tree: the criterion holds no parameters
        self.__dict__["model"] = model
        self.aux_weight = aux_weight

    def forward(self, logits, labels):
        loss = super().forward(logits, labels)
        aux = self.model.aux_loss() if self.model is not None else None
        if aux is not None:
            w = self.aux_weight
            if w is None:
                w = getattr(self.model.config, "router_aux_weight", 0.01)
            loss = loss + w * aux
        return loss
