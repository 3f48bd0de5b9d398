"""Autoregressive generation for the causal LM, with a dense KV cache.

Port of ``paddle_tpu/models/generation.py``: ``generate`` and
``GenerationMixin``.  A model whose ``forward`` takes ``use_cache``
prefills the prompt once and then feeds one token a step, its K/V
concatenated onto the cache (each decode step is flash attention with
one query row against the whole prefix); other models rerun the full
sequence each step.  Tokens are chosen on the host by `_sample_logits`,
a copy of the reference's: greedy argmax, or temperature, top-k and
top-p filtering and a draw from numpy's ``default_rng(seed)``, so the
same logits give the same tokens as the reference.  ``eos_token_id``
ends a row (later tokens are ``pad_token_id``, or eos again); the
sequence never grows past the model's position table.
"""
from __future__ import annotations

import inspect

import numpy as np
import torch

__all__ = ["GenerationMixin", "generate"]


def _sample_logits(logits_row, do_sample, top_k, top_p, temperature,
                   rng):
    z = np.asarray(logits_row, np.float64)
    if not do_sample or temperature == 0.0:
        # temperature 0 means greedy (the conventional request), not
        # "skip scaling and sample at temperature 1"
        return int(z.argmax())
    if temperature is not None and temperature != 1.0:
        # None (HF-style "default") samples unscaled
        z = z / float(temperature)
    z = z - z.max()
    p = np.exp(z)
    p /= p.sum()
    if top_k:
        k = min(int(top_k), len(p))  # clamp to vocab (HF semantics)
        kth = np.sort(p)[-k]
        p = np.where(p >= kth, p, 0.0)
        p /= p.sum()  # renormalize BEFORE nucleus filtering
    if top_p and top_p < 1.0:
        order = np.argsort(-p)
        cum = np.cumsum(p[order])
        # nucleus: smallest set whose cumulative mass REACHES top_p —
        # the boundary token is included (cum before it < top_p)
        cut = (cum - p[order]) < top_p
        mask = np.zeros_like(p, bool)
        mask[order[cut]] = True
        p = np.where(mask, p, 0.0)
    p /= p.sum()
    return int(rng.choice(len(p), p=p))


def _model_max_positions(model):
    """Find max_position_embeddings on the model's config, if any."""
    for obj in (model, getattr(model, "gpt", None),
                getattr(model, "llama", None), getattr(model, "model", None)):
        cfg = getattr(obj, "config", None) if obj is not None else None
        mp = getattr(cfg, "max_position_embeddings", None)
        if mp is not None:
            return int(mp)
    return None


def generate(model, input_ids, max_new_tokens=20, max_length=None,
             do_sample=False, top_k=0, top_p=1.0, temperature=1.0,
             eos_token_id=None, pad_token_id=None, seed=None):
    """Decode continuation tokens of ``input_ids`` (``[B, S]`` or ``[S]``,
    a tensor or an array); returns the full ``[B, S + T]`` int64 ids on
    the model's device."""
    ids = np.asarray(input_ids.cpu().numpy()
                     if isinstance(input_ids, torch.Tensor) else input_ids)
    if ids.ndim == 1:
        ids = ids[None, :]
    device = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    if max_length is not None:
        max_new_tokens = max(0, int(max_length) - ids.shape[1])
    # never decode past the model's position table
    mp = _model_max_positions(model)
    if mp is not None:
        max_new_tokens = max(0, min(int(max_new_tokens), mp - ids.shape[1]))
    done = np.zeros(ids.shape[0], bool)
    cache = None
    use_cache = "use_cache" in inspect.signature(model.forward).parameters
    for step in range(int(max_new_tokens)):
        with torch.no_grad():
            if use_cache:
                # KV-cache decode: feed only the new token after the prompt
                feed = ids if step == 0 else ids[:, -1:]
                logits, cache = model(
                    torch.from_numpy(feed.astype(np.int64)).to(device),
                    cache=cache, use_cache=True)
            else:
                logits = model(torch.from_numpy(ids.astype(np.int64))
                               .to(device))
        if isinstance(logits, (tuple, list)):
            logits = logits[-1]
        last = logits[:, -1, :].float().cpu().numpy()
        nxt = np.array([_sample_logits(last[b], do_sample, top_k, top_p,
                                       temperature, rng)
                        for b in range(ids.shape[0])], ids.dtype)
        if eos_token_id is not None:
            fill = eos_token_id if pad_token_id is None else pad_token_id
            nxt = np.where(done, fill, nxt)
            done |= nxt == eos_token_id
        ids = np.concatenate([ids, nxt[:, None]], axis=1)
        if eos_token_id is not None and done.all():
            break
    return torch.from_numpy(ids.astype(np.int64)).to(device)


class GenerationMixin:
    def generate(self, input_ids, **kwargs):
        return generate(self, input_ids, **kwargs)
