"""JAX's threefry random stream, bit for bit, in torch integer ops.

The reference's serving sampler draws each token with
``jax.random.categorical(fold_in(PRNGKey(seed), position), logp)``
(``paddle_tpu/inference/serving/engine.py:121-125``).  This module
reproduces that draw, so seeded sampled tokens are the reference's:

* ``PRNGKey(seed)`` for a 32-bit seed is the key ``(0, seed)``;
* ``fold_in(key, data)`` is ``threefry2x32(key, (0, data))``;
* the random bits of a ``[..., V]`` draw are, for the flat index ``i``
  of each element, ``x1 ^ x2`` of ``threefry2x32(key, (0, i))``: JAX's
  *partitionable* threefry mode (``jax_threefry_partitionable=True``,
  the default since jax 0.5 and the mode of jax 0.9, which the tests
  run against);
* ``uniform`` keeps the top 23 bits as the mantissa of a float in
  [1, 2), subtracts 1, and maps to ``[tiny, 1)``; ``gumbel`` is
  ``-log(-log(u))``; ``categorical`` is ``argmax(logits + gumbel)``.

Every uint32 value is held in an int64 tensor and masked with
``0xFFFFFFFF`` after each add and shift, so the arithmetic is exact on
the CPU and on the card.
"""
from __future__ import annotations

import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "random_bits",
           "uniform", "gumbel", "categorical"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY_F32 = torch.finfo(torch.float32).tiny


def _rotl(x, d):
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds (JAX's ``_threefry2x32_lowering``):
    key words ``k1, k2`` and count words ``x1, x2`` are int64 tensors (or
    ints) holding uint32 values, broadcast together.  Returns the two
    output words."""
    k1 = torch.as_tensor(k1, dtype=torch.int64)
    k2 = torch.as_tensor(k2, dtype=torch.int64, device=k1.device)
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (torch.as_tensor(x1, dtype=torch.int64, device=k1.device)
          + ks[0]) & _MASK
    x2 = (torch.as_tensor(x2, dtype=torch.int64, device=k1.device)
          + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seed, device=None):
    """``jax.random.PRNGKey`` of uint32 seeds: ``[..., 2]`` int64."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device) & _MASK
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in``: ``key`` ``[..., 2]``, uint32 ``data``
    broadcast against the key's leading shape."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key, n):
    """32-bit random bits of a ``[..., n]`` draw with keys ``[..., 2]``
    (partitionable threefry): int64 ``[..., n]`` holding uint32 values."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0:1], key[..., 1:2], 0, i)
    return b1 ^ b2


def uniform(key, n):
    """``jax.random.uniform(key, (n,), float32, minval=tiny, maxval=1)``
    per key, the draw under ``gumbel``: f32 ``[..., n]``."""
    bits = random_bits(key, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(_TINY_F32, dtype=torch.float32, device=key.device)
    hi = torch.tensor(1.0, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def gumbel(key, n):
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low") per key."""
    return -torch.log(-torch.log(uniform(key, n)))


def categorical(key, logits):
    """``jax.random.categorical(key, logits)`` over the last dim of f32
    ``logits`` ``[..., V]`` with one key per row ``[..., 2]``: int64."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)
