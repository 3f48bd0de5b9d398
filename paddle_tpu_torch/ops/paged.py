"""Paged decode attention: one query row per (sequence, head) over the
sequence's pages of a paged KV pool.

Port of ``paddle_tpu/ops/pallas_kernels.py`` ``paged_attention`` (:964),
whose body ``_paged_attn_kernel`` (:898) becomes
``paddle_tpu_torch/csrc/paged_attention.cu``.  The plain version,
`paged_attention_ref`, is the reference's XLA composite ``_paged_ref``
(``paddle_tpu/inference/serving/attention.py:166-199``) op for op: gather
the table's pages, f32 scores, the -1e30 mask, f32 softmax, the
probabilities cast to ``q``'s type, zeros where nothing is visible, the
f32 PV product.

Layout (unchanged from the reference)::

    q            [B, 1, H, D]
    k/v pools    [num_blocks, H, block_size, D]
    block_tables [B, W] int32 (padding entries point at block 0)
    context_lens [B] int32 (0: a zero output)

The kernel's domain is the reference's Pallas domain
(``_use_pallas_paged``, attention.py:202-211): head_dim <= 256,
``block_size % 8 == 0``, f32 or bf16.  On CUDA tensors outside it the
wrapper raises, naming the shape; a CPU tensor takes the plain version.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .tiles import NEG_INF

__all__ = ["MAX_HEAD_DIM", "paged_attention_ref", "paged_attention"]

#: the largest head_dim the kernel (and the reference's Pallas path) takes
MAX_HEAD_DIM = 256


def _scale(q, scale):
    return 1.0 / q.shape[-1] ** 0.5 if scale is None else float(scale)


def paged_attention_ref(q, k_pool, v_pool, block_tables, context_lens,
                        scale=None):
    """Plain decode attention for q ``[B, 1, H, D]`` over the paged pools
    (the reference's ``_paged_ref``)."""
    B, s, H, D = q.shape
    if s != 1:
        raise ValueError(f"paged_attention decodes 1 token, got s={s}")
    scale = _scale(q, scale)
    W = block_tables.shape[1]
    bs = k_pool.shape[2]
    bt = block_tables.long()
    k = k_pool[bt].movedim(2, 1).reshape(B, H, W * bs, D)
    v = v_pool[bt].movedim(2, 1).reshape(B, H, W * bs, D)
    qt = q.transpose(1, 2)                               # [B, H, 1, D]
    scores = torch.einsum("bhqd,bhkd->bhqk", qt.float(), k.float()) * scale
    pos = torch.arange(W * bs, device=q.device)
    visible = pos[None, :] < context_lens.long()[:, None]
    scores = torch.where(visible[:, None, None, :], scores,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    any_visible = (scores > -1e29).any(dim=-1, keepdim=True)
    probs = torch.where(any_visible, probs,
                        torch.zeros((), dtype=q.dtype, device=q.device))
    out = torch.einsum("bhqk,bhkd->bhqd", probs.float(), v.float())
    return out.to(q.dtype).transpose(1, 2)               # [B, 1, H, D]


def _check(q, k_pool, v_pool, block_tables, context_lens):
    """Raise unless the call is in the kernel's domain and its tensors lie
    contiguous on q's device with the layout's shapes and types."""
    B, s, H, D = q.shape
    nb, Hp, bs, Dp = k_pool.shape
    shape = (f"q {tuple(q.shape)} {q.dtype}, pools {tuple(k_pool.shape)} "
             f"{k_pool.dtype}")
    if s != 1:
        raise ValueError(f"paged attention decodes 1 token, got {shape}")
    if D > MAX_HEAD_DIM or bs % 8:
        raise ValueError(f"paged attention: head_dim {D} (at most "
                         f"{MAX_HEAD_DIM}) and block_size {bs} (a multiple "
                         f"of 8) outside the kernel's domain: {shape}")
    cuda_lib.dtype_code(q.dtype)
    if (Hp, Dp) != (H, D) or tuple(v_pool.shape) != tuple(k_pool.shape):
        raise ValueError(f"paged attention: pools do not match q: {shape}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != q.dtype:
            raise ValueError(f"paged attention: {name} is {t.dtype}, q is "
                             f"{q.dtype}")
    W = block_tables.shape[-1]
    for name, t, want in (("block_tables", block_tables, (B, W)),
                          ("context_lens", context_lens, (B,))):
        if t.dtype != torch.int32 or tuple(t.shape) != want:
            raise ValueError(f"paged attention: {name} must be int32 {want}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables),
                    ("context_lens", context_lens)):
        if t.device != q.device:
            raise ValueError(f"paged attention: {name} is on {t.device}, q "
                             f"on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged attention: {name} must be contiguous")
    return B, H, D, bs, W


def paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                    scale=None):
    """Decode attention for q ``[B, 1, H, D]`` over paged K/V (see the
    module doc).  Returns ``[B, 1, H, D]`` in ``q``'s type; the default
    scale is ``1 / sqrt(D)``."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_tables,
                                   context_lens, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged attention: no kernel for device "
                           f"{q.device}")
    B, H, D, bs, W = _check(q, k_pool, v_pool, block_tables, context_lens)
    out = torch.empty_like(q)
    if B and H:
        rc = cuda_lib.library().ptt_paged_attention_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
            B, H, D, bs, W, _scale(q, scale), cuda_lib.dtype_code(q.dtype),
            q.device.index, cuda_lib.stream_handle(q.device))
        cuda_lib.check(rc, "paged_attention")
        paged_attention.launches += 1
    return out


#: kernel launches since the last reset (chip_smoke.py reads them)
paged_attention.launches = 0
