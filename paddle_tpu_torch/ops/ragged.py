"""Ragged paged attention: one call for a mixed prefill + decode batch.

Port of ``paddle_tpu/ops/pallas_ragged.py``: ``ragged_q_block`` (:67),
the host-side descriptor function ``ragged_segments`` (:73, identical
outputs), and ``ragged_paged_attention`` (:206), whose Pallas body
``_ragged_attn_body``/``_ragged_attn_kernel`` (:115/:189) becomes
``paddle_tpu_torch/csrc/ragged_attention.cu``.  The plain version,
`ragged_attention_ref`, is the reference's XLA composite ``_ragged_ref``
(``paddle_tpu/inference/serving/attention.py:230``) op for op.

Layout (unchanged from the reference)::

    q            [T, H, D]   T = num_q_blocks * block_q
    k/v pools    [num_blocks, H, block_size, D]
    block_tables [S, W], context_lens [S]              int32
    seq_ids / q_starts / q_valids [num_q_blocks]       int32

``seq_ids == S`` marks the null segment (all padding).  Row ``r`` of
q-block ``i`` sees key ``c`` iff ``r < q_valids[i]`` and ``c <=
q_starts[i] + r`` and ``c < context_len``; a row that sees nothing is
zeros.  A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_lib
from .tiles import NEG_INF, STAT_LANES, min_rows

__all__ = ["ragged_q_block", "ragged_segments", "ragged_attention_ref",
           "ragged_paged_attention"]


def ragged_q_block(dtype) -> int:
    """Rows per ragged q-block for queries of ``dtype``: 8 for f32, 16
    for bf16 (the reference's value, so its descriptors match)."""
    return max(STAT_LANES, min_rows(dtype))


def ragged_segments(query_lens, context_lens, block_q,
                    num_q_blocks=None, num_seqs=None):
    """Host-side ragged layout for a mixed batch (numpy).

    Returns ``(seq_ids, q_starts, q_valids, offsets, total_rows)``:
    per-q-block descriptor arrays (padded to ``num_q_blocks`` with the
    ``num_seqs`` null segment when given) plus each sequence's flat row
    offset and the total flat rows used.
    """
    query_lens = [int(x) for x in query_lens]
    context_lens = [int(x) for x in context_lens]
    if num_seqs is None:
        num_seqs = len(query_lens)
    sids, starts, valids, offsets = [], [], [], []
    off = 0
    for s, (ql, cl) in enumerate(zip(query_lens, context_lens)):
        offsets.append(off)
        if ql == 0:
            continue
        if ql > cl:
            raise ValueError(
                f"sequence {s}: query_len {ql} > context_len {cl}")
        base = cl - ql
        nseg = -(-ql // block_q)
        for j in range(nseg):
            sids.append(s)
            starts.append(base + j * block_q)
            valids.append(min(block_q, ql - j * block_q))
        off += nseg * block_q
    if num_q_blocks is not None:
        if len(sids) > num_q_blocks:
            raise ValueError(
                f"{len(sids)} q-blocks exceed budget {num_q_blocks}")
        pad = num_q_blocks - len(sids)
        sids += [num_seqs] * pad
        starts += [0] * pad
        valids += [0] * pad
    return (np.asarray(sids, np.int32), np.asarray(starts, np.int32),
            np.asarray(valids, np.int32),
            np.asarray(offsets, np.int32), off)


def ragged_attention_ref(q, k_pool, v_pool, block_tables, context_lens,
                         seq_ids, q_starts, q_valids, block_q=None,
                         scale=None):
    """Plain PyTorch version: gather every q-block's table, f32 scores,
    -1e30 mask, f32 softmax, probabilities cast to ``q``'s type (as the
    reference does), any-visible zeroing, f32 PV product."""
    T, H, D = q.shape
    if block_q is None:
        block_q = ragged_q_block(q.dtype)
    if scale is None:
        scale = 1.0 / D ** 0.5
    S, W = block_tables.shape
    bs = k_pool.shape[2]
    nqb = T // block_q
    dev = q.device
    # null segment: a zero table row (pad block) and a zero context
    bt = torch.cat([block_tables.long(),
                    torch.zeros(1, W, dtype=torch.long, device=dev)])
    cl = torch.cat([context_lens.long(),
                    torch.zeros(1, dtype=torch.long, device=dev)])
    sid = seq_ids.long()
    bt_q = bt[sid]                                   # [nqb, W]
    k = k_pool[bt_q].movedim(2, 1).reshape(nqb, H, W * bs, D)
    v = v_pool[bt_q].movedim(2, 1).reshape(nqb, H, W * bs, D)
    qt = q.reshape(nqb, block_q, H, D).transpose(1, 2)
    scores = torch.einsum("nhqd,nhkd->nhqk", qt.float(), k.float()) * scale
    row = torch.arange(block_q, device=dev)
    col = torch.arange(W * bs, device=dev)
    pos = q_starts.long()[:, None] + row[None, :]
    visible = ((row[None, :, None] < q_valids.long()[:, None, None])
               & (col[None, None, :] <= pos[:, :, None])
               & (col[None, None, :] < cl[sid][:, None, None]))
    scores = torch.where(visible[:, None], scores,
                         torch.full((), NEG_INF, device=dev))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    any_visible = (scores > -1e29).any(dim=-1, keepdim=True)
    probs = torch.where(any_visible, probs, torch.zeros((), dtype=q.dtype,
                                                        device=dev))
    out = torch.einsum("nhqk,nhkd->nhqd", probs.float(), v.float())
    return out.to(q.dtype).transpose(1, 2).reshape(T, H, D)


def ragged_paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                           seq_ids, q_starts, q_valids, block_q=None,
                           scale=None):
    """Mixed prefill + decode attention over the paged pool (see the
    module doc).  Returns ``[T, H, D]`` in ``q``'s type."""
    T, H, D = q.shape
    if block_q is None:
        block_q = ragged_q_block(q.dtype)
    block_q = int(block_q)
    if T % block_q:
        raise ValueError(f"flat query rows {T} not a multiple of "
                         f"block_q {block_q}")
    nqb = T // block_q
    if seq_ids.shape[0] != nqb:
        raise ValueError(f"{seq_ids.shape[0]} segment descriptors for "
                         f"{nqb} q-blocks")
    if scale is None:
        scale = 1.0 / D ** 0.5
    if q.device.type == "cpu":
        return ragged_attention_ref(q, k_pool, v_pool, block_tables,
                                    context_lens, seq_ids, q_starts,
                                    q_valids, block_q, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"ragged attention: no kernel for device {q.device}")
    code = cuda_lib.dtype_code(q.dtype)
    nb, Hp, bs, Dp = k_pool.shape
    S, W = block_tables.shape
    if (Hp, Dp) != (H, D) or tuple(v_pool.shape) != tuple(k_pool.shape):
        raise ValueError(f"ragged attention: pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q heads {H} "
                         f"x dim {D}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != q.dtype:
            raise ValueError(f"ragged attention: {name} is {t.dtype}, "
                             f"q is {q.dtype}")
    ints = (("block_tables", block_tables, (S, W)),
            ("context_lens", context_lens, (S,)),
            ("seq_ids", seq_ids, (nqb,)), ("q_starts", q_starts, (nqb,)),
            ("q_valids", q_valids, (nqb,)))
    for name, t, shape in ints:
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"ragged attention: {name} must be int32 "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)) \
            + tuple((n, t) for n, t, _ in ints):
        if t.device != q.device:
            raise ValueError(f"ragged attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"ragged attention: {name} must be contiguous")
    out = torch.empty_like(q)
    if nqb and H:
        lib = cuda_lib.library()
        rc = lib.ptt_ragged_attention_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(),
            seq_ids.data_ptr(), q_starts.data_ptr(), q_valids.data_ptr(),
            out.data_ptr(), nqb, S, H, D, bs, W, block_q, float(scale),
            code, q.device.index, cuda_lib.stream_handle(q.device))
        cuda_lib.check(rc, "ragged_attention")
        ragged_paged_attention.launches += 1
    return out


#: kernel launches since the last reset (chip_smoke.py reads it)
ragged_paged_attention.launches = 0
