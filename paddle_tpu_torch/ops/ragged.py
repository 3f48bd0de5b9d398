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

int8 pools (the reference's ``_ragged_attn_int8_kernel`` :197, the int8
branch :268-279) carry per-slot f32 dequant scales ``k_scales`` /
``v_scales`` ``[num_blocks, block_size, KV_SCALE_LANES]``, walked through
the same block tables; the gathered tiles are dequantized to f32 before
the score and output products.  `ragged_paged_attention` sends them to
`ragged_paged_attention_int8`, the int8 kernel's wrapper, which counts
its launches apart from the float kernel's.

The kernel has three routes (`mma_route`): bf16 queries with heads of 64
or 128, 16-row q-blocks, pages a multiple of 16 slots and 16-byte aligned
bases on the tensor cores (row 1, and row 10 over int8 pools); f32
queries on the CUDA cores; f16 queries on the same CUDA-core kernel;
other bf16 layouts element by element on the CUDA cores.  Both wrappers
count their launches by route (``mma_launches``, ``f32_launches``,
``f16_launches``, ``elementwise_launches``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_lib
from .tiles import NEG_INF, STAT_LANES, min_rows

__all__ = ["KV_SCALE_LANES", "ragged_q_block", "ragged_segments",
           "ragged_attention_ref", "ragged_paged_attention",
           "ragged_paged_attention_int8", "mma_route"]

#: lane width of the int8 pools' per-slot scale tables (pallas_ragged.py
#: :64): one f32 per slot, shared by every head
KV_SCALE_LANES = 1


#: head dims of the tensor-core route's instantiations
_MMA_HEAD_DIMS = (64, 128)
#: rows of a q-block and keys of a page slice on the tensor-core route
_MMA_ROWS = 16


def mma_route(q, k_pool, v_pool, out, block_q, k_scales=None,
              v_scales=None):
    """Whether the kernel on these tensors takes the tensor-core route:
    the kernel's rule (``ptt_ragged_attention_mma_route``), bf16 queries
    with D in `_MMA_HEAD_DIMS`, ``block_q`` 16, pages of a multiple of 16
    slots and every base 16-byte aligned; else the CUDA-core kernel: the
    f32 route, the f16 route (the same kernel on f16 rows) or, for other
    bf16 layouts, the element-wise route."""
    bs = k_pool.shape[2]
    return (q.dtype == torch.bfloat16 and q.shape[2] in _MMA_HEAD_DIMS
            and bs > 0 and bs % _MMA_ROWS == 0 and block_q == _MMA_ROWS
            and all(t.data_ptr() % 16 == 0 for t in
                    (q, k_pool, v_pool, k_scales, v_scales, out)
                    if t is not None))


def _count(wrapper, route, dtype):
    """One launch of ``wrapper``, counted by route."""
    wrapper.launches += 1
    if route:
        wrapper.mma_launches += 1
    elif dtype == torch.float32:
        wrapper.f32_launches += 1
    elif dtype == torch.float16:
        wrapper.f16_launches += 1
    else:
        wrapper.elementwise_launches += 1


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
                         scale=None, k_scales=None, v_scales=None):
    """Plain PyTorch version: gather every q-block's table, f32 scores,
    -1e30 mask, f32 softmax, probabilities cast to ``q``'s type (as the
    reference does), any-visible zeroing, f32 PV product.  With
    ``k_scales``/``v_scales`` (int8 pools) the gathered tiles are
    dequantized to f32 first, slot by slot (``_ragged_ref``,
    serving/attention.py:260-264)."""
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
    k = k_pool[bt_q]                                 # [nqb, W, H, bs, D]
    v = v_pool[bt_q]
    if k_scales is not None:
        # per-slot dequant: [nqb, W, 1, bs, 1] over the heads and D
        k = k.float() * k_scales[bt_q][:, :, None, :, :1]
        v = v.float() * v_scales[bt_q][:, :, None, :, :1]
    k = k.movedim(2, 1).reshape(nqb, H, W * bs, D)
    v = v.movedim(2, 1).reshape(nqb, H, W * bs, D)
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


def _geometry(q, seq_ids, block_q, scale):
    """(block_q, number of q-blocks, scale) of a call, checked."""
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
    return block_q, nqb, scale


def _check_inputs(what, q, pools, ints, nqb, pool_dtype):
    """Raise unless the pools match q's heads and dim and hold
    ``pool_dtype``, the int32 inputs have their shapes, and everything
    lies contiguous on q's device."""
    T, H, D = q.shape
    k_pool, v_pool = pools[:2]
    nb, Hp, bs, Dp = k_pool.shape
    S, W = ints[0].shape
    if (Hp, Dp) != (H, D) or tuple(v_pool.shape) != tuple(k_pool.shape):
        raise ValueError(f"{what}: pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q heads {H} "
                         f"x dim {D}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != pool_dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}, expected "
                             f"{pool_dtype}")
    named = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool)]
    if len(pools) == 4:
        for name, t in (("k_scales", pools[2]), ("v_scales", pools[3])):
            if t.dtype != torch.float32 or tuple(t.shape) != (
                    nb, bs, KV_SCALE_LANES):
                raise ValueError(f"{what}: {name} must be float32 "
                                 f"{(nb, bs, KV_SCALE_LANES)}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
            named.append((name, t))
    shapes = ((S, W), (S,), (nqb,), (nqb,), (nqb,))
    for name, t, shape in zip(("block_tables", "context_lens", "seq_ids",
                               "q_starts", "q_valids"), ints, shapes):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must be int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        named.append((name, t))
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return S, H, D, bs, W


def ragged_paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                           seq_ids, q_starts, q_valids, block_q=None,
                           scale=None, k_scales=None, v_scales=None):
    """Mixed prefill + decode attention over the paged pool (see the
    module doc).  Returns ``[T, H, D]`` in ``q``'s type.  int8 pools
    need ``k_scales``/``v_scales`` and go to
    `ragged_paged_attention_int8`."""
    ints = (block_tables, context_lens, seq_ids, q_starts, q_valids)
    if k_pool.dtype == torch.int8:
        return ragged_paged_attention_int8(q, k_pool, v_pool, k_scales,
                                           v_scales, *ints, block_q=block_q,
                                           scale=scale)
    block_q, nqb, scale = _geometry(q, seq_ids, block_q, scale)
    if q.device.type == "cpu":
        return ragged_attention_ref(q, k_pool, v_pool, *ints, block_q,
                                    scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"ragged attention: no kernel for device {q.device}")
    code = cuda_lib.dtype_code(q.dtype)
    S, H, D, bs, W = _check_inputs("ragged attention", q, (k_pool, v_pool),
                                   ints, nqb, q.dtype)
    out = torch.empty_like(q)
    if nqb and H:
        rc = cuda_lib.library().ptt_ragged_attention_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            *(t.data_ptr() for t in ints), out.data_ptr(), nqb, S, H, D, bs,
            W, block_q, float(scale), code, q.device.index,
            cuda_lib.stream_handle(q.device))
        cuda_lib.check(rc, "ragged_attention")
        _count(ragged_paged_attention,
               mma_route(q, k_pool, v_pool, out, block_q), q.dtype)
    return out


def ragged_paged_attention_int8(q, k_pool, v_pool, k_scales, v_scales,
                                block_tables, context_lens, seq_ids,
                                q_starts, q_valids, block_q=None,
                                scale=None):
    """`ragged_paged_attention` over int8 pools with their per-slot f32
    scales ``[num_blocks, block_size, 1]``: the int8 kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if k_scales is None or v_scales is None:
        raise ValueError("int8 KV pools need k_scales/v_scales tables")
    ints = (block_tables, context_lens, seq_ids, q_starts, q_valids)
    block_q, nqb, scale = _geometry(q, seq_ids, block_q, scale)
    if q.device.type == "cpu":
        return ragged_attention_ref(q, k_pool, v_pool, *ints, block_q,
                                    scale, k_scales, v_scales)
    if q.device.type != "cuda":
        raise RuntimeError(f"int8 ragged attention: no kernel for device "
                           f"{q.device}")
    code = cuda_lib.dtype_code(q.dtype)
    S, H, D, bs, W = _check_inputs(
        "int8 ragged attention", q, (k_pool, v_pool, k_scales, v_scales),
        ints, nqb, torch.int8)
    out = torch.empty_like(q)
    if nqb and H:
        rc = cuda_lib.library().ptt_ragged_attention_int8_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(),
            *(t.data_ptr() for t in ints), out.data_ptr(), nqb, S, H, D, bs,
            W, block_q, float(scale), code, q.device.index,
            cuda_lib.stream_handle(q.device))
        cuda_lib.check(rc, "ragged_attention_int8")
        _count(ragged_paged_attention_int8,
               mma_route(q, k_pool, v_pool, out, block_q, k_scales,
                         v_scales), q.dtype)
    return out


#: kernel launches since the last reset (chip_smoke.py reads them), and
#: the same by route
ragged_paged_attention.launches = 0
ragged_paged_attention.mma_launches = 0
ragged_paged_attention.f32_launches = 0
ragged_paged_attention.f16_launches = 0
ragged_paged_attention.elementwise_launches = 0
ragged_paged_attention_int8.launches = 0
ragged_paged_attention_int8.mma_launches = 0
ragged_paged_attention_int8.f32_launches = 0
ragged_paged_attention_int8.f16_launches = 0
ragged_paged_attention_int8.elementwise_launches = 0
