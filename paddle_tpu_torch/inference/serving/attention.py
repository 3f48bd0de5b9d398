"""The paged cache as the model sees it: K/V scatter, then attention.

Port of ``paddle_tpu/inference/serving/attention.py``: ``RaggedCacheView``,
``RaggedLayerCache``, ``PagedCacheView``, ``PagedLayerCache``,
``kv_cache_scatter``, ``kv_cache_scatter_quant`` (with
``_quantize_tokens``), ``ragged_attention`` and ``paged_attention``.  A
view holds one step's driving tensors (slot mapping, block tables,
context lengths, positions, and for the ragged step the segment
descriptors), all on the pool's device; ``models/gpt.py`` finds it by its
``attend`` and ``position_ids`` attributes.  Each layer scatters its
fresh K/V into the pool in place, then attends.

* The ragged view (the engine's unified step) runs ragged paged
  attention over every segment, so prefill chunks and decode rows share
  one kernel launch.  Its driving tensors are persistent buffers that
  `RaggedCacheView.set_inputs` writes in place (``copy_``), so a CUDA
  graph of the step (``jit.to_static``) reads each step's values at the
  addresses it captured; the reference swaps read-only state instead
  (``paddle_tpu/inference/serving/attention.py:416-436``).  An int8 pool quantizes each token as it is
  scattered and hands its per-slot scale tables to the int8 attention
  kernel.  With multi-LoRA on, the view carries the per-q-block adapter
  state (``lora``) that the model's projections read.
* The paged view has two modes: ``"prefill"`` attends densely and
  causally over the call's own K/V; ``"decode"`` runs the paged decode
  attention kernel, one query row per sequence over its block table.
"""
from __future__ import annotations

import torch

from ...ops.paged import paged_attention as _paged_attention
from ...ops.ragged import ragged_paged_attention

__all__ = ["kv_cache_scatter", "kv_cache_scatter_quant", "ragged_attention",
           "paged_attention", "RaggedCacheView", "RaggedLayerCache",
           "PagedCacheView", "PagedLayerCache"]


def kv_cache_scatter(k_pool, v_pool, k_new, v_new, blk, off):
    """Write this step's K/V ``[..., H, D]`` (one row per token) into the
    pools ``[nb, H, bs, D]`` at block ``blk`` / offset ``off`` (int64
    ``[tokens]``), in place.  Pad tokens all go to slot 0, the pad block:
    their racing writes are harmless because block 0 is never read
    unmasked.  The reference's functional ``.at[].set`` was never a
    Pallas kernel; this is PyTorch's indexed write."""
    H, D = k_pool.shape[1], k_pool.shape[3]
    k_pool[blk, :, off] = k_new.reshape(-1, H, D).to(k_pool.dtype)
    v_pool[blk, :, off] = v_new.reshape(-1, H, D).to(v_pool.dtype)


def _quantize_tokens(flat, lanes):
    """Per-token symmetric int8 quantization of ``flat`` ``[T, H, D]``:
    one abs-max over each token's ``(H, D)``, scale ``amax / 127`` (1.0
    where the abs-max is 0), codes rounded half to even and clamped to
    ±127.  Returns (int8 ``[T, H, D]``, f32 scales ``[T, lanes]``)."""
    f = flat.float()
    amax = f.abs().amax(dim=(1, 2))                  # [T]
    scale = torch.where(amax > 0.0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(f / scale[:, None, None]), -127.0, 127.0)
    return q.to(torch.int8), scale[:, None].expand(scale.shape[0], lanes)


def kv_cache_scatter_quant(k_pool, v_pool, k_scales, v_scales, k_new,
                           v_new, blk, off):
    """`kv_cache_scatter` for int8 pools: quantize each new token on its
    own (`_quantize_tokens`) and write its codes into the pools and its
    dequant scale into the per-slot tables ``[nb, bs, lanes]``, in place.
    A block filling up over many steps never re-scales a written slot.
    K and V are quantized in one pass (each token keeps its own scale)."""
    H, D = k_pool.shape[1], k_pool.shape[3]
    kv = torch.stack((k_new.reshape(-1, H, D), v_new.reshape(-1, H, D)))
    q, sc = _quantize_tokens(kv.reshape(-1, H, D), k_scales.shape[-1])
    n = kv.shape[1]
    k_pool[blk, :, off] = q[:n]
    v_pool[blk, :, off] = q[n:]
    k_scales[blk, off] = sc[:n]
    v_scales[blk, off] = sc[n:]


def ragged_attention(q, k_pool, v_pool, block_tables, context_lens,
                     seq_ids, q_starts, q_valids, block_q, scale=None,
                     k_scales=None, v_scales=None):
    """Mixed prefill + decode attention for q ``[1, T, H, D]`` (int8
    pools with their scale tables)."""
    out = ragged_paged_attention(q[0].contiguous(), k_pool, v_pool,
                                 block_tables, context_lens, seq_ids,
                                 q_starts, q_valids, block_q=block_q,
                                 scale=scale, k_scales=k_scales,
                                 v_scales=v_scales)
    return out[None]


def paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                    scale=None):
    """Decode attention for q ``[B, 1, H, D]`` over paged K/V (the paged
    decode kernel; the plain version on CPU tensors)."""
    return _paged_attention(q.contiguous(), k_pool, v_pool, block_tables,
                            context_lens, scale=scale)


def _slots(slot_mapping, block_size):
    """(block, offset) of each flat pool slot, int64."""
    slots = slot_mapping.long()
    return torch.div(slots, block_size, rounding_mode="floor"), \
        slots % block_size


class PagedLayerCache:
    """One layer's view of a paged step: what GPTAttention receives as
    ``cache``."""

    __slots__ = ("_view", "_layer")

    def __init__(self, view, layer):
        self._view = view
        self._layer = layer

    def attend(self, q, k, v, use_flash=True):
        """Scatter this step's K/V ``[b, s, H, D]`` into the pool, then
        attend: in ``"prefill"`` mode densely and causally over the call's
        own K/V (through ``F.scaled_dot_product_attention`` under
        ``sdp_kernel(enable_flash=use_flash)``; padded tail rows are never
        read), in ``"decode"`` mode through the paged decode kernel."""
        view = self._view
        k_pool, v_pool = view.cache.layer_pools(self._layer)
        kv_cache_scatter(k_pool, v_pool, k, v, view.slot_block,
                         view.slot_offset)
        if view.mode == "prefill":
            from ...nn import functional as F
            with F.sdp_kernel(enable_flash=use_flash):
                return F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True)
        return paged_attention(q, k_pool, v_pool, view.block_tables,
                               view.context_lens)


class PagedCacheView:
    """Adapts a float PagedKVCache to the model for a prefill or a decode
    step (``mode``).  `set_inputs` stages one step's driving tensors;
    every layer of the forward pass reads them."""

    def __init__(self, cache, mode):
        if mode not in ("prefill", "decode"):
            raise ValueError(f"mode must be prefill|decode, got {mode!r}")
        if cache.quantized:
            raise NotImplementedError(
                "an int8 pool under the paged view is not ported yet (the "
                "reference's view has no scale tables either)")
        self.cache = cache
        self.mode = mode
        self.slot_block = None     # [tokens] int64 pool block of each token
        self.slot_offset = None    # [tokens] int64 offset in that block
        self.block_tables = None   # [b, W] int32
        self.context_lens = None   # [b] int32
        self.position_ids = None   # [b, s] int64 absolute positions
        self._layers = [PagedLayerCache(self, i)
                        for i in range(cache.num_layers)]

    def __getitem__(self, layer):
        return self._layers[layer]

    def __len__(self):
        return len(self._layers)

    def set_inputs(self, slot_mapping, block_tables, context_lens,
                   position_ids):
        """Stage this step's driving values (tensors or host arrays), on
        the pool's device."""
        dev = self.cache.device

        def put(v, dtype):
            return torch.as_tensor(v).to(dev, dtype)
        self.slot_block, self.slot_offset = _slots(
            put(slot_mapping, torch.int64).reshape(-1),
            self.cache.block_size)
        self.block_tables = put(block_tables, torch.int32).contiguous()
        self.context_lens = put(context_lens, torch.int32).contiguous()
        self.position_ids = put(position_ids, torch.int64)


class RaggedLayerCache:
    """One layer's view of the ragged step: what GPTAttention receives
    as ``cache``."""

    __slots__ = ("_view", "_layer")

    def __init__(self, view, layer):
        self._view = view
        self._layer = layer

    @property
    def lora(self):
        """The multi-LoRA segment state (``serving.lora``), or None."""
        return self._view.lora

    def attend(self, q, k, v, use_flash=True):
        """Scatter this step's K/V into the pool, then attend.  q/k/v:
        ``[1, T, H, D]``; returns ``[1, T, H, D]``.  An int8 pool
        quantizes per token at scatter time and passes its per-slot scale
        tables to the attention.  ``use_flash`` is taken, as the
        reference's signature has it, and does not apply: the ragged
        kernel attends every row."""
        view = self._view
        k_pool, v_pool = view.cache.layer_pools(self._layer)
        scales = view.cache.layer_scales(self._layer)
        if scales is not None:
            kv_cache_scatter_quant(k_pool, v_pool, *scales, k, v,
                                   view.slot_block, view.slot_offset)
        else:
            kv_cache_scatter(k_pool, v_pool, k, v, view.slot_block,
                             view.slot_offset)
            scales = (None, None)
        return ragged_attention(q, k_pool, v_pool, view.block_tables,
                                view.context_lens, view.seq_ids,
                                view.q_starts, view.q_valids,
                                view.block_q, k_scales=scales[0],
                                v_scales=scales[1])


class RaggedCacheView:
    """Adapts a PagedKVCache to the model for the unified ragged step.

    `set_inputs` stages one step's driving tensors into persistent
    buffers on the pool's device; every layer of the forward pass reads
    them.  A buffer is made at the first call (or when a shape changes)
    and written in place after, so the engine's fixed-shape steps always
    read the same addresses.
    """

    def __init__(self, cache, block_q):
        self.cache = cache
        self.block_q = int(block_q)
        self.slot_block = None     # [T] int64 pool block of each token
        self.slot_offset = None    # [T] int64 offset inside that block
        self.block_tables = None   # [S, W] int32
        self.context_lens = None   # [S] int32
        self.position_ids = None   # [1, T] absolute positions
        self.seq_ids = None        # [T // block_q] int32 (S = null)
        self.q_starts = None       # [T // block_q] int32
        self.q_valids = None       # [T // block_q] int32
        self.last_index = None     # [S] int64 flat row each sequence samples
        self.sample_pos = None     # [S] int64 position of that sample
        self.lora = None           # SegmentAdapterState with multi-LoRA on
        self._layers = [RaggedLayerCache(self, i)
                        for i in range(cache.num_layers)]

    def set_lora(self, state):
        """Attach the multi-LoRA segment state (``serving.lora``); model
        layers reach it through their layer cache as ``cache.lora``."""
        self.lora = state

    def __getitem__(self, layer):
        return self._layers[layer]

    def _stage(self, name, value, dtype):
        """Write ``value`` into the persistent buffer ``name`` (made, or
        made anew, when missing or of another shape)."""
        value = torch.as_tensor(value)
        buf = getattr(self, name)
        if buf is None or buf.shape != value.shape:
            buf = torch.empty(value.shape, dtype=dtype,
                              device=self.cache.device)
            setattr(self, name, buf)
        buf.copy_(value, non_blocking=True)

    def set_inputs(self, slot_mapping, block_tables, context_lens,
                   position_ids, seq_ids, q_starts, q_valids,
                   last_index=None, sample_pos=None):
        """Stage this step's driving values (tensors or host arrays) into
        the view's buffers, in place.  ``last_index`` and ``sample_pos``
        (each sequence's sampled flat row and its position) are the
        engine's sampler inputs."""
        block, offset = _slots(torch.as_tensor(slot_mapping),
                               self.cache.block_size)
        self._stage("slot_block", block, torch.int64)
        self._stage("slot_offset", offset, torch.int64)
        self._stage("block_tables", block_tables, torch.int32)
        self._stage("context_lens", context_lens, torch.int32)
        self._stage("position_ids", position_ids, torch.int64)
        self._stage("seq_ids", seq_ids, torch.int32)
        self._stage("q_starts", q_starts, torch.int32)
        self._stage("q_valids", q_valids, torch.int32)
        if last_index is not None:
            self._stage("last_index", last_index, torch.int64)
        if sample_pos is not None:
            self._stage("sample_pos", sample_pos, torch.int64)
