"""Paged KV cache: block pool + block tables + copy-on-write prefix cache.

Port of ``paddle_tpu/inference/serving/kv_cache.py`` ``PagedKVCache``.
K/V live in a pool of fixed-size blocks per layer,

    k_pool[layer], v_pool[layer]: [num_blocks, num_heads, block_size, head_dim]

and each sequence owns an ordered list of block ids (its *block table*);
token ``i`` lives at flat slot ``table[i // bs] * bs + i % bs``.  Block 0
is the pad block: padded rows scatter there and padded table entries
point at it, and attention masks it out through the context lengths.

**Copy-on-write prefix caching** (``PADDLE_TPU_PREFIX_CACHE``, default
on): every full block of a prompt gets a chain hash ``h_i = hash((h_{i-1},
block_tokens))``; ``allocate(..., tokens=)`` shares every leading hit
block (refcount + 1) instead of recomputing it, capped so one token is
still computed.  Freed blocks whose content is indexed park in an LRU
(refcount 0, children before parents) and are evicted only when the free
list runs dry, so prefix credit survives preemption.  A write into a
shared block splits it (device block copy + table swap); a write into a
private indexed block de-indexes it.  ``truncate`` releases whole blocks
refcount-aware and never touches block contents.

**int8 pools** (``dtype=torch.int8``): every token is quantized on its
own at scatter time, and each layer carries per-slot f32 dequant scale
tables ``[num_blocks, block_size, KV_SCALE_LANES]`` for K and V beside
the int8 blocks.  The COW split copies the scale rows with the data, and
the byte charge per block counts the element type plus the scales, so a
fixed budget admits about twice the bf16 pool's blocks.

The host-side bookkeeping is the reference's, decision for decision, so
that the two engines' block tables match step for step.  Not ported yet:
the host-RAM tier and sequence export/import.  Sizing: ``num_blocks``
explicit, else ``hbm_fraction`` of the device memory
``torch.cuda.mem_get_info`` reports free, else (CPU) 256 blocks.
"""
from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from ...core import dtype_name, resolve_device, to_torch_dtype
from ...ops.ragged import KV_SCALE_LANES

__all__ = ["ENV_KV_BLOCK_SIZE", "ENV_PREFIX_CACHE", "kv_block_size",
           "prefix_cache_enabled", "PagedKVCache"]

ENV_KV_BLOCK_SIZE = "PADDLE_TPU_KV_BLOCK_SIZE"
ENV_PREFIX_CACHE = "PADDLE_TPU_PREFIX_CACHE"
_DEFAULT_BLOCK_SIZE = 16
_DEFAULT_NUM_BLOCKS = 256     # when no device memory is visible (CPU)
_MIN_NUM_BLOCKS = 8
_MAX_NUM_BLOCKS = 65536


def kv_block_size():
    """Tokens per KV block (PADDLE_TPU_KV_BLOCK_SIZE, default 16)."""
    try:
        v = int(os.environ.get(ENV_KV_BLOCK_SIZE, _DEFAULT_BLOCK_SIZE))
    except ValueError:
        return _DEFAULT_BLOCK_SIZE
    return max(1, v)


def prefix_cache_enabled():
    """Whether COW prefix caching is on (PADDLE_TPU_PREFIX_CACHE,
    default "1"; "0"/"false"/"off" disable)."""
    return os.environ.get(ENV_PREFIX_CACHE, "1").lower() not in (
        "0", "false", "off")


class PagedKVCache:
    """Block pool + allocator + per-sequence block tables + COW prefix
    cache.  The only device work started here is the COW block copy; the
    scatter and the attention read the pools through the arrays this
    class builds (slot mappings, block tables)."""

    def __init__(self, num_layers, num_heads, head_dim, dtype=torch.float32,
                 block_size=None, num_blocks=None, max_model_len=None,
                 hbm_fraction=0.3, prefix_cache=None, device=None):
        self.device = resolve_device(device)
        self.dtype = to_torch_dtype(dtype)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.block_size = int(block_size or kv_block_size())
        #: int8 pools carry per-slot f32 dequant scale tables
        self.quantized = self.dtype == torch.int8
        self.scale_lanes = KV_SCALE_LANES if self.quantized else 0
        # the charge follows the element type plus the scale tables
        self.bytes_per_block = (2 * self.num_layers * self.num_heads
                                * self.block_size * self.head_dim
                                * self.dtype.itemsize
                                + 2 * self.num_layers * self.block_size
                                * self.scale_lanes * 4)
        if num_blocks is None:
            num_blocks = self._blocks_from_budget(hbm_fraction)
        # +1: block 0 is the reserved pad block, never allocated
        self.num_blocks = max(_MIN_NUM_BLOCKS, int(num_blocks)) + 1
        self.max_model_len = int(max_model_len) if max_model_len else None
        cap = self.max_model_len or (self.num_blocks - 1) * self.block_size
        self.table_width = max(1, -(-cap // self.block_size))
        self.prefix_cache = (prefix_cache_enabled()
                             if prefix_cache is None else bool(prefix_cache))

        shape = (self.num_blocks, self.num_heads, self.block_size,
                 self.head_dim)
        self._pools = [(torch.zeros(shape, dtype=self.dtype,
                                    device=self.device),
                        torch.zeros(shape, dtype=self.dtype,
                                    device=self.device))
                       for _ in range(self.num_layers)]
        sshape = (self.num_blocks, self.block_size, self.scale_lanes)
        self._scales = [(torch.zeros(sshape, dtype=torch.float32,
                                     device=self.device),
                         torch.zeros(sshape, dtype=torch.float32,
                                     device=self.device))
                        for _ in range(self.num_layers)] \
            if self.quantized else []

        self._free = list(range(self.num_blocks - 1, 0, -1))  # pop() -> 1
        self._tables = {}      # seq_id -> [block ids]
        self._lengths = {}     # seq_id -> tokens stored
        self._ref = {}         # block -> refcount (blocks in any table)
        self._hash_of = {}     # block -> chain hash (full prefix blocks)
        self._by_hash = {}     # chain hash -> canonical block
        self._cached_free = OrderedDict()  # refcount-0 indexed blocks LRU
        self._cached_len = {}  # seq_id -> tokens served from the cache
        self._seq_adapter = {}  # seq_id -> LoRA adapter id (None: base)
        self._hit_tokens = 0   # prefix tokens reused, cumulative
        self._lookup_tokens = 0  # prompt tokens that consulted the index
        self.cow_splits = 0
        self.stale_hash_drops = 0
        self.high_water = 0

    # -- sizing ----------------------------------------------------------
    def _blocks_from_budget(self, fraction):
        if self.device.type != "cuda":
            return _DEFAULT_NUM_BLOCKS
        free, _ = torch.cuda.mem_get_info(self.device)
        n = int(free * float(fraction)) // self.bytes_per_block
        return max(_MIN_NUM_BLOCKS, min(_MAX_NUM_BLOCKS, n))

    @property
    def pool_bytes(self):
        return self.num_blocks * self.bytes_per_block

    def layer_pools(self, layer):
        """(k_pool, v_pool) tensors of one layer."""
        return self._pools[layer]

    def layer_scales(self, layer):
        """(k_scale, v_scale) per-slot dequant tables of one layer (int8
        pools only; None otherwise)."""
        return self._scales[layer] if self.quantized else None

    # -- allocator -------------------------------------------------------
    @property
    def free_blocks(self):
        """Virgin free blocks plus the evictable refcount-0 LRU."""
        return len(self._free) + len(self._cached_free)

    @property
    def blocks_in_use(self):
        """Physical blocks held by live sequences (shared counted once)."""
        return (self.num_blocks - 1) - self.free_blocks

    @property
    def logical_blocks(self):
        return sum(len(t) for t in self._tables.values())

    @property
    def shared_blocks(self):
        return sum(1 for c in self._ref.values() if c > 1)

    def blocks_needed(self, num_tokens):
        return -(-int(num_tokens) // self.block_size)

    def can_allocate(self, num_tokens, tokens=None, headroom=0,
                     adapter=None):
        """Admission check: prefix hits count as available (a parked hit
        is reactivated, not consumed) and ``headroom`` blocks are held
        back for the decode growth of running sequences."""
        hits = self._prefix_hits(tokens, num_tokens, adapter)
        need = self.blocks_needed(num_tokens) - len(hits)
        hits_parked = sum(1 for b in hits if b in self._cached_free)
        capacity = (len(self._free)
                    + len(self._cached_free) - hits_parked)
        return need + int(headroom) <= capacity

    def _chain_hash(self, prev, block_tokens, adapter=None):
        # the chain root carries the pool dtype and the LoRA adapter id, as
        # the reference's does: an adapter changes the K/V every layer
        # writes, so two adapters never share a prefix block
        if prev is None:
            prev = (dtype_name(self.dtype),
                    None if adapter is None else str(adapter))
        return hash((prev, tuple(int(t) for t in block_tokens)))

    def _prefix_hits(self, tokens, num_tokens, adapter=None):
        """Blocks covering the longest cached block-aligned prefix of
        ``tokens`` under ``adapter``, capped so one of ``num_tokens`` is
        still computed."""
        hits = []
        if not self.prefix_cache or tokens is None:
            return hits
        bs = self.block_size
        h = None
        max_reuse = int(num_tokens) - 1
        for b in range(min(len(tokens), int(num_tokens)) // bs):
            if (b + 1) * bs > max_reuse:
                break
            h = self._chain_hash(h, tokens[b * bs:(b + 1) * bs], adapter)
            blk = self._by_hash.get(h)
            if blk is None:
                break
            hits.append(blk)
        return hits

    def _take_block(self):
        """One writable block: a virgin free block, else the LRU's least
        recently used refcount-0 cached block (de-indexed)."""
        if self._free:
            return self._free.pop()
        blk, _ = self._cached_free.popitem(last=False)
        h = self._hash_of.pop(blk, None)
        if h is not None and self._by_hash.get(h) == blk:
            del self._by_hash[h]
        return blk

    def _activate(self, blk):
        if blk in self._cached_free:
            del self._cached_free[blk]
            self._ref[blk] = 1
        else:
            self._ref[blk] = self._ref.get(blk, 0) + 1

    def _release(self, blk):
        """Drop one table reference; an indexed block parks in the LRU
        (most recently freed last), anything else is free again."""
        c = self._ref.get(blk, 1) - 1
        if c > 0:
            self._ref[blk] = c
            return
        self._ref.pop(blk, None)
        if blk in self._hash_of:
            self._cached_free[blk] = None
            self._cached_free.move_to_end(blk)
        else:
            self._free.append(blk)

    def allocate(self, seq_id, num_tokens, tokens=None, adapter=None):
        """Reserve blocks for a sequence's first ``num_tokens`` tokens,
        sharing every leading cached block of ``tokens`` cached under the
        same ``adapter`` (remembered for the sequence's later commits).
        Raises KeyError on a duplicate id; returns False when the pool
        cannot hold it."""
        if seq_id in self._tables:
            raise KeyError(f"sequence {seq_id!r} already allocated")
        hits = self._prefix_hits(tokens, num_tokens, adapter)
        need = self.blocks_needed(num_tokens) - len(hits)
        hits_parked = sum(1 for b in hits if b in self._cached_free)
        if need > len(self._free) + (len(self._cached_free) - hits_parked):
            return False
        # activate every hit before taking fresh blocks, so an eviction
        # cannot consume a later hit of the same chain
        for blk in hits:
            self._activate(blk)
        table = list(hits)
        for _ in range(need):
            blk = self._take_block()
            self._ref[blk] = 1
            table.append(blk)
        self._tables[seq_id] = table
        self._lengths[seq_id] = int(num_tokens)
        if adapter is not None:
            self._seq_adapter[seq_id] = adapter
        cached = len(hits) * self.block_size
        self._cached_len[seq_id] = cached
        if self.prefix_cache and tokens is not None:
            self._hit_tokens += cached
            self._lookup_tokens += int(num_tokens)
        self._update_high_water()
        return True

    def cached_prefix_len(self, seq_id):
        """Prompt tokens served from the prefix cache at allocate()."""
        return self._cached_len.get(seq_id, 0)

    def commit_prefix(self, seq_id, tokens):
        """Index every full block covered by ``tokens`` (the sequence's
        written prefix).  Stored hashes are verified against recomputed
        ones: a truncated-then-regrown sequence de-indexes its stale
        entries instead of re-anchoring them."""
        if not self.prefix_cache:
            return
        bs = self.block_size
        table = self._tables[seq_id]
        adapter = self._seq_adapter.get(seq_id)
        n = min(int(len(tokens)), self._lengths[seq_id]) // bs
        h = None
        for b in range(n):
            blk = table[b]
            h = self._chain_hash(h, tokens[b * bs:(b + 1) * bs], adapter)
            stored = self._hash_of.get(blk)
            if stored is not None:
                if stored == h:
                    continue
                if self._ref.get(blk, 1) == 1:
                    del self._hash_of[blk]
                    if self._by_hash.get(stored) == blk:
                        del self._by_hash[stored]
                    self.stale_hash_drops += 1
                else:
                    # a shared block whose canonical content differs
                    # from our tokens: leave the other owners' index
                    continue
            if self._by_hash.get(h) is None:
                self._hash_of[blk] = h
                self._by_hash[h] = blk
            # duplicate content under another canonical block: leave
            # this one unindexed

    def _ensure_writable(self, seq_id, position):
        """Make the block holding ``position`` safe to scatter into: a
        shared block is split (device copy + table swap), a private
        indexed one de-indexed."""
        idx = int(position) // self.block_size
        table = self._tables[seq_id]
        if idx >= len(table):
            return
        blk = table[idx]
        if self._ref.get(blk, 1) > 1:
            new = self._take_block()
            self._copy_block(blk, new)
            table[idx] = new
            self._ref[new] = 1
            self._ref[blk] -= 1
            self.cow_splits += 1
        elif blk in self._hash_of:
            h = self._hash_of.pop(blk)
            if self._by_hash.get(h) == blk:
                del self._by_hash[h]

    def _copy_block(self, src, dst):
        """Device-side block copy across all layers (the COW split).  An
        int8 pool copies the per-slot scale rows with the data."""
        for k, v in self._pools + self._scales:
            k[dst].copy_(k[src])
            v[dst].copy_(v[src])

    def append(self, seq_id, num_tokens=1):
        """Extend a sequence by ``num_tokens`` slots.  Returns False
        (state unchanged) when a needed block is not available."""
        length = self._lengths[seq_id]
        table = self._tables[seq_id]
        need = self.blocks_needed(length + num_tokens) - len(table)
        cow = 0
        if length % self.block_size:
            idx = length // self.block_size
            if idx < len(table) and self._ref.get(table[idx], 1) > 1:
                cow = 1                      # the split takes a block
        if need + cow > self.free_blocks:
            return False
        if length % self.block_size:
            self._ensure_writable(seq_id, length)
        for _ in range(need):
            blk = self._take_block()
            self._ref[blk] = 1
            table.append(blk)
        self._lengths[seq_id] = length + int(num_tokens)
        self._update_high_water()
        return True

    def truncate(self, seq_id, length):
        """Shrink a sequence back to ``length`` tokens, releasing whole
        blocks past the new end refcount-aware (contents untouched)."""
        length = int(length)
        if length > self._lengths[seq_id]:
            raise ValueError(
                f"truncate({seq_id!r}, {length}) beyond current "
                f"length {self._lengths[seq_id]}")
        table = self._tables[seq_id]
        keep = self.blocks_needed(length)
        while len(table) > keep:
            self._release(table.pop())
        if length % self.block_size:
            # the new end cuts into an indexed private block whose tail
            # the regrow will overwrite: de-index it now
            idx = length // self.block_size
            if idx < len(table):
                blk = table[idx]
                if self._ref.get(blk, 1) == 1 and blk in self._hash_of:
                    h = self._hash_of.pop(blk)
                    if self._by_hash.get(h) == blk:
                        del self._by_hash[h]
        self._lengths[seq_id] = length

    def __contains__(self, seq_id):
        return seq_id in self._tables

    def free(self, seq_id, tokens=None):
        """Drop a sequence's references, indexing its full blocks first
        when ``tokens`` (its written tokens) is given.  Children release
        before parents so the LRU evicts the chain tip first."""
        if seq_id not in self._tables:
            return 0
        if tokens is not None:
            self.commit_prefix(seq_id, tokens)
        blocks = self._tables.pop(seq_id)
        self._lengths.pop(seq_id, None)
        self._cached_len.pop(seq_id, None)
        self._seq_adapter.pop(seq_id, None)
        for blk in reversed(blocks):
            self._release(blk)
        return len(blocks)

    def length(self, seq_id):
        return self._lengths[seq_id]

    @property
    def prefix_hit_rate(self):
        """Fraction of looked-up prompt tokens served from the cache."""
        return self._hit_tokens / max(1, self._lookup_tokens)

    # -- driving arrays --------------------------------------------------
    def slot_mapping(self, seq_id, start, count):
        """Flat pool slots of positions [start, start+count)."""
        table = self._tables[seq_id]
        pos = np.arange(int(start), int(start) + int(count))
        blocks = np.asarray(table, np.int32)[pos // self.block_size]
        return (blocks * self.block_size
                + (pos % self.block_size)).astype(np.int32)

    def block_table(self, seq_id, width=None):
        """The sequence's block table padded to ``width`` (default the
        pool's fixed table_width) with the pad block 0."""
        width = int(width or self.table_width)
        table = self._tables[seq_id]
        if len(table) > width:
            raise ValueError(
                f"sequence {seq_id!r} spans {len(table)} blocks "
                f"> table width {width}")
        out = np.zeros(width, np.int32)
        out[:len(table)] = table
        return out

    # -- accounting ------------------------------------------------------
    def _update_high_water(self):
        self.high_water = max(self.high_water, self.blocks_in_use)

    def stats(self):
        return {
            "num_blocks": self.num_blocks - 1,
            "block_size": self.block_size,
            "kv_dtype": dtype_name(self.dtype),
            "bytes_per_block": self.bytes_per_block,
            "blocks_in_use": self.blocks_in_use,
            "free_blocks": self.free_blocks,
            "logical_blocks": self.logical_blocks,
            "physical_blocks": self.blocks_in_use,
            "shared_blocks": self.shared_blocks,
            "cached_free_blocks": len(self._cached_free),
            "cow_splits": self.cow_splits,
            "prefix_hit_rate": self.prefix_hit_rate,
            "high_water": self.high_water,
            "pool_bytes": self.pool_bytes,
            "sequences": len(self._tables),
            "stale_hash_drops": self.stale_hash_drops,
        }
