"""Multi-LoRA tenancy: the paged adapter store and the serving plumbing.

Port of ``paddle_tpu/inference/serving/lora.py``.  One base model serves
many tenants, each with its own LoRA fine-tune, through the same unified
ragged step:

* `convert_to_lora` / `merge_lora` / `unmerge_lora`: a converted
  ``nn.Linear`` gets trainable ``lora_A`` ``[in, r]`` and ``lora_B``
  ``[r, out]`` (the base weight and bias frozen) and adds their delta
  through the segmented SGMV epilogue (``ops.lora``), whose backward
  trains the adapter through the kernels serving runs.
  `lora_state_dict` extracts the per-site form that
  `LoRAAdapterStore.register_adapter` takes.
* `LoRAAdapterStore`: every registered adapter's packed, scale-folded
  factors in a host tier, and ``num_slots`` device slots per site
  (``A_stack [num_slots, k, r_pad]``, ``B_stack [num_slots, r_pad, n]``),
  rewritten in place when an adapter is promoted.  ``acquire`` pins,
  ``release`` unpins; a miss evicts the least recently used slot whose
  refcount is 0.
* `SegmentAdapterState`: what the ragged cache view carries, the
  per-q-block slot ids the engine stages each step (``store.null_slot``
  for rows without an adapter, whose outputs stay the base model's).

``PADDLE_TPU_LORA_STORE_BUDGET`` (bytes, or the "64M"/"1G" form) sizes
``num_slots`` when it is not given.  The reference's memory-guard
resident and its observability counters and gauges are not ported: the
store reports its bytes through ``device_bytes``/``host_bytes`` and
``stats()`` and registers with nothing.
"""
from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from ...core import resolve_device, to_torch_dtype
from ...ops.lora import lora_rank_pad

__all__ = ["ENV_LORA_STORE_BUDGET", "DEFAULT_LORA_TARGETS",
           "lora_store_budget", "AdapterStoreFull", "attach_lora_sites",
           "convert_to_lora", "merge_lora", "unmerge_lora",
           "lora_state_dict", "load_lora_state_dict", "LoRAAdapterStore",
           "SegmentAdapterState"]

ENV_LORA_STORE_BUDGET = "PADDLE_TPU_LORA_STORE_BUDGET"

#: the linears of a GPT-family block: attention qkv and out, both MLP
#: projections
DEFAULT_LORA_TARGETS = ("qkv_proj", "out_proj", "fc1", "fc2")


def _parse_bytes(v):
    """Bytes from ``"123"``, ``"64M"``, ``"1.5G"`` (K/M/G/T are powers of
    1024); None when empty or malformed (``serving/tiering.py:62``)."""
    s = str(v).strip()
    if not s:
        return None
    mult = 1
    suffix = s[-1].upper()
    if suffix in ("K", "M", "G", "T"):
        mult = 1024 ** ("KMGT".index(suffix) + 1)
        s = s[:-1]
    try:
        return int(float(s) * mult)
    except ValueError:
        return None


def lora_store_budget():
    """Device bytes for the adapter slots (PADDLE_TPU_LORA_STORE_BUDGET;
    None when unset)."""
    return _parse_bytes(os.environ.get(ENV_LORA_STORE_BUDGET, ""))


class AdapterStoreFull(RuntimeError):
    """Every device slot is pinned by an in-flight request: the batch
    holds more distinct adapters than the store has slots."""


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported yet")


# -- site discovery -------------------------------------------------------

def attach_lora_sites(model, targets=None):
    """Mark every target ``nn.Linear`` under ``model`` with its structured
    name as ``lora_site`` and return ``[(site, in_features,
    out_features)]`` in walk order.  Idempotent; int8-converted layers
    (no float ``weight``) are skipped."""
    from ...nn.layers import Linear
    targets = tuple(targets or DEFAULT_LORA_TARGETS)
    sites = []
    for name, layer in model.named_modules():
        if not isinstance(layer, Linear) \
                or name.rsplit(".", 1)[-1] not in targets \
                or "weight" not in layer._parameters:
            continue
        layer.lora_site = name
        k, n = (int(s) for s in layer.weight.shape)
        sites.append((name, k, n))
    return sites


def _generator(model, device):
    """The model's own generator (its dropout layers hold it), else a
    fresh one seeded 0 on ``device``."""
    gen = getattr(model, "generator", None)
    if isinstance(gen, torch.Generator):
        return gen
    for layer in model.modules():
        gen = getattr(layer, "generator", None)
        if isinstance(gen, torch.Generator):
            return gen
    return torch.Generator(device=device).manual_seed(0)


# -- the checkpoint retarget path ----------------------------------------

def convert_to_lora(model, rank=8, alpha=None, targets=None):
    """Convert every target ``nn.Linear`` under ``model`` to LoRA
    fine-tuning, in place: freeze its ``weight`` and ``bias`` and add
    trainable ``lora_A`` ``[in, r]`` (N(0, 0.02) from the model's
    generator) and ``lora_B`` ``[r, out]`` (zeros: the delta starts at
    exactly 0).  Returns the converted ``[(site, k, n)]``."""
    alpha = float(alpha if alpha is not None else rank)
    sites = attach_lora_sites(model, targets=targets)
    layers = dict(model.named_modules())
    for site, k, n in sites:
        layer = layers[site]
        if getattr(layer, "lora_A", None) is not None:
            continue  # already converted
        w = layer.weight
        a = torch.empty(k, int(rank), dtype=w.dtype, device=w.device)
        a.normal_(0.0, 0.02, generator=_generator(model, w.device))
        layer.lora_A = torch.nn.Parameter(a)
        layer.lora_B = torch.nn.Parameter(torch.zeros(
            int(rank), n, dtype=w.dtype, device=w.device))
        for name, p in (("lora_A", layer.lora_A), ("lora_B", layer.lora_B)):
            p.param_name = f"{site}.{name}"
        w.requires_grad_(False)
        if layer.bias is not None:
            layer.bias.requires_grad_(False)
        layer.lora_rank = int(rank)
        layer.lora_alpha = alpha
        layer.lora_scaling = alpha / float(rank)
        layer.lora_merged = False
    return sites


def _lora_layers(model):
    for name, layer in model.named_modules():
        if getattr(layer, "lora_A", None) is not None:
            yield name, layer


def _delta(layer):
    """``A @ B * (alpha / r)`` in f32, cast to the weight's type: merge
    and unmerge compute it the same way."""
    a = layer.lora_A.detach().float()
    b = layer.lora_B.detach().float()
    return (a @ b * layer.lora_scaling).to(layer.weight.dtype)


def merge_lora(model):
    """Fold every adapter's delta into its base weight (one adapter served
    densely); the layer's LoRA branch then stops.  Idempotent."""
    with torch.no_grad():
        for _, layer in _lora_layers(model):
            if not layer.lora_merged:
                layer.weight.add_(_delta(layer))
                layer.lora_merged = True
    return model


def unmerge_lora(model):
    """Subtract the folded delta back out, restoring the live LoRA branch.
    Idempotent."""
    with torch.no_grad():
        for _, layer in _lora_layers(model):
            if layer.lora_merged:
                layer.weight.sub_(_delta(layer))
                layer.lora_merged = False
    return model


def lora_state_dict(model):
    """The adapter alone: ``{site: {"A", "B", "rank", "alpha"}}`` with f32
    numpy arrays, the form `LoRAAdapterStore.register_adapter` takes."""
    return {name: {"A": layer.lora_A.detach().float().cpu().numpy(),
                   "B": layer.lora_B.detach().float().cpu().numpy(),
                   "rank": int(layer.lora_rank),
                   "alpha": float(layer.lora_alpha)}
            for name, layer in _lora_layers(model)}


def load_lora_state_dict(model, state):
    """Load an adapter into a converted model in place (same sites, new
    values)."""
    with torch.no_grad():
        for name, layer in _lora_layers(model):
            entry = state.get(name)
            if entry is None:
                continue
            for p, key in ((layer.lora_A, "A"), (layer.lora_B, "B")):
                p.copy_(torch.as_tensor(np.asarray(entry[key])).to(p.dtype))
    return model


# -- the paged adapter store ---------------------------------------------

class LoRAAdapterStore:
    """Device slots for packed per-site A/B adapter stacks.

    Per site ``(k, n)``: ``A_stack [num_slots, k, r_pad]`` and ``B_stack
    [num_slots, r_pad, n]``, ``r_pad`` the store rank rounded up to the
    dtype's row multiple.  ``alpha / r`` is folded into the packed B at
    registration.  Slot id ``num_slots`` (`null_slot`) is the epilogue's
    null adapter and holds no storage.  The host tier keeps every
    registered adapter's packed factors, so an evicted adapter is
    promoted back bit for bit.

    The reference registers the store with its memory guard
    (``register``, ``resident_name``) and publishes counters and gauges;
    neither is ported: the store's bytes are ``device_bytes`` and
    ``host_bytes``, its counters `stats`."""

    def __init__(self, sites, rank, dtype=torch.float32, alpha=None,
                 num_slots=None, budget=None, register=False,
                 resident_name=None, device=None):
        if register or resident_name is not None:
            raise _not_ported("the memory guard's adapter-store resident")
        if not sites:
            raise ValueError("no LoRA sites (attach_lora_sites found no "
                             "target linears)")
        self.device = resolve_device(device)
        self._site_order = [str(name) for name, _, _ in sites]
        self.sites = {str(name): (int(k), int(n)) for name, k, n in sites}
        self.rank = int(rank)
        self.alpha = float(alpha if alpha is not None else rank)
        self.scaling = self.alpha / float(self.rank)
        self.dtype = to_torch_dtype(dtype)
        self.r_pad = lora_rank_pad(self.rank, self.dtype)
        per_slot = sum(k * self.r_pad + self.r_pad * n
                       for k, n in self.sites.values())
        self.bytes_per_slot = per_slot * self.dtype.itemsize
        if num_slots is None:
            if budget is None:
                budget = lora_store_budget()
            num_slots = (max(1, int(budget) // self.bytes_per_slot)
                         if budget else 8)
        self.num_slots = int(num_slots)
        self._stacks = {
            name: (torch.zeros(self.num_slots, k, self.r_pad,
                               dtype=self.dtype, device=self.device),
                   torch.zeros(self.num_slots, self.r_pad, n,
                               dtype=self.dtype, device=self.device))
            for name, (k, n) in self.sites.items()}
        self._host = {}              # name -> {site: (A, B)} on the CPU
        self._slot_names = [None] * self.num_slots
        self._refs = [0] * self.num_slots
        self._resident = {}          # name -> slot
        self._lru = OrderedDict()    # refcount-0 residents, LRU first
        self._hits = self._misses = self._spills = 0

    @property
    def device_bytes(self):
        return self.num_slots * self.bytes_per_slot

    @property
    def host_bytes(self):
        return len(self._host) * self.bytes_per_slot

    def close(self):
        """Nothing to release: the store registers with no guard."""

    # -- registration (the host tier) ------------------------------------
    def _pack(self, site, a, b, scaling):
        """Pad ``[k, r]`` / ``[r, n]`` to the store rank and fold the scale
        into B (an f32 multiply, then one cast)."""
        k, n = self.sites[site]
        a = torch.as_tensor(np.asarray(a))
        b = torch.as_tensor(np.asarray(b))
        r = a.shape[1]
        if tuple(a.shape) != (k, r) or tuple(b.shape) != (r, n):
            raise ValueError(
                f"adapter weights for site {site!r} have shapes "
                f"{tuple(a.shape)}/{tuple(b.shape)}; expected ({k}, r)/"
                f"(r, {n})")
        if r > self.r_pad:
            raise ValueError(f"adapter rank {r} exceeds the store's packed "
                             f"rank {self.r_pad} (store rank {self.rank})")
        ap = torch.zeros(k, self.r_pad, dtype=self.dtype)
        bp = torch.zeros(self.r_pad, n, dtype=self.dtype)
        ap[:, :r] = a.to(self.dtype)
        bp[:r] = (b.float() * float(scaling)).to(self.dtype)
        return ap, bp

    def register_adapter(self, name, weights, alpha=None, rank=None):
        """Put one adapter's packed factors in the host tier.  ``weights``
        is `lora_state_dict` output or ``{site: (A, B)}``; a site the
        adapter does not name packs as zeros.  The device is not touched
        until the first `acquire`."""
        name = str(name)
        if name in self._host:
            raise KeyError(f"adapter {name!r} already registered")
        packed = {}
        for site in self._site_order:
            entry = weights.get(site)
            if entry is None:
                k, n = self.sites[site]
                packed[site] = (torch.zeros(k, self.r_pad, dtype=self.dtype),
                                torch.zeros(self.r_pad, n, dtype=self.dtype))
                continue
            if isinstance(entry, dict):
                a, b = entry["A"], entry["B"]
                sc = float(entry.get("alpha", self.alpha)) \
                    / float(entry.get("rank", self.rank))
            else:
                a, b = entry
                sc = (float(alpha) / float(rank or self.rank)
                      if alpha is not None else self.scaling)
            packed[site] = self._pack(site, a, b, sc)
        self._host[name] = packed
        return name

    def drop_adapter(self, name):
        """Forget an adapter in both tiers; refuses while an in-flight
        request pins it."""
        slot = self._resident.get(name)
        if slot is not None:
            if self._refs[slot]:
                raise RuntimeError(
                    f"adapter {name!r} is pinned by {self._refs[slot]} "
                    "in-flight request(s)")
            self._evict(name)
        del self._host[name]

    def has_adapter(self, name):
        return name in self._host

    def adapters(self):
        return list(self._host)

    # -- residency -------------------------------------------------------
    @property
    def null_slot(self):
        """The block id of rows without an adapter (``num_slots``)."""
        return self.num_slots

    def pair(self, site):
        """``(A_stack, B_stack)`` of one site."""
        return self._stacks[site]

    def slot_of(self, name):
        """Device slot of a resident adapter (KeyError otherwise)."""
        return self._resident[name]

    def acquire(self, name):
        """Pin ``name`` in a device slot, promoting it if needed, and return
        the slot.  Raises `AdapterStoreFull` when every slot is pinned."""
        if name not in self._host:
            raise KeyError(f"adapter {name!r} is not registered")
        slot = self._resident.get(name)
        if slot is not None:
            self._hits += 1
            self._lru.pop(name, None)
            self._refs[slot] += 1
            return slot
        self._misses += 1
        slot = self._promote(name)
        self._refs[slot] = 1
        return slot

    def release(self, name):
        """Unpin one reference; at refcount 0 the slot keeps its factors
        and parks as evictable, so a re-acquire is a hit."""
        slot = self._resident.get(name)
        if slot is None:
            return
        self._refs[slot] = max(0, self._refs[slot] - 1)
        if self._refs[slot] == 0:
            self._lru[name] = None
            self._lru.move_to_end(name)

    def _free_slot(self):
        for s, owner in enumerate(self._slot_names):
            if owner is None:
                return s
        if not self._lru:
            raise AdapterStoreFull(
                f"all {self.num_slots} adapter slots are pinned by "
                "in-flight requests")
        victim, _ = self._lru.popitem(last=False)
        self._spills += 1
        return self._evict(victim)

    def _evict(self, name):
        slot = self._resident.pop(name)
        self._slot_names[slot] = None
        self._refs[slot] = 0
        self._lru.pop(name, None)
        return slot

    def _promote(self, name):
        slot = self._free_slot()
        packed = self._host[name]
        for site in self._site_order:
            a_t, b_t = self._stacks[site]
            a_np, b_np = packed[site]
            a_t[slot].copy_(a_np)
            b_t[slot].copy_(b_np)
        self._slot_names[slot] = name
        self._resident[name] = slot
        return slot

    def stats(self):
        looked = self._hits + self._misses
        return {"hits": self._hits, "misses": self._misses,
                "spills": self._spills,
                "hit_rate": self._hits / looked if looked else 0.0,
                "resident": len(self._resident),
                "registered": len(self._host),
                "num_slots": self.num_slots,
                "device_bytes": self.device_bytes,
                "host_bytes": self.host_bytes}

    def __repr__(self):
        return (f"LoRAAdapterStore(slots={len(self._resident)}/"
                f"{self.num_slots}, registered={len(self._host)}, "
                f"rank={self.rank}, sites={len(self.sites)})")


# -- the view-side handle -------------------------------------------------

class SegmentAdapterState:
    """The multi-LoRA state the ragged cache view carries: the store and
    this step's per-q-block slot ids.  Model layers reach it as
    ``cache.lora`` and call `apply` after each base projection."""

    def __init__(self, store, block_q):
        self.store = store
        self.block_q = int(block_q)
        self.block_adapter = None   # [NQB] int32 slot ids on the device

    def stage(self, slots):
        """This step's slot ids (an int tensor or host array), written in
        place into the persistent int32 buffer on the store's device (made
        at the first call, or anew when the width changes), so a CUDA
        graph of the step reads each step's ids."""
        slots = torch.as_tensor(slots)
        if self.block_adapter is None \
                or self.block_adapter.shape != slots.shape:
            self.block_adapter = torch.empty(
                slots.shape, dtype=torch.int32, device=self.store.device)
        self.block_adapter.copy_(slots, non_blocking=True)

    def active(self, layer):
        site = getattr(layer, "lora_site", None)
        return site is not None and site in self.store.sites

    def apply(self, z, x, layer, act="none"):
        """``act(z + (x @ A[slot]) @ B[slot])`` per q-block through the
        segmented epilogue, ``z = layer(x)`` the pre-activation.  A layer
        without a site passes ``z`` through (``act`` must then be
        "none")."""
        if not self.active(layer):
            if act != "none":
                raise ValueError(f"layer has no adapter site but act={act!r} "
                                 "was deferred to the epilogue")
            return z
        from ...nn import functional as F
        a_t, b_t = self.store.pair(layer.lora_site)
        return F.lora_segment_act(z, x, a_t, b_t,
                                  block_adapter=self.block_adapter, act=act)
