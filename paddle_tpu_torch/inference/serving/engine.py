"""GenerationEngine: continuous-batching LLM serving over the paged KV cache.

Port of ``paddle_tpu/inference/serving/engine.py``.  Each `step` runs ONE
unified ragged step: at most one prefill chunk plus every decode row,
packed into a fixed ``[token_budget]`` flat buffer of block-aligned
segments (``ops/ragged.py``), through the model, then the sampler.  As in
the reference (engine.py:284), the step function ``_ragged_step(ids,
seeds, do_sample, top_k, top_p, temperature)`` runs through
``jit.to_static``: on the card its first call runs eagerly, its second is
captured into a CUDA graph and every later step replays it; on the CPU
it runs eagerly.  The step therefore has fixed shapes and no host branch:

  * every driving value of a step (token ids, slots, positions, segment
    descriptors, block tables, context lengths, the sampled rows and
    their positions, the decode feed and the sampling controls) goes to
    the device in ONE host-to-device copy, outside the step, and is
    written in place into the view's persistent buffers
    (``attention.RaggedCacheView.set_inputs``);
  * the decode feed scatters the previous step's device-side tokens into
    the ids over all ``max_batch`` rows, a row that is not fed writing to
    a null target past the buffer;
  * the sampler computes the greedy and the sampled token of every row
    and picks with ``torch.where`` (the reference's in-graph
    ``ragged_sample_next``).

``stats()["step_compiles"]`` is the number of call signatures the step
has seen (``len(_step_fn._cache)``), as the reference counts its
compiles: 1 for any mix of prefill and decode.

  * **prefix caching**: admission consults the COW prefix index
    (``kv_cache.py``), so a request sharing a cached prompt prefix starts
    prefill at its first uncached block, and each landed chunk commits
    its full blocks back to the index;
  * **sampling**: greedy argmax, or temperature -> top-k -> top-p and a
    draw.  Each draw is the reference's: ``categorical(fold_in(
    PRNGKey(seed), position), logp)`` on JAX's threefry stream, ported
    bit for bit in ``core/random.py``, so a request draws the same tokens
    under any packing, chunking or preemption, and the same tokens as the
    reference engine;
  * **no host stall**: decode inputs come from the previous step's
    device-side tokens with no host read, and results drain
    ``pipeline_depth - 1`` steps behind dispatch (default depth 2).

Only the LM-head rows a step samples from are computed: the hidden state
of each sequence's last query row is gathered before the head, which
gives the same logits for those rows as the reference's full ``[T, V]``
product.

**int8 serving**: ``weight_dtype="int8"`` (or ``PADDLE_TPU_WEIGHT_DTYPE=
int8``) converts every ``Linear`` of the model to weight-only int8
(``quantization.convert_to_int8``), and ``kv_cache_dtype="int8"`` (or
``PADDLE_TPU_KV_DTYPE=int8``) makes the paged pool int8 with per-slot
scales, under any compute dtype.  The step geometry (``block_q``)
follows the compute dtype, not the pool's.

**multi-LoRA**: ``enable_lora`` builds the paged adapter store
(``lora.py``) over the model's qkv, out, fc1 and fc2 projections,
``register_adapter`` lands adapters in its host tier, and
``add_request(adapter=)`` serves a request through its adapter: it is
pinned in a device slot at admission and released at finish or
preemption, and every step stages each q-block's slot id (the null slot
for rows without one), so rows with different adapters and base-model
rows share one step.

Not ported yet, and refused with ``NotImplementedError`` when asked for:
tenant-tagged requests (``tenant=``), speculative decoding, SLO
policies, the host KV tier (``kv_tiering``, ``kv_host_budget``), the prefill/decode roles and their handoff
(``extract_request``, ``inject_request``), streaming (``open_stream``),
the step watchdog (``step_deadline_ms``, ``clock``), load shedding
(``shed_depth``) and the memory guard's resident (``resident_name``).
Every constructor parameter and public method of the reference's engine
exists here, so a caller meets that error rather than a ``TypeError`` or
an ``AttributeError``.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ... import jit
from ...core import random, resolve_device, to_torch_dtype
from ...core.pipeline import ENV_PIPELINE_DEPTH, pipeline_depth
from ...ops.ragged import ragged_q_block
from ...quantization import convert_to_int8
from .attention import RaggedCacheView
from .kv_cache import PagedKVCache
from .lora import AdapterStoreFull
from .scheduler import (ContinuousBatchingScheduler, Request,
                        max_batch_size, prefill_chunk_size)

__all__ = ["GenerationEngine", "sample_next", "ragged_sample_next",
           "pipeline_depth", "ENV_PIPELINE_DEPTH", "ENV_KV_DTYPE",
           "ENV_WEIGHT_DTYPE"]

#: KV pool element dtype override ("int8": the quantized paged cache;
#: unset: the model's dtype)
ENV_KV_DTYPE = "PADDLE_TPU_KV_DTYPE"
#: weight dtype override ("int8": weight-only int8 Linears; unset: float)
ENV_WEIGHT_DTYPE = "PADDLE_TPU_WEIGHT_DTYPE"

#: environment knobs of the reference that select paths not ported yet
_UNPORTED_ENV = ("PADDLE_TPU_SPEC_K", "PADDLE_TPU_KV_TIERING",
                 "PADDLE_TPU_SERVE_STEP_DEADLINE_MS",
                 "PADDLE_TPU_SERVE_SHED_DEPTH")


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported yet")


# ---------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------
def _nucleus_mask(probs, top_p):
    """Keep-mask of each row's smallest prefix of descending-probability
    tokens whose mass reaches ``top_p[row]``; a token stays while the
    mass *before* it is < top_p, and rows with top_p >= 1 keep all (the
    reference's ``incubate/nn/functional.py:280``)."""
    order = torch.argsort(-probs, dim=-1, stable=True)
    sorted_p = probs.gather(-1, order)
    cum = sorted_p.cumsum(dim=-1)
    keep_sorted = (cum - sorted_p) < top_p[:, None]
    keep = torch.zeros_like(probs, dtype=torch.bool).scatter(
        -1, order, keep_sorted)
    return keep | (top_p[:, None] >= 1.0)


def ragged_sample_next(z, seeds, positions, do_sample, top_k, top_p,
                       temperature):
    """Next token for each row of ``z`` ``[B, V]`` (f32 logits), int64,
    with every control a device tensor of length B: the reference's
    in-graph ``_filter_and_draw`` (engine.py:92-127).

    Both the greedy token (the argmax) and the sampled one are computed
    for every row, and ``torch.where`` picks: rows with ``do_sample`` and
    temperature > 0 apply temperature -> top-k -> top-p, the reference's
    filter order, and draw ``argmax(logp + gumbel)`` with the key
    ``fold_in(PRNGKey(seed), position)`` of JAX's threefry.  No value is
    read on the host, so the draw can be captured."""
    greedy = z.argmax(dim=-1)
    V = z.shape[-1]
    use = do_sample & (temperature > 0)
    temp = torch.where(use, temperature, 1.0)
    p = torch.softmax(z / temp[:, None], dim=-1)
    k = top_k.clamp(0, V)
    p_desc = torch.sort(p, dim=-1, descending=True).values
    kth = p_desc.gather(-1, (k - 1).clamp(min=0)[:, None])
    p = torch.where((k > 0)[:, None] & (p < kth), 0.0, p)
    p = p / p.sum(dim=-1, keepdim=True)
    p = torch.where(_nucleus_mask(p, top_p), p, 0.0)
    logp = torch.log(torch.clamp_min(p, 1e-30))
    key = random.fold_in(random.prng_key(seeds), positions)
    sampled = random.categorical(key, logp)
    return torch.where(use, sampled, greedy)


def sample_next(z, seeds, positions, do_sample, top_k, top_p, temperature):
    """`ragged_sample_next` with the controls as host arrays of length B
    (seeds and positions int, do_sample bool, top_k int, top_p and
    temperature float)."""
    dev = z.device

    def put(v, dtype):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)
    return ragged_sample_next(
        z, put(seeds, torch.int64), put(positions, torch.int64),
        put(np.asarray(do_sample, bool), torch.bool),
        put(top_k, torch.int64), put(top_p, torch.float32),
        put(temperature, torch.float32))


# ---------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------
class GenerationEngine:
    """Multi-request generation over one GPT model.

    ``add_request()`` enqueues, ``step()`` advances the whole batch one
    unified ragged step, ``generate()`` runs prompts to completion.
    Results are full token sequences (prompt + generated, cut at EOS).
    ``device=None`` serves on the CUDA device and raises without one;
    the model must live on the engine's device.
    """

    def __init__(self, model, config=None, max_batch=None,
                 block_size=None, num_blocks=None, max_model_len=None,
                 prefill_chunk=None, hbm_fraction=0.3, prefix_cache=None,
                 speculative=None, slo=None, step_deadline_ms=None,
                 shed_depth=None, clock=None, kv_cache_dtype=None,
                 weight_dtype=None, role="colocated", kv_tiering=None,
                 kv_host_budget=None, resident_name=None, device=None):
        if speculative is not None:
            raise _not_ported("speculative decoding")
        if slo is not None:
            raise _not_ported("SLO serving")
        if kv_tiering or kv_host_budget is not None:
            raise _not_ported("the host KV tier")
        if step_deadline_ms is not None or clock is not None:
            raise _not_ported("the step watchdog")
        if shed_depth is not None:
            raise _not_ported("load shedding")
        if resident_name is not None:
            raise _not_ported("the memory guard's KV resident")
        if role != "colocated":
            raise _not_ported(f"the {role!r} engine role")
        for var in _UNPORTED_ENV:
            if os.environ.get(var):
                raise _not_ported(f"{var} (set in the environment)")
        if weight_dtype is None:
            weight_dtype = os.environ.get(ENV_WEIGHT_DTYPE) or None
        if weight_dtype is not None and str(weight_dtype) != "int8":
            raise _not_ported(f"weight_dtype={weight_dtype!r}")
        if kv_cache_dtype is None:
            kv_cache_dtype = os.environ.get(ENV_KV_DTYPE) or model.dtype
        kv_dtype = to_torch_dtype(kv_cache_dtype)
        if kv_dtype not in (model.dtype, torch.int8):
            raise _not_ported(f"a {kv_cache_dtype} KV pool under a "
                              f"{model.dtype} model")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"engine serves on {self.device}")
        if weight_dtype is not None:
            convert_to_int8(model)   # a no-op on converted layers
        cfg = config or model.config
        self.model = model
        model.eval()
        head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.max_model_len = int(min(
            max_model_len or cfg.max_position_embeddings,
            cfg.max_position_embeddings))
        self.cache = PagedKVCache(
            cfg.num_hidden_layers, cfg.num_attention_heads, head_dim,
            dtype=kv_dtype, block_size=block_size,
            num_blocks=num_blocks, max_model_len=self.max_model_len,
            hbm_fraction=hbm_fraction, prefix_cache=prefix_cache,
            device=self.device)
        self.max_batch = int(max_batch or max_batch_size())

        # unified step geometry: one prefill chunk padded to whole
        # q-blocks plus one q-block per other row; block_q follows the
        # compute dtype (never the int8 pool's), as in the reference
        self.block_q = ragged_q_block(model.dtype)
        chunk = min(int(prefill_chunk or prefill_chunk_size()),
                    self.max_model_len)
        self.prefill_chunk = max(1, chunk)
        chunk_pad = -(-self.prefill_chunk // self.block_q) * self.block_q
        self.token_budget = (chunk_pad
                             + (self.max_batch - 1) * self.block_q)
        self.num_q_blocks = self.token_budget // self.block_q

        self.scheduler = ContinuousBatchingScheduler(
            self.cache, self.max_batch, self.prefill_chunk)
        self._view = RaggedCacheView(self.cache, self.block_q)
        self._step_fn = jit.to_static(self._ragged_step)
        # multi-LoRA (lora.py): the store and the per-q-block slot ids,
        # built by enable_lora before the first step
        self._lora = None
        self._lora_held = {}      # req.id -> adapter pinned for it
        self._rows = [None] * self.max_batch
        self._last_tokens = torch.zeros(self.max_batch, dtype=torch.int64,
                                        device=self.device)
        self._pending = []        # [(rows_reqs, device_tokens)]
        self._results = {}        # req.id -> Request
        self._req_counter = 0
        self._step_idx = 0
        self._steps_dispatched = 0
        self._step_finished = []
        self._tokens_generated = 0

    # -- public API -----------------------------------------------------
    def add_request(self, prompt, max_new_tokens=16, do_sample=False,
                    top_k=0, top_p=1.0, temperature=1.0, seed=0,
                    eos_token_id=None, request_id=None, tenant=None,
                    adapter=None):
        """Enqueue one prompt; returns the request id.  ``adapter`` names
        a registered LoRA adapter (None: the base model)."""
        if tenant is not None:
            raise _not_ported("tenant-tagged (SLO) requests")
        if adapter is not None:
            if self._lora is None:
                raise RuntimeError(
                    f"adapter={adapter!r} requires enable_lora() first")
            if not self._lora.store.has_adapter(adapter):
                raise KeyError(f"adapter {adapter!r} is not registered")
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) >= self.max_model_len:
            raise ValueError(
                f"prompt length {len(prompt)} >= max_model_len "
                f"{self.max_model_len}")
        max_new_tokens = min(int(max_new_tokens),
                             self.max_model_len - len(prompt))
        if request_id is None:
            request_id = f"req{self._req_counter}"
        self._req_counter += 1
        req = Request(request_id, prompt, max_new_tokens=max_new_tokens,
                      do_sample=do_sample, top_k=top_k, top_p=top_p,
                      temperature=temperature, seed=seed,
                      eos_token_id=eos_token_id, adapter=adapter)
        self.scheduler.submit(req)
        return request_id

    def has_unfinished(self):
        return self.scheduler.has_work() or bool(self._pending)

    def enable_lora(self, rank=8, alpha=None, targets=None, num_slots=None,
                    budget=None):
        """Build the paged adapter store over the model's target linears
        and attach it to the step's view; run it before the first step.
        Without ``num_slots``, ``budget`` or
        ``PADDLE_TPU_LORA_STORE_BUDGET`` the store gets ``max_batch``
        slots, one for each row, so admission never waits for a slot.
        Returns the store."""
        from .lora import (LoRAAdapterStore, SegmentAdapterState,
                           attach_lora_sites, lora_store_budget)
        if self._lora is not None:
            return self._lora.store
        if len(self._step_fn._cache):
            raise RuntimeError(
                "enable_lora() must run before the first step: the "
                "compiled step program is already traced without the "
                "adapter epilogue")
        sites = attach_lora_sites(self.model, targets=targets)
        if num_slots is None and budget is None \
                and lora_store_budget() is None:
            num_slots = self.max_batch
        store = LoRAAdapterStore(sites, rank, dtype=self.model.dtype,
                                 alpha=alpha, num_slots=num_slots,
                                 budget=budget, device=self.device)
        self._lora = SegmentAdapterState(store, self.block_q)
        self._lora.stage(torch.full((self.num_q_blocks,), store.null_slot,
                                    dtype=torch.int32))
        self._view.set_lora(self._lora)
        return store

    def register_adapter(self, name, weights, alpha=None, rank=None):
        """Put one adapter in the store's host tier (see
        ``LoRAAdapterStore.register_adapter``); needs `enable_lora`."""
        if self._lora is None:
            raise RuntimeError("enable_lora() first")
        return self._lora.store.register_adapter(name, weights, alpha=alpha,
                                                 rank=rank)

    def _lora_acquire(self, req):
        """Pin the request's adapter in a device slot, once (a requeued
        request is admitted again without a second pin)."""
        if self._lora is None or req.adapter is None \
                or req.id in self._lora_held:
            return
        self._lora.store.acquire(req.adapter)
        self._lora_held[req.id] = req.adapter

    def _lora_release(self, req):
        """Drop the request's pin; its slot parks as evictable."""
        if self._lora is None:
            return
        name = self._lora_held.pop(req.id, None)
        if name is not None:
            self._lora.store.release(name)

    def handoff_ready(self):
        """Requests whose prompt K/V is complete and first token sampled:
        what a prefill engine would hand to a decode engine (the
        reference's engine.py:503-508)."""
        return [r for r in self.scheduler.running
                if not r.done and not r.prefilling and r.generated]

    def extract_request(self, req):
        raise _not_ported("the prefill/decode handoff (extract_request)")

    def inject_request(self, req, length, payload, stream=None):
        raise _not_ported("the prefill/decode handoff (inject_request)")

    def open_stream(self, request_id):
        raise _not_ported("streaming (open_stream)")

    def close(self):
        """Close the adapter store.  The reference's close also releases
        the speculative proposer and the pool's memory-guard charge, which
        the port does not have; the pool dies with its last reference, as
        the reference's does."""
        if self._lora is not None:
            self._lora.store.close()

    def step(self):
        """One unified ragged step (admissions + at most one prefill
        chunk + every decode row) plus a lazy drain.  Returns the
        requests that finished this step."""
        self._step_idx += 1
        self._step_finished = []
        allow_admission = True
        while True:
            action, payload = self.scheduler.next_action(allow_admission)
            if action != "admit":
                break
            try:
                self._admit(payload)
            except AdapterStoreFull:
                # every adapter slot is pinned by a running request: the
                # request stays at the queue head (nothing was mutated)
                # and is admitted again next step, as in the reference
                allow_admission = False
        if action == "step":
            self._run_step(payload)
        elif self._pending:
            self._drain(0)       # nothing to schedule: retire in flight
        self._drain(max(0, pipeline_depth() - 1))
        self._collect_finished()
        return list(self._step_finished)

    def generate(self, prompts, stream=False, **kwargs):
        """Run prompts to completion; one full token list per prompt."""
        if stream:
            raise _not_ported("streaming generation")
        ids = [self.add_request(p, **kwargs) for p in prompts]
        while self.has_unfinished():
            self.step()
        return [self.result(i) for i in ids]

    def result(self, request_id):
        """Full token sequence of a finished request."""
        req = self._results[request_id]
        return list(req.prompt) + list(req.generated)

    def stats(self):
        s = self.cache.stats()
        s.update(queue_depth=self.scheduler.queue_depth,
                 running=len(self.scheduler.running),
                 tokens_generated=self._tokens_generated,
                 token_budget=self.token_budget,
                 steps=self._steps_dispatched,
                 step_compiles=len(self._step_fn._cache))
        if self._lora is not None:
            ls = self._lora.store.stats()
            s.update(lora=ls, adapter_hit_rate=ls["hit_rate"])
        return s

    # -- admission ------------------------------------------------------
    def _admit(self, req):
        """Allocate the prompt (prefix-aware) and seat the request."""
        # pin the adapter first: AdapterStoreFull leaves the scheduler and
        # the pool untouched
        self._lora_acquire(req)
        self.scheduler.begin_prefill(req)
        row = self._rows.index(None)
        self._rows[row] = req
        req.row = row

    # -- the unified step -----------------------------------------------
    def _run_step(self, plan):
        appended = {}            # req.id -> length before this round
        while True:
            chunk, decodes = plan
            if self._reserve_slots(decodes, appended):
                break
            # preemption (or a finish) changed the schedule: the slots
            # reserved this round were never dispatched; if the next
            # action is no longer a step, roll them back
            action, payload = self.scheduler.next_action()
            if action != "step":
                self._rollback_slots(appended)
                return
            plan = payload
        self._dispatch_step(chunk, decodes)

    def _rollback_slots(self, appended):
        for rid, before in appended.items():
            if rid in self.cache:        # freed rows need no rollback
                self.cache.truncate(rid, before)

    def _reserve_slots(self, active, appended):
        """Extend every decode sequence by one slot; on pool exhaustion
        retire in-flight work, then preempt the policy's victim.
        Returns False when the active set changed."""
        for req in active:
            if req.id in appended:
                continue
            before = self.cache.length(req.id)
            if self.cache.append(req.id, 1):
                appended[req.id] = before
                continue
            self._drain(0)
            self._collect_finished()     # finished rows free blocks
            if req.done:
                return False
            if self.cache.append(req.id, 1):
                appended[req.id] = before
                continue
            victim = self.scheduler.select_victim()
            if victim is None:
                raise RuntimeError(
                    "KV pool exhausted with nothing left to preempt")
            self._preempt(victim)
            appended.pop(victim.id, None)
            return False
        return True

    def _preempt(self, victim):
        """Requeue by recompute: the victim's tokens are all drained (the
        caller forced lag 0), so prompt + generated resubmits at the
        queue head and its written blocks stay prefix-indexed."""
        if victim.row is not None:
            self._rows[victim.row] = None
        self._lora_release(victim)
        self.scheduler.requeue(victim, victim.generated)

    def _ragged_step(self, ids, seeds, do_sample, top_k, top_p,
                     temperature):
        """The ONE step function (``self._step_fn`` runs it through
        ``jit.to_static``): the model over the flat buffer ``ids`` ``[1,
        T]`` with the view's staged inputs, the hidden state of each
        sequence's sampled row (``view.last_index``), the LM head on those
        rows, then the sampler at ``view.sample_pos``."""
        view = self._view
        with torch.no_grad():
            hidden = self.model.gpt(ids, cache=view)
            rows_hidden = hidden[0, view.last_index]            # [S, h]
            logits = self.model.logits(rows_hidden).float()
            return ragged_sample_next(logits, seeds, view.sample_pos,
                                      do_sample, top_k, top_p, temperature)

    def _dispatch_step(self, chunk, decodes):
        """Pack the chunk and the decode rows into the flat ragged buffer,
        stage them with one copy, feed the decode rows from the previous
        step's device tokens, and run the step function."""
        T, S, BQ = self.token_budget, self.max_batch, self.block_q
        W = self.cache.table_width
        NQB = self.num_q_blocks
        # every input of the step in ONE int32 host buffer: one copy (the
        # ids carry one more slot, the decode feed's null target; top_p
        # and temperature are f32 bit patterns)
        sizes = dict(ids=T + 1, slots=T, positions=T, seq_ids=NQB,
                     q_starts=NQB, q_valids=NQB, tables=S * W, ctx=S,
                     last_index=S, sample_pos=S, feed_flat=S, feed_rows=S,
                     seeds=S, do_sample=S, top_k=S, top_p=S, temperature=S,
                     lora_slots=NQB if self._lora is not None else 0)
        buf = np.zeros(sum(sizes.values()), np.int32)
        host, off = {}, 0
        for name, n in sizes.items():
            host[name] = buf[off:off + n]
            off += n
        host["seq_ids"][:] = S           # S = null segment
        host["feed_flat"][:] = T         # not fed: the null target
        store = self._lora.store if self._lora is not None else None
        if store is not None:
            host["lora_slots"][:] = store.null_slot
        tables = host["tables"].reshape(S, W)
        self._controls(host)

        flat = 0
        rows_reqs = []           # rows that sample a token this step
        n_feed = 0               # decode rows fed from device tokens
        for req in decodes:
            r = req.row
            length = self.cache.length(req.id)   # incl. this new slot
            seg = flat // BQ
            host["seq_ids"][seg] = r
            host["q_starts"][seg] = length - 1
            host["q_valids"][seg] = 1
            if store is not None and req.adapter is not None:
                host["lora_slots"][seg] = store.slot_of(req.adapter)
            host["slots"][flat] = self.cache.slot_mapping(
                req.id, length - 1, 1)[0]
            host["positions"][flat] = length - 1
            host["feed_flat"][n_feed] = flat
            host["feed_rows"][n_feed] = r
            n_feed += 1
            tables[r] = self.cache.block_table(req.id)
            host["ctx"][r] = length
            host["last_index"][r] = flat
            host["sample_pos"][r] = length
            rows_reqs.append((r, req))
            flat += BQ
        if chunk is not None:
            req, start, n = chunk
            r = req.row
            host["ids"][flat:flat + n] = req.prompt[start:start + n]
            host["slots"][flat:flat + n] = self.cache.slot_mapping(
                req.id, start, n)
            host["positions"][flat:flat + n] = np.arange(start, start + n)
            nseg = -(-n // BQ)
            for j in range(nseg):
                host["seq_ids"][flat // BQ + j] = r
                host["q_starts"][flat // BQ + j] = start + j * BQ
                host["q_valids"][flat // BQ + j] = min(BQ, n - j * BQ)
            if store is not None and req.adapter is not None:
                host["lora_slots"][flat // BQ:flat // BQ + nseg] = \
                    store.slot_of(req.adapter)
            tables[r] = self.cache.block_table(req.id)
            host["ctx"][r] = start + n
            if start + n == len(req.prompt):
                # prompt complete: sample the first new token
                host["last_index"][r] = flat + n - 1
                host["sample_pos"][r] = start + n
                rows_reqs.append((r, req))
            flat += nseg * BQ

        dev_buf = torch.from_numpy(buf).to(self.device)
        dev, off = {}, 0
        for name, n in sizes.items():
            dev[name] = dev_buf[off:off + n]
            off += n
        self._view.set_inputs(dev["slots"], dev["tables"].view(S, W),
                              dev["ctx"], dev["positions"].view(1, T),
                              dev["seq_ids"], dev["q_starts"],
                              dev["q_valids"], dev["last_index"],
                              dev["sample_pos"])
        if store is not None:
            self._lora.stage(dev["lora_slots"])
        # the previous step's device-side tokens feed this step's decode
        # inputs with no host read, over all max_batch rows
        ids = dev["ids"].long()
        ids[dev["feed_flat"].long()] = self._last_tokens[
            dev["feed_rows"].long()]
        tok = self._step_fn(
            ids[:T].view(1, T), dev["seeds"].long() & 0xFFFFFFFF,
            dev["do_sample"].bool(), dev["top_k"].long(),
            dev["top_p"].view(torch.float32),
            dev["temperature"].view(torch.float32))
        self._steps_dispatched += 1
        self._last_tokens = tok
        for _, req in rows_reqs:
            req.n_scheduled += 1
        if rows_reqs:
            self._pending.append((rows_reqs, tok))
        if chunk is not None:
            req = chunk.request
            req.num_computed = chunk.start + chunk.length
            # landed blocks join the prefix index for future sharers
            self.cache.commit_prefix(
                req.id, req.prompt[:req.num_computed])

    def _controls(self, host):
        """Write each row's sampling controls (seed, do_sample, top_k,
        top_p, temperature) into the step's host buffer; empty rows are
        greedy."""
        top_p = host["top_p"].view(np.float32)
        temp = host["temperature"].view(np.float32)
        seeds = host["seeds"].view(np.uint32)
        top_p[:] = 1.0
        temp[:] = 1.0
        for i, req in enumerate(self._rows):
            if req is None:
                continue
            seeds[i] = int(req.seed) & 0xFFFFFFFF
            host["do_sample"][i] = bool(req.do_sample)
            host["top_k"][i] = req.top_k
            top_p[i] = req.top_p
            temp[i] = req.temperature

    # -- committing + draining ------------------------------------------
    def _commit_token(self, req, token):
        """Append one drained token to ``req``: TTFT stamp, EOS and
        max-new cut."""
        if not req.generated and req.t_first_token is None:
            req.t_first_token = time.perf_counter()
        req.generated.append(token)
        self._tokens_generated += 1
        if req.eos_token_id is not None and token == req.eos_token_id:
            req.done = True
        elif len(req.generated) >= req.max_new_tokens:
            req.done = True

    def _drain(self, lag):
        """Read dispatched token arrays older than ``lag`` steps back to
        the host: the only device synchronisation in the loop."""
        while len(self._pending) > lag:
            rows_reqs, device_toks = self._pending.pop(0)
            host = device_toks.cpu().numpy()
            for idx, req in rows_reqs:
                if req.done:
                    continue     # tokens raced past EOS: discard
                self._commit_token(req, int(host[idx]))

    def _collect_finished(self):
        for req in list(self.scheduler.running):
            if req.done:
                if req.row is not None:
                    self._rows[req.row] = None
                self._lora_release(req)
                req.t_finish = time.perf_counter()
                self.scheduler.finish(req)
                self._results[req.id] = req
                self._step_finished.append(req)
