"""Continuous-batching scheduler: admission, chunked prefill, preemption.

Port of ``paddle_tpu/inference/serving/scheduler.py`` (:97-383), host
logic only and decision for decision the reference's, so that the port's
block tables match the reference engine's step for step:

  * **one step**: every step packs at most one prefill *chunk* (the
    oldest request still computing its prompt, ``prefill_chunk``
    tokens) plus every decodable row into one fixed ``[token_budget]``
    ragged buffer;
  * **admission**: when a row and enough free blocks exist, and no
    running request is still computing its prompt, the oldest waiting
    request is admitted through the prefix cache; one free block of
    headroom per running sequence is held back so an admission cannot
    be preempted straight back out by the decode growth it displaced;
  * **preempt to requeue**: when the pool cannot extend every running
    sequence, the victim's written blocks are prefix-indexed on free
    and it re-enters the queue head with its generated tokens folded
    into its prompt.

The policy hooks (`VictimPolicy`, `AdmissionPolicy`, `TokenBudgetPolicy`)
keep the reference's defaults.  The SLO policies, the prefill-only role
and adoption of a handed-off request are not ported yet.
"""
from __future__ import annotations

import os
import time
from collections import deque, namedtuple

__all__ = ["ENV_MAX_BATCH", "ENV_PREFILL_CHUNK", "max_batch_size",
           "prefill_chunk_size", "Request", "PrefillChunk",
           "VictimPolicy", "YoungestFirst", "AdmissionPolicy",
           "TokenBudgetPolicy", "ContinuousBatchingScheduler"]

ENV_MAX_BATCH = "PADDLE_TPU_MAX_BATCH"
ENV_PREFILL_CHUNK = "PADDLE_TPU_PREFILL_CHUNK"
_DEFAULT_MAX_BATCH = 8
_DEFAULT_PREFILL_CHUNK = 256


def _env_int(name, default):
    try:
        v = int(os.environ.get(name, default))
    except ValueError:
        return default
    return max(1, v)


def max_batch_size():
    """Decode batch width (PADDLE_TPU_MAX_BATCH, default 8)."""
    return _env_int(ENV_MAX_BATCH, _DEFAULT_MAX_BATCH)


def prefill_chunk_size():
    """Prefill tokens per step (PADDLE_TPU_PREFILL_CHUNK, default 256)."""
    return _env_int(ENV_PREFILL_CHUNK, _DEFAULT_PREFILL_CHUNK)


#: one scheduled slice of a prompt: ``request.prompt[start:start+length]``
PrefillChunk = namedtuple("PrefillChunk", ["request", "start", "length"])


class VictimPolicy:
    """Picks the preemption victim from the evictable running set."""

    def select_victim(self, candidates):
        raise NotImplementedError


class YoungestFirst(VictimPolicy):
    """The default: the most recently admitted request loses."""

    def select_victim(self, candidates):
        return max(candidates, key=lambda r: r.arrival)


class AdmissionPolicy:
    """Picks which waiting request admits next (default: FIFO head).
    ``None`` defers admission this step."""

    def select_admission(self, waiting, running):
        return waiting[0]


class TokenBudgetPolicy:
    """Filters the decode rows one step may schedule (default: all)."""

    def filter_decodes(self, decodes):
        return decodes


class Request:
    """One generation request and its host-side progress."""

    __slots__ = ("id", "prompt", "max_new_tokens", "do_sample", "top_k",
                 "top_p", "temperature", "seed", "eos_token_id",
                 "generated", "n_scheduled", "num_computed",
                 "cached_prefix", "row", "arrival", "done",
                 "preemptions", "t_submit", "t_first_token", "t_finish",
                 "adapter")

    def __init__(self, id, prompt, max_new_tokens=16, do_sample=False,
                 top_k=0, top_p=1.0, temperature=1.0, seed=0,
                 eos_token_id=None, adapter=None):
        self.id = id
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.do_sample = bool(do_sample)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.eos_token_id = eos_token_id
        self.generated = []       # host-read tokens, in order
        self.n_scheduled = 0      # tokens sampled on device (>= drained)
        self.num_computed = 0     # prompt tokens whose K/V are in cache
        self.cached_prefix = 0    # of those, served by the prefix cache
        self.row = None           # batch row while running
        self.arrival = -1         # admission-order stamp
        self.done = False
        self.preemptions = 0
        self.t_submit = None      # wall clock at submit (TTFT start)
        self.t_first_token = None  # wall clock at first drained token
        self.t_finish = None      # wall clock at finish
        self.adapter = adapter    # LoRA adapter id (None: the base model)

    @property
    def remaining(self):
        """Tokens still to schedule."""
        return max(0, self.max_new_tokens - self.n_scheduled)

    @property
    def prefilling(self):
        """Still computing prompt K/V (chunked prefill in progress)."""
        return self.num_computed < len(self.prompt)

    def __repr__(self):
        return (f"Request({self.id!r}, prompt={len(self.prompt)}tok, "
                f"computed={self.num_computed}, "
                f"gen={len(self.generated)}/{self.max_new_tokens}, "
                f"row={self.row}, done={self.done})")


class ContinuousBatchingScheduler:
    """Iteration-level scheduling over a shared PagedKVCache."""

    def __init__(self, cache, max_batch=None, prefill_chunk=None,
                 victim_policy=None, admission_policy=None,
                 budget_policy=None):
        self.cache = cache
        self.max_batch = int(max_batch or max_batch_size())
        self.prefill_chunk = int(prefill_chunk or prefill_chunk_size())
        self.victim_policy = victim_policy or YoungestFirst()
        self.admission_policy = admission_policy or AdmissionPolicy()
        self.budget_policy = budget_policy or TokenBudgetPolicy()
        self.waiting = deque()
        self.running = []
        self._arrival = 0

    # -- queue ----------------------------------------------------------
    def submit(self, request):
        request.arrival = self._arrival
        self._arrival += 1
        if request.t_submit is None:
            request.t_submit = time.perf_counter()
        self.waiting.append(request)

    def has_work(self):
        return bool(self.waiting or self.running)

    @property
    def queue_depth(self):
        return len(self.waiting)

    # -- policy ---------------------------------------------------------
    def next_action(self, allow_admission=True):
        """("admit", request) | ("step", (chunk, decodes)) |
        ("idle", None).  ``chunk`` is a `PrefillChunk` (or None) for the
        oldest running request still computing its prompt; ``decodes``
        are the prefilled sequences that still owe tokens.
        ``allow_admission=False`` skips admission: the engine passes it
        for the rest of a step whose admission failed."""
        # only ONE chunk runs per step, so admitting while a prompt is
        # still prefilling cannot start prefill sooner; it would only
        # allocate before that prompt's prefix is committed, turning
        # would-be prefix hits into misses
        prefilling = any(r.prefilling and not r.done
                         for r in self.running)
        if (allow_admission and self.waiting and not prefilling
                and len(self.running) < self.max_batch):
            req = self.admission_policy.select_admission(
                list(self.waiting), self.running)
            if req is None and not self.running:
                req = self.waiting[0]    # an idle engine always admits
            if req is not None and req is not self.waiting[0]:
                self.waiting.remove(req)
                self.waiting.appendleft(req)
            # +1 token: the sample at the end of prefill needs a slot at
            # the first decode step; one block of headroom per live row
            headroom = sum(1 for r in self.running if not r.done)
            if req is not None and self.cache.can_allocate(
                    len(req.prompt) + 1, tokens=req.prompt,
                    headroom=headroom, adapter=req.adapter):
                return ("admit", req)
            if req is not None and not self.running:
                need = self.cache.blocks_needed(len(req.prompt) + 1)
                raise RuntimeError(
                    f"request {req.id!r} needs {need} KV blocks but the "
                    f"pool only has {self.cache.free_blocks} free and "
                    f"nothing is running to preempt — the pool is too "
                    f"small for this prompt")
        chunk = None
        for r in self.running:           # oldest admitted first
            if not r.done and r.prefilling:
                n = min(self.prefill_chunk,
                        len(r.prompt) - r.num_computed)
                chunk = PrefillChunk(r, r.num_computed, n)
                break
        decodes = [r for r in self.running
                   if not r.done and not r.prefilling
                   and r.remaining > 0]
        if decodes:
            allowed = self.budget_policy.filter_decodes(list(decodes))
            if not allowed and chunk is None:
                allowed = [decodes[0]]   # quotas shape rates, never stall
            decodes = [r for r in decodes if r in allowed]
        if chunk is not None or decodes:
            return ("step", (chunk, decodes))
        return ("idle", None)

    # -- engine callbacks -----------------------------------------------
    def begin_prefill(self, request):
        """Pop from waiting and allocate the prompt's blocks through the
        prefix index: prefill starts at the first uncached block."""
        if not self.waiting or self.waiting[0] is not request:
            raise RuntimeError(f"{request.id!r} is not at the queue head")
        if not self.cache.allocate(request.id, len(request.prompt),
                                   tokens=request.prompt,
                                   adapter=request.adapter):
            raise RuntimeError(
                f"allocation for {request.id!r} raced the free list")
        request.cached_prefix = self.cache.cached_prefix_len(request.id)
        request.num_computed = request.cached_prefix
        self.waiting.popleft()
        self.running.append(request)

    def finish(self, request):
        """Return a finished request's blocks, indexing its full blocks
        so a follow-up sharing the prompt still hits."""
        self.cache.free(request.id,
                        tokens=self._written_tokens(request))
        if request in self.running:
            self.running.remove(request)
        request.row = None

    def select_victim(self):
        """The preemption victim through the `VictimPolicy` hook, or
        None when nothing is evictable."""
        candidates = [r for r in self.running if not r.done]
        if not candidates:
            return None
        return self.victim_policy.select_victim(candidates)

    def _written_tokens(self, request):
        """The tokens actually WRITTEN to the request's blocks: mid
        prefill only ``num_computed`` prompt tokens; after it,
        everything up to the cache length."""
        full = list(request.prompt) + list(request.generated)
        written = request.num_computed
        if not request.prefilling and request.id in self.cache:
            written = self.cache.length(request.id)
        return full[:written]

    def requeue(self, request, tokens_so_far):
        """Evict ``request`` to the head of the waiting queue, its prompt
        extended by everything generated so far; its written blocks stay
        prefix-indexed, so the resumed prefill skips what is cached."""
        self.cache.free(request.id,
                        tokens=self._written_tokens(request))
        if request in self.running:
            self.running.remove(request)
        request.prompt = list(request.prompt) + list(tokens_so_far)
        request.max_new_tokens = (request.max_new_tokens
                                  - len(tokens_so_far))
        request.generated = []
        request.n_scheduled = 0
        request.num_computed = 0
        request.cached_prefix = 0
        request.row = None
        request.preemptions += 1
        self.waiting.appendleft(request)
