"""The port's serving engine vs the JAX reference engine.

Greedy decoding through ``paddle_tpu_torch``'s GenerationEngine must give
the reference GenerationEngine's tokens exactly, with the same driving
arrays at every step (block tables, slot mappings, context lengths,
positions and segment descriptors), on a shared-prefix burst whose pool
is sized to force preemption.  The paged cache is held to the
reference's allocator on a seeded random trace.  Seeded sampling draws
from the port's copy of JAX's threefry (``core/random.py``, partitionable
mode, jax 0.9): its keys and random bits equal ``jax.random``'s bit for
bit, and the port's engine samples the reference engine's tokens on a
burst with temperature, top-k and top-p.  Everything runs on the CPU
(the port's plain kernel versions, the reference's XLA composites).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import GenerationEngine as RefEngine
from paddle_tpu.inference.serving.kv_cache import \
    PagedKVCache as RefCache
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.inference.serving import PagedKVCache, sample_next

TINY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64)
_ENV = ("PADDLE_TPU_KV_BLOCK_SIZE", "PADDLE_TPU_MAX_BATCH",
        "PADDLE_TPU_PIPELINE_DEPTH", "PADDLE_TPU_PREFIX_CACHE",
        "PADDLE_TPU_PREFILL_CHUNK", "PADDLE_TPU_SPEC_K",
        "PADDLE_TPU_KV_DTYPE", "PADDLE_TPU_WEIGHT_DTYPE",
        "PADDLE_TPU_KV_TIERING", "PADDLE_TPU_HBM_BUDGET",
        "PADDLE_TPU_SERVE_STEP_DEADLINE_MS", "PADDLE_TPU_SERVE_SHED_DEPTH")


@pytest.fixture(autouse=True)
def _serving_env(monkeypatch):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    ref = RefGPT(RefConfig(**TINY))
    ref.eval()
    port = pt.GPTForCausalLM(pt.GPTConfig(**TINY), device="cpu")
    pt.load_reference_state(
        port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    return ref, port


def _record_inputs(engine, to_numpy):
    """Log the first seven driving arrays of every dispatched step."""
    log = []
    stage = engine._view.set_inputs

    def wrapped(*args):
        log.append([to_numpy(a).reshape(-1).tolist() for a in args[:7]])
        return stage(*args)

    engine._view.set_inputs = wrapped
    return log


def _burst(seed=7):
    rng = np.random.default_rng(seed)
    shared = list(rng.integers(1, 256, size=8))
    return [shared + list(rng.integers(1, 256, size=int(n)))
            for n in (2, 3, 4, 3)]


def _run(engine, prompts, **kw):
    ids = [engine.add_request(p, **kw) for p in prompts]
    while engine.has_unfinished():
        engine.step()
    preempted = sum(engine._results[i].preemptions for i in ids)
    return [engine.result(i) for i in ids], preempted


def test_greedy_burst_matches_reference_engine(models):
    ref, port = models
    prompts = _burst()
    kw = dict(num_blocks=12, block_size=4, max_batch=3, max_model_len=64)
    ref_eng = RefEngine(ref, **kw)
    ref_log = _record_inputs(ref_eng, np.asarray)
    try:
        want, ref_pre = _run(ref_eng, prompts, max_new_tokens=16)
    finally:
        ref_eng.close()
    eng = pt.GenerationEngine(port, device="cpu", **kw)
    log = _record_inputs(eng, lambda t: t.numpy())
    got, pre = _run(eng, prompts, max_new_tokens=16)
    assert ref_pre > 0 and pre == ref_pre, "pool sized to force preemption"
    assert got == want
    assert len(log) == len(ref_log)
    names = ("slots", "tables", "ctx", "positions", "seq_ids", "q_starts",
             "q_valids")
    for step, (a, b) in enumerate(zip(log, ref_log)):
        for name, x, y in zip(names, a, b):
            assert x == y, f"step {step}: {name} differs"
    assert eng.cache._hit_tokens == ref_eng.cache._hit_tokens > 0
    assert eng.stats()["blocks_in_use"] == 0


def test_paged_cache_matches_reference_allocator():
    """A seeded trace of allocate / append / truncate / free / commit
    leaves the same tables, free list, refcounts and prefix index."""
    rng = np.random.default_rng(2)
    ref = RefCache(1, 1, 4, dtype="float32", block_size=4, num_blocks=24,
                   max_model_len=64, register=False)
    port = PagedKVCache(1, 1, 4, dtype=torch.float32, block_size=4,
                        num_blocks=24, max_model_len=64, device="cpu")
    shared = [int(t) for t in rng.integers(1, 50, size=12)]
    live, tokens = [], {}
    for step in range(300):
        op = rng.integers(0, 5)
        if op == 0 or not live:
            sid = f"s{step}"
            toks = shared[:int(rng.integers(4, 13))] + [
                int(t) for t in rng.integers(1, 50, size=rng.integers(1, 6))]
            ok = ref.allocate(sid, len(toks), tokens=toks)
            assert port.allocate(sid, len(toks), tokens=toks) == ok
            if ok:
                live.append(sid)
                tokens[sid] = toks
                assert (port.cached_prefix_len(sid)
                        == ref.cached_prefix_len(sid))
            continue
        sid = live[int(rng.integers(0, len(live)))]
        if op == 1:
            n = int(rng.integers(1, 4))
            assert port.append(sid, n) == ref.append(sid, n)
        elif op == 2:
            keep = int(rng.integers(1, ref.length(sid) + 1))
            ref.truncate(sid, keep)
            port.truncate(sid, keep)
        elif op == 3:
            toks = tokens[sid][:ref.length(sid)]
            ref.commit_prefix(sid, toks)
            port.commit_prefix(sid, toks)
        else:
            ref.free(sid, tokens=tokens[sid][:ref.length(sid)])
            port.free(sid, tokens=tokens[sid][:port.length(sid)])
            live.remove(sid)
        assert port._tables == ref._tables
        assert port._free == ref._free
        assert port._ref == ref._ref
        assert list(port._cached_free) == list(ref._cached_free)
        assert sorted(port._hash_of) == sorted(ref._hash_of)
    assert port.cow_splits == ref.cow_splits > 0
    assert port.prefix_hit_rate == ref.prefix_hit_rate > 0


def _soft_port_model():
    """A port model whose logits are soft enough for sampling to
    matter: the tied embedding is scaled down."""
    model = pt.GPTForCausalLM(pt.GPTConfig(**TINY), device="cpu", seed=3)
    with torch.no_grad():
        model.gpt.wte.weight.mul_(0.1)
    return model


@pytest.mark.parametrize("seed", [0, 7, 123456789, 2 ** 32 - 1, -3])
def test_threefry_keys_and_bits_match_jax(seed):
    assert jax.config.jax_threefry_partitionable, \
        "the port reproduces the partitionable threefry mode"
    positions = [0, 1, 63, 1000, 2 ** 31 + 5]
    key = trandom.fold_in(trandom.prng_key([seed] * len(positions)),
                          torch.tensor(positions))
    for row, pos in enumerate(positions):
        want = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed % 2 ** 32)),
                                  np.uint32(pos))
        assert key[row].tolist() == np.asarray(want, np.int64).tolist()
        for V in (1, 5, 256, 50304):
            bits = np.asarray(jax.random.bits(want, (V,), jnp.uint32))
            got = trandom.random_bits(key[row:row + 1], V)[0].numpy()
            assert (got == bits.astype(np.int64)).all(), (pos, V)
        logp = np.random.default_rng(row).standard_normal(300, np.float32)
        assert int(trandom.categorical(
            key[row:row + 1], torch.from_numpy(logp)[None])[0]) == int(
            jax.random.categorical(want, jnp.asarray(logp)))
        u = trandom.uniform(key[row:row + 1], 256)[0].numpy()
        np.testing.assert_array_equal(
            u, np.asarray(jax.random.uniform(
                want, (256,), jnp.float32,
                minval=np.finfo(np.float32).tiny, maxval=1.0)))


def test_seeded_sampled_tokens_match_reference_engine(models):
    ref, port = models
    prompts = _burst(seed=9)
    kw = dict(num_blocks=12, block_size=4, max_batch=3, max_model_len=64)
    reqs = [dict(max_new_tokens=12, do_sample=True, top_k=k, top_p=p,
                 temperature=t, seed=200 + i)
            for i, (k, p, t) in enumerate([(20, 0.9, 0.8), (0, 1.0, 1.0),
                                           (5, 1.0, 1.3), (0, 0.7, 0.9)])]
    ref_eng = RefEngine(ref, **kw)
    try:
        ids = [ref_eng.add_request(p, **r) for p, r in zip(prompts, reqs)]
        while ref_eng.has_unfinished():
            ref_eng.step()
        want = [ref_eng.result(i) for i in ids]
    finally:
        ref_eng.close()
    eng = pt.GenerationEngine(port, device="cpu", **kw)
    ids = [eng.add_request(p, **r) for p, r in zip(prompts, reqs)]
    while eng.has_unfinished():
        eng.step()
    got = [eng.result(i) for i in ids]
    assert got == want
    greedy = eng.generate(prompts, max_new_tokens=12)
    assert greedy != got, "sampling drew nothing but the argmax"


def test_seeded_sampling_invariant_to_batch_and_preemption():
    model = _soft_port_model()
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(1, 256, size=n)) for n in (2, 3, 4, 2)]
    kw = dict(max_new_tokens=16, do_sample=True, top_k=20, top_p=0.9,
              temperature=0.8)
    solo = pt.GenerationEngine(model, num_blocks=64, max_batch=1,
                               max_model_len=64, device="cpu")
    want = [solo.generate([p], seed=100 + i, **kw)[0]
            for i, p in enumerate(prompts)]
    eng = pt.GenerationEngine(model, num_blocks=8, block_size=4,
                              max_batch=3, max_model_len=64, device="cpu")
    ids = [eng.add_request(p, seed=100 + i, **kw)
           for i, p in enumerate(prompts)]
    while eng.has_unfinished():
        eng.step()
    assert sum(eng._results[i].preemptions for i in ids) > 0
    assert [eng.result(i) for i in ids] == want
    greedy = solo.generate(prompts, max_new_tokens=16)
    assert greedy != want, "sampling drew nothing but the argmax"


def test_sampler_filters():
    z = torch.tensor([[0.0, 3.0, 1.0, 2.0],
                      [5.0, 4.0, 0.0, 0.0],
                      [1.0, 1.0, 1.0, 1.0]])
    n = 3
    greedy = sample_next(z, np.zeros(n), np.zeros(n), np.zeros(n, bool),
                         np.zeros(n), np.ones(n), np.ones(n))
    assert greedy.tolist() == [1, 0, 0]
    # top_k = 1 and a tiny top_p both leave only the argmax
    for top_k, top_p in ((1, 1.0), (0, 1e-6)):
        for seed in range(5):
            tok = sample_next(z, np.full(n, seed), np.arange(n),
                              np.ones(n, bool), np.full(n, top_k),
                              np.full(n, top_p), np.ones(n))
            assert tok.tolist()[:2] == [1, 0]
    # temperature 0 rows stay greedy even when sampling is on
    tok = sample_next(z, np.arange(n), np.arange(n), np.ones(n, bool),
                      np.zeros(n), np.ones(n), np.zeros(n))
    assert tok.tolist() == [1, 0, 0]
    # a draw depends only on (seed, position)
    draws = {int(sample_next(z[2:], [7], [pos], [True], [0], [1.0],
                             [1.0])[0]) for pos in range(40)}
    assert len(draws) > 1
    again = [int(sample_next(z[2:], [7], [9], [True], [0], [1.0], [1.0])[0])
             for _ in range(3)]
    assert len(set(again)) == 1


def test_unported_options_raise(models):
    _, port = models
    for kw in (dict(speculative=4), dict(slo=object()),
               dict(role="prefill"), dict(kv_tiering=True)):
        with pytest.raises(NotImplementedError):
            pt.GenerationEngine(port, device="cpu", num_blocks=16, **kw)
    eng = pt.GenerationEngine(port, device="cpu", num_blocks=16)
    with pytest.raises(NotImplementedError):
        eng.add_request([1, 2, 3], tenant="a")
    with pytest.raises(RuntimeError, match="enable_lora"):
        eng.add_request([1, 2, 3], adapter="a")     # LoRA is ported
    with pytest.raises(NotImplementedError):
        eng.generate([[1, 2, 3]], stream=True)
    with pytest.raises(ValueError):
        eng.add_request([])
    with pytest.raises(ValueError):
        eng.add_request(list(range(1, 70)))      # >= max_model_len
    # use_scan_layers is ported: the model builds, and with a cache (as
    # the engine runs it) it takes the unrolled loop, as the reference's
    scan = pt.GPTForCausalLM(pt.GPTConfig(**TINY, use_scan_layers=True),
                             device="cpu")
    assert scan.config.use_scan_layers


def test_engine_takes_every_reference_name(models):
    """Every constructor parameter and public method of the reference's
    engine exists on the port's: ``config``, ``handoff_ready`` and
    ``close`` work as the reference's do, every other unported option or
    method raises ``NotImplementedError`` (never a ``TypeError`` or an
    ``AttributeError``)."""
    import inspect
    ref_model, port = models
    params = inspect.signature(RefEngine.__init__).parameters
    assert set(params) <= set(inspect.signature(
        pt.GenerationEngine.__init__).parameters)
    methods = {n for n, f in vars(RefEngine).items()
               if callable(f) and not n.startswith("_")}
    assert methods <= {n for n in dir(pt.GenerationEngine)
                       if not n.startswith("_")}
    for kw in (dict(step_deadline_ms=50.0), dict(shed_depth=4),
               dict(clock=lambda: 0.0), dict(kv_host_budget=1 << 20),
               dict(resident_name="kv")):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            pt.GenerationEngine(port, device="cpu", num_blocks=16, **kw)
    eng = pt.GenerationEngine(port, port.config, device="cpu", num_blocks=16,
                              max_batch=2)
    # multi-LoRA is ported (tests/test_torch_lora.py)
    lora_eng = pt.GenerationEngine(port, device="cpu", num_blocks=16)
    assert lora_eng.enable_lora().num_slots == lora_eng.max_batch
    assert lora_eng.register_adapter("a", {}) == "a"
    for name, args in (("extract_request", (None,)),
                       ("inject_request", (None, 0, None)),
                       ("open_stream", ("req0",))):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            getattr(eng, name)(*args)
    # handoff_ready lists the same requests as the reference's, step by
    # step: prompt complete, first token drained, not done
    ref = RefEngine(ref_model, num_blocks=16, max_batch=2)
    prompts = [[5, 6, 7, 8, 9], [1, 2, 3]]
    for e in (eng, ref):
        for p in prompts:
            e.add_request(p, max_new_tokens=4)
    seen = []
    while eng.has_unfinished() or ref.has_unfinished():
        eng.step()
        ref.step()
        got = sorted(r.id for r in eng.handoff_ready())
        assert got == sorted(r.id for r in ref.handoff_ready())
        seen += got
    assert seen, "no request was ever handoff-ready"
    assert eng.result("req0") == ref.result("req0")
    assert eng.close() is None and ref.close() is None
