"""Multi-LoRA in the port vs the JAX reference, from the same inputs.

Inputs come from numpy seeds.  On this CPU the reference's models run
their XLA composites (its Pallas gate is closed here) and the port its
plain kernel versions.

* The SGMV epilogue: the port's plain version (what the CUDA kernel is
  held to on the card) against ``pallas_grouped.lora_segment_epilogue``
  called directly (the Pallas kernel in interpret mode) over blocks that
  mix adapters, null blocks and one adapter that owns no block, in f32
  and bf16, every activation: within 1e-5 abs + rel in f32, 2e-2 in bf16
  (about two bf16 ulps).  Its gradients (dz, dx, dA, dB, through the
  grouped kernels' plain versions) against ``jax.vjp`` of the reference's
  custom-vjp, which runs its grouped Pallas kernels in interpret mode:
  dz and dx within the same tolerance, dA and dB within it of each
  gradient's largest magnitude; the adapter without blocks gets exact
  zeros on both sides.  Null rows equal ``act(z)`` bit for bit.  The
  single-adapter path of ``F.lora_segment_act`` (row padding) against the
  reference's functional within 1e-5.
* ``convert_to_lora`` / merge / unmerge / the LoRA state dict and the
  adapter store, as the reference's ``tests/test_lora.py`` holds them;
  the paged cache keys its prefix chain by adapter.
* The engine: greedy tokens with mixed adapters and base rows equal the
  reference engine's with the same adapters and weights; base rows equal
  a LoRA-free engine's; 64 adapters over 8 slots under decode (spills)
  equal the reference engine's.
* Fine-tuning: 3 AdamW steps of ``convert_to_lora`` (base frozen) against
  the reference's eager training: losses within 1e-5 relative, step-1
  LoRA gradients within 1e-4 of each one's largest magnitude, parameters
  within 1e-4 abs + rel (the f32 gates of the port's other training
  tests).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.fault_tolerance.chaos import bursty_trace
from paddle_tpu.inference.serving import GenerationEngine as RefEngine
from paddle_tpu.inference.serving import lora as RL
from paddle_tpu.inference.serving.kv_cache import PagedKVCache as RefCache
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as RefCriterion
from paddle_tpu.ops import pallas_grouped as pg

import paddle_tpu_torch as pt
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.inference.serving import (AdapterStoreFull,
                                                LoRAAdapterStore,
                                                PagedKVCache)
from paddle_tpu_torch.inference.serving import lora as L
from paddle_tpu_torch.nn import functional as F

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
VOCAB = 97
TINY = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64,
            use_flash_attention=False)


@pytest.fixture(autouse=True)
def _serving_env(monkeypatch):
    for var in ("PADDLE_TPU_KV_BLOCK_SIZE", "PADDLE_TPU_MAX_BATCH",
                "PADDLE_TPU_PREFIX_CACHE", "PADDLE_TPU_PREFILL_CHUNK",
                "PADDLE_TPU_PIPELINE_DEPTH", "PADDLE_TPU_LORA_STORE_BUDGET",
                "PADDLE_TPU_HBM_BUDGET", "PADDLE_TPU_MEMORY_GUARD"):
        monkeypatch.delenv(var, raising=False)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    if hasattr(t, "numpy"):         # a reference Tensor
        t = t.numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close_to_max(got, want, tol, name):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0,
                               err_msg=name)


# ---------------------------------------------------------------------
# the SGMV epilogue
# ---------------------------------------------------------------------
#: adapter of each row block: 4 adapters (id 1 owns no block), id 4 null
AID = [0, 4, 2, 2, 4, 0, 3]


def _sgmv_case(dtype, K=32, N=48, rank=4, seed=0):
    L_ = 4
    bm = 8 if dtype == "float32" else 16
    r = tops.lora_rank_pad(rank, _TORCH[dtype])
    R = len(AID) * bm
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((R, N)).astype(np.float32)
    x = rng.standard_normal((R, K)).astype(np.float32)
    a = (rng.standard_normal((L_, K, r)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((L_, r, N)) * 0.2).astype(np.float32)
    g = rng.standard_normal((R, N)).astype(np.float32)
    return z, x, a, b, g, np.asarray(AID, np.int32), bm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", tops.ACTIVATIONS)
def test_sgmv_plain_matches_pallas(act, dtype):
    z, x, a, b, _, aid, _ = _sgmv_case(dtype)
    jd, td = _JAX[dtype], _TORCH[dtype]
    want = pg.lora_segment_epilogue(
        *(jnp.asarray(v).astype(jd) for v in (z, x, a, b)),
        block_adapter=jnp.asarray(aid), act=act)
    tz, tx, ta, tb = (torch.from_numpy(v).to(td) for v in (z, x, a, b))
    taid = torch.from_numpy(aid)
    got = tops.lora_segment_epilogue_ref(tz, tx, ta, tb, block_adapter=taid,
                                         act=act)
    out, s = tops.fused_lora_segment_epilogue(tz, tx, ta, tb, taid, act)
    assert got.dtype == out.dtype == s.dtype == td
    assert torch.equal(got, out)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["none", "gelu_tanh", "silu"])
def test_sgmv_grads_match_reference_vjp(act, dtype):
    z, x, a, b, g, aid, _ = _sgmv_case(dtype, seed=1)
    jd, td = _JAX[dtype], _TORCH[dtype]
    jaid = jnp.asarray(aid)
    out_ref, vjp = jax.vjp(
        lambda zz, xx, aa, bb: pg.lora_segment_epilogue(
            zz, xx, aa, bb, block_adapter=jaid, act=act),
        *(jnp.asarray(v).astype(jd) for v in (z, x, a, b)))
    grads_ref = vjp(jnp.asarray(g).astype(jd))
    leaves = [torch.from_numpy(v).to(td).requires_grad_()
              for v in (z, x, a, b)]
    out = tops.lora_segment_epilogue(*leaves,
                                     block_adapter=torch.from_numpy(aid),
                                     act=act)
    out.backward(torch.from_numpy(g).to(td))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(out), _np(out_ref), atol=tol, rtol=tol)
    for name, t, want in zip(("dz", "dx"), leaves[:2], grads_ref[:2]):
        assert t.grad.dtype == td
        np.testing.assert_allclose(_np(t.grad), _np(want), atol=tol,
                                   rtol=tol, err_msg=name)
    for name, t, want in zip(("dA", "dB"), leaves[2:], grads_ref[2:]):
        assert t.grad.dtype == td
        _close_to_max(_np(t.grad), _np(want), tol, name)
        # adapter 1 owns no block: exact zeros on both sides
        assert not t.grad[1].any() and not np.asarray(want[1]).any()


def test_null_rows_are_act_z_bitwise():
    for dtype in ("float32", "bfloat16"):
        z, x, a, b, _, aid, bm = _sgmv_case(dtype, seed=2)
        td = _TORCH[dtype]
        tz, tx, ta, tb = (torch.from_numpy(v).to(td) for v in (z, x, a, b))
        for act in tops.ACTIVATIONS:
            out, s = tops.fused_lora_segment_epilogue(
                tz, tx, ta, tb, torch.from_numpy(aid), act)
            act_z = tops.matmul_epilogue.act_f32(tz.float(), act).to(td)
            for i, ad in enumerate(AID):
                rows = slice(i * bm, (i + 1) * bm)
                if ad == 4:
                    assert torch.equal(out[rows], act_z[rows]), (dtype, act)
                    assert torch.equal(s[rows], tz[rows])
                else:
                    assert not torch.equal(out[rows], act_z[rows])


@pytest.mark.parametrize("rows", [13, 16, 40])
def test_single_adapter_functional_matches_reference(rows):
    """`F.lora_segment_act` with one adapter's [K, r] / [r, N] factors
    pads the rows to a legal block height and slices them off, as the
    reference's functional does; under auto_cast it runs in bf16."""
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((1, rows, 32)).astype(np.float32)
    z = rng.standard_normal((1, rows, 24)).astype(np.float32)
    a = (rng.standard_normal((32, 4)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((4, 24)) * 0.2).astype(np.float32)
    for act in ("none", "gelu_tanh"):
        want = paddle.nn.functional.lora_segment_act(
            *(paddle.to_tensor(v) for v in (z, x, a, b)), act=act)
        got = F.lora_segment_act(*(torch.from_numpy(v) for v in (z, x, a, b)),
                                 act=act)
        assert got.shape == (1, rows, 24)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    with paddle.amp.auto_cast(dtype="bfloat16", level="O1"):
        want = paddle.nn.functional.lora_segment_act(
            *(paddle.to_tensor(v) for v in (z, x, a, b)))
    with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
        got = F.lora_segment_act(*(torch.from_numpy(v) for v in (z, x, a, b)))
    assert got.dtype == torch.bfloat16
    assert str(want.dtype).endswith("bfloat16")
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)


def test_layout_errors_and_rank_pad():
    assert [tops.lora_rank_pad(r, torch.float32) for r in (1, 8, 9)] \
        == [8, 8, 16]
    assert [tops.lora_rank_pad(r, torch.bfloat16) for r in (0, 16, 17)] \
        == [16, 16, 32]
    z, x, a, b, _, aid, _ = (torch.from_numpy(np.asarray(v)) if i < 6 else v
                             for i, v in enumerate(_sgmv_case("float32")))
    with pytest.raises(ValueError, match="act"):
        tops.lora_segment_epilogue(z, x, a, b, block_adapter=aid, act="tanh")
    with pytest.raises(ValueError, match="not divisible"):
        tops.lora_segment_epilogue(z, x, a, b, block_adapter=aid[:5])
    with pytest.raises(ValueError, match="K="):
        tops.lora_segment_epilogue(z, x[:, :8], a, b, block_adapter=aid)
    with pytest.raises(ValueError, match="b_stack"):
        tops.lora_segment_epilogue(z, x, a, b[:, :4], block_adapter=aid)


# ---------------------------------------------------------------------
# convert / merge / state dict, and the adapter store
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    """The reference GPT and the port's on the same weights."""
    paddle.seed(7)
    ref = RefGPT(RefConfig(**TINY))
    ref.eval()
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    return ref, state


def _port(state):
    port = pt.GPTForCausalLM(pt.GPTConfig(**TINY), device="cpu")
    pt.load_reference_state(port, state)
    return port.eval()


def _ref(state):
    paddle.seed(7)
    ref = RefGPT(RefConfig(**TINY))
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    ref.eval()
    return ref


def _adapter_sd(sites, seed, rank=4, scale=0.05):
    rng = np.random.default_rng(seed)
    return {name: {"A": (rng.standard_normal((k, rank)) * scale
                         ).astype(np.float32),
                   "B": (rng.standard_normal((rank, n)) * scale
                         ).astype(np.float32),
                   "rank": rank, "alpha": float(rank)}
            for name, k, n in sites}


def test_sites_match_reference(pair):
    ref, state = pair
    port = _port(state)
    assert L.attach_lora_sites(port) == RL.attach_lora_sites(ref)


def test_convert_zero_init_is_identity(pair):
    port = _port(pair[1])
    x = torch.arange(8).reshape(1, 8) % VOCAB
    want = port(x)
    sites = L.convert_to_lora(port, rank=4)
    assert len(sites) == 4 * TINY["num_hidden_layers"]
    assert torch.equal(port(x), want)      # B starts at zero
    layers = dict(port.named_modules())
    for site, k, n in sites:
        layer = layers[site]
        assert not layer.weight.requires_grad
        assert not layer.bias.requires_grad
        assert layer.lora_A.requires_grad and layer.lora_B.requires_grad
        assert layer.lora_A.shape == (k, 4) and not layer.lora_B.any()
        assert abs(float(layer.lora_A.detach().std()) - 0.02) < 0.01
    assert "gpt.h.0.attn.qkv_proj.lora_A" in port.state_dict()


def test_merge_unmerge_and_state_dict_roundtrip(pair):
    port = _port(pair[1])
    sites = L.convert_to_lora(port, rank=4)
    sd = _adapter_sd(sites, 1)
    L.load_lora_state_dict(port, sd)
    out = L.lora_state_dict(port)
    for site, _, _ in sites:
        np.testing.assert_array_equal(out[site]["A"], sd[site]["A"])
        np.testing.assert_array_equal(out[site]["B"], sd[site]["B"])
        assert out[site]["rank"] == 4 and out[site]["alpha"] == 4.0
    layers = dict(port.named_modules())
    before = {s: layers[s].weight.detach().clone() for s, _, _ in sites}
    L.merge_lora(port)
    L.merge_lora(port)                      # idempotent
    for s, _, _ in sites:
        delta = torch.from_numpy(sd[s]["A"] @ sd[s]["B"])   # alpha / r = 1
        np.testing.assert_allclose(_np(layers[s].weight),
                                   _np(before[s] + delta), atol=1e-6,
                                   rtol=1e-6)
    # merged: the LoRA branch is off
    qkv = port.gpt.h[0].attn.qkv_proj
    h = torch.randn(1, 10, 32)
    assert torch.equal(qkv(h), F.linear(h, qkv.weight, qkv.bias))
    L.unmerge_lora(port)
    L.unmerge_lora(port)                    # idempotent
    for s in before:
        np.testing.assert_allclose(_np(layers[s].weight), _np(before[s]),
                                   atol=1e-6, rtol=1e-6)


SITES = [("blk.fc1", 32, 64), ("blk.fc2", 64, 32)]


def _store(**kw):
    kw.setdefault("num_slots", 2)
    return LoRAAdapterStore(SITES, rank=4, device="cpu", **kw)


def _weights(seed):
    rng = np.random.default_rng(seed)
    return {name: (rng.standard_normal((k, 4)).astype(np.float32),
                   rng.standard_normal((4, n)).astype(np.float32))
            for name, k, n in SITES}


def test_store_spill_promote_bit_identical():
    st = _store()
    for i in range(3):
        st.register_adapter(f"t{i}", _weights(i))
    st.acquire("t0")
    packed = {s: tuple(t[st.slot_of("t0")].clone() for t in st.pair(s))
              for s, _, _ in SITES}
    st.release("t0")
    st.acquire("t1")
    st.acquire("t2")                        # evicts t0 (LRU, refcount 0)
    assert st.stats()["spills"] == 1 and not st.has_adapter("t9")
    st.release("t1")
    st.release("t2")
    st.acquire("t0")                        # promoted back from the host
    for s, _, _ in SITES:
        for got, want in zip((t[st.slot_of("t0")] for t in st.pair(s)),
                             packed[s]):
            assert torch.equal(got, want)
    stats = st.stats()
    assert (stats["hits"], stats["misses"], stats["resident"]) == (0, 4, 2)
    assert stats["device_bytes"] == 2 * st.bytes_per_slot
    assert stats["host_bytes"] == 3 * st.bytes_per_slot


def test_store_full_when_pinned_and_drop_refuses_pinned():
    st = _store()
    for i in range(3):
        st.register_adapter(f"t{i}", _weights(i))
    st.acquire("t0")
    st.acquire("t1")
    with pytest.raises(AdapterStoreFull):
        st.acquire("t2")
    with pytest.raises(RuntimeError, match="pinned"):
        st.drop_adapter("t0")
    st.release("t0")
    st.acquire("t2")                        # the LRU slot is evictable
    st.release("t2")
    st.drop_adapter("t2")
    assert not st.has_adapter("t2") and st.null_slot == 2
    with pytest.raises(KeyError):
        st.acquire("t2")
    with pytest.raises(KeyError):
        st.register_adapter("t0", _weights(0))


def test_store_folds_the_scale_into_b_like_the_reference():
    w = _weights(5)
    st = _store()
    ref = RL.LoRAAdapterStore(SITES, rank=4, num_slots=2, register=False)
    for s in (st, ref):
        s.register_adapter("x2", w, alpha=8.0)   # alpha / r = 2.0
        s.acquire("x2")
    for site, _, _ in SITES:
        for got, want in zip(st.pair(site), ref.pair(site)):
            np.testing.assert_array_equal(
                _np(got[st.slot_of("x2")]),
                np.asarray(want._value[ref.slot_of("x2")]))
        b = _np(st.pair(site)[1][st.slot_of("x2")])
        np.testing.assert_allclose(b[:4], w[site][1] * 2.0, rtol=1e-6)
        assert not b[4:].any()             # the packed rank's zero tail
    ref.close()


def test_store_sized_from_the_budget(monkeypatch):
    per = _store().bytes_per_slot
    monkeypatch.setenv("PADDLE_TPU_LORA_STORE_BUDGET", str(3 * per))
    assert _store(num_slots=None).num_slots == 3
    monkeypatch.setenv("PADDLE_TPU_LORA_STORE_BUDGET", "1M")
    assert _store(num_slots=None).num_slots == (1 << 20) // per
    assert L._parse_bytes("1.5K") == 1536 and L._parse_bytes("x") is None
    with pytest.raises(NotImplementedError, match="not ported yet"):
        _store(register=True)


def test_adapters_never_share_prefix_blocks():
    """The adapter id seeds the chain hash's root: a prefix cached under
    one adapter is a hit for that adapter only, after its owner is freed
    too, as in the reference's pool."""
    port = PagedKVCache(1, 1, 8, block_size=4, num_blocks=64, device="cpu")
    ref = RefCache(1, 1, 8, dtype="float32", block_size=4, num_blocks=64,
                   register=False)
    toks = list(range(1, 17))
    for c in (port, ref):
        c.allocate("a", len(toks), tokens=toks, adapter="t0")
        c.commit_prefix("a", toks)
    for seq, adapter, cached in (("b", "t0", 12), ("c", "t1", 0),
                                 ("d", None, 0)):
        for c in (port, ref):
            c.allocate(seq, len(toks), tokens=toks, adapter=adapter)
            assert c.cached_prefix_len(seq) == cached, (c, adapter)
    for c in (port, ref):
        c.free("a")
        c.free("b")
        c.allocate("e", len(toks), tokens=toks, adapter="t0")
        assert c.cached_prefix_len("e") == 12


# ---------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------
def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, VOCAB, size=int(rng.integers(5, 14))))
            for _ in range(n)]


_ENGINE = dict(max_batch=4, num_blocks=128, block_size=8, max_model_len=64)


def _serve(eng, reqs, n=8):
    ids = [eng.add_request(p, max_new_tokens=n, adapter=a) for p, a in reqs]
    while eng.has_unfinished():
        eng.step()
    return [eng.result(i) for i in ids]


def _lora_engines(state, adapters, num_slots=None, **kw):
    """The reference engine and the port's, LoRA on, the same adapters."""
    ref = RefEngine(_ref(state), **dict(_ENGINE, **kw))
    eng = pt.GenerationEngine(_port(state), device="cpu",
                              **dict(_ENGINE, **kw))
    for e in (ref, eng):
        e.enable_lora(rank=4, num_slots=num_slots)
        for name, sd in adapters.items():
            e.register_adapter(name, sd)
    return ref, eng


def test_engine_mixed_adapters_match_reference_engine(pair):
    ref_model, state = pair
    sites = RL.attach_lora_sites(ref_model)
    adapters = {f"t{i}": _adapter_sd(sites, 10 + i) for i in range(3)}
    reqs = list(zip(_prompts(6, seed=3),
                    ["t0", "t1", None, "t2", "t0", None]))
    ref, eng = _lora_engines(state, adapters)
    try:
        want = _serve(ref, reqs)
    finally:
        ref.close()
    got = _serve(eng, reqs)
    assert got == want
    stats = eng.stats()
    assert stats["lora"]["registered"] == 3 and stats["blocks_in_use"] == 0
    assert stats["adapter_hit_rate"] == stats["lora"]["hit_rate"]
    assert all(r == 0 for r in eng._lora.store._refs)   # all released
    # an adapter moves the tokens away from the base model's
    base = pt.GenerationEngine(_port(state), device="cpu", **_ENGINE)
    plain = base.generate([p for p, _ in reqs], max_new_tokens=8)
    assert got[2] == plain[2] and got[5] == plain[5]
    assert any(got[i] != plain[i] for i in (0, 1, 3, 4))


def test_engine_null_rows_match_the_base_engine(pair):
    ref_model, state = pair
    prompts = _prompts(5, seed=9)
    base = pt.GenerationEngine(_port(state), device="cpu", **_ENGINE)
    want = base.generate(prompts, max_new_tokens=8)
    eng = pt.GenerationEngine(_port(state), device="cpu", **_ENGINE)
    eng.enable_lora(rank=4)
    eng.register_adapter("t0", _adapter_sd(RL.attach_lora_sites(ref_model),
                                           20))
    got = _serve(eng, [(p, "t0" if i == 2 else None)
                       for i, p in enumerate(prompts)])
    for i in range(len(prompts)):
        if i != 2:
            assert got[i] == want[i], i


def test_sixty_four_adapters_over_eight_slots_match_reference(pair):
    ref_model, state = pair
    sites = RL.attach_lora_sites(ref_model)
    adapters = {f"t{i}": _adapter_sd(sites, 100 + i) for i in range(64)}
    trace = bursty_trace(5, n_requests=16, vocab=VOCAB, prefix_len=8,
                         tail_max=6, max_new_tokens=6, adapter_pool=64)
    reqs = [(r["prompt"], r["adapter"]) for r in trace]
    ref, eng = _lora_engines(state, adapters, num_slots=4, max_batch=3)
    try:
        want = _serve(ref, reqs, n=6)
        ref_stats = ref.stats()["lora"]
    finally:
        ref.close()
    got = _serve(eng, reqs, n=6)
    assert got == want
    stats = eng.stats()["lora"]
    assert stats["spills"] > 0 and stats["registered"] == 64
    for key in ("hits", "misses", "spills"):
        assert stats[key] == ref_stats[key], key


def test_full_store_defers_admission_like_reference(pair):
    """Two slots under four rows and four adapters: an admission that
    finds every slot pinned waits at the queue head for the next step
    (the reference's admission-fault path), with the same tokens and
    store counters as the reference engine."""
    ref_model, state = pair
    sites = RL.attach_lora_sites(ref_model)
    adapters = {f"t{i}": _adapter_sd(sites, 200 + i) for i in range(4)}
    reqs = list(zip(_prompts(6, seed=21), ["t0", "t1", "t2", "t3", None,
                                           "t0"]))
    ref, eng = _lora_engines(state, adapters, num_slots=2)
    try:
        want = _serve(ref, reqs)
        ref_stats = ref.stats()["lora"]
    finally:
        ref.close()
    assert _serve(eng, reqs) == want
    stats = eng.stats()["lora"]
    assert stats["spills"] > 0
    for key in ("hits", "misses", "spills"):
        assert stats[key] == ref_stats[key], key


def test_adapter_requests_need_enable_lora_and_a_registered_adapter(pair):
    eng = pt.GenerationEngine(_port(pair[1]), device="cpu", **_ENGINE)
    with pytest.raises(RuntimeError, match="enable_lora"):
        eng.add_request([1, 2, 3], adapter="nope")
    with pytest.raises(RuntimeError, match="enable_lora"):
        eng.register_adapter("nope", {})
    store = eng.enable_lora(rank=4)
    assert eng.enable_lora(rank=4) is store and store.num_slots == 4
    with pytest.raises(KeyError):
        eng.add_request([1, 2, 3], adapter="nope")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        eng.add_request([1, 2, 3], tenant="acme")


def test_bursty_trace_copy_matches_reference():
    import chip_smoke
    for kw in (dict(n_requests=64, vocab=50304, prefix_len=24, tail_max=12,
                    max_new_tokens=32, adapter_pool=64),
               dict(n_requests=9)):
        assert chip_smoke.bursty_trace(7, **kw) == bursty_trace(7, **kw)


# ---------------------------------------------------------------------
# LoRA fine-tuning
# ---------------------------------------------------------------------
def test_lora_finetune_matches_reference_training(pair):
    """Base frozen, ``convert_to_lora(rank=4)``, the same numpy A and B on
    both sides, AdamW(1e-4, weight decay 0.01, clip 1.0) over the LoRA
    parameters: 3 steps.  fc1's factors get no gradient on either side
    (GPT's MLP runs fc1 through the fused epilogue, as the reference's
    does)."""
    _, state = pair
    ref, port = _ref(state), _port(state)
    for p in ref.parameters():
        p.stop_gradient = True
    for p in port.parameters():
        p.requires_grad_(False)
    sites = RL.convert_to_lora(ref, rank=4)
    assert L.convert_to_lora(port, rank=4) == sites
    sd = _adapter_sd(sites, 3, scale=0.2)
    RL.load_lora_state_dict(ref, sd)
    L.load_lora_state_dict(port, sd)
    ref_params = [p for p in ref.parameters() if not p.stop_gradient]
    port_params = [p for p in port.parameters() if p.requires_grad]
    assert len(ref_params) == len(port_params) == 2 * len(sites)
    opts = [cls(learning_rate=1e-4, weight_decay=0.01, parameters=ps,
                grad_clip=clip(1.0)) for cls, ps, clip in (
        (paddle.optimizer.AdamW, ref_params, paddle.nn.ClipGradByGlobalNorm),
        (pt.optimizer.AdamW, port_params, pt.nn.ClipGradByGlobalNorm))]
    rng = np.random.default_rng(4)
    ids = rng.integers(0, VOCAB, (2, 24))
    base = {n: p.detach().clone() for n, p in port.named_parameters()
            if not p.requires_grad}
    ref.train()
    port.train()
    ref_crit, port_crit = RefCriterion(), pt.GPTPretrainingCriterion()
    own = dict(port.named_parameters())
    for step in range(3):
        rl = ref_crit(ref(paddle.to_tensor(ids)), paddle.to_tensor(ids))
        pl = port_crit(port(torch.from_numpy(ids)), torch.from_numpy(ids))
        rl.backward()
        pl.backward()
        want, got = float(rl.numpy()), float(pl.detach())
        assert abs(got - want) <= 1e-5 * abs(want), step
        if step == 0:
            for name, p in ref.named_parameters():
                if p.stop_gradient:
                    continue
                g = own[name].grad
                if ".fc1." in name:
                    assert g is None and (p.grad is None
                                          or not _np(p.grad).any()), name
                    continue
                _close_to_max(_np(g), _np(p.grad), 1e-4, name)
                assert _np(g).any(), name
        for opt in opts:
            opt.step()
            opt.clear_grad()
    for name, p in ref.named_parameters():
        np.testing.assert_allclose(_np(own[name]), _np(p), atol=1e-4,
                                   rtol=1e-4, err_msg=name)
    for name, p in base.items():
        assert torch.equal(own[name], p), name   # the base is untouched


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_out_is_s_only_without_activation(dtype):
    """``fused_lora_segment_epilogue`` returns s itself as out exactly when
    act is "none" (out equals s bit for bit there; the kernel writes s
    alone), and the autograd function saving that one tensor gives the
    gradients of the plain composite differentiated by autograd."""
    z, x, a, b, g, aid, _ = _sgmv_case(dtype, seed=5)
    td = _TORCH[dtype]
    tz, tx, ta, tb = (torch.from_numpy(v).to(td) for v in (z, x, a, b))
    taid = torch.from_numpy(aid)
    for act in tops.ACTIVATIONS:
        out, s = tops.fused_lora_segment_epilogue(tz, tx, ta, tb, taid, act)
        assert (out is s) == (act == "none"), act
    grads = []
    for fn in (tops.lora_segment_epilogue, tops.lora_segment_epilogue_ref):
        leaves = [t.clone().requires_grad_() for t in (tz, tx, ta, tb)]
        out = fn(*leaves, block_adapter=taid, act="none")
        out.backward(torch.from_numpy(g).to(td))
        grads.append([t.grad.float() for t in leaves])
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, got, want in zip(("dz", "dx", "dA", "dB"), *grads):
        torch.testing.assert_close(got, want, atol=tol * want.abs().max(),
                                   rtol=tol, msg=name)
