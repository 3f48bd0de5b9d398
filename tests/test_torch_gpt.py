"""GPT in the port vs the JAX reference, with the reference's weights.

The reference's tiny GPT (vocab 256, hidden 64, 2 layers, 4 heads) is
built from a seed; its parameters go to the port through
``convert.load_reference_state``.  Both models then take the same token
ids through (a) the paged serving path, two ragged steps over their own
paged caches (two prompts prefilled as chunks, then one decode row
each), (b) the dense no-cache path, and (c) the dense KV cache (a
prefill, then one-token decode steps), with flash attention and with
the composite.  The reference runs its XLA
composites on the CPU (its Pallas gate is closed here), the port its
plain kernel versions.  Tolerance: f32 logits within 1e-4 abs + 1e-4
rel, the cross-framework f32 gate of ROADMAP.md.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving.attention import \
    RaggedCacheView as RefView
from paddle_tpu.inference.serving.kv_cache import \
    PagedKVCache as RefCache
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT

import paddle_tpu_torch as pt
from paddle_tpu_torch.inference.serving import PagedKVCache, RaggedCacheView

TINY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64)
ATOL = RTOL = 1e-4


def reference_params(model):
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    ref = RefGPT(RefConfig(**TINY))
    ref.eval()
    port = pt.GPTForCausalLM(pt.GPTConfig(**TINY), device="cpu")
    pt.load_reference_state(port, reference_params(ref))
    return ref, port


def _steps(cache, block_q, prompts):
    """Host arrays of two ragged steps: both prompts as prefill chunks,
    then one decode row each.  Every array is int32 except positions."""
    S, T = 2, 4 * block_q
    for i, p in enumerate(prompts):
        cache.allocate(i, len(p) + 1)
    steps = []
    for phase in ("prefill", "decode"):
        ids = np.zeros(T, np.int64)
        slots = np.zeros(T, np.int32)
        pos = np.zeros(T, np.int64)
        qlens, ctxs, flat = [], [], 0
        for i, p in enumerate(prompts):
            if phase == "prefill":
                n, start, toks = len(p), 0, p
            else:
                n, start, toks = 1, len(p), [p[0]]
            ids[flat:flat + n] = toks
            slots[flat:flat + n] = cache.slot_mapping(i, start, n)
            pos[flat:flat + n] = np.arange(start, start + n)
            qlens.append(n)
            ctxs.append(start + n)
            flat += -(-n // block_q) * block_q
        sid, qs, qv, _, _ = pt.ops.ragged_segments(
            qlens, ctxs, block_q, num_q_blocks=T // block_q, num_seqs=S)
        tables = np.stack([cache.block_table(i) for i in range(S)])
        steps.append(dict(ids=ids, slots=slots, pos=pos, tables=tables,
                          ctx=np.asarray(ctxs, np.int32), sid=sid, qs=qs,
                          qv=qv))
    return steps


def test_paged_path_logits_match_reference(models):
    ref, port = models
    rng = np.random.default_rng(5)
    prompts = [list(rng.integers(1, 256, size=n)) for n in (12, 5)]
    H = TINY["num_attention_heads"]
    D = TINY["hidden_size"] // H
    L = TINY["num_hidden_layers"]
    ref_cache = RefCache(L, H, D, dtype="float32", block_size=4,
                         num_blocks=16, max_model_len=64, register=False)
    port_cache = PagedKVCache(L, H, D, dtype=torch.float32, block_size=4,
                              num_blocks=16, max_model_len=64,
                              device="cpu")
    block_q = pt.ops.ragged_q_block(torch.float32)
    ref_view, port_view = RefView(ref_cache, block_q), RaggedCacheView(
        port_cache, block_q)
    ref_steps = _steps(ref_cache, block_q, prompts)
    port_steps = _steps(port_cache, block_q, prompts)
    for rs, ps in zip(ref_steps, port_steps):
        for key in rs:
            assert rs[key].tolist() == ps[key].tolist(), key
        S = len(prompts)
        ref_view.set_inputs(rs["slots"], rs["tables"], rs["ctx"],
                            rs["pos"][None], rs["sid"], rs["qs"], rs["qv"],
                            np.zeros(S, np.int32), np.zeros(S, np.int64))
        with paddle.no_grad():
            want = ref(paddle.to_tensor(rs["ids"][None]),
                       cache=ref_view).numpy()
        t = {k: torch.from_numpy(v) for k, v in ps.items()}
        port_view.set_inputs(t["slots"], t["tables"], t["ctx"],
                             t["pos"][None], t["sid"], t["qs"], t["qv"])
        with torch.no_grad():
            got = port(t["ids"][None], cache=port_view).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_dense_path_logits_match_reference(models):
    ref, port = models
    ids = np.random.default_rng(6).integers(1, 256, size=(2, 19))
    with paddle.no_grad():
        want = ref(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("flash", [True, False],
                         ids=["flash", "composite"])
def test_dense_cache_logits_match_reference(flash):
    """The dense KV cache: a 9-token prefill, then two one-token decode
    steps whose single query row sees the whole cache (bottom-right
    causal), through the port's flash path or its composite; the logits
    and the returned caches against the reference's."""
    cfg = dict(TINY, use_flash_attention=flash)
    paddle.seed(12)
    ref = RefGPT(RefConfig(**cfg))
    ref.eval()
    port = pt.GPTForCausalLM(pt.GPTConfig(**cfg), device="cpu").eval()
    pt.load_reference_state(port, reference_params(ref))
    ids = np.random.default_rng(8).integers(1, 256, size=(2, 11))
    rc = pc = None
    for lo, hi in ((0, 9), (9, 10), (10, 11)):
        with paddle.no_grad():
            rl, rc = ref(paddle.to_tensor(ids[:, lo:hi]), cache=rc,
                         use_cache=True)
        with torch.no_grad():
            pl, pc = port(torch.from_numpy(ids[:, lo:hi]), cache=pc,
                          use_cache=True)
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl.numpy()),
                                   atol=ATOL, rtol=RTOL)
    for got, want in zip(pc, rc):
        for g, w in zip(got, want):
            assert g.shape == (2, 11, 4, 16)
            np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()),
                                       atol=ATOL, rtol=RTOL)


def test_state_dict_names_and_shapes_match_reference(models):
    ref, port = models
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    assert port.gpt.h[0].attn.qkv_proj.weight.shape == (64, 192)  # [in, out]


def test_load_reference_state_rejects_mismatches(models):
    ref, port = models
    params = reference_params(ref)
    with pytest.raises(KeyError):
        pt.load_reference_state(port, {k: v for k, v in params.items()
                                       if k != "gpt.ln_f.bias"})
    with pytest.raises(KeyError):
        pt.load_reference_state(port, dict(params, extra=np.zeros(1)))
    bad = dict(params)
    bad["gpt.wte.weight"] = bad["gpt.wte.weight"][:, :32]
    with pytest.raises(ValueError):
        pt.load_reference_state(port, bad)
