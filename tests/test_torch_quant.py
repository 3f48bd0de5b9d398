"""int8 serving in the port vs the JAX reference, from the same inputs.

Inputs come from numpy seeds; models share weights through
``convert.load_reference_state``.  Everything runs on the CPU: the port's
plain kernel versions against the reference's Pallas entry points called
directly in interpret mode (kernels), or against the reference's XLA
composites (models and engines: its Pallas gate is closed on this CPU).

Tolerances:

* ``quantize_weight_int8`` and the quantizing KV scatter: codes and
  scales identical (both compute in f32 and round half to even).
* The int8 matmul epilogue vs ``pf.fused_linear_act_int8``: f32 within
  2e-5 abs + rel (a K-long f32 sum in another order; 1.9e-6 seen), bf16
  within 2e-2 (about one bf16 ulp at the outputs' scale, as
  ``tests/test_torch_ops.py`` holds the float epilogue).
* int8 ragged attention vs ``pr.ragged_paged_attention(k_scales=,
  v_scales=)``: as ``tests/test_torch_ops.py`` holds the float kernel,
  f32 2e-5 abs + rel, bf16 2e-2.
* Converted models: f32 logits within 1e-4 abs + rel of the reference's
  converted model; ``logits_cosine`` against the float model at least
  0.99 (the reference's weight-only gate).
* Engines: greedy tokens identical to the reference engine's for int8
  weights, an int8 KV pool and both; ``greedy_match_ratio`` against the
  port's float engine at least 0.95 (``scripts/quant_smoke.py``'s gate).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.analysis.diagnostics import DiagnosticReport
from paddle_tpu.inference.serving import GenerationEngine as RefEngine
from paddle_tpu.inference.serving.attention import _kv_scatter_quant_impl
from paddle_tpu.inference.serving.kv_cache import PagedKVCache as RefCache
from paddle_tpu.models import llama as ref_llama
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.ops import pallas_fused as pf
from paddle_tpu.ops import pallas_ragged as pr
from paddle_tpu import quantization as ref_quant

import paddle_tpu_torch as pt
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch import quantization as quant
from paddle_tpu_torch.inference.serving import (PagedKVCache,
                                                kv_cache_scatter_quant)
from paddle_tpu_torch.nn import functional as F

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TINY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64)
TINY_LLAMA = dict(TINY, num_key_value_heads=2, intermediate_size=128)
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


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    if hasattr(t, "numpy"):         # a reference Tensor
        t = t.numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _state(ref):
    return {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}


# ---------------------------------------------------------------------
# quantize_weight_int8
# ---------------------------------------------------------------------
@pytest.mark.parametrize("shape,axis", [((96, 80), 1), ((96, 80), -1),
                                        ((33, 17), 0), ((4, 6, 10), 1)])
def test_quantize_weight_int8_identical(shape, axis):
    rng = np.random.default_rng(5)
    w = rng.standard_normal(shape).astype(np.float32) * 0.3
    idx = [slice(None)] * len(shape)
    idx[axis] = 3
    w[tuple(idx)] = 0.0                       # a zero channel
    idx[axis] = 1
    bad = np.zeros(shape, bool)
    bad[tuple(idx)] = True
    w[np.unravel_index(np.flatnonzero(bad)[2], shape)] = np.nan
    ref_rep, rep = DiagnosticReport(), quant.QuantReport()
    ref_q, ref_s = ref_quant.quantize_weight_int8(paddle.to_tensor(w),
                                                  axis=axis, report=ref_rep)
    q, s = quant.quantize_weight_int8(torch.from_numpy(w), axis=axis,
                                      report=rep)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q.numpy()))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s.numpy()))
    assert s[3] == 1.0 and s[1] == 1.0
    [d] = ref_rep.by_code("TPU404")
    [f] = rep.by_code("TPU404")
    assert (f.site, f.message) == (d.site, d.message)
    assert f.bad_channels == 2 and f.channels == d.data["bad_channels"]


def test_quantize_clean_weight_reports_nothing():
    w = torch.from_numpy(
        np.random.default_rng(1).standard_normal((8, 5)).astype(np.float32))
    rep = quant.QuantReport()
    q, s = quant.quantize_weight_int8(w, axis=1, report=rep)
    assert len(rep) == 0
    assert int(q.abs().max()) == 127
    torch.testing.assert_close(q.float() * s, w, atol=float(s.max()) / 2,
                               rtol=0)


# ---------------------------------------------------------------------
# the int8 matmul epilogue
# ---------------------------------------------------------------------
def _int8_linear_inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.1
    b = rng.standard_normal(n).astype(np.float32)
    q, s = quant.quantize_weight_int8(torch.from_numpy(w), axis=1)
    return x, q.numpy(), s.numpy(), b


@pytest.mark.parametrize("shape", [(64, 128, 256), (37, 96, 80)],
                         ids=["aligned", "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", tops.ACTIVATIONS)
def test_linear_act_int8_plain_matches_pallas(act, dtype, shape):
    x, q, s, b = _int8_linear_inputs(*shape, seed=len(act) + shape[0])
    jx = jnp.asarray(x).astype(_JAX[dtype])
    jb = jnp.asarray(b).astype(_JAX[dtype])
    ref = pf.fused_linear_act_int8(jx, jnp.asarray(q), jnp.asarray(s), jb,
                                   act)
    tx = torch.from_numpy(x).to(_TORCH[dtype])
    tb = torch.from_numpy(b).to(_TORCH[dtype])
    got = tops.fused_linear_act_int8(tx, torch.from_numpy(q),
                                     torch.from_numpy(s), tb, act)
    assert got.dtype == _TORCH[dtype] and got.shape == (shape[0], shape[2])
    tol = _TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(ref), atol=tol, rtol=tol)
    assert torch.equal(got, tops.linear_act_int8_ref(
        tx, torch.from_numpy(q), torch.from_numpy(s), tb, act))


def test_linear_act_int8_backward_not_ported():
    x, q, s, b = _int8_linear_inputs(4, 8, 6, seed=0)
    xt = torch.from_numpy(x).requires_grad_()
    with pytest.raises(NotImplementedError, match="backward"):
        tops.fused_linear_act_int8(xt, torch.from_numpy(q),
                                   torch.from_numpy(s), torch.from_numpy(b))
    bias = torch.nn.Parameter(torch.from_numpy(b))
    with pytest.raises(NotImplementedError, match="backward"):
        F.linear_act_int8(torch.from_numpy(x), torch.from_numpy(q),
                          torch.from_numpy(s), bias)
    with torch.no_grad():
        out = F.linear_act_int8(xt, torch.from_numpy(q),
                                torch.from_numpy(s), bias)
    assert out.shape == (4, 6)
    with pytest.raises(ValueError):
        tops.fused_linear_act_int8(torch.from_numpy(x),
                                   torch.from_numpy(q).float(),
                                   torch.from_numpy(s), torch.from_numpy(b))
    with pytest.raises(ValueError):
        tops.fused_linear_act_int8(torch.from_numpy(x), torch.from_numpy(q),
                                   None, torch.from_numpy(b))
    with pytest.raises(RuntimeError):
        tops.fused_linear_act_int8(torch.zeros(2, 8, device="meta"),
                                   torch.from_numpy(q), torch.from_numpy(s),
                                   torch.from_numpy(b))


@pytest.mark.parametrize("bias", [True, False])
def test_functional_linear_act_int8_matches_reference(bias):
    """``F.linear_act_int8`` against the reference's (its XLA composite on
    this CPU), f32 and under ``auto_cast(bf16, O1)``: the op is on the
    white list, so x, the scale and the bias are cast to bf16 on both
    sides (the codes are not floating)."""
    x, q, s, b = _int8_linear_inputs(9, 48, 40, seed=3)
    b = b if bias else None
    rx, rq, rs = (paddle.to_tensor(a) for a in (x, q, s))
    rb = paddle.to_tensor(b) if bias else None
    tx, tq, ts = (torch.from_numpy(a) for a in (x, q, s))
    tb = torch.from_numpy(b) if bias else None
    want = paddle.nn.functional.linear_act_int8(rx, rq, rs, rb, act="silu")
    got = F.linear_act_int8(tx, tq, ts, tb, act="silu")
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)
    with paddle.amp.auto_cast(dtype="bfloat16", level="O1"):
        want = paddle.nn.functional.linear_act_int8(rx, rq, rs, rb,
                                                    act="silu")
    with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
        got = F.linear_act_int8(tx, tq, ts, tb, act="silu")
    assert str(want.dtype).endswith("bfloat16")
    assert got.dtype == torch.bfloat16
    # the same bf16 inputs (scale included) on both sides: one rounding
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)
    bf16_scale = torch.from_numpy(s).to(torch.bfloat16).float()
    np.testing.assert_array_equal(
        _np(got), _np(tops.linear_act_int8_ref(
            tx.to(torch.bfloat16), tq, bf16_scale,
            (tb if bias else torch.zeros(40)).to(torch.bfloat16), "silu")))


# ---------------------------------------------------------------------
# int8 ragged paged attention
# ---------------------------------------------------------------------
#: (query_lens, context_lens, pad q-blocks): decode rows, a prefill
#: chunk, a chunk boundary, a null segment with a context-0 sequence, and
#: a row whose keys all lie past the context (fully masked)
_RAGGED_CASES = {
    "pure_decode": ([1, 1, 1], [60, 17, 5], 0),
    "pure_prefill": ([20], [20], 0),
    "mixed": ([12, 1, 1], [30, 25, 9], 0),
    "chunk_boundary": ([16, 1], [48, 33], 0),
    "null_and_ctx0": ([1, 0], [25, 0], 2),
}


def _int8_pool_inputs(query_lens, context_lens, pad_blocks, dtype, seed=31,
                      H=4, D=32, bs=16, W=4):
    block_q = pr.ragged_q_block(_JAX[dtype])
    S = len(query_lens)
    sid = tops.ragged_segments(query_lens, context_lens, block_q)[0]
    nqb = len(sid) + pad_blocks
    sid, qs, qv, _, _ = tops.ragged_segments(
        query_lens, context_lens, block_q, num_q_blocks=nqb, num_seqs=S)
    rng = np.random.default_rng(seed)
    nb = S * W + 1
    q = rng.standard_normal((nqb * block_q, H, D)).astype(np.float32)
    kv = [rng.standard_normal((nb, H, bs, D)).astype(np.float32)
          * rng.uniform(0.2, 3.0, (nb, 1, bs, 1)).astype(np.float32)
          for _ in range(2)]
    codes, scales = [], []
    for a in kv:                   # per-slot codes, as the scatter makes
        t = torch.from_numpy(a).transpose(1, 2).reshape(-1, H, D)
        c, sc = pt.inference.serving.attention._quantize_tokens(t, 1)
        codes.append(c.reshape(nb, bs, H, D).transpose(1, 2).contiguous()
                     .numpy())
        scales.append(sc.reshape(nb, bs, 1).contiguous().numpy())
    tables = np.zeros((S, W), np.int32)
    for s, ctx in enumerate(context_lens):
        for w in range(-(-int(ctx) // bs)):
            tables[s, w] = 1 + s * W + w
    ints = [tables, np.asarray(context_lens, np.int32), sid, qs, qv]
    return block_q, q, codes, scales, ints


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_RAGGED_CASES))
def test_ragged_attention_int8_plain_matches_pallas(case, dtype):
    qls, ctxs, pad = _RAGGED_CASES[case]
    block_q, q, codes, scales, ints = _int8_pool_inputs(qls, ctxs, pad,
                                                        dtype)
    scale = 1.0 / q.shape[-1] ** 0.5
    ref = pr.ragged_paged_attention(
        jnp.asarray(q).astype(_JAX[dtype]), *(jnp.asarray(c) for c in codes),
        *(jnp.asarray(a) for a in ints), block_q=block_q, scale=scale,
        k_scales=jnp.asarray(scales[0]), v_scales=jnp.asarray(scales[1]))
    tq = torch.from_numpy(q).to(_TORCH[dtype])
    got = tops.ragged_paged_attention(
        tq, *(torch.from_numpy(c) for c in codes),
        *(torch.from_numpy(a) for a in ints), block_q=block_q, scale=scale,
        k_scales=torch.from_numpy(scales[0]),
        v_scales=torch.from_numpy(scales[1]))
    assert got.dtype == _TORCH[dtype] and got.shape == tq.shape
    tol = _TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(ref), atol=tol, rtol=tol)
    if case == "null_and_ctx0":
        assert float(got[block_q:].abs().sum()) == 0.0


def test_ragged_attention_int8_needs_scales():
    block_q, q, codes, scales, ints = _int8_pool_inputs([1], [9], 0,
                                                        "float32")
    args = (torch.from_numpy(q), *(torch.from_numpy(c) for c in codes),
            *(torch.from_numpy(a) for a in ints))
    with pytest.raises(ValueError, match="k_scales"):
        tops.ragged_paged_attention(*args, block_q=block_q)
    with pytest.raises(ValueError, match="k_scales"):
        tops.ragged_paged_attention_int8(args[0], *args[1:3], None, None,
                                         *args[3:], block_q=block_q)
    with pytest.raises(ValueError, match="int8 KV pools need"):
        pr.ragged_paged_attention(*(jnp.asarray(a) for a in (q, *codes,
                                                              *ints)),
                                  block_q=block_q)


# ---------------------------------------------------------------------
# the quantizing scatter
# ---------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_cache_scatter_quant_identical(dtype):
    rng = np.random.default_rng(12)
    nb, H, bs, D = 6, 2, 4, 8
    pools = [rng.integers(-127, 128, (nb, H, bs, D)).astype(np.int8)
             for _ in range(2)]
    scales = [rng.uniform(0.1, 1.0, (nb, bs, 1)).astype(np.float32)
              for _ in range(2)]
    new = [rng.standard_normal((2, 3, H, D)).astype(np.float32) * 4
           for _ in range(2)]
    new[0][0, 1] = 0.0                      # a zero key token: scale 1.0
    new[1][1, 2] = 0.0                      # a zero value token
    slots = np.asarray([5, 6, 7, 8, 13, 22], np.int32)
    ref = _kv_scatter_quant_impl(
        *(jnp.asarray(a) for a in pools + scales),
        *(jnp.asarray(a).astype(_JAX[dtype]) for a in new),
        jnp.asarray(slots))
    tp = [torch.from_numpy(a.copy()) for a in pools + scales]
    sl = torch.from_numpy(slots).long()
    kv_cache_scatter_quant(*tp, *(torch.from_numpy(a).to(_TORCH[dtype])
                                  for a in new), sl // bs, sl % bs)
    for got, want in zip(tp, ref):
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(tp[2][6 // bs, 6 % bs, 0]) == 1.0
    assert float(tp[3][22 // bs, 22 % bs, 0]) == 1.0
    assert int(tp[0][6 // bs, :, 6 % bs].abs().max()) == 0


# ---------------------------------------------------------------------
# the int8 paged cache
# ---------------------------------------------------------------------
def _int8_cache(**kw):
    args = dict(num_layers=1, num_heads=2, head_dim=8, block_size=4,
                num_blocks=10, max_model_len=40, dtype=torch.int8,
                device="cpu")
    args.update(kw)
    return PagedKVCache(**args)


def test_int8_cache_carries_scale_tables():
    c = _int8_cache()
    assert c.quantized and c.scale_lanes == pr.KV_SCALE_LANES \
        == tops.KV_SCALE_LANES
    ks, vs = c.layer_scales(0)
    for t in (ks, vs):
        assert t.shape == (c.num_blocks, c.block_size, c.scale_lanes)
        assert t.dtype == torch.float32
    k, v = c.layer_pools(0)
    assert k.dtype == v.dtype == torch.int8
    f = PagedKVCache(1, 2, 8, block_size=4, num_blocks=10, device="cpu")
    assert f.layer_scales(0) is None and not f.quantized
    assert c.stats()["kv_dtype"] == "int8"


def test_int8_cow_split_copies_scale_rows():
    c = _int8_cache()
    p = list(range(1, 13))
    assert c.allocate("a", 12, tokens=p)
    c.commit_prefix("a", p)
    assert c.allocate("b", 12, tokens=p)
    shared = c._tables["b"][1]
    k, _ = c.layer_pools(0)
    ks, vs = c.layer_scales(0)
    k[shared] = 42
    ks[shared] = 0.625
    vs[shared] = 0.25
    c.truncate("b", 6)
    assert c.append("b", 1)                    # forces the COW split
    assert c.cow_splits == 1
    new = c._tables["b"][1]
    assert new != shared
    assert torch.equal(k[new], k[shared])
    assert torch.equal(ks[new], ks[shared]) and float(ks[new].max()) == 0.625
    assert float(vs[new].max()) == 0.25


def test_int8_cache_truncate_rolls_back_reserved_slots():
    c = _int8_cache(num_blocks=8, max_model_len=32)
    assert c.allocate("a", 5)
    assert c.append("a", 3) and c.length("a") == 8
    assert c.append("a", 1) and len(c._tables["a"]) == 3
    c.truncate("a", 5)
    assert c.length("a") == 5 and len(c._tables["a"]) == 2
    assert c.free_blocks == 6
    assert c.append("a", 4) and c.length("a") == 9


def test_prefix_hash_includes_kv_dtype():
    ci, ci2 = _int8_cache(), _int8_cache()
    cf = _int8_cache(dtype=torch.float32)
    toks = tuple(range(1, 5))
    assert ci._chain_hash(None, toks) != cf._chain_hash(None, toks)
    assert ci._chain_hash(None, toks) == ci2._chain_hash(None, toks)
    # and the chain hashes are the reference's (one process, one seed)
    ri = RefCache(1, 2, 8, dtype="int8", block_size=4, num_blocks=10,
                  max_model_len=40, register=False)
    rf = RefCache(1, 2, 8, dtype="float32", block_size=4, num_blocks=10,
                  max_model_len=40, register=False)
    h = ci._chain_hash(None, toks)
    assert h == ri._chain_hash(None, toks)
    assert cf._chain_hash(None, toks) == rf._chain_hash(None, toks)
    assert ci._chain_hash(h, toks) == ri._chain_hash(h, toks)


def test_int8_pool_admits_1_8x_blocks_at_fixed_budget(monkeypatch):
    """The byte charge is the reference's formula, so the same budget
    admits about twice the bf16 pool's blocks (at least 1.8x: the scale
    tables take a little of the 2x)."""
    budget = 64 << 20
    monkeypatch.setenv("PADDLE_TPU_HBM_BUDGET", "64M")
    kw = dict(num_layers=2, num_heads=4, head_dim=32, block_size=16)
    blocks = {}
    for name in ("bfloat16", "int8"):
        ref = RefCache(dtype=name, register=False, hbm_fraction=0.5, **kw)
        port = PagedKVCache(dtype=name, num_blocks=8, device="cpu", **kw)
        assert port.bytes_per_block == ref.bytes_per_block
        assert port.stats()["bytes_per_block"] == port.bytes_per_block
        # the card's sizing rule, fed the same free bytes
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda device=None: (budget, 80 << 30))
        port.device = torch.device("cuda", 0)
        blocks[name] = port._blocks_from_budget(0.5) + 1
        assert blocks[name] == ref.num_blocks
    HD = 4 * 32
    assert blocks["int8"] >= 1.8 * blocks["bfloat16"]
    assert RefCache(dtype="int8", register=False, num_blocks=8,
                    **kw).bytes_per_block == 2 * 2 * 16 * (HD + 4)


# ---------------------------------------------------------------------
# convert_to_int8 on the models
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def gpt_pair():
    paddle.seed(11)
    ref = RefGPT(RefConfig(**TINY))
    ref.eval()
    return ref, _state(ref)


def _port_gpt(state, dtype=torch.float32):
    port = pt.GPTForCausalLM(pt.GPTConfig(**TINY), device="cpu", dtype=dtype)
    pt.load_reference_state(port, state)
    return port


def _ids(seed=6, shape=(2, 19)):
    return np.random.default_rng(seed).integers(1, 256, size=shape)


def test_convert_to_int8_gpt_matches_reference(gpt_pair):
    ref_float, state = gpt_pair
    ids = _ids()
    with paddle.no_grad():
        float_logits = np.array(ref_float(paddle.to_tensor(ids)).numpy())
    paddle.seed(11)
    ref = RefGPT(RefConfig(**TINY))
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    ref.eval()
    ref_report = ref_quant.convert_to_int8(ref)
    port = _port_gpt(state)
    report = quant.convert_to_int8(port)
    assert len(report) == len(ref_report) == 0
    assert len(quant.convert_to_int8(port)) == 0     # a no-op the 2nd time
    rs, ps = _state(ref), port.state_dict()
    assert sorted(rs) == sorted(ps)
    for name, want in rs.items():
        got = ps[name]
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert any(n.endswith("qkv_proj.weight_q") for n in ps)
    assert not any(n.endswith("proj.weight") or n.endswith("fc1.weight")
                   for n in ps)
    assert "gpt.wte.weight" in ps                    # the tied head stays
    assert port.dtype == torch.float32 and port.device.type == "cpu"
    with paddle.no_grad():
        want = ref(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert quant.logits_cosine(torch.from_numpy(got),
                               torch.from_numpy(float_logits)) >= 0.99
    assert abs(quant.logits_cosine(torch.from_numpy(got),
                                   torch.from_numpy(float_logits))
               - ref_quant.logits_cosine(paddle.to_tensor(got),
                                         paddle.to_tensor(float_logits))) \
        < 1e-6
    # the reference's int8 state loads into a converted port model
    fresh = pt.GPTForCausalLM(pt.GPTConfig(**TINY), device="cpu", seed=5)
    quant.convert_to_int8(fresh)
    pt.load_reference_state(fresh, rs)
    for name, t in fresh.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), rs[name], err_msg=name)
    with torch.no_grad():
        np.testing.assert_array_equal(
            fresh(torch.from_numpy(ids)).numpy(), got)


def test_int8_buffers_keep_their_dtypes_in_a_bf16_model(gpt_pair):
    _, state = gpt_pair
    port = _port_gpt(state, dtype=torch.bfloat16)
    quant.convert_to_int8(port)
    f32 = _port_gpt(state)
    quant.convert_to_int8(f32)
    int8_state = {k: v.numpy() for k, v in f32.state_dict().items()}
    pt.load_reference_state(port, {
        k: (v if k.endswith(("weight_q", "weight_scale"))
            else v.astype(np.float32)) for k, v in int8_state.items()})
    for name, t in port.state_dict().items():
        if name.endswith("weight_q"):
            assert t.dtype == torch.int8
        elif name.endswith("weight_scale"):
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), int8_state[name])
        else:
            assert t.dtype == torch.bfloat16, name
    assert port.dtype == torch.bfloat16
    with torch.no_grad():
        out = port(torch.from_numpy(_ids()))
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())


def test_convert_to_int8_reports_dead_channels(gpt_pair):
    _, state = gpt_pair
    port = _port_gpt(state)
    with torch.no_grad():
        port.gpt.h[0].mlp.fc2.weight[:, :3] = 0.0
    report = quant.convert_to_int8(port)
    [f] = report.by_code("TPU404")
    assert f.bad_channels == 3 and f.channels == [0, 1, 2]
    assert f.site == "quantize_weight_int8[shape=(256, 64)]"
    assert torch.equal(port.gpt.h[0].mlp.fc2.weight_scale[:3],
                       torch.ones(3))


def test_convert_to_int8_llama_matches_reference():
    """Row 11's path on the second model family: every projection of a
    tiny GQA LLaMA and its untied LM head go int8 in both packages."""
    paddle.seed(13)
    ref = ref_llama.LlamaForCausalLM(ref_llama.LlamaConfig(**TINY_LLAMA))
    ref.eval()
    port = pt.LlamaForCausalLM(pt.LlamaConfig(**TINY_LLAMA), device="cpu")
    pt.load_reference_state(port, _state(ref))
    ref_quant.convert_to_int8(ref)
    quant.convert_to_int8(port)
    names = [n for n in port.state_dict() if n.endswith("weight_q")]
    assert len(names) == 7 * TINY_LLAMA["num_hidden_layers"] + 1
    assert "lm_head.weight_q" in names
    rs = _state(ref)
    for name, t in port.state_dict().items():
        np.testing.assert_array_equal(_np(t), _np(rs[name]), err_msg=name)
    ids = _ids(seed=8, shape=(2, 17))
    with paddle.no_grad():
        want = ref(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------
# the engine with int8 weights and an int8 pool
# ---------------------------------------------------------------------
def _burst(seed=7):
    rng = np.random.default_rng(seed)
    shared = list(rng.integers(1, 256, size=8))
    return [shared + list(rng.integers(1, 256, size=int(n)))
            for n in (2, 3, 4, 3)]


_ENGINE_KW = dict(num_blocks=12, block_size=4, max_batch=3, max_model_len=64)


def _serve(engine, prompts, new=16):
    ids = [engine.add_request(p, max_new_tokens=new) for p in prompts]
    while engine.has_unfinished():
        engine.step()
    return [engine.result(i) for i in ids]


@pytest.mark.parametrize("weights,kv", [("int8", None), (None, "int8"),
                                        ("int8", "int8")],
                         ids=["weights", "kv", "both"])
def test_int8_engine_matches_reference_engine(gpt_pair, weights, kv):
    _, state = gpt_pair
    prompts = _burst()
    paddle.seed(11)
    ref = RefGPT(RefConfig(**TINY))
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    ref.eval()
    ref_eng = RefEngine(ref, weight_dtype=weights, kv_cache_dtype=kv,
                        **_ENGINE_KW)
    try:
        want = _serve(ref_eng, prompts)
        assert ref_eng.cache.quantized == (kv == "int8")
    finally:
        ref_eng.close()
    port = _port_gpt(state)
    eng = pt.GenerationEngine(port, device="cpu", weight_dtype=weights,
                              kv_cache_dtype=kv, **_ENGINE_KW)
    got = _serve(eng, prompts)
    assert got == want
    assert eng.cache.quantized == (kv == "int8")
    assert eng.stats()["kv_dtype"] == ("int8" if kv else "float32")
    assert eng.block_q == tops.ragged_q_block(torch.float32)
    assert (getattr(port.gpt.h[0].attn.qkv_proj, "weight_q", None)
            is not None) == (weights == "int8")
    assert eng.cache.cow_splits == ref_eng.cache.cow_splits
    float_eng = pt.GenerationEngine(_port_gpt(state), device="cpu",
                                    **_ENGINE_KW)
    assert quant.greedy_match_ratio(_serve(float_eng, prompts), got) >= 0.95


def test_engine_env_knobs_select_int8(gpt_pair, monkeypatch):
    _, state = gpt_pair
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", "int8")
    monkeypatch.setenv("PADDLE_TPU_WEIGHT_DTYPE", "int8")
    port = _port_gpt(state)
    eng = pt.GenerationEngine(port, device="cpu", **_ENGINE_KW)
    assert eng.cache.quantized and eng.cache.dtype == torch.int8
    linears = [m for m in port.modules() if isinstance(m, pt.nn.Linear)]
    assert linears and all(getattr(m, "weight_q", None) is not None
                           for m in linears)
    assert len(_serve(eng, _burst()[:2], new=4)[0]) == len(_burst()[0]) + 4
    assert pt.inference.serving.ENV_KV_DTYPE == "PADDLE_TPU_KV_DTYPE"
    assert pt.inference.serving.ENV_WEIGHT_DTYPE == "PADDLE_TPU_WEIGHT_DTYPE"
    with pytest.raises(NotImplementedError):
        pt.GenerationEngine(port, device="cpu", weight_dtype="float16",
                            **_ENGINE_KW)
    with pytest.raises(NotImplementedError):
        pt.GenerationEngine(port, device="cpu", kv_cache_dtype="bfloat16",
                            **_ENGINE_KW)


def test_int8_pool_under_bf16_model_keeps_compute_geometry(gpt_pair):
    _, state = gpt_pair
    port = _port_gpt(state, dtype=torch.bfloat16)
    eng = pt.GenerationEngine(port, device="cpu", kv_cache_dtype="int8",
                              **_ENGINE_KW)
    assert eng.block_q == tops.ragged_q_block(torch.bfloat16) == 16
    out = _serve(eng, _burst()[:2], new=4)
    assert all(len(o) == len(p) + 4 for o, p in zip(out, _burst()[:2]))
