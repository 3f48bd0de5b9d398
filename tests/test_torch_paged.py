"""The paged decode view in the port vs the JAX reference.

* ``ops.paged_attention_ref`` (what the CUDA kernel is held to on the
  card) against ``pallas_kernels.paged_attention`` called directly (the
  Pallas kernel in interpret mode) and against the reference's composite
  ``_paged_ref``, in f32 and bf16, with a context-0 row (zeros) and
  padded table entries (block 0) past each context: f32 within 1e-5 abs
  + rel (against the composite, which runs the same ops, 1e-6), bf16
  within 2e-2 (about two bf16 ulps; the kernel keeps f32 probabilities,
  the composite rounds them to bf16).
* ``PagedCacheView`` in both packages on the same weights, pool geometry
  and block tables: 3 equal-length prompts prefilled through the
  ``"prefill"`` view, then greedy steps through the ``"decode"`` view.
  Every step's logits within 1e-4 abs + rel (f32), the greedy tokens
  identical, and the pools after the drive within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import attention as ref_attention
from paddle_tpu.inference.serving.kv_cache import PagedKVCache as RefCache
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.ops import pallas_kernels as pk

import paddle_tpu_torch as pt
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.inference.serving import (PagedCacheView,
                                                PagedKVCache,
                                                paged_attention)

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    if hasattr(t, "numpy"):         # a reference Tensor
        t = t.numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _case(seed, B=4, H=2, D=32, bs=8, nb=12, W=4):
    """Pools, queries and tables: sequence 1 has context 0; every table
    is padded with block 0 past its context."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((nb, H, bs, D)).astype(np.float32)
    v = rng.standard_normal((nb, H, bs, D)).astype(np.float32)
    ctx = np.asarray([29, 0, 8, 17][:B], np.int32)
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((B, W), np.int32)
    used = 0
    for b, c in enumerate(ctx):
        n = -(-int(c) // bs)
        tables[b, :n] = perm[used:used + n]
        used += n
    return q, k, v, tables, ctx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [None, 0.3])
def test_paged_plain_matches_pallas_and_composite(dtype, scale):
    q, k, v, tables, ctx = _case(len(dtype))
    jd, td = _JAX[dtype], _TORCH[dtype]
    jq, jk, jv = (jnp.asarray(a).astype(jd) for a in (q, k, v))
    want = pk.paged_attention(jq, jk, jv, jnp.asarray(tables),
                              jnp.asarray(ctx), scale=scale)
    comp = ref_attention._paged_ref(
        jq, jk, jv, jnp.asarray(tables), jnp.asarray(ctx),
        scale if scale is not None else 1.0 / q.shape[-1] ** 0.5)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    got = tops.paged_attention_ref(tq, tk, tv, torch.from_numpy(tables),
                                   torch.from_numpy(ctx), scale=scale)
    assert got.dtype == td and got.shape == q.shape
    assert torch.equal(got, paged_attention(tq, tk, tv,
                                            torch.from_numpy(tables),
                                            torch.from_numpy(ctx), scale))
    assert not got[1].any() and not np.asarray(want)[1].any()  # ctx == 0
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(comp),
                               atol=1e-6 if dtype == "float32" else tol,
                               rtol=1e-6 if dtype == "float32" else tol)


def test_padding_entries_are_never_read():
    """Table entries past the context may point anywhere: changing them,
    or the pool blocks they name, changes nothing."""
    q, k, v, tables, ctx = _case(3)
    args = [torch.from_numpy(a) for a in (q, k, v, tables, ctx)]
    want = tops.paged_attention_ref(*args)
    t2 = tables.copy()
    t2[2, 1:] = 7                              # past sequence 2's 8 keys
    k2 = k.copy()
    k2[0] = 1e4                                # the pad block
    got = tops.paged_attention_ref(args[0], torch.from_numpy(k2), args[2],
                                   torch.from_numpy(t2), args[4])
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="1 token"):
        tops.paged_attention_ref(torch.zeros(2, 2, 2, 32), *args[1:])


# ---------------------------------------------------------------------
# the prefill-then-decode drive through both packages' views
# ---------------------------------------------------------------------
TINY = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64,
            use_flash_attention=False)
GEOM = dict(block_size=4, num_blocks=40, max_model_len=64)


def _drive(call, view_cls, cache, prompts, steps, to_ids):
    """Prefill ``prompts`` (equal lengths) through a ``"prefill"`` view,
    then ``steps`` greedy decode steps through a ``"decode"`` view.
    Returns each forward's last-row logits (f32 numpy) and the tokens."""
    B, P = len(prompts), len(prompts[0])
    seqs = [f"s{i}" for i in range(B)]
    for s in seqs:
        assert cache.allocate(s, P)
    view = view_cls(cache, "prefill")
    view.set_inputs(
        np.concatenate([cache.slot_mapping(s, 0, P) for s in seqs]),
        np.stack([cache.block_table(s) for s in seqs]),
        np.full(B, P, np.int32), np.tile(np.arange(P), (B, 1)))
    logits = [call(to_ids(np.asarray(prompts)), view)]
    toks = [logits[-1].argmax(-1)]
    view = view_cls(cache, "decode")
    for _ in range(steps):
        for s in seqs:
            assert cache.append(s, 1)
        n = cache.length(seqs[0])
        view.set_inputs(
            np.concatenate([cache.slot_mapping(s, n - 1, 1) for s in seqs]),
            np.stack([cache.block_table(s) for s in seqs]),
            np.full(B, n, np.int32), np.full((B, 1), n - 1))
        logits.append(call(to_ids(toks[-1][:, None]), view))
        toks.append(logits[-1].argmax(-1))
    return logits, np.stack(toks, 1)


def test_paged_view_drive_matches_reference_view():
    paddle.seed(3)
    ref = RefGPT(RefConfig(**TINY))
    ref.eval()
    port = pt.GPTForCausalLM(pt.GPTConfig(**TINY), device="cpu").eval()
    pt.load_reference_state(
        port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    rng = np.random.default_rng(5)
    prompts = rng.integers(1, 97, (3, 11)).tolist()
    head = TINY["num_attention_heads"]
    dims = (TINY["num_hidden_layers"], head, TINY["hidden_size"] // head)
    ref_cache = RefCache(*dims, dtype="float32", register=False, **GEOM)
    port_cache = PagedKVCache(*dims, device="cpu", **GEOM)

    def ref_call(ids, view):
        return _np(ref(ids, cache=view))[:, -1]

    def port_call(ids, view):
        with torch.no_grad():
            return _np(port(ids, cache=view))[:, -1]
    want, want_tok = _drive(ref_call, ref_attention.PagedCacheView,
                            ref_cache, prompts, 9,
                            lambda a: paddle.to_tensor(a.astype(np.int64)))
    got, got_tok = _drive(port_call, PagedCacheView, port_cache, prompts, 9,
                          lambda a: torch.from_numpy(a.astype(np.int64)))
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {step}")
    np.testing.assert_array_equal(got_tok, want_tok)
    for layer in range(dims[0]):
        for g, w in zip(port_cache.layer_pools(layer),
                        ref_cache.layer_pools(layer)):
            np.testing.assert_allclose(_np(g), _np(w), atol=1e-5, rtol=1e-5)


def test_paged_view_modes_and_pools():
    cache = PagedKVCache(1, 2, 8, block_size=4, num_blocks=8, device="cpu")
    with pytest.raises(ValueError, match="prefill|decode"):
        PagedCacheView(cache, "ragged")
    view = PagedCacheView(cache, "decode")
    assert len(view) == 1 and view[0].attend
    view.set_inputs(np.asarray([5, 9]), np.asarray([[1, 2], [2, 3]]),
                    np.asarray([6, 2]), np.asarray([[5], [1]]))
    assert view.slot_block.tolist() == [1, 2]
    assert view.slot_offset.tolist() == [1, 1]
    assert view.block_tables.dtype == torch.int32
    int8 = PagedKVCache(1, 2, 8, dtype=torch.int8, block_size=4,
                        num_blocks=8, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        PagedCacheView(int8, "decode")
