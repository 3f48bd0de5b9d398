"""MoE-GPT in the port vs the JAX reference, from the same inputs.

Inputs come from numpy seeds; the reference's weights go to the port
through ``convert.load_reference_state``.  On this CPU the reference's
MoE model runs its XLA composites (its Pallas gate is closed here) and
the port its plain kernel versions.

* The grouped matmul: the port's plain version (what the CUDA kernels are
  held to on the card) and its autograd function against
  ``pallas_grouped.grouped_linear_act`` called directly (the Pallas
  kernels in interpret mode) and its ``jax.vjp``, for counts [7, 0, 21,
  4], [16, 16, 16, 16] and [0, 0, 0, 50], f32 and bf16, every activation.
  f32: out and dx within 1e-5 abs + rel, dw and db (sums over up to 64
  rows in another order) within 1e-5 of each gradient's largest
  magnitude; bf16: 2e-2 abs + rel for out and dx (about two bf16 ulps),
  dw and db within 2e-2 of the largest.  The dw of an expert that owns no
  block is exactly 0.
* Dropless routing against ``moe_dispatch`` on the same top-k: rows,
  block ids and counts equal exactly; dispatch exactly, combine within
  1e-6; the router's top-k keeps the lower index on ties, as
  ``jax.lax.top_k`` does.
* The model (vocab 97, hidden 64, 2 layers, 4 heads, intermediate 128,
  E = 4, top_k = 2) against ``paddle_tpu.models.MoEGPTForCausalLM`` on
  the same weights: logits and aux loss within 1e-5 abs + rel, every
  step-1 gradient and every parameter after 3 AdamW steps within 1e-4
  abs + rel (the f32 gate of the port's other training tests); under
  ``auto_cast(bf16, O1)`` the loss within 1e-3 relative and every
  gradient within 5e-2 of its largest magnitude (the GPT test's bounds),
  with the experts in f32 on both sides.
* The dense twin (every expert the dense MLP) gives the dense GPT's
  logits within 1e-5; recompute gives the router the aux term's gradient
  (within 1e-6 of the run without it).
* The engine's greedy tokens equal the reference's ``generate()``, also
  across preemption.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.auto_parallel import moe_dispatch as ref_md
from paddle_tpu.models import MoEGPTConfig as RefMoEConfig
from paddle_tpu.models import MoEGPTForCausalLM as RefMoE
from paddle_tpu.models.moe_gpt import \
    MoEGPTPretrainingCriterion as RefMoECriterion
from paddle_tpu.ops import pallas_grouped as pg
from paddle_tpu.ops.pallas_tiles import group_segments as ref_segments

import paddle_tpu_torch as pt
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.distributed.auto_parallel import moe_dispatch as md
from paddle_tpu_torch.models import moe_gpt

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

KW = dict(vocab_size=97, hidden_size=64, num_hidden_layers=2,
          num_attention_heads=4, intermediate_size=128,
          max_position_embeddings=64, use_flash_attention=False)
ATOL = RTOL = 1e-4


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    if hasattr(t, "numpy"):         # a reference Tensor
        t = t.numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _state(ref):
    return {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}


# ---------------------------------------------------------------------
# the grouped matmul
# ---------------------------------------------------------------------
def _grouped_case(seed, counts, K, N, dtype):
    """A grouped buffer for explicit per-expert counts (tokens in their
    block-aligned rows, padding rows zero), stacked weights, biases and an
    upstream gradient, as numpy f32, with the reference's descriptors."""
    E = len(counts)
    rng = np.random.default_rng(seed)
    bm, nb, R = pg.grouped_layout(max(sum(counts), 1), E, _JAX[dtype])
    gid, offsets = ref_segments(jnp.asarray(counts, jnp.int32), bm, nb)
    x = np.zeros((R, K), np.float32)
    for e, c in enumerate(counts):
        x[int(offsets[e]):int(offsets[e]) + c] = rng.standard_normal((c, K))
    w = rng.standard_normal((E, K, N)).astype(np.float32) * 0.2
    b = rng.standard_normal((E, N)).astype(np.float32) * 0.2
    g = rng.standard_normal((R, N)).astype(np.float32)
    return x, w, b, g, np.array(gid)


def _close_to_max(got, want, tol, name):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", tops.ACTIVATIONS)
@pytest.mark.parametrize("counts", [[7, 0, 21, 4], [16, 16, 16, 16],
                                    [0, 0, 0, 50]])
def test_grouped_matmul_matches_pallas_and_vjp(counts, act, dtype):
    x, w, b, g, gid = _grouped_case(len(counts) + sum(counts), counts, 32,
                                    48, dtype)
    jd = _JAX[dtype]
    jx, jw, jb = (jnp.asarray(a).astype(jd) for a in (x, w, b))
    jgid = jnp.asarray(gid)
    out_ref, vjp = jax.vjp(lambda a, ww, bb: pg.grouped_linear_act(
        a, ww, bb, block_group=jgid, act=act), jx, jw, jb)
    dx_ref, dw_ref, db_ref = vjp(jnp.asarray(g).astype(jd))
    td = _TORCH[dtype]
    tx, tw, tb = (torch.from_numpy(a).to(td).requires_grad_()
                  for a in (x, w, b))
    tgid = torch.from_numpy(gid)
    out = tops.grouped_linear_act(tx, tw, tb, block_group=tgid, act=act)
    plain = tops.grouped_linear_act_ref(tx.detach(), tw.detach(),
                                        tb.detach(), block_group=tgid,
                                        act=act)
    out.backward(torch.from_numpy(g).to(td))
    assert out.dtype == tx.grad.dtype == tw.grad.dtype == tb.grad.dtype == td
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, got in (("out", out), ("plain", plain)):
        np.testing.assert_allclose(_np(got), _np(out_ref), atol=tol,
                                   rtol=tol, err_msg=name)
    np.testing.assert_allclose(_np(tx.grad), _np(dx_ref), atol=tol,
                               rtol=tol, err_msg="dx")
    _close_to_max(_np(tw.grad), _np(dw_ref), tol, "dw")
    _close_to_max(_np(tb.grad), _np(db_ref), tol, "db")
    for e, c in enumerate(counts):
        if c == 0:      # no block: exact zeros, on both sides
            assert not tw.grad[e].any() and not tb.grad[e].any()
            assert not np.asarray(dw_ref[e]).any()


def test_grouped_dw_plain_is_the_per_expert_sum():
    counts = [5, 0, 19, 8]
    x, _, _, g, gid = _grouped_case(3, counts, 24, 40, "float32")
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    dw = tops.grouped_dw_ref(tx, tg, torch.from_numpy(gid), 4)
    rows = np.repeat(gid, x.shape[0] // len(gid))
    for e in range(4):
        want = x[rows == e].T @ g[rows == e]
        np.testing.assert_allclose(dw[e].numpy(), want, atol=1e-5, rtol=1e-5)
    assert not dw[1].any()
    assert torch.equal(tops.fused_grouped_dw(tx, tg, torch.from_numpy(gid),
                                             4), dw)


def test_grouped_transposed_weights_and_null_blocks():
    """The wrapper's transposed layout (the backward's dx) reads w[e] as
    [N, K]; a buffer of null blocks only gives zeros."""
    counts = [9, 3, 0, 14]
    x, w, b, _, gid = _grouped_case(4, counts, 16, 24, "float32")
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    tgid = torch.from_numpy(gid)
    y = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (x.shape[0], 24)).astype(np.float32))
    got = tops.fused_grouped_linear_act(y, tw, None, tgid, transpose_w=True)
    want = tops.grouped_linear_act_ref(
        y, tw.transpose(1, 2).contiguous(), None, block_group=tgid)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    null = torch.full_like(tgid, 4)
    out, z = tops.fused_grouped_linear_act(tx, tw, torch.from_numpy(b), null,
                                           "gelu", return_z=True)
    assert not out.any() and not z.any()


def test_grouped_layout_and_segments_match_reference():
    for tokens, E in ((736, 4), (16384, 4), (7, 4), (50, 8), (3, 3)):
        for dtype in ("float32", "bfloat16"):
            assert tops.grouped_layout(tokens, E, _TORCH[dtype]) == \
                pg.grouped_layout(tokens, E, _JAX[dtype])
    assert tops.grouped_layout(736, 4, torch.bfloat16) == (128, 10, 1280)
    for counts in ([7, 0, 21, 4], [0, 0, 0, 50], [3, 0, 0, 0], [0, 0]):
        bm = 16
        nb = tops.num_group_blocks(sum(counts), len(counts), bm)
        got = tops.group_segments(torch.tensor(counts), bm, nb)
        want = ref_segments(jnp.asarray(counts, jnp.int32), bm, nb)
        for a, r in zip(got, want):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def test_grouped_layout_validation_errors():
    x, w, b, _, gid = _grouped_case(6, [8, 8], 16, 16, "float32")
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    tgid = torch.from_numpy(gid)
    with pytest.raises(ValueError, match="block descriptors"):
        tops.grouped_linear_act(tx[:-1], tw, tb, block_group=tgid)
    with pytest.raises(ValueError, match="act must be one of"):
        tops.grouped_linear_act(tx, tw, tb, block_group=tgid, act="tanhh")
    with pytest.raises(ValueError, match="b shape"):
        tops.grouped_linear_act(tx, tw, tb[:1], block_group=tgid)
    with pytest.raises(ValueError, match="row multiple"):
        tops.grouped_linear_act(tx[:12].to(torch.bfloat16), tw, tb,
                                block_group=tgid[:1])


# ---------------------------------------------------------------------
# dropless routing
# ---------------------------------------------------------------------
@pytest.mark.parametrize("seed,N,k,E", [(0, 37, 2, 4), (1, 64, 2, 8),
                                        (2, 20, 1, 4), (3, 5, 2, 4)])
def test_dropless_plan_dispatch_combine_match_reference(seed, N, k, E):
    rng = np.random.default_rng(seed)
    topk = np.stack([rng.choice(E - 1 if seed == 3 else E, k, replace=False)
                     for _ in range(N)]).astype(np.int32)
    x = rng.standard_normal((N, 16)).astype(np.float32)
    topv = rng.random((N, k)).astype(np.float32)
    bm, nb, R = pg.grouped_layout(N * k, E, jnp.float32)
    assert tops.grouped_layout(N * k, E, torch.float32) == (bm, nb, R)
    want = ref_md.dropless_plan(jnp.asarray(topk), E, bm, nb)
    got = md.dropless_plan(torch.from_numpy(topk), E, bm, nb)
    for a, r in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    assert torch.equal(md.dropless_plan(torch.from_numpy(topk), E, bm)[1],
                       got[1])
    rows = got[0]
    xd = md.dropless_dispatch(torch.from_numpy(x), rows, k, R)
    xd_ref = ref_md.dropless_dispatch(jnp.asarray(x), want[0], k, R)
    np.testing.assert_array_equal(xd.numpy(), np.asarray(xd_ref))
    y_rows = rng.standard_normal((R, 16)).astype(np.float32)
    y = md.dropless_combine(torch.from_numpy(y_rows), rows,
                            torch.from_numpy(topv))
    y_ref = ref_md.dropless_combine(jnp.asarray(y_rows), want[0],
                                    jnp.asarray(topv))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-6,
                               rtol=1e-6)
    imb = md.expert_imbalance(got[2])
    assert float(imb) == pytest.approx(float(ref_md.expert_imbalance(
        want[2])), rel=1e-7)


def test_router_top_k_keeps_the_lower_index_on_ties():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((33, 8)).astype(np.float32)
    router = rng.standard_normal((8, 6)).astype(np.float32)
    router[:, 4] = router[:, 1]          # experts 1 and 4 always tie
    router[:, 5] = router[:, 2]          # and 2 and 5
    probs, topv, topi = moe_gpt.route(torch.from_numpy(x),
                                      torch.from_numpy(router), 3)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(topv.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_unported_ep_pieces_raise():
    for fn in (md.ring_all_to_all_local, md.measured_ep_dispatch):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            fn(None)


# ---------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------
def _pair(seed=11, **over):
    cfg = dict(KW, num_experts=4, top_k=2, **over)
    paddle.seed(seed)
    ref = RefMoE(RefMoEConfig(**cfg))
    port = pt.MoEGPTForCausalLM(pt.MoEGPTConfig(**cfg), device="cpu")
    pt.load_reference_state(port, _state(ref))
    return ref, port


def _batch(seed=0, b=2, s=24):
    ids = np.random.default_rng(seed).integers(0, KW["vocab_size"], (b, s))
    labels = ids.copy()
    labels[0, 5] = -100                       # the criterion's ignore index
    return ids, labels


def test_state_names_shapes_and_config_match_reference():
    ref, port = _pair()
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    assert got["gpt.h.1.mlp.router"] == (64, 4)
    assert got["gpt.h.1.mlp.w1"] == (4, 64, 128)
    assert got["gpt.h.1.mlp.w2"] == (4, 128, 64)
    assert got["gpt.h.1.mlp.b1"] == (4, 128)
    assert got["gpt.h.1.mlp.b2"] == (4, 64)
    assert vars(pt.MoEGPTConfig()) == vars(RefMoEConfig())
    assert all(p.param_name == n for n, p in port.named_parameters())


def test_stacked_init_follows_the_reference_fans():
    """XavierNormal on [E, H, I] with the reference's fans: fan_in = H*I,
    fan_out = E*I (std within 3% over 131072 draws; the zero biases
    exactly)."""
    cfg = pt.MoEGPTConfig(vocab_size=32, hidden_size=128,
                          num_hidden_layers=1, num_attention_heads=2,
                          intermediate_size=256, max_position_embeddings=8)
    mlp = pt.MoEGPTForCausalLM(cfg, device="cpu").gpt.h[0].mlp
    E, H, I = 4, 128, 256
    for p, std in ((mlp.w1, (2 / (H * I + E * I)) ** 0.5),
                   (mlp.w2, (2 / (I * H + E * H)) ** 0.5),
                   (mlp.router, (2 / (H + E)) ** 0.5)):
        assert abs(float(p.detach().std()) / std - 1) < 0.03
    assert not mlp.b1.any() and not mlp.b2.any()


def test_logits_and_aux_loss_match_reference():
    ref, port = _pair()
    ids, _ = _batch()
    rl = ref(paddle.to_tensor(ids))
    pl = port(torch.from_numpy(ids))
    np.testing.assert_allclose(_np(pl), _np(rl), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(port.aux_loss()), _np(ref.aux_loss()),
                               atol=1e-5, rtol=1e-5)
    for blk in port.gpt.h:
        assert int(blk.mlp.counts.sum()) == ids.size * 2


def _train(ref, port, steps, amp=False):
    ids, labels = _batch()
    ref_opt = paddle.optimizer.AdamW(
        learning_rate=1e-4, weight_decay=0.01, parameters=ref.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    port_opt = pt.optimizer.AdamW(
        learning_rate=1e-4, weight_decay=0.01, parameters=port.parameters(),
        grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    ref_crit = RefMoECriterion(model=ref)
    port_crit = pt.MoEGPTPretrainingCriterion(model=port)
    losses, grads = [], None
    for step in range(steps):
        if amp:
            with paddle.amp.auto_cast(dtype="bfloat16", level="O1"):
                rl = ref_crit(ref(paddle.to_tensor(ids)),
                              paddle.to_tensor(labels))
            with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
                pl = port_crit(port(torch.from_numpy(ids)),
                               torch.from_numpy(labels))
        else:
            rl = ref_crit(ref(paddle.to_tensor(ids)),
                          paddle.to_tensor(labels))
            pl = port_crit(port(torch.from_numpy(ids)),
                           torch.from_numpy(labels))
        rl.backward()
        pl.backward()
        losses.append((float(rl.numpy()), float(pl.detach())))
        if step == 0:
            own = dict(port.named_parameters())
            grads = {n: (_np(p.grad), own[n].grad.numpy().copy())
                     for n, p in ref.named_parameters()}
        for opt in (ref_opt, port_opt):
            opt.step()
            opt.clear_grad()
    return losses, grads


def test_adamw_f32_grads_and_params_match_reference():
    ref, port = _pair()
    losses, grads = _train(ref, port, steps=3)
    for want, got in losses:
        assert abs(got - want) <= ATOL + RTOL * abs(want)
    assert losses[-1][1] < losses[0][1]
    assert len(grads) == len(list(port.parameters()))
    for name, (want, got) in grads.items():
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=name)
    for name in ("router", "w1", "b1", "w2", "b2"):
        assert np.abs(grads[f"gpt.h.0.mlp.{name}"][1]).max() > 0, name
    own = dict(port.named_parameters())
    for name, p in ref.named_parameters():
        np.testing.assert_allclose(own[name].detach().numpy(), _np(p),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


def test_bf16_o1_keeps_the_experts_f32_and_matches_reference(monkeypatch):
    """``moe_mlp_dropless`` is on neither O1 list: after the black-listed
    layer norm the experts get f32 and stay f32 (a white-listed route
    would cast them to bf16)."""
    from paddle_tpu_torch.ops import grouped
    seen = []
    fwd = grouped.fused_grouped_linear_act

    def spy(x, w, b, *a, **k):
        seen.append((x.dtype, w.dtype))
        return fwd(x, w, b, *a, **k)
    monkeypatch.setattr(grouped, "fused_grouped_linear_act", spy)
    ref, port = _pair()
    losses, grads = _train(ref, port, steps=1, amp=True)
    (want, got), = losses
    assert abs(got - want) <= 1e-3 * abs(want)
    for name, (want, got) in grads.items():
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=5e-2 * scale, rtol=0,
                                   err_msg=name)
    # forward: 2 a layer; backward: dx 2 a layer
    assert len(seen) == 4 * KW["num_hidden_layers"]
    assert set(seen) == {(torch.float32, torch.float32)}


def test_dense_twin_gives_the_dense_logits():
    """Every expert the dense MLP: the renormalised top-k mix is a no-op
    (tests/test_moe_gpt.py:54 within the port)."""
    E = 4
    gcfg = {k: v for k, v in KW.items()}
    dense = pt.GPTForCausalLM(pt.GPTConfig(**gcfg), device="cpu", seed=3)
    moe = pt.MoEGPTForCausalLM(pt.MoEGPTConfig(num_experts=E, top_k=2,
                                               **gcfg), device="cpu")
    own = dict(moe.named_parameters())
    with torch.no_grad():
        for name, p in dense.named_parameters():
            if name in own:
                own[name].copy_(p)
        for bd, bm in zip(dense.gpt.h, moe.gpt.h):
            bm.mlp.w1.copy_(bd.mlp.fc1.weight.expand(E, -1, -1))
            bm.mlp.b1.copy_(bd.mlp.fc1.bias.expand(E, -1))
            bm.mlp.w2.copy_(bd.mlp.fc2.weight.expand(E, -1, -1))
            bm.mlp.b2.copy_(bd.mlp.fc2.bias.expand(E, -1))
    ids = torch.from_numpy(_batch()[0])
    torch.testing.assert_close(moe(ids), dense(ids), atol=1e-5, rtol=1e-5)


def test_recompute_keeps_the_routers_aux_gradient():
    ids, labels = (torch.from_numpy(a) for a in _batch(3))
    grads = {}
    for recompute, aux_weight in ((False, None), (True, None), (False, 0.0)):
        _, port = _pair(use_recompute=recompute)
        crit = pt.MoEGPTPretrainingCriterion(model=port,
                                             aux_weight=aux_weight)
        crit(port(ids), labels).backward()
        grads[recompute, aux_weight] = [blk.mlp.router.grad.clone()
                                        for blk in port.gpt.h]
    for a, b, c in zip(grads[False, None], grads[True, None],
                       grads[False, 0.0]):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=1e-6)
        assert (a - c).abs().max() > 1e-3 * a.abs().max()   # the aux term


# ---------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def served():
    cfg = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=4, max_position_embeddings=64,
               num_experts=4, top_k=2)
    paddle.seed(7)
    ref = RefMoE(RefMoEConfig(**cfg))
    ref.eval()
    port = pt.MoEGPTForCausalLM(pt.MoEGPTConfig(**cfg), device="cpu")
    pt.load_reference_state(port, _state(ref))
    prompts = [list(np.random.RandomState(0).randint(1, 97, size=n))
               for n in (3, 7, 12)]
    return ref, port, prompts


def _ref_tokens(ref, prompts, n):
    return [np.asarray(ref.generate(paddle.to_tensor(
        np.asarray([p], np.int64)), max_new_tokens=n).numpy())[0].tolist()
        for p in prompts]


def test_engine_greedy_tokens_match_reference_generate(served):
    ref, port, prompts = served
    want = _ref_tokens(ref, prompts, 6)
    eng = pt.GenerationEngine(port, device="cpu", num_blocks=64,
                              max_batch=3, max_model_len=64,
                              prefill_chunk=16)
    assert eng.generate(prompts, max_new_tokens=6) == want
    got = [port.generate(torch.tensor([p]), max_new_tokens=6)[0].tolist()
           for p in prompts]
    assert got == want


def test_engine_tokens_match_reference_across_preemption(served):
    ref, port, prompts = served
    want = _ref_tokens(ref, prompts, 20)
    eng = pt.GenerationEngine(port, device="cpu", num_blocks=8,
                              block_size=4, max_batch=3, max_model_len=64)
    ids = [eng.add_request(p, max_new_tokens=20) for p in prompts]
    while eng.has_unfinished():
        eng.step()
    assert [eng.result(i) for i in ids] == want
    assert sum(eng._results[i].preemptions for i in ids) > 0
