"""LLaMA in the port vs the JAX reference, from the same weights and inputs.

Inputs come from numpy seeds; the reference's weights go to the port
through ``convert.load_reference_state`` (its rope buffers included).

* RMS norm, the port's plain kernel versions (what the CUDA kernels are
  held to on the card) against ``pk.fused_rms_norm`` called directly in
  interpret mode, and its gradients against ``jax.vjp`` with a
  non-uniform upstream gradient, at 37 and 300 rows (not multiples of
  the reference's row block).  f32: output and dx within 1e-5 abs + rel,
  dgamma (a sum over up to 300 rows in another order) 1e-4; bf16: 2e-2
  (about two bf16 ulps at unit scale) for values rounded once to bf16.
* ``F.rms_norm`` without a weight against the reference's composite, f32
  within 1e-6 and bf16 within one bf16 rounding (2^-7 rel); with a
  weight the port runs its kernel, which rounds once where the
  composite rounds ``x * rstd`` and then the product with the weight: f32
  within 1e-6, bf16 within 2^-7 abs + 2^-7 rel, one bf16 ulp.
* ``_rope_tables`` bit-equal to the reference's, ``apply_rotary_pos_emb``
  within 1e-6 (f32) and exactly equal in bf16 for bf16 tables.
* A tiny GQA LLaMA (vocab 256, hidden 64, 2 layers, 4 heads, 2 kv heads,
  ffn 128): f32 logits and loss within 1e-4 abs + rel; every step-1
  gradient and every parameter after 3 AdamW steps within 1e-4, with and
  without ``use_recompute``; under ``auto_cast(bf16, O1)`` on both sides
  the loss within 1e-3 relative and every gradient within 5e-2 of that
  gradient's largest magnitude (the port's RMS-norm kernel and its
  attention round bf16 at other places than the reference's composites;
  3-6x the largest deviations seen, 1.7e-4 and 1.3e-2).  The reference's
  Pallas gate is closed on this CPU, so its model runs its XLA
  composites; the port's its plain kernel versions.
* ``generate()``: greedy and seeded sampled tokens identical to the
  reference's; the dense cache holds the kv heads.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as ref_llama
from paddle_tpu.models.generation import generate as ref_generate
from paddle_tpu.models.gpt import GPTConfig as RefGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.ops import pallas_kernels as pk

import paddle_tpu_torch as pt
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.models import llama as port_llama

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

TINY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=128, max_position_embeddings=64)
ATOL = RTOL = 1e-4


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    if hasattr(t, "numpy"):         # a reference Tensor
        t = t.numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _state(ref):
    return {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}


def _pair(seed=11, **over):
    cfg = dict(TINY, **over)
    paddle.seed(seed)
    ref = ref_llama.LlamaForCausalLM(ref_llama.LlamaConfig(**cfg))
    port = pt.LlamaForCausalLM(pt.LlamaConfig(**cfg), device="cpu")
    pt.load_reference_state(port, _state(ref))
    return ref, port


def _batch(seed=0, b=2, s=24):
    ids = np.random.default_rng(seed).integers(0, 256, (b, s))
    labels = ids.copy()
    labels[0, 5] = -100                       # the loss's ignore index
    return ids, labels


# ---------------------------------------------------------------------
# RMS norm
# ---------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [37, 300])
def test_rms_norm_matches_pallas_forward_and_vjp(dtype, rows):
    rng = np.random.default_rng(70 + rows)
    n = 96
    x = rng.standard_normal((rows, n), np.float32) * 2 + 0.5
    gamma = rng.standard_normal(n, np.float32) + 1
    dout = rng.standard_normal((rows, n), np.float32)
    jx, jg = (jnp.asarray(a).astype(_JAX[dtype]) for a in (x, gamma))
    out_ref, vjp = jax.vjp(lambda a, g: pk.fused_rms_norm(a, g), jx, jg)
    dx_ref, dg_ref = vjp(jnp.asarray(dout).astype(_JAX[dtype]))
    tx, tg = (torch.from_numpy(a).to(_TORCH[dtype]).requires_grad_()
              for a in (x, gamma))
    out = tops.rms_norm(tx, tg)
    out.backward(torch.from_numpy(dout).to(_TORCH[dtype]))
    tol = 1e-5 if dtype == "float32" else 2e-2
    sum_tol = 1e-4 if dtype == "float32" else 2e-2
    assert out.dtype == tx.grad.dtype == tg.grad.dtype == _TORCH[dtype]
    for got, want, t in ((out, out_ref, tol), (tx.grad, dx_ref, tol),
                         (tg.grad, dg_ref, sum_tol)):
        np.testing.assert_allclose(_np(got), _np(want), atol=t, rtol=t)
    # the saved statistic: f32 rstd, one per row
    _, rstd = tops.fused_rms_norm(tx.detach(), tg.detach())
    assert rstd.dtype == torch.float32 and rstd.shape == (rows,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weighted", [False, True])
def test_functional_rms_norm_matches_reference(dtype, weighted):
    rng = np.random.default_rng(80)
    x = rng.standard_normal((3, 5, 48), np.float32) * 3
    w = rng.standard_normal(48, np.float32) + 1
    rx = paddle.to_tensor(x).astype(dtype)
    tx = torch.from_numpy(x).to(_TORCH[dtype])
    if weighted:
        want = paddle.nn.functional.rms_norm(
            rx, paddle.to_tensor(w).astype(dtype), 1e-6)
        got = pt.nn.functional.rms_norm(tx, torch.from_numpy(w).to(
            _TORCH[dtype]), 1e-6)
    else:
        want = paddle.nn.functional.rms_norm(rx, epsilon=1e-6)
        got = pt.nn.functional.rms_norm(tx, epsilon=1e-6)
    assert got.dtype == _TORCH[dtype] and got.shape == (3, 5, 48)
    if dtype == "float32":
        tol = (1e-6, 1e-6)
    else:
        tol = (2.0 ** -7, 2.0 ** -7) if weighted else (0.0, 2.0 ** -7)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol[0],
                               rtol=tol[1])


def test_functional_rms_norm_runs_in_f32_under_o1():
    x = torch.randn(4, 32).to(torch.bfloat16)
    w = torch.ones(32)
    with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
        assert pt.nn.functional.rms_norm(x, w).dtype == torch.float32
        assert pt.nn.functional.rms_norm(x).dtype == torch.float32
        rx = paddle.to_tensor(np.ones((4, 32), np.float32)).astype(
            "bfloat16")
    with paddle.amp.auto_cast(dtype="bfloat16", level="O1"):
        want = paddle.nn.functional.rms_norm(rx, paddle.to_tensor(
            np.ones(32, np.float32)))
    assert str(want.dtype).endswith("float32")


def test_rms_norm_layer_defaults():
    layer = pt.nn.RMSNorm(24, device="cpu")
    assert layer.epsilon == 1e-6
    assert torch.equal(layer.weight.detach(), torch.ones(24))
    x = torch.randn(2, 24, requires_grad=True)
    layer(x).sum().backward()
    assert layer.weight.grad.shape == (24,) and x.grad.shape == (2, 24)


# ---------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------
@pytest.mark.parametrize("head_dim,max_pos,theta", [(16, 64, 10000.0),
                                                    (128, 4096, 10000.0),
                                                    (64, 100, 500000.0)])
def test_rope_tables_bit_equal_reference(head_dim, max_pos, theta):
    got = port_llama._rope_tables(head_dim, max_pos, theta)
    want = ref_llama._rope_tables(head_dim, max_pos, theta)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rotary_pos_emb_matches_reference(dtype):
    rng = np.random.default_rng(90)
    q = rng.standard_normal((2, 7, 4, 16), np.float32)
    k = rng.standard_normal((2, 7, 2, 16), np.float32)
    cos, sin = (t[3:10] for t in port_llama._rope_tables(16, 32, 10000.0))
    want = ref_llama.apply_rotary_pos_emb(
        *(paddle.to_tensor(a).astype(dtype) for a in (q, k, cos, sin)))
    got = port_llama.apply_rotary_pos_emb(
        *(torch.from_numpy(a).to(_TORCH[dtype]) for a in (q, k, cos, sin)))
    for g, w in zip(got, want):
        assert g.dtype == _TORCH[dtype]
        if dtype == "float32":
            np.testing.assert_allclose(_np(g), _np(w), atol=1e-6, rtol=1e-6)
        else:
            np.testing.assert_array_equal(_np(g), _np(w))


# ---------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------
def test_state_names_and_shapes_match_reference():
    paddle.seed(5)
    ref = ref_llama.LlamaForCausalLM(ref_llama.LlamaConfig(**TINY))
    port = pt.LlamaForCausalLM(pt.LlamaConfig(**TINY), device="cpu")
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    assert "llama.rope_cos" in got and "lm_head.weight" in got
    assert all(p.param_name == n for n, p in port.named_parameters())
    assert len(list(port.parameters())) == len(want) - 2
    # the configuration's defaults, the reference's
    cfg = pt.LlamaConfig(**pt.LLAMA_7B)
    assert cfg.num_key_value_heads == 32 and cfg.rms_norm_eps == 1e-6
    assert pt.LLAMA_7B == ref_llama.LLAMA_7B


def test_rope_buffers_take_the_model_dtype():
    port = pt.LlamaForCausalLM(pt.LlamaConfig(**TINY), device="cpu",
                               dtype="bfloat16")
    cos = port.llama.rope_cos
    assert cos.dtype == torch.bfloat16 and cos.shape == (64, 16)
    want = port_llama._rope_tables(16, 64, 10000.0)[0]
    assert torch.equal(cos, torch.from_numpy(want).to(torch.bfloat16))
    paddle.seed(5)
    ref = ref_llama.LlamaForCausalLM(ref_llama.LlamaConfig(**TINY))
    ref.astype("bfloat16")
    np.testing.assert_array_equal(_np(ref.llama.rope_cos), _np(cos))


@pytest.mark.parametrize("recompute", [False, True])
def test_logits_and_loss_match_reference(recompute):
    ref, port = _pair(use_recompute=recompute)
    ids, labels = _batch()
    rl, rlogits = ref(paddle.to_tensor(ids), paddle.to_tensor(labels))
    pl, plogits = port(torch.from_numpy(ids), torch.from_numpy(labels))
    np.testing.assert_allclose(_np(plogits), _np(rlogits), atol=ATOL,
                               rtol=RTOL)
    assert abs(float(pl.detach()) - float(rl.numpy())) \
        <= ATOL + RTOL * abs(float(rl.numpy()))
    assert torch.equal(port(torch.from_numpy(ids)), plogits)


def _train(ref, port, steps, amp=False):
    ids, labels = _batch()
    ref_opt = paddle.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                     parameters=ref.parameters())
    port_opt = pt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                  parameters=port.parameters())
    losses, grads = [], None
    for step in range(steps):
        if amp:
            with paddle.amp.auto_cast(dtype="bfloat16", level="O1"):
                rl, _ = ref(paddle.to_tensor(ids), paddle.to_tensor(labels))
            with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
                pl, _ = port(torch.from_numpy(ids), torch.from_numpy(labels))
        else:
            rl, _ = ref(paddle.to_tensor(ids), paddle.to_tensor(labels))
            pl, _ = port(torch.from_numpy(ids), torch.from_numpy(labels))
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


@pytest.mark.parametrize("recompute", [False, True])
def test_adamw_f32_grads_and_params_match_reference(recompute):
    ref, port = _pair(use_recompute=recompute)
    losses, grads = _train(ref, port, steps=3)
    for want, got in losses:
        assert abs(got - want) <= ATOL + RTOL * abs(want)
    assert losses[-1][1] < losses[0][1]
    assert len(grads) == len(list(port.parameters()))
    for name, (want, got) in grads.items():
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=name)
    own = dict(port.named_parameters())
    for name, p in ref.named_parameters():
        np.testing.assert_allclose(own[name].detach().numpy(), _np(p),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


def test_bf16_o1_loss_and_grads_match_reference():
    ref, port = _pair(use_recompute=True)
    losses, grads = _train(ref, port, steps=1, amp=True)
    (want, got), = losses
    assert abs(got - want) <= 1e-3 * abs(want)
    for name, (want, got) in grads.items():
        assert got.dtype == np.float32, name     # f32 master weights
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=5e-2 * scale, rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------
# generate()
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def gen_models():
    ref, port = _pair(seed=21)
    ref.eval()
    return ref, port.eval()


@pytest.mark.parametrize("kw", [
    dict(max_new_tokens=12),
    dict(max_new_tokens=10, do_sample=True, seed=5),
    dict(max_new_tokens=10, do_sample=True, top_k=20, top_p=0.7,
         temperature=1.3, seed=11),
], ids=["greedy", "sample", "top_k_top_p"])
def test_generate_tokens_match_reference(gen_models, kw):
    ref, port = gen_models
    ids = np.random.default_rng(3).integers(0, 256, (2, 7))
    want = np.asarray(ref_generate(ref, ids, **kw).numpy())
    got = port.generate(torch.from_numpy(ids), **kw)
    assert got.dtype == torch.int64
    assert got.shape == (2, 7 + kw["max_new_tokens"])
    np.testing.assert_array_equal(got.numpy(), want)


def test_dense_cache_holds_kv_heads_and_matches_full_forward(gen_models):
    _, port = gen_models
    ids = np.random.default_rng(4).integers(0, 256, (2, 13))
    with torch.no_grad():
        full = port(torch.from_numpy(ids))
        logits, cache = port(torch.from_numpy(ids[:, :9]), use_cache=True)
        steps = [logits]
        for t in range(9, 13):
            logits, cache = port(torch.from_numpy(ids[:, t:t + 1]),
                                 cache=cache, use_cache=True)
            steps.append(logits)
    # 2 kv heads of 16, not the 4 query heads GQA repeats them to
    assert len(cache) == 2
    assert all(k.shape == v.shape == (2, 13, 2, 16) for k, v in cache)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------
# convert.load_reference_state
# ---------------------------------------------------------------------
def test_load_reference_state_takes_buffers_and_still_raises():
    ref, port = _pair(seed=31)
    state = _state(ref)
    assert "llama.rope_sin" in state
    # a bf16 reference state (its rope tables too) into a bf16 model
    paddle.seed(31)
    ref16 = ref_llama.LlamaForCausalLM(ref_llama.LlamaConfig(**TINY))
    ref16.astype("bfloat16")
    port16 = pt.LlamaForCausalLM(pt.LlamaConfig(**TINY), device="cpu",
                                 dtype=torch.bfloat16)
    pt.load_reference_state(port16, _state(ref16))
    np.testing.assert_array_equal(
        _np(port16.lm_head.weight), _np(ref16.lm_head.weight))
    with pytest.raises(KeyError, match="unexpected"):
        pt.load_reference_state(port, dict(state, **{
            "llama.rope_extra": state["llama.rope_cos"]}))
    del state["llama.rope_cos"]
    with pytest.raises(KeyError, match="missing"):
        pt.load_reference_state(port, state)
    # a GPT state still loads, and an extra key still raises
    gcfg = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                num_attention_heads=2, max_position_embeddings=16)
    paddle.seed(32)
    gref = RefGPT(RefGPTConfig(**gcfg))
    gport = pt.GPTForCausalLM(pt.GPTConfig(**gcfg), device="cpu")
    gstate = _state(gref)
    pt.load_reference_state(gport, gstate)
    np.testing.assert_array_equal(_np(gport.gpt.wte.weight),
                                  _np(gref.gpt.wte.weight))
    with pytest.raises(KeyError, match="unexpected"):
        pt.load_reference_state(gport, dict(gstate, extra=np.zeros(1)))
