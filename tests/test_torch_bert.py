"""BERT and ERNIE in the port vs the JAX reference, from the same weights
and inputs.

Inputs come from numpy seeds; the reference's weights go to the port
through ``convert.load_reference_state``.  The reference's Pallas gate is
closed on this CPU, so its models run their XLA composites; the port's
run their plain kernel versions.

* The fused residual layer norm, the port's plain version (what the CUDA
  kernel is held to on the card) against ``pf.fused_layer_norm_residual``
  called directly in interpret mode (and the sum ``s``, ``mu`` and
  ``rstd`` its forward saves), and its gradients against ``jax.vjp`` with
  a non-uniform upstream gradient, at 37 and 300 rows (not multiples of
  the reference's 256-row block) and widths 64 and 768.  f32: the output,
  ``s`` and dx within 1e-5 abs + rel, ``mu``/``rstd`` within 1e-6,
  dgamma and dbeta (sums over up to 300 rows in another order) within
  1e-4; bf16: 2e-2 (about two bf16 ulps at unit scale).  The gradient of
  the residual is the gradient of x, exactly.
* ``F.fused_residual_layer_norm`` against the reference's composite
  (norm.py:80-93): f32 within 1e-5; bf16 within 2^-7 abs + 2^-7 rel, the
  composite rounding the normalised value, the product with the weight
  and the sum with the bias in turn, the kernel once.  Under O1 both run
  in f32.
* A tiny BERT MLM (vocab 256, hidden 64, 2 layers, 4 heads, ffn 128) at
  dropout 0, with token types and labels at -100: f32 logits and loss
  within 1e-4 abs + rel; every step-1 gradient and every parameter after
  3 AdamW steps within 1e-4, but for one slice: the key part of each
  ``qkv.bias``.  Adding a constant to every key of a row leaves its
  softmax unchanged, so that gradient is 0 in exact arithmetic (both
  sides give rounding noise, ~1e-8 against ~0.2 for the query part; the
  test holds it below 1e-6 of the layer's largest bias gradient), and
  Adam turns noise into steps of +-lr of either sign: after 3 steps at
  lr 1e-4 that slice is held to 2 * 3 * lr, the most two such walks can
  differ.  Under ``auto_cast(bf16, O1)`` on both sides
  the loss within 1e-3 relative and every gradient within 5e-2 of that
  gradient's largest magnitude, the LLaMA test's bounds (the port's
  kernels round bf16 once where the reference's composites round in
  turn).
* ERNIE in eval (the flash kernels' plain version against the reference's
  composite attention): the MLM logits, the pooled output and the
  classification logits and loss within 1e-4, with task types given, with
  ``task_type_ids=None`` (task 0) and with ``use_task_id=False``.
* Attention dropout on the model's generator: one seed gives one mask,
  the share of dropped probabilities is p within 0.01 (6 standard
  deviations of 32768 draws), kept ones are divided by 1 - p exactly, eval
  is the identity, and no flash call is made while it is on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import bert as ref_bert
from paddle_tpu.models import ernie as ref_ernie
from paddle_tpu.ops import pallas_fused as pf

import paddle_tpu_torch as pt
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.nn import functional as F

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

TINY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
ATOL = RTOL = 1e-4


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    if hasattr(t, "numpy"):         # a reference Tensor
        t = t.numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _state(ref):
    return {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}


def _port_of(ref, make):
    port = make()
    pt.load_reference_state(port, _state(ref))
    return port


# ---------------------------------------------------------------------
# the fused residual layer norm
# ---------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [64, 768])
@pytest.mark.parametrize("rows", [37, 300])
def test_ln_residual_matches_pallas_forward_and_vjp(dtype, rows, n):
    rng = np.random.default_rng(100 + rows + n)
    x = rng.standard_normal((rows, n), np.float32) * 2 + 0.5
    r = rng.standard_normal((rows, n), np.float32)
    gamma = rng.standard_normal(n, np.float32) * 0.5 + 1
    beta = rng.standard_normal(n, np.float32) * 0.2
    dout = rng.standard_normal((rows, n), np.float32)
    j = [jnp.asarray(a).astype(_JAX[dtype]) for a in (x, r, gamma, beta)]
    out_ref, vjp = jax.vjp(
        lambda a, b, g, bb: pf.fused_layer_norm_residual(a, b, g, bb), *j)
    dx_ref, dr_ref, dg_ref, db_ref = vjp(jnp.asarray(dout).astype(
        _JAX[dtype]))
    _, (s_ref, _, mu_ref, rstd_ref) = pf._fused_ln_residual_2d_fwd(
        *j, 1e-5)
    tx, tr, tg, tb = (torch.from_numpy(a).to(_TORCH[dtype]).requires_grad_()
                      for a in (x, r, gamma, beta))
    out = tops.layer_norm_residual(tx, tr, tg, tb)
    out.backward(torch.from_numpy(dout).to(_TORCH[dtype]))
    _, s, mu, rstd = tops.fused_layer_norm_residual(
        *(t.detach() for t in (tx, tr, tg, tb)))
    tol = 1e-5 if dtype == "float32" else 2e-2
    sum_tol = 1e-4 if dtype == "float32" else 2e-2
    assert out.dtype == s.dtype == tx.grad.dtype == _TORCH[dtype]
    assert mu.dtype == rstd.dtype == torch.float32 and mu.shape == (rows,)
    for got, want, t in ((out, out_ref, tol), (s, s_ref, tol),
                         (tx.grad, dx_ref, tol), (tr.grad, dr_ref, tol),
                         (tg.grad, dg_ref, sum_tol),
                         (tb.grad, db_ref, sum_tol)):
        np.testing.assert_allclose(_np(got), _np(want), atol=t, rtol=t)
    for got, want in ((mu, mu_ref), (rstd, rstd_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:rows, 0],
                                   atol=1e-6, rtol=1e-6)
    assert torch.equal(tx.grad, tr.grad)    # d(x) == d(residual)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_functional_fused_residual_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(110)
    x = rng.standard_normal((3, 7, 96), np.float32) * 2 + 0.3
    r = rng.standard_normal((3, 7, 96), np.float32)
    w = rng.standard_normal(96, np.float32) * 0.5 + 1
    b = rng.standard_normal(96, np.float32) * 0.2
    want = paddle.nn.functional.fused_residual_layer_norm(
        *(paddle.to_tensor(a).astype(dtype) for a in (x, r)), 96,
        *(paddle.to_tensor(a).astype(dtype) for a in (w, b)), 1e-12)
    got = F.fused_residual_layer_norm(
        *(torch.from_numpy(a).to(_TORCH[dtype]) for a in (x, r)), 96,
        *(torch.from_numpy(a).to(_TORCH[dtype]) for a in (w, b)), 1e-12)
    assert got.dtype == _TORCH[dtype] and got.shape == (3, 7, 96)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    layer = pt.nn.LayerNorm(96, 1e-12, device="cpu")
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
        layer.bias.copy_(torch.from_numpy(b))
    fused = layer.forward_fused(torch.from_numpy(x), torch.from_numpy(r))
    assert torch.equal(fused, F.fused_residual_layer_norm(
        torch.from_numpy(x), torch.from_numpy(r), 96, layer.weight,
        layer.bias, 1e-12))
    with pytest.raises(NotImplementedError):
        F.fused_residual_layer_norm(torch.from_numpy(x), torch.from_numpy(r),
                                    96)


def test_functional_fused_residual_layer_norm_runs_in_f32_under_o1():
    x = torch.randn(4, 32).to(torch.bfloat16)
    w, b = torch.ones(32), torch.zeros(32)
    with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
        assert F.fused_residual_layer_norm(x, x, 32, w, b).dtype \
            == torch.float32
    rx = paddle.to_tensor(np.ones((4, 32), np.float32)).astype("bfloat16")
    with paddle.amp.auto_cast(dtype="bfloat16", level="O1"):
        want = paddle.nn.functional.fused_residual_layer_norm(
            rx, rx, 32, paddle.to_tensor(np.ones(32, np.float32)),
            paddle.to_tensor(np.zeros(32, np.float32)))
    assert str(want.dtype).endswith("float32")


# ---------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------
def _bert_pair(seed=11, **over):
    cfg = dict(TINY, **over)
    paddle.seed(seed)
    ref = ref_bert.BertForMaskedLM(ref_bert.BertConfig(**cfg))
    return ref, _port_of(ref, lambda: pt.BertForMaskedLM(
        pt.BertConfig(**cfg), device="cpu"))


def _mlm_batch(seed=0, b=2, s=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (b, s))
    token_types = (np.arange(s)[None, :] >= s // 2).repeat(b, 0).astype(
        np.int64)
    labels = ids.copy()
    labels[rng.random((b, s)) < 0.85] = -100   # ~15% masked positions
    labels[0, 0] = ids[0, 0]                   # at least one
    return ids, token_types, labels


def test_bert_state_names_shapes_and_defaults_match_reference():
    paddle.seed(5)
    ref = ref_bert.BertForMaskedLM(ref_bert.BertConfig(**TINY))
    port = pt.BertForMaskedLM(pt.BertConfig(**TINY), device="cpu")
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    assert "bert.encoder.1.attention.qkv.weight" in got
    assert got["cls.transform.weight"] == (64, 64) and "cls.ln.bias" in got
    assert all(p.param_name == n for n, p in port.named_parameters())
    assert vars(pt.BertConfig()) == vars(ref_bert.BertConfig())
    assert pt.BertConfig().attention_probs_dropout_prob == 0.1
    assert port.training


def test_bert_use_scan_layers_raises():
    with pytest.raises(NotImplementedError, match="use_scan_layers"):
        pt.BertForMaskedLM(pt.BertConfig(**dict(TINY, use_scan_layers=True)),
                           device="cpu")


def test_bert_logits_and_loss_match_reference():
    ref, port = _bert_pair()
    ids, tt, labels = _mlm_batch()
    rl, rlogits = ref(paddle.to_tensor(ids), paddle.to_tensor(tt),
                      labels=paddle.to_tensor(labels))
    pl, plogits = port(torch.from_numpy(ids), torch.from_numpy(tt),
                       labels=torch.from_numpy(labels))
    np.testing.assert_allclose(_np(plogits), _np(rlogits), atol=ATOL,
                               rtol=RTOL)
    assert abs(float(pl.detach()) - float(rl.numpy())) \
        <= ATOL + RTOL * abs(float(rl.numpy()))
    assert torch.equal(port(torch.from_numpy(ids), torch.from_numpy(tt)),
                       plogits)


def _train(ref, port, steps, amp=False, lr=1e-4):
    ids, tt, labels = _mlm_batch()
    ref_opt = paddle.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                                     parameters=ref.parameters())
    port_opt = pt.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                                  parameters=port.parameters())
    rin = [paddle.to_tensor(a) for a in (ids, tt, labels)]
    tin = [torch.from_numpy(a) for a in (ids, tt, labels)]
    losses, grads = [], None
    for step in range(steps):
        if amp:
            with paddle.amp.auto_cast(dtype="bfloat16", level="O1"):
                rl, _ = ref(rin[0], rin[1], labels=rin[2])
            with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
                pl, _ = port(tin[0], tin[1], labels=tin[2])
        else:
            rl, _ = ref(rin[0], rin[1], labels=rin[2])
            pl, _ = port(tin[0], tin[1], labels=tin[2])
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


def test_bert_adamw_f32_grads_and_params_match_reference():
    ref, port = _bert_pair()
    steps, lr, h = 3, 1e-4, TINY["hidden_size"]
    losses, grads = _train(ref, port, steps=steps, lr=lr)
    for want, got in losses:
        assert abs(got - want) <= ATOL + RTOL * abs(want)
    assert losses[-1][1] < losses[0][1]
    assert len(grads) == len(list(port.parameters()))
    for name, (want, got) in grads.items():
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=name)
        if name.endswith("qkv.bias"):    # the key slice's gradient is 0
            for g in (want, got):
                assert np.abs(g[h:2 * h]).max() \
                    <= 1e-6 * np.abs(g).max(), name
    own = dict(port.named_parameters())
    for name, p in ref.named_parameters():
        got, want = own[name].detach().numpy(), _np(p)
        if name.endswith("qkv.bias"):
            np.testing.assert_allclose(got[h:2 * h], want[h:2 * h],
                                       atol=2 * steps * lr, rtol=0,
                                       err_msg=name)
            got, want = np.delete(got, np.s_[h:2 * h]), \
                np.delete(want, np.s_[h:2 * h])
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_bert_bf16_o1_loss_and_grads_match_reference():
    ref, port = _bert_pair()
    losses, grads = _train(ref, port, steps=1, amp=True)
    (want, got), = losses
    assert abs(got - want) <= 1e-3 * abs(want)
    for name, (want, got) in grads.items():
        assert got.dtype == np.float32, name     # f32 master weights
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=5e-2 * scale, rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------
# ERNIE
# ---------------------------------------------------------------------
def _ernie_pair(cls_ref, cls_port, seed=13, **over):
    cfg = dict(TINY, **over)
    paddle.seed(seed)
    ref = cls_ref(ref_ernie.ErnieConfig(**cfg))
    ref.eval()
    port = _port_of(ref, lambda: cls_port(pt.ErnieConfig(**cfg),
                                          device="cpu"))
    return ref, port.eval()


@pytest.mark.parametrize("use_task_id", [True, False])
@pytest.mark.parametrize("task_types", [True, False],
                         ids=["task_types", "task_types_none"])
def test_ernie_heads_match_reference(use_task_id, task_types):
    ids, tt, labels = _mlm_batch(seed=4)
    task = np.random.default_rng(5).integers(0, 3, ids.shape)
    rargs = [paddle.to_tensor(ids), paddle.to_tensor(tt),
             paddle.to_tensor(task) if task_types else None]
    targs = [torch.from_numpy(ids), torch.from_numpy(tt),
             torch.from_numpy(task) if task_types else None]
    ref, port = _ernie_pair(ref_ernie.ErnieForMaskedLM, pt.ErnieForMaskedLM,
                            use_task_id=use_task_id)
    assert ("ernie.embeddings.task_type_embeddings.weight"
            in port.state_dict()) == use_task_id
    with torch.no_grad():
        np.testing.assert_allclose(_np(port(*targs)), _np(ref(*rargs)),
                                   atol=ATOL, rtol=RTOL)
        _, pooled = port.ernie(*targs)
    _, rpooled = ref.ernie(*rargs)
    assert pooled.shape == (2, 64)
    np.testing.assert_allclose(_np(pooled), _np(rpooled), atol=ATOL,
                               rtol=RTOL)

    ref, port = _ernie_pair(ref_ernie.ErnieForSequenceClassification,
                            pt.ErnieForSequenceClassification,
                            use_task_id=use_task_id)
    cls_labels = np.array([1, 0])
    rl, rlogits = ref(*rargs, labels=paddle.to_tensor(cls_labels))
    with torch.no_grad():
        pl, plogits = port(*targs, labels=torch.from_numpy(cls_labels))
    assert plogits.shape == (2, 2)
    np.testing.assert_allclose(_np(plogits), _np(rlogits), atol=ATOL,
                               rtol=RTOL)
    assert abs(float(pl) - float(rl.numpy())) \
        <= ATOL + RTOL * abs(float(rl.numpy()))


def test_ernie_embeddings_apply_no_dropout():
    cfg = pt.ErnieConfig(**dict(TINY, hidden_dropout_prob=0.5))
    model = pt.ErnieForMaskedLM(cfg, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (2, 9)))
    emb = model.ernie.embeddings
    assert model.training and emb.dropout.p == 0.5
    assert torch.equal(emb(ids), emb(ids))
    assert torch.equal(emb(ids), emb.layer_norm(
        emb._sum(ids, None) + emb.task_type_embeddings(torch.zeros_like(ids))))


# ---------------------------------------------------------------------
# attention dropout
# ---------------------------------------------------------------------
def _dropout_probe(p, seed, training=True, B=2, S=64, H=4):
    """Attention whose probabilities are uniform (q = k = 0) and whose
    values are the key's one-hot vector: each output row is its
    probabilities row after dropout."""
    q = torch.zeros(B, S, H, S)
    v = torch.eye(S)[None, :, None, :].expand(B, S, H, S).contiguous()
    gen = torch.Generator().manual_seed(seed)
    return F.scaled_dot_product_attention(q, q, v, dropout_p=p,
                                          training=training, generator=gen)


def test_attention_dropout_masks_follow_the_generator():
    p = 0.1
    out = _dropout_probe(p, seed=3)
    assert torch.equal(out, _dropout_probe(p, seed=3))
    assert not torch.equal(out, _dropout_probe(p, seed=4))
    dropped = float((out == 0).float().mean())
    assert abs(dropped - p) <= 0.01
    kept = out[out != 0]
    assert torch.equal(kept, torch.full_like(kept, (1.0 / 64) / (1 - p)))
    # eval, or dropout 0, is the identity on the probabilities
    for plain in (_dropout_probe(p, seed=3, training=False),
                  _dropout_probe(0.0, seed=3)):
        assert torch.allclose(plain, torch.full_like(plain, 1.0 / 64))


def test_attention_dropout_takes_the_composite(monkeypatch):
    def no_flash(*a, **k):
        raise AssertionError("flash attention called")
    monkeypatch.setattr(tops, "flash_attention", no_flash)
    q = torch.randn(1, 8, 2, 16)
    gen = torch.Generator().manual_seed(0)
    out = F.scaled_dot_product_attention(q, q, q, dropout_p=0.5,
                                         training=True, generator=gen)
    assert out.shape == q.shape
    with pytest.raises(AssertionError, match="flash attention called"):
        F.scaled_dot_product_attention(q, q, q, dropout_p=0.5,
                                       training=False)


def test_bert_dropout_masks_follow_the_model_seed():
    cfg = pt.BertConfig(**dict(TINY, hidden_dropout_prob=0.1,
                               attention_probs_dropout_prob=0.1))
    ids, tt, labels = (torch.from_numpy(a) for a in _mlm_batch())
    a, b = (pt.BertForMaskedLM(cfg, device="cpu", seed=7) for _ in range(2))
    la, lb = (float(m(ids, tt, labels)[0].detach()) for m in (a, b))
    assert la == lb
    assert float(a(ids, tt, labels)[0].detach()) != la   # fresh masks
    a.eval()
    assert torch.equal(a(ids, tt), a(ids, tt))
