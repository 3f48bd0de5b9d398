"""The port's Transformer family against the reference's
(``paddle_tpu.nn.layer.transformer``).

Weights come from the reference through ``load_reference_state`` (the
``state_dict`` names are equal), inputs from a seeded numpy draw, dropout
0.  Held in f32 within 1e-5 relative plus 1e-5 of the largest magnitude
(at least 1) of each output (2e-5 for the stacks: more sums in other
orders) and of the gradients of the inputs and of every
parameter under one seeded upstream gradient; under ``auto_cast(dtype=
"bfloat16")`` (O1) in both packages, within 2^-5 of the largest
magnitude (the two round their bf16 products at other places, through
several layers).  The key projection's bias has a zero gradient in
exact arithmetic (softmax ignores a per-row constant), so its rounding
noise is held against the largest gradient of the model.

* ``MultiHeadAttention``: self-attention, cross-attention (``Sq != Sk``,
  ``kdim``/``vdim``), an additive mask, the incremental ``Cache`` and the
  projected ``StaticCache``, ``gen_cache``.
* The encoder and decoder layers, post-norm and pre-norm, with and
  without biases (``bias_attr=False``: the feed-forward block leaves the
  epilogue for ``activation(linear1(x))``), relu and gelu.
* ``Transformer`` at d_model 64, 4 heads, 2 + 2 layers, forward and
  backward with the causal ``tgt_mask``.  relu is held in f32 only: in
  bf16 the packages round pre-activations at its kink to either side,
  which flips their gradients; bf16 takes gelu.
* The reference's incremental-cache properties (its ``tests/test_nn.py``
  decoder and encoder cache tests) and the port's cached steps against
  the reference's.
* Routing, by spies on the kernel entry points (on the CPU they run the
  plain versions): the flash kernel for the unmasked attentions only,
  the epilogue for the feed-forward block with biases, the residual
  layer norm for post-norm sublayers, layer norm for pre-norm ones.
* Quirks kept: the stack's layers start as copies of the first, values
  included; ``need_weights`` returns no weights.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as rnn

import paddle_tpu_torch as pt
from paddle_tpu_torch import ops

D, H, FF = 64, 4, 128


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.astype("float32").numpy(), np.float32)


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if tol < 1e-3:
        top = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got, want, atol=tol * top, rtol=tol,
                                   err_msg=what)
    else:
        err = float(np.abs(got - want).max()) / max(
            float(np.abs(want).max()), 1e-30)
        assert err <= tol, (what, err)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _copy(ref, port):
    """The reference's weights into the port (same names)."""
    pt.load_reference_state(port, {k: v.numpy() for k, v in
                                   ref.state_dict().items()})
    return port


def _hold(ref, port, arrays, call, tol=1e-5, bf16=False, masks=()):
    """``call(model, *inputs, *masks)`` in both packages: outputs, the
    inputs' gradients and every parameter's gradient."""
    rx = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    tx = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    rm = [None if m is None else paddle.to_tensor(m) for m in masks]
    tm = [None if m is None else torch.from_numpy(m) for m in masks]
    if bf16:
        with paddle.amp.auto_cast(dtype="bfloat16"):
            rout = call(ref, *rx, *rm)
        with pt.amp.auto_cast(dtype="bfloat16"):
            tout = call(port, *tx, *tm)
    else:
        rout, tout = call(ref, *rx, *rm), call(port, *tx, *tm)
    _close(tout, rout, tol, "output")
    up = _x(*tout.shape, seed=99)
    (rout.astype("float32") * paddle.to_tensor(up)).sum().backward()
    (tout.float() * torch.from_numpy(up)).sum().backward()
    for i, (r, t) in enumerate(zip(rx, tx)):
        _close(t.grad, r.grad, tol, f"gradient of input {i}")
    rg = {k: p.grad for k, p in ref.named_parameters()}
    top = max(float(np.abs(_np(g)).max()) for g in rg.values()
              if g is not None)
    for k, p in port.named_parameters():
        if rg[k] is None:     # unused by this forward, in both
            assert p.grad is None or not bool(p.grad.any()), k
            continue
        if k.endswith(("k_proj.bias", "qkv_proj.bias", "qkv.bias")):
            # the key bias (a slice of a fused qkv bias) has a gradient of
            # 0 in exact arithmetic (softmax ignores a per-row constant):
            # rounding noise, held against the largest gradient
            assert float(np.abs(_np(p.grad) - _np(rg[k])).max()) \
                <= tol * top, k
        else:
            _close(p.grad, rg[k], tol, k)


def _causal(s):
    return np.triu(np.full((s, s), -np.inf, np.float32), 1)


MHA_CASES = {
    "self": (dict(), lambda m, q: m(q), [_x(2, 5, D)], ()),
    "cross": (dict(kdim=32, vdim=48),
              lambda m, q, k, v: m(q, k, v),
              [_x(2, 5, D), _x(2, 7, 32, seed=1), _x(2, 7, 48, seed=2)], ()),
    "masked": (dict(), lambda m, q, mask: m(q, attn_mask=mask),
               [_x(2, 5, D)], (_causal(5),)),
    "no_bias": (dict(bias_attr=False), lambda m, q: m(q), [_x(2, 5, D)], ()),
}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name", list(MHA_CASES))
def test_multi_head_attention_matches_reference(name, bf16):
    kw, call, arrays, masks = MHA_CASES[name]
    paddle.seed(0)
    ref = rnn.MultiHeadAttention(D, H, **kw)
    port = _copy(ref, pt.nn.MultiHeadAttention(D, H, **kw, device="cpu"))
    _hold(ref, port, arrays, call, 2 ** -5 if bf16 else 1e-5, bf16, masks)


def test_multi_head_attention_caches():
    """``Cache``: each step's k/v appended (a prefix given verbatim to
    ``gen_cache`` too); ``StaticCache``: k/v projected once from the
    memory and used as they are; both packages alike."""
    paddle.seed(1)
    ref = rnn.MultiHeadAttention(D, H)
    port = _copy(ref, pt.nn.MultiHeadAttention(D, H, device="cpu"))
    x, mem = _x(2, 3, D), _x(2, 6, D, seed=1)
    rc = ref.gen_cache(paddle.to_tensor(x))
    tc = port.gen_cache(torch.from_numpy(x))
    assert tuple(tc.k.shape) == (2, 0, H, D // H)
    for t in range(3):
        r, rc = ref(paddle.to_tensor(x[:, t:t + 1]), cache=rc)
        p, tc = port(torch.from_numpy(x[:, t:t + 1]), cache=tc)
        _close(p, r, 1e-5, f"cached step {t}")
    assert isinstance(tc, pt.nn.MultiHeadAttention.Cache)
    _close(tc.k, rc.k, 1e-5)
    resumed = port.gen_cache(tc.k, tc.v)
    assert resumed.k is tc.k and resumed.v is tc.v
    st = pt.nn.MultiHeadAttention.StaticCache
    rs = ref.gen_cache(paddle.to_tensor(mem),
                       type=rnn.MultiHeadAttention.StaticCache)
    ts = port.gen_cache(torch.from_numpy(mem), type=st)
    r, rs2 = ref(paddle.to_tensor(x), cache=rs)
    p, ts2 = port(torch.from_numpy(x), cache=ts)
    assert ts2 is ts
    _close(p, r, 1e-5, "static cache")
    _close(ts.v, rs.v, 1e-5)


#: (normalize_before, bias_attr, activation, bf16): relu is held in f32
#: only, since in bf16 the two packages round pre-activations lying at
#: its kink to either side, which flips their gradients
LAYER_CASES = [(pre, bias, act, False) for pre in (False, True)
               for bias in (None, False) for act in ("relu", "gelu")] + [
    (pre, bias, "gelu", True) for pre in (False, True)
    for bias in (None, False)]


def _layer_kw(pre, bias, act):
    return dict(dropout=0.0, activation=act, normalize_before=pre,
                bias_attr=bias)


@pytest.mark.parametrize("pre,bias,act,bf16", LAYER_CASES)
def test_encoder_layer_matches_reference(pre, bias, act, bf16):
    paddle.seed(2)
    kw = _layer_kw(pre, bias, act)
    ref = rnn.TransformerEncoderLayer(D, H, FF, **kw)
    port = _copy(ref, pt.nn.TransformerEncoderLayer(D, H, FF, **kw,
                                                    device="cpu"))
    _hold(ref, port, [_x(2, 5, D)], lambda m, s: m(s),
          2 ** -5 if bf16 else 1e-5, bf16)


@pytest.mark.parametrize("pre,bias,act,bf16", LAYER_CASES)
def test_decoder_layer_matches_reference(pre, bias, act, bf16):
    paddle.seed(3)
    kw = _layer_kw(pre, bias, act)
    ref = rnn.TransformerDecoderLayer(D, H, FF, **kw)
    port = _copy(ref, pt.nn.TransformerDecoderLayer(D, H, FF, **kw,
                                                    device="cpu"))
    _hold(ref, port, [_x(2, 5, D), _x(2, 7, D, seed=1)],
          lambda m, t, mem, mask: m(t, mem, tgt_mask=mask),
          2 ** -5 if bf16 else 1e-5, bf16, masks=(_causal(5),))


#: (normalize_before, activation) of the module's Transformers
TRANSFORMERS = ((False, "relu"), (True, "gelu"), (False, "gelu"))


@pytest.fixture(scope="module")
def transformers():
    """Reference Transformers (64 wide, 4 heads, 2 + 2 layers, dropout 0)
    post-norm and pre-norm, and the port's with their weights."""
    out = {}
    for pre, act in TRANSFORMERS:
        paddle.seed(4)
        ref = rnn.Transformer(D, H, 2, 2, FF, dropout=0.0, activation=act,
                              normalize_before=pre)
        port = _copy(ref, pt.nn.Transformer(
            D, H, 2, 2, FF, dropout=0.0, activation=act,
            normalize_before=pre, device="cpu"))
        out[pre, act] = ref, port
    return out


@pytest.mark.parametrize("pre,act,bf16", [
    (False, "relu", False), (True, "gelu", False), (False, "gelu", True),
    (True, "gelu", True)])
def test_transformer_matches_reference(transformers, pre, act, bf16):
    ref, port = transformers[pre, act]
    ref.clear_gradients()
    port.zero_grad(set_to_none=True)
    assert sorted(ref.state_dict()) == sorted(port.state_dict())
    mask = np.asarray(port.generate_square_subsequent_mask(6, device="cpu"))
    np.testing.assert_array_equal(
        mask, rnn.Transformer.generate_square_subsequent_mask(6).numpy())
    _hold(ref, port, [_x(2, 5, D), _x(2, 6, D, seed=1)],
          lambda m, s, t, mask: m(s, t, tgt_mask=mask),
          2 ** -5 if bf16 else 2e-5, bf16, masks=(mask,))


def _spies(monkeypatch):
    calls = {n: 0 for n in ("flash_attention", "linear_act", "layer_norm",
                            "layer_norm_residual")}
    for name in calls:
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    return calls


@pytest.mark.parametrize("pre,act", TRANSFORMERS[:2])
def test_transformer_routes_as_the_reference(transformers, monkeypatch, pre,
                                             act):
    """Per forward of 2 + 2 layers with the causal ``tgt_mask``: flash for
    the encoder's self-attention and the cross-attention (4), the
    composite for the masked decoder self-attention; the epilogue for
    each feed-forward block (4); post-norm: 10 residual layer norms, none
    plain; pre-norm: 10 sublayer norms and 2 final norms, no residual
    one.  Attention dropout sends every attention to the composite in
    training; in eval the three unmasked attentions of 1 + 1 layers take
    flash."""
    _, port = transformers[pre, act]
    calls = _spies(monkeypatch)
    s, t = torch.from_numpy(_x(2, 5, D)), torch.from_numpy(_x(2, 6, D))
    port(s, t, tgt_mask=port.generate_square_subsequent_mask(6,
                                                             device="cpu"))
    assert calls == {"flash_attention": 4, "linear_act": 4,
                     "layer_norm": 12 if pre else 0,
                     "layer_norm_residual": 0 if pre else 10}
    dropped = pt.nn.Transformer(D, H, 1, 1, FF, dropout=0.0, attn_dropout=0.1,
                                device="cpu")
    calls["flash_attention"] = 0
    dropped(s, t)
    assert calls["flash_attention"] == 0
    dropped.eval()
    dropped(s, t)
    assert calls["flash_attention"] == 3


def test_decoder_incremental_cache_parity(monkeypatch):
    """The reference's ``test_transformer_decoder_incremental_cache_
    parity`` on the port: step-by-step decoding with ``gen_cache`` equals
    the full forward under a causal mask; the steps take the flash kernel
    (one query row, no mask); each step equals the reference's."""
    paddle.seed(0)
    S = 5
    ref = rnn.TransformerDecoder(rnn.TransformerDecoderLayer(
        16, 2, 32, dropout=0.0), 2)
    port = _copy(ref, pt.nn.TransformerDecoder(pt.nn.TransformerDecoderLayer(
        16, 2, 32, dropout=0.0, device="cpu"), 2))
    ref.eval()
    port.eval()
    tgt, mem = _x(2, S, 16), _x(2, 3, 16, seed=1)
    causal = np.triu(np.full((S, S), -1e9, np.float32), 1)
    full = port(torch.from_numpy(tgt), torch.from_numpy(mem),
                tgt_mask=torch.from_numpy(causal))
    calls = _spies(monkeypatch)
    caches = port.gen_cache(torch.from_numpy(mem))
    rcaches = ref.gen_cache(paddle.to_tensor(mem))
    outs = []
    for t in range(S):
        out, caches = port(torch.from_numpy(tgt[:, t:t + 1]),
                           torch.from_numpy(mem), cache=caches)
        rout, rcaches = ref(paddle.to_tensor(tgt[:, t:t + 1]),
                            paddle.to_tensor(mem), cache=rcaches)
        _close(out, rout, 1e-5, f"step {t}")
        outs.append(out)
    assert calls["flash_attention"] == 2 * 2 * S
    _close(torch.cat(outs, 1), full, 1e-5)
    zipped = port.gen_cache(torch.from_numpy(mem), do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2


def test_encoder_incremental_cache():
    paddle.seed(0)
    ref = rnn.TransformerEncoder(rnn.TransformerEncoderLayer(
        16, 2, 32, dropout=0.0), 2)
    port = _copy(ref, pt.nn.TransformerEncoder(pt.nn.TransformerEncoderLayer(
        16, 2, 32, dropout=0.0, device="cpu"), 2))
    port.eval()
    src = _x(2, 4, 16, seed=1)
    causal = np.triu(np.full((4, 4), -1e9, np.float32), 1)
    full = port(torch.from_numpy(src), src_mask=torch.from_numpy(causal))
    _close(full, ref(paddle.to_tensor(src),
                     src_mask=paddle.to_tensor(causal)), 1e-5)
    caches = port.gen_cache(torch.from_numpy(src))
    outs = []
    for t in range(4):
        out, caches = port(torch.from_numpy(src[:, t:t + 1]), cache=caches)
        outs.append(out)
    _close(torch.cat(outs, 1), full, 1e-5)


def test_stack_clones_values_and_need_weights_ignored():
    """``_clone_layer`` copies values (the reference's quirk): every layer
    starts equal to the first, with parameters of its own; the copies
    share the model's generator.  ``need_weights=True`` returns the
    output alone, as in the reference."""
    gen = torch.Generator().manual_seed(5)
    layer = pt.nn.TransformerEncoderLayer(16, 2, 32, device="cpu",
                                          generator=gen)
    enc = pt.nn.TransformerEncoder(layer, 3)
    w0 = enc.layers[0].linear1.weight
    for other in enc.layers[1:]:
        assert other.linear1.weight is not w0
        assert torch.equal(other.linear1.weight, w0)
        assert other.dropout1.generator is gen
    ref = rnn.TransformerEncoder(rnn.TransformerEncoderLayer(16, 2, 32), 3)
    assert np.array_equal(ref.layers[2].linear1.weight.numpy(),
                          ref.layers[0].linear1.weight.numpy())
    mha = pt.nn.MultiHeadAttention(16, 2, need_weights=True, device="cpu")
    assert isinstance(mha(torch.zeros(1, 3, 16)), torch.Tensor)


def test_recompute_matches_the_plain_stack():
    """``enable_recompute`` replays each layer in the backward: the same
    gradients as the plain stack."""
    enc = pt.nn.TransformerEncoder(pt.nn.TransformerEncoderLayer(
        16, 2, 32, dropout=0.0, device="cpu"), 2)
    x = torch.from_numpy(_x(2, 4, 16)).requires_grad_()
    grads = []
    for remat in (False, True):
        enc.enable_recompute = remat
        x.grad = None
        enc(x).square().sum().backward()
        grads.append(x.grad.clone())
    torch.testing.assert_close(grads[0], grads[1])


def test_attributes_other_than_initializers_raise():
    lin = pt.nn.MultiHeadAttention(
        8, 2, weight_attr=pt.nn.initializer.Constant(0.25), device="cpu")
    assert torch.equal(lin.q_proj.weight, torch.full((8, 8), 0.25))
    with pytest.raises(NotImplementedError):
        pt.nn.MultiHeadAttention(8, 2, weight_attr="w", device="cpu")


SCAN_GPT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=3,
                num_attention_heads=2, max_position_embeddings=16)


@pytest.mark.parametrize("remat", [False, True])
def test_gpt_use_scan_layers_matches_unrolled(remat):
    """``use_scan_layers=True`` (with and without recompute): logits and
    every gradient equal to the reference's scanned model and to the
    port's unrolled one; with dropout on in training (where the reference
    falls back to its loop) it draws as the unrolled model does."""
    from paddle_tpu.models.gpt import GPTConfig as RefConfig
    from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
    paddle.seed(6)
    kw = dict(SCAN_GPT, use_recompute=remat)
    ref = RefGPT(RefConfig(**kw, use_scan_layers=True))
    scan = _copy(ref, pt.GPTForCausalLM(pt.GPTConfig(
        **kw, use_scan_layers=True), device="cpu"))
    plain = _copy(ref, pt.GPTForCausalLM(pt.GPTConfig(**kw), device="cpu"))
    ids = np.random.default_rng(0).integers(0, 64, (2, 8))
    _hold(ref, scan, [], lambda m, i: m(i), 1e-5,
          masks=(ids,))
    want = {k: p.grad.clone() for k, p in scan.named_parameters()}
    plain(torch.from_numpy(ids)).mul(torch.from_numpy(
        _x(2, 8, 64, seed=99))).sum().backward()
    for k, p in plain.named_parameters():
        torch.testing.assert_close(p.grad, want[k], rtol=1e-6, atol=1e-7)
    drop = [pt.GPTForCausalLM(pt.GPTConfig(
        **dict(kw, hidden_dropout_prob=0.1), use_scan_layers=flag),
        device="cpu", seed=3) for flag in (True, False)]
    assert torch.equal(drop[0](torch.from_numpy(ids)),
                       drop[1](torch.from_numpy(ids)))


def test_bert_use_scan_layers_matches_reference():
    from paddle_tpu.models import bert as ref_bert
    cfg = dict(vocab_size=64, hidden_size=32, num_hidden_layers=3,
               num_attention_heads=2, intermediate_size=64,
               max_position_embeddings=16, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0, use_scan_layers=True)
    paddle.seed(7)
    ref = ref_bert.BertForMaskedLM(ref_bert.BertConfig(**cfg))
    port = _copy(ref, pt.BertForMaskedLM(pt.BertConfig(**cfg),
                                         device="cpu"))
    ids = np.random.default_rng(1).integers(0, 64, (2, 8))
    _hold(ref, port, [], lambda m, i: m(i), 1e-5, masks=(ids,))


def test_scan_layer_stack_refuses_unlike_layers():
    from paddle_tpu_torch.nn.layer.scanned import scan_layer_stack
    with pytest.raises(ValueError, match="param count"):
        scan_layer_stack([pt.nn.Linear(2, 2, device="cpu"),
                          pt.nn.Linear(2, 2, bias=False, device="cpu")],
                         torch.zeros(1, 2))
