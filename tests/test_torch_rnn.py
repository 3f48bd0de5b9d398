"""The port's recurrent family against the reference's
(``paddle_tpu.nn.layer.rnn``).

Weights come from the reference through ``load_reference_state`` (the
names, ``weight_ih_l0``, ``bias_hh_l1_reverse``, ..., are equal), inputs
from a seeded numpy draw.  The whole-sequence layers (ATen's fused
recurrence in the port, ``lax.scan`` in the reference) are held in f32
within 1e-5 relative plus 1e-5 of the largest magnitude: outputs, final
states and the gradients of the input, the initial states and every
parameter under one seeded upstream gradient; under ``auto_cast(level=
"O2", dtype="bfloat16")`` (``rnn`` is on neither O1 list, so O1 casts
nothing) within 2^-5 of the largest magnitude.  The cases take every
layer (``SimpleRNN`` tanh and relu, ``LSTM``, ``GRU``), both directions,
``time_major`` and ``sequence_length`` (the reference's own test holds
its semantics against PyTorch's packed RNN), given initial states and two
layers.  The cells, ``RNN`` and ``BiRNN`` with lengths, and
``dynamic_decode``'s tokens and lengths (exactly equal; the reference's
beam-search tests on the port) follow.  Quirk kept: ``dropout`` between
layers is not applied.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as rnn

import paddle_tpu_torch as pt

B, T, I, HID = 3, 6, 4, 5
LENS = np.array([6, 3, 5], np.int64)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.astype("float32").numpy(), np.float32)


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    top = max(float(np.abs(want).max()), 1e-30)
    if tol < 1e-3:
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * max(top, 1.0), err_msg=what)
    else:
        assert float(np.abs(got - want).max()) / top <= tol, what


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _copy(ref, port):
    pt.load_reference_state(port, {k: v.numpy() for k, v in
                                   ref.state_dict().items()})
    return port


def _flat(out):
    """The tensors of a nested output, in order."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _hold(ref, port, arrays, call, tol=1e-5, o2=False, extra=()):
    """``call(model, *inputs, *extra)`` in both packages: every output
    tensor, the inputs' gradients and every parameter's gradient."""
    rx = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    tx = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    re = [paddle.to_tensor(e) for e in extra]
    te = [torch.from_numpy(e) for e in extra]
    if o2:
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            rout = _flat(call(ref, *rx, *re))
        with pt.amp.auto_cast(level="O2", dtype="bfloat16"):
            tout = _flat(call(port, *tx, *te))
    else:
        rout, tout = _flat(call(ref, *rx, *re)), _flat(call(port, *tx, *te))
    rloss, tloss = 0, 0
    for k, (r, t) in enumerate(zip(rout, tout)):
        _close(t, r, tol, f"output {k}")
        up = _x(*t.shape, seed=90 + k)
        rloss = rloss + (r.astype("float32") * paddle.to_tensor(up)).sum()
        tloss = tloss + (t.float() * torch.from_numpy(up)).sum()
    rloss.backward()
    tloss.backward()
    for i, (r, t) in enumerate(zip(rx, tx)):
        _close(t.grad, r.grad, tol, f"gradient of input {i}")
    rg = {k: p.grad for k, p in ref.named_parameters()}
    names = [k for k, _ in port.named_parameters()]
    assert names == list(rg)
    for k, p in port.named_parameters():
        _close(p.grad, rg[k], tol, k)


#: name -> (layer name, kwargs, time_major, lengths?, initial states?)
LAYER_CASES = {
    "lstm": ("LSTM", dict(num_layers=2), False, False, False),
    "lstm_bidirect_lengths": ("LSTM", dict(direction="bidirect"), False,
                              True, False),
    "lstm_time_major_lengths_states": (
        "LSTM", dict(direction="bidirect", num_layers=2, time_major=True),
        True, True, True),
    "gru_time_major": ("GRU", dict(time_major=True), True, False, False),
    "gru_bidirect_lengths": ("GRU", dict(direction="bidirectional",
                                         num_layers=2), False, True, False),
    "gru_states": ("GRU", dict(), False, False, True),
    "simple_tanh_bidirect_lengths": ("SimpleRNN", dict(direction="bidirect"),
                                     False, True, False),
    "simple_relu_time_major": ("SimpleRNN", dict(activation="relu",
                                                 time_major=True),
                               True, False, False),
    "simple_relu_bidirect_states": (
        "SimpleRNN", dict(activation="relu", direction="bidirect"), False,
        False, True),
}
BF16_CASES = ("lstm_bidirect_lengths", "gru_time_major",
              "simple_tanh_bidirect_lengths")


@pytest.mark.parametrize("name,o2", [(n, False) for n in LAYER_CASES]
                         + [(n, True) for n in BF16_CASES])
def test_rnn_layer_matches_reference(name, o2):
    cls, kw, time_major, lengths, states = LAYER_CASES[name]
    paddle.seed(1)
    ref = getattr(rnn, cls)(I, HID, **kw)
    port = _copy(ref, getattr(pt.nn, cls)(I, HID, **kw, device="cpu"))
    x = _x(T, B, I) if time_major else _x(B, T, I)
    arrays = [x]
    if states:
        n = kw.get("num_layers", 1) * (2 if "direction" in kw else 1)
        arrays += [_x(n, B, HID, seed=s) for s in
                   ((1, 2) if cls == "LSTM" else (1,))]

    def call(m, x, *rest):
        st = rest[:len(arrays) - 1]
        st = None if not st else (tuple(st) if len(st) == 2 else st[0])
        return m(x, st, rest[-1] if lengths else None)

    _hold(ref, port, arrays, call, 2 ** -5 if o2 else 1e-5, o2,
          extra=(LENS,) if lengths else ())


def test_sequence_length_semantics_and_dropout_quirk():
    """With lengths the padded outputs are 0 and the final state is the
    state at each end (the same as running the valid prefix alone);
    ``dropout`` between layers is accepted and not applied (the
    reference's quirk): training with 0.5 gives dropout 0's outputs."""
    lstm = pt.nn.LSTM(I, HID, num_layers=2, dropout=0.5, device="cpu")
    x = torch.from_numpy(_x(B, T, I))
    y, (h, c) = lstm(x, sequence_length=torch.from_numpy(LENS))
    assert torch.equal(y[1, 3:], torch.zeros(3, HID))
    y1, (h1, c1) = lstm(x[1:2, :3])
    torch.testing.assert_close(h[:, 1], h1[:, 0])
    torch.testing.assert_close(c[:, 1], c1[:, 0])
    plain = pt.nn.LSTM(I, HID, num_layers=2, device="cpu")
    plain.load_state_dict(lstm.state_dict())
    assert lstm.training and torch.equal(lstm(x)[0], plain(x)[0])


CELL_CASES = {
    "simple_tanh": ("SimpleRNNCell", dict(), 1),
    "simple_relu": ("SimpleRNNCell", dict(activation="relu"), 1),
    "lstm": ("LSTMCell", dict(), 2),
    "gru": ("GRUCell", dict(), 1),
}


@pytest.mark.parametrize("o2", [False, True])
@pytest.mark.parametrize("name", list(CELL_CASES))
def test_cell_matches_reference(name, o2):
    cls, kw, n_states = CELL_CASES[name]
    paddle.seed(2)
    ref = getattr(rnn, cls)(I, HID, **kw)
    port = _copy(ref, getattr(pt.nn, cls)(I, HID, **kw, device="cpu"))
    states = [_x(B, HID, seed=s) for s in range(1, n_states + 1)]

    def call(m, x, *st):
        return m(x, tuple(st) if len(st) == 2 else st[0])

    _hold(ref, port, [_x(B, I)] + states, call, 2 ** -5 if o2 else 1e-5, o2)
    # the cell's own zero states when none are given
    _close(port(torch.from_numpy(_x(B, I)))[0],
           ref(paddle.to_tensor(_x(B, I)))[0], 1e-5, "zero states")


@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("cls", ["LSTMCell", "GRUCell"])
def test_rnn_and_birnn_wrappers_match_reference(cls, time_major):
    paddle.seed(3)
    ref_f, ref_b = getattr(rnn, cls)(I, HID), getattr(rnn, cls)(I, HID)
    port_f = _copy(ref_f, getattr(pt.nn, cls)(I, HID, device="cpu"))
    port_b = _copy(ref_b, getattr(pt.nn, cls)(I, HID, device="cpu"))
    x = _x(T, B, I) if time_major else _x(B, T, I)
    ref = rnn.BiRNN(ref_f, ref_b, time_major=time_major)
    port = pt.nn.BiRNN(port_f, port_b, time_major=time_major)
    _hold(ref, port, [x], lambda m, x, lens: m(x, sequence_length=lens),
          extra=(LENS,))
    one_ref = rnn.RNN(ref_f, is_reverse=True, time_major=time_major)
    one = pt.nn.RNN(port_f, is_reverse=True, time_major=time_major)
    for r, p in zip(_flat(one_ref(paddle.to_tensor(x))),
                    _flat(one(torch.from_numpy(x)))):
        _close(p, r, 1e-5)


def test_rnn_wrapper_reference_cases():
    """The reference's ``test_rnn_cell_wrapper_sequence_length`` and its
    LSTM twin on the port."""
    x = torch.from_numpy(_x(2, 5, 3, seed=1))
    lens = torch.tensor([5, 3])
    wrap = pt.nn.RNN(pt.nn.GRUCell(3, 4, device="cpu"))
    y, h = wrap(x, sequence_length=lens)
    assert torch.equal(y[1, 3:], torch.zeros(2, 4))
    torch.testing.assert_close(h[1], wrap(x[1:, :3])[1][0])
    wrap = pt.nn.RNN(pt.nn.LSTMCell(3, 4, device="cpu"))
    y, (h, c) = wrap(x, sequence_length=torch.tensor([5, 2]))
    assert torch.equal(y[1, 2:], torch.zeros(3, 4))
    h2, c2 = wrap(x[1:, :2])[1]
    torch.testing.assert_close(h[1], h2[0])
    torch.testing.assert_close(c[1], c2[0])


def _decoders(cls, V, H, K, bias=None, seed=0):
    """The same beam-search decoder (embedding, cell, projection) in
    both packages."""
    paddle.seed(seed)
    emb, cell, proj = rnn.Embedding(V, H), getattr(rnn, cls)(H, H), \
        rnn.Linear(H, V)
    if bias is not None:
        proj.bias.set_value(paddle.to_tensor(bias))
    pemb = _copy(emb, pt.nn.Embedding(V, H, device="cpu"))
    pcell = _copy(cell, getattr(pt.nn, cls)(H, H, device="cpu"))
    pproj = _copy(proj, pt.nn.Linear(H, V, device="cpu"))
    ref = rnn.BeamSearchDecoder(cell, 0, V - 1, K, embedding_fn=emb,
                                output_fn=proj)
    port = pt.nn.BeamSearchDecoder(pcell, 0, V - 1, K, embedding_fn=pemb,
                                   output_fn=pproj)
    return ref, port, cell, pcell


@pytest.mark.parametrize("cls,steps", [("SimpleRNNCell", 8),
                                       ("LSTMCell", 12), ("GRUCell", 6)])
def test_dynamic_decode_tokens_equal_reference(cls, steps):
    V, H, K = 7, 6, 3
    ref, port, cell, pcell = _decoders(cls, V, H, K, seed=4)
    h0 = _x(2, H, seed=5) * 0.5
    if cls == "LSTMCell":
        rinit = (paddle.to_tensor(h0), paddle.to_tensor(h0 * 0.3))
        tinit = (torch.from_numpy(h0), torch.from_numpy(h0 * 0.3))
    else:
        rinit, tinit = paddle.to_tensor(h0), torch.from_numpy(h0)
    rseq, rlen = rnn.dynamic_decode(ref, inits=rinit, max_step_num=steps)
    seq, lens = pt.nn.dynamic_decode(port, inits=tinit, max_step_num=steps)
    assert np.array_equal(seq.numpy(), rseq.numpy())
    assert np.array_equal(lens.numpy(), rlen.numpy())
    assert seq.dtype == torch.int64 and tuple(seq.shape[:2]) == (2, K)


def test_beam_search_reference_cases():
    """The reference's ``test_beam_search_decoder`` (a projection biased
    toward token 2: the best beam picks it) and
    ``test_beam_search_scores_are_true_log_probs`` (the best beam is the
    brute-force most probable sequence) on the port."""
    V, H = 5, 8
    bias = np.zeros(V, np.float32)
    bias[2] = 5.0
    _, port, _, cell = _decoders("SimpleRNNCell", V, H, 3, bias=bias)
    port.end_token = 3
    init = cell.get_initial_states(torch.zeros(2, H))
    seq, lengths = pt.nn.dynamic_decode(port, inits=init, max_step_num=4)
    assert tuple(seq.shape[:2]) == (2, 3) and seq.shape[2] <= 4
    assert (seq[:, 0, 0] == 2).all()
    V, H = 4, 6
    _, port, _, cell = _decoders("SimpleRNNCell", V, H, 4, seed=3)
    init = cell.get_initial_states(torch.zeros(1, H))
    seq, _ = pt.nn.dynamic_decode(port, inits=init, max_step_num=2)
    best = tuple(seq[0, 0].tolist())

    def logprobs(tok, state):
        out, new = cell(port.embedding_fn(torch.tensor([tok])), state)
        lg = port.output_fn(out)[0].detach().double().numpy()
        lg = lg - lg.max()
        return lg - np.log(np.exp(lg).sum()), new

    scores = {}
    lp0, st0 = logprobs(0, init)
    for t1 in range(V):
        lp1, _ = logprobs(t1, st0)
        if t1 == V - 1:
            scores[(t1,)] = lp0[t1]
            continue
        for t2 in range(V):
            scores[(t1, t2)] = lp0[t1] + lp1[t2]
    brute = max(scores, key=scores.get)
    assert best[:len(brute)] == brute


def test_rnn_state_names_match_reference():
    for cls, kw in (("LSTM", dict(num_layers=2, direction="bidirect")),
                    ("GRU", dict()), ("SimpleRNN", dict(num_layers=2))):
        ref = getattr(rnn, cls)(I, HID, **kw)
        port = getattr(pt.nn, cls)(I, HID, **kw, device="cpu")
        assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
            {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    with pytest.raises(NotImplementedError):
        pt.nn.LSTM(I, HID, bias_ih_attr=False, device="cpu")
