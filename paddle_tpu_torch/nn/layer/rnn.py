"""The recurrent family: port of ``paddle_tpu/nn/layer/rnn.py``.

``SimpleRNN`` (tanh or relu), ``LSTM`` and ``GRU`` run the whole sequence
in ATen's fused recurrence (``torch._VF.rnn_tanh``/``rnn_relu``/``lstm``/
``gru``: cuDNN on the card, ATen's own on the CPU).  Its recurrence is the
reference's ``_cell_step`` (:24-49): LSTM gates i, f, g, o; GRU ``n =
tanh(xn + r * hn)`` with ``hn`` carrying its bias and ``h = (1 - z) * n +
z * h``; both biases.  Parameters are named as the reference names them
(``weight_ih_l{k}[_reverse]``, ``weight_hh_l...``, ``bias_ih_l...``,
``bias_hh_l...``; :147-160), which are also PyTorch's, with its shapes
``[gates * hidden, in]`` and its ``Uniform(-1/sqrt(hidden),
1/sqrt(hidden))`` draws from the ``generator`` given.

``sequence_length`` has the reference's semantics (:56-120), which are a
packed sequence's: the states stop at each sequence's end, the outputs
past it are 0, and the reverse direction runs within the length; the
layers pack with ``pack_padded_sequence(enforce_sorted=False)`` (the
lengths are read on the host).  On the card the weights are views into
one flat buffer in cuDNN's layout (PyTorch's ``flatten_parameters``),
made at construction and again whenever a weight has moved, so that
cuDNN reads them in place and does not copy them all into a buffer of
its own on every call.  As in the reference (:191), ``dropout``
is accepted and not applied between layers.  The whole-sequence op is
``"rnn"`` for AMP, on neither O1 list: under O1 the layer runs in its
parameters' dtype, under O2 in the AMP dtype.

The cells (``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``; ops ``rnn_cell``,
``lstm_cell``, ``gru_cell``) are ATen's cell functions with the same
recurrence, and ``RNN``/``BiRNN`` step them in Python over time with the
reference's masking of states and outputs past each length (:375-431).
As in the reference, a cell's ``weight_ih_attr``-style keywords are
accepted and not read.

``BeamSearchDecoder`` and ``dynamic_decode`` (:434-541) keep the beam
bookkeeping on the host in numpy, as the reference does: float64
log-probabilities, ``np.argsort(-flat)`` over beam x vocabulary (so ties
break alike), finished beams extended by the end token at no cost.  Only
the cell, ``embedding_fn`` and ``output_fn`` run on the device of the
initial states.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn.utils.rnn import (PackedSequence, pack_padded_sequence,
                                pad_packed_sequence)

from ... import amp
from ...core import resolve_device
from .. import initializer as I
from .common import attr_param

__all__ = ["SimpleRNN", "LSTM", "GRU", "RNNCellBase", "SimpleRNNCell",
           "LSTMCell", "GRUCell", "RNN", "BiRNN", "BeamSearchDecoder",
           "dynamic_decode"]

_GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}


def _fused(mode):
    return {"LSTM": torch._VF.lstm, "GRU": torch._VF.gru,
            "RNN_TANH": torch._VF.rnn_tanh,
            "RNN_RELU": torch._VF.rnn_relu}[mode]


class _RNNBase(nn.Module):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"unknown direction {direction!r}")
        attrs = (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr)
        if any(a is False for a in attrs):
            raise NotImplementedError("RNN layers without weights or biases "
                                      "are not ported yet")
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        self.bidirect = direction != "forward"
        ndir = 2 if self.bidirect else 1
        gate = _GATES[mode] * hidden_size
        std = 1.0 / np.sqrt(hidden_size)
        kw = dict(device=resolve_device(device), dtype=dtype,
                  generator=generator)
        self._weight_names = []
        for layer in range(num_layers):
            for d in range(ndir):
                in_sz = input_size if layer == 0 else hidden_size * ndir
                sfx = f"{layer}" + ("_reverse" if d else "")
                for n, s, a in zip(
                        (f"weight_ih_l{sfx}", f"weight_hh_l{sfx}",
                         f"bias_ih_l{sfx}", f"bias_hh_l{sfx}"),
                        ((gate, in_sz), (gate, hidden_size), (gate,),
                         (gate,)), attrs):
                    self.register_parameter(n, attr_param(
                        s, a, I.Uniform(-std, std), **kw))
                    self._weight_names.append(n)
        self._flat_ptrs = None
        self._flatten()

    def _flatten(self):
        """On CUDA weights cuDNN takes, unless they already are: copy them
        into one buffer in cuDNN's layout and make each parameter a view
        of its slice (the same ``Parameter`` objects, so optimizers and
        in-place updates keep them there)."""
        weights = [getattr(self, n) for n in self._weight_names]
        ptrs = tuple(w.data_ptr() for w in weights)
        if ptrs == self._flat_ptrs or not weights[0].is_cuda \
                or not torch.backends.cudnn.is_acceptable(weights[0]) \
                or not torch._use_cudnn_rnn_flatten_weight() \
                or len({(w.dtype, w.device) for w in weights}) > 1 \
                or len(set(ptrs)) < len(ptrs):
            return
        from torch.backends.cudnn import rnn as cudnn_rnn
        with torch.cuda.device_of(weights[0]), torch.no_grad():
            torch._cudnn_rnn_flatten_weight(
                weights, 4, self.input_size,
                cudnn_rnn.get_cudnn_mode(self.mode), self.hidden_size, 0,
                self.num_layers, not self.time_major, self.bidirect)
        self._flat_ptrs = tuple(w.data_ptr() for w in weights)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """``inputs`` ``[batch, time, in]`` (``[time, batch, in]`` when
        ``time_major``); returns the outputs and the final states ``[layers
        * directions, batch, hidden]`` (``(h, c)`` for LSTM)."""
        ndir = 2 if self.bidirect else 1
        lstm = self.mode == "LSTM"
        batch = inputs.shape[1 if self.time_major else 0]
        if initial_states is None:
            zeros = inputs.new_zeros(self.num_layers * ndir, batch,
                                     self.hidden_size)
            initial_states = (zeros, zeros) if lstm else (zeros,)
        elif not isinstance(initial_states, (tuple, list)):
            initial_states = (initial_states,)
        n_st = len(initial_states)
        self._flatten()
        cast = amp.cast_inputs("rnn", inputs, *initial_states,
                               *(getattr(self, n) for n in
                                 self._weight_names))
        x, states, weights = cast[0], list(cast[1:1 + n_st]), \
            list(cast[1 + n_st:])
        # dropout 0 (the reference's quirk, :191); "train" only keeps
        # cuDNN's reserve space, which its backward needs in eval mode too
        args = (weights, True, self.num_layers, 0.0,
                torch.is_grad_enabled(), self.bidirect)
        hx = states if lstm else states[0]
        if sequence_length is None:
            res = _fused(self.mode)(x, hx, *args, not self.time_major)
            out, finals = res[0], res[1:]
        else:
            packed = pack_padded_sequence(
                x, sequence_length.detach().cpu().long(),
                batch_first=not self.time_major, enforce_sorted=False)
            order = packed.sorted_indices
            hx = [h.index_select(1, order) for h in states] if lstm \
                else states[0].index_select(1, order)
            res = _fused(self.mode)(packed.data, packed.batch_sizes, hx,
                                    *args)
            out, _ = pad_packed_sequence(
                PackedSequence(res[0], packed.batch_sizes, order,
                               packed.unsorted_indices),
                batch_first=not self.time_major,
                total_length=x.shape[0 if self.time_major else 1])
            finals = [h.index_select(1, packed.unsorted_indices)
                      for h in res[1:]]
        return (out, tuple(finals)) if lstm else (out, finals[0])


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, **kw):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, time_major, dropout, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, **kw)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, **kw)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, **kw)


class RNNCellBase(nn.Module):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """One ``[batch, hidden]`` tensor of ``init_value`` on
        ``batch_ref``'s device (for an LSTM cell too, as in the
        reference)."""
        return torch.full((batch_ref.shape[batch_dim_idx], self.hidden_size),
                          float(init_value), dtype=dtype or torch.float32,
                          device=batch_ref.device)


class _Cell(RNNCellBase):
    _gates = 1

    def __init__(self, input_size, hidden_size, *, device=None,
                 dtype=torch.float32, generator=None, **attrs):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        std = 1.0 / np.sqrt(hidden_size)
        kw = dict(device=resolve_device(device), dtype=dtype)
        gate = self._gates * hidden_size
        for n, s in (("weight_ih", (gate, input_size)),
                     ("weight_hh", (gate, hidden_size)), ("bias_ih", (gate,)),
                     ("bias_hh", (gate,))):
            p = nn.Parameter(torch.empty(s, **kw))
            I.Uniform(-std, std)(p, generator)
            self.register_parameter(n, p)

    def _weights(self, op, x, *states):
        return amp.cast_inputs(op, x, *states, self.weight_ih,
                               self.weight_hh, self.bias_ih, self.bias_hh)


class SimpleRNNCell(_Cell):
    def __init__(self, input_size, hidden_size, activation="tanh", **kw):
        super().__init__(input_size, hidden_size, **kw)
        self.mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, dtype=inputs.dtype)
        x, h, *w = self._weights("rnn_cell", inputs, states)
        fn = torch.rnn_tanh_cell if self.mode == "RNN_TANH" \
            else torch.rnn_relu_cell
        h = fn(x, h, *w)
        return h, h


class LSTMCell(_Cell):
    _gates = 4

    def forward(self, inputs, states=None):
        if states is None:
            h = self.get_initial_states(inputs, dtype=inputs.dtype)
            states = (h, h)
        x, h, c, *w = self._weights("lstm_cell", inputs, *states)
        h, c = torch.lstm_cell(x, (h, c), *w)
        return h, (h, c)


class GRUCell(_Cell):
    _gates = 3

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, dtype=inputs.dtype)
        x, h, *w = self._weights("gru_cell", inputs, states)
        h = torch.gru_cell(x, h, *w)
        return h, h


def _map_states(fn, *trees):
    """``fn`` over the tensors of equally nested state tuples."""
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_map_states(fn, *leaves)
                              for leaves in zip(*trees))
    return fn(*trees)


def _batch_mask(keep, t):
    return keep.reshape([-1] + [1] * (t.dim() - 1))


class RNN(nn.Module):
    """A cell stepped over time in Python (:375-411); with
    ``sequence_length`` each state stops at its sequence's end and the
    outputs past it are 0 (for the reverse pass the padding comes first,
    so its carry starts at the sequence's last token)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        t_axis = 0 if self.time_major else 1
        steps = inputs.shape[t_axis]
        xs = inputs.unbind(t_axis)
        order = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        states = initial_states
        outs = []
        for t in order:
            y, new_states = self.cell(xs[t], states)
            if sequence_length is not None:
                if states is None:   # the cell's own zeros, in its nesting
                    states = _map_states(torch.zeros_like, new_states)
                keep = sequence_length.to(y.device) > t
                y = torch.where(_batch_mask(keep, y), y, y * 0)
                states = _map_states(
                    lambda n, o: torch.where(_batch_mask(keep, n), n, o),
                    new_states, states)
            else:
                states = new_states
            outs.append(y)
        if self.is_reverse:
            outs = outs[::-1]
        return torch.stack(outs, t_axis), states


class BiRNN(nn.Module):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        st_fw, st_bw = (None, None) if initial_states is None \
            else initial_states
        y_fw, s_fw = self.rnn_fw(inputs, st_fw, sequence_length)
        y_bw, s_bw = self.rnn_bw(inputs, st_bw, sequence_length)
        return torch.cat([y_fw, y_bw], -1), (s_fw, s_bw)


class BeamSearchDecoder(nn.Module):
    """Beam search over ``cell`` from ``start_token`` until every beam
    has emitted ``end_token``; ``embedding_fn`` maps token ids to the
    cell's input and ``output_fn`` its output to logits.  Run it with
    `dynamic_decode`."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        super().__init__()
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn


def dynamic_decode(decoder, inits=None, max_step_num=32, **kwargs):
    """Beam search with ``decoder`` from the cell states ``inits`` (one
    tensor or a tuple, batch first) for at most ``max_step_num`` steps.
    Returns ``(token_ids [batch, beam, steps], lengths [batch, beam])``,
    int64 on the states' device, best beam first; a length counts up to
    and including the first end token."""
    if inits is None:
        raise ValueError("dynamic_decode needs the initial cell states "
                         "(cell.get_initial_states(...))")
    K, end = decoder.beam_size, decoder.end_token
    single = not isinstance(inits, (tuple, list))
    state_list = [inits] if single else list(inits)
    device = state_list[0].device
    B = state_list[0].shape[0]
    state_list = [s.repeat_interleave(K, dim=0) for s in state_list]
    ids = np.full((B, K), decoder.start_token, np.int64)
    scores = np.full((B, K), -1e9, np.float64)
    scores[:, 0] = 0.0            # the beams start alike: keep one
    finished = np.zeros((B, K), bool)
    tokens = []
    rows = np.arange(B)[:, None]
    for _ in range(max_step_num):
        inp = torch.from_numpy(ids.reshape(-1)).to(device)
        if decoder.embedding_fn is not None:
            inp = decoder.embedding_fn(inp)
        out, new_states = decoder.cell(
            inp, state_list[0] if single else tuple(state_list))
        new_list = list(new_states) if isinstance(new_states, (tuple, list)) \
            else [new_states]
        if decoder.output_fn is not None:
            out = decoder.output_fn(out)
        raw = out.detach().double().cpu().numpy()            # [B*K, V]
        m = raw.max(-1, keepdims=True)
        logp = (raw - m - np.log(np.exp(raw - m).sum(-1, keepdims=True))) \
            .reshape(B, K, -1)
        V = logp.shape[-1]
        # a finished beam extends only by the end token, at no cost
        fin = np.full((V,), -1e9)
        fin[end] = 0.0
        logp = np.where(finished[..., None], fin[None, None, :], logp)
        flat = (scores[..., None] + logp).reshape(B, K * V)
        top = np.argsort(-flat, axis=1)[:, :K]
        scores = np.take_along_axis(flat, top, axis=1)
        beam_src, tok = top // V, top % V
        gather = torch.from_numpy(
            (beam_src + np.arange(B)[:, None] * K).reshape(-1)).to(device)
        state_list = [s.index_select(0, gather) for s in new_list]
        tokens = [t[rows, beam_src] for t in tokens]
        finished = finished[rows, beam_src] | (tok == end)
        tokens.append(tok)
        ids = tok
        if finished.all():
            break
    seq = np.stack(tokens, axis=-1) if tokens else \
        np.zeros((B, K, 0), np.int64)
    hit = seq == end
    lengths = np.where(hit.any(-1), hit.argmax(-1) + 1, seq.shape[-1])
    return (torch.from_numpy(seq.astype(np.int64)).to(device),
            torch.from_numpy(lengths.astype(np.int64)).to(device))
