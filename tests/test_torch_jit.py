"""The port's ``jit.to_static`` and in-flight window vs the reference's.

The six cases of the reference's ``tests/test_jit.py`` run beside the
reference's own ``paddle.jit.to_static`` on the same inputs (weights and
data cross through numpy): results within 1e-5 relative in f32 and the
same number of cache entries.  On the CPU the port runs its function
eagerly at every call (CUDA graphs exist only on the card); the cache keys,
the gradient rule and the optimizers' device state are the ones a capture
uses.  The reference's compiled ``Adam`` step keeps its step count at the
value it was traced with, so from the third call on the port's Adam case
is held to the reference's eager steps.  Masks of the two random streams
cannot match: both must differ between calls.  Also: the modes the port
refuses, the gradient rule of a step that leaves gradients set, the
closure rule, the window's waits at depths 1-3 against the reference's
``InFlightWindow``, and the serving engine's ``step_compiles`` and
``enable_lora`` refusal against the reference engine's.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.core.pipeline as ref_pipeline
import paddle_tpu.nn.functional as RF
from paddle_tpu import nn as rnn
from paddle_tpu import optimizer as ropt
from paddle_tpu.inference.serving import GenerationEngine as RefEngine
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.core import pipeline

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _port_linear(ref_lin):
    lin = pt.nn.Linear(*ref_lin.weight.shape, device="cpu")
    with torch.no_grad():
        lin.weight.copy_(_t(ref_lin.weight.numpy()))
        lin.bias.copy_(_t(ref_lin.bias.numpy()))
    return lin


def _mse(pred, y):
    return ((pred - y) ** 2).mean()


def test_to_static_pure_fn():
    rng = np.random.RandomState(0)
    a, b = rng.randn(3, 4).astype(np.float32), rng.randn(4, 5).astype(
        np.float32)

    @paddle.jit.to_static
    def rf(x, y):
        return paddle.matmul(x, y) + 1.0

    @pt.jit.to_static
    def pf(x, y):
        return torch.matmul(x, y) + 1.0

    ra, rb = paddle.to_tensor(a), paddle.to_tensor(b)
    want = [rf(ra, rb).numpy() for _ in range(3)]
    got = [pf(_t(a), _t(b)).numpy() for _ in range(3)]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=RTOL)
    np.testing.assert_allclose(got[-1], a @ b + 1.0, rtol=RTOL)
    assert len(pf._cache) == len(rf._cache) == 1
    assert pf.eager_calls == 3 and pf.replays == 0


def test_to_static_captures_params():
    rlin = rnn.Linear(4, 4)
    plin = _port_linear(rlin)
    x = np.random.RandomState(1).randn(2, 4).astype(np.float32)
    rf = paddle.jit.to_static(lambda v: rlin(v))
    pf = pt.jit.to_static(lambda v: plin(v))
    rx, px = paddle.to_tensor(x), _t(x)
    for _ in range(2):
        np.testing.assert_allclose(pf(px).detach().numpy(),
                                   rf(rx).numpy(), rtol=RTOL)
    # a parameter written after the capture is what the next call reads
    rlin.weight.set_value(np.zeros((4, 4), np.float32))
    with torch.no_grad():
        plin.weight.zero_()
    r3, p3 = rf(rx).numpy(), pf(px).detach().numpy()
    np.testing.assert_allclose(p3, r3, rtol=RTOL)
    np.testing.assert_allclose(
        p3, np.broadcast_to(plin.bias.detach().numpy(), (2, 4)), rtol=RTOL)
    assert len(pf._cache) == len(rf._cache) == 1


def _adam_models():
    paddle.seed(7)
    rmodel = rnn.Sequential(rnn.Linear(8, 16), rnn.ReLU(),
                            rnn.Linear(16, 1))
    pmodel = pt.nn.Sequential(_port_linear(rmodel[0]), pt.nn.ReLU(),
                              _port_linear(rmodel[2]))
    return rmodel, pmodel


def test_to_static_train_step():
    """The reference's Adam train step (15 calls): the port's to_static
    losses equal the reference's to_static losses on the two calls the
    reference computes right, then the reference's eager losses; the loss
    falls to under half on every side."""
    rng = np.random.RandomState(3)
    x = rng.randn(16, 8).astype(np.float32)
    y = rng.randn(16, 1).astype(np.float32)

    def ref_losses(traced):
        rmodel, _ = _adam_models()
        opt = ropt.Adam(learning_rate=0.01, parameters=rmodel.parameters())

        def step(xx, yy):
            loss = RF.mse_loss(rmodel(xx), yy)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        fn = paddle.jit.to_static(step) if traced else step
        out = [float(fn(paddle.to_tensor(x), paddle.to_tensor(y)).item())
               for _ in range(15)]
        return out, (len(fn._cache) if traced else None)

    ref_traced, ref_entries = ref_losses(True)
    ref_eager, _ = ref_losses(False)
    _, pmodel = _adam_models()
    popt = pt.optimizer.Adam(learning_rate=0.01,
                             parameters=pmodel.parameters())

    def pstep(xx, yy):
        loss = _mse(pmodel(xx), yy)
        loss.backward()
        popt.step()
        popt.clear_grad()
        return loss

    pf = pt.jit.to_static(pstep)
    got = [pf(_t(x), _t(y)).item() for _ in range(15)]
    np.testing.assert_allclose(got[:2], ref_traced[:2], rtol=RTOL)
    np.testing.assert_allclose(got, ref_eager, rtol=RTOL)
    for losses in (got, ref_traced, ref_eager):
        assert losses[-1] < losses[0] * 0.5, losses
    assert len(pf._cache) == ref_entries == 1
    assert int(popt._step_count) == 15


def test_to_static_matches_eager_equivalence():
    paddle.seed(11)
    r1 = rnn.Linear(4, 4)
    p1, p2 = _port_linear(r1), _port_linear(r1)
    o_r = ropt.SGD(learning_rate=0.1, parameters=r1.parameters())
    o1 = pt.optimizer.SGD(learning_rate=0.1, parameters=p1.parameters())
    o2 = pt.optimizer.SGD(learning_rate=0.1, parameters=p2.parameters())

    def pstep(model, opt, xx, yy):
        loss = _mse(model(xx), yy)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    traced = pt.jit.to_static(lambda xx, yy: pstep(p2, o2, xx, yy))
    for i in range(5):
        x = np.random.RandomState(i).rand(8, 4).astype(np.float32)
        y = np.random.RandomState(100 + i).rand(8, 4).astype(np.float32)
        lr_ = RF.mse_loss(r1(paddle.to_tensor(x)), paddle.to_tensor(y))
        lr_.backward()
        o_r.step()
        o_r.clear_grad()
        l1 = pstep(p1, o1, _t(x), _t(y))
        l2 = traced(_t(x), _t(y))
        np.testing.assert_allclose(l2.detach().numpy(),
                                   l1.detach().numpy(), rtol=RTOL,
                                   atol=1e-6)
        np.testing.assert_allclose(l2.detach().numpy(), lr_.numpy(),
                                   rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(p2.weight.detach().numpy(),
                               p1.weight.detach().numpy(), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(p2.weight.detach().numpy(),
                               r1.weight.numpy(), rtol=RTOL, atol=1e-6)


def test_to_static_rng_state_threading():
    paddle.seed(5)
    rf = paddle.jit.to_static(
        lambda v: RF.dropout(v, 0.5, training=True))
    pf = pt.jit.to_static(lambda v: F.dropout(v, 0.5, training=True))
    rx, px = paddle.ones([100]), torch.ones(100)
    routs = [rf(rx).numpy() for _ in range(3)]
    pouts = [pf(px).numpy() for _ in range(3)]
    for outs in (routs, pouts):
        assert not np.allclose(outs[1], outs[2])
        assert set(np.unique(outs[2])) <= {0.0, 2.0}
    assert len(pf._cache) == len(rf._cache) == 1


def test_to_static_shape_polymorphism_via_cache():
    rf = paddle.jit.to_static(lambda v: (v * 2).sum())
    pf = pt.jit.to_static(lambda v: (v * 2).sum())
    for n, want in ((3, 6), (5, 10), (3, 6)):
        assert float(rf(paddle.ones([n])).item()) == want
        assert float(pf(torch.ones(n))) == want
    assert len(pf._cache) == len(rf._cache) == 2


@pytest.mark.parametrize("what", ["full_graph", "sot", "save", "load",
                                  "analyze_program", "enable_false"])
def test_refused_modes_raise(what):
    fn = pt.jit.to_static(lambda v: v + 1)
    calls = {
        "full_graph": lambda: pt.jit.to_static(lambda v: v,
                                               full_graph=False),
        "sot": lambda: pt.jit.to_static(lambda v: v, backend="sot"),
        "save": lambda: pt.jit.save(pt.nn.ReLU(), "unused"),
        "load": lambda: pt.jit.load("unused"),
        "analyze_program": lambda: fn.analyze_program(torch.ones(2)),
        "enable_false": lambda: pt.jit.enable_to_static(False),
    }
    with pytest.raises(NotImplementedError, match="not ported"):
        calls[what]()
    pt.jit.enable_to_static(True)      # accepted: what the port does
    pt.jit.ignore_module([torch])      # a no-op, as in the reference


def test_gradients_left_set_follow_the_reference():
    """A step that leaves gradients set: after each call the parameters
    hold that call's gradient, not a sum over calls, on both sides (the
    reference's compiled calls start from the discovery run's None)."""
    rlin = rnn.Linear(3, 2)
    plin = _port_linear(rlin)

    def rstep(v):
        loss = (rlin(v) ** 2).mean()
        loss.backward()
        return loss

    def pstep(v):
        loss = (plin(v) ** 2).mean()
        loss.backward()
        return loss

    rf, pf = paddle.jit.to_static(rstep), pt.jit.to_static(pstep)
    for i in range(3):
        x = np.random.RandomState(20 + i).randn(4, 3).astype(np.float32)
        rf(paddle.to_tensor(x))
        pf(_t(x))
        np.testing.assert_allclose(plin.weight.grad.numpy(),
                                   rlin.weight.grad.numpy(), rtol=RTOL,
                                   atol=1e-7)
        np.testing.assert_allclose(plin.bias.grad.numpy(),
                                   rlin.bias.grad.numpy(), rtol=RTOL,
                                   atol=1e-7)
    assert pf._cache[next(iter(pf._cache))].grad_slots  # both params


def test_closure_without_tensor_arguments_runs_eagerly_on_cpu():
    """The closure rule: no tensor argument names a device; its discovery
    run returned CPU tensors and ran CPU modules, so every call is eager
    (on a card it is captured: tests/test_torch_cuda.py)."""
    lin = pt.nn.Linear(2, 2, device="cpu")
    x = torch.ones(1, 2)
    fn = pt.jit.to_static(lambda: lin(x))
    outs = [fn() for _ in range(3)]
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert fn.eager_calls == 3 and fn.replays == 0 and fn.captures == 0
    assert len(fn._cache) == 1
    assert fn._cache[next(iter(fn._cache))].device is None


def test_to_static_layer_and_rewrap_rules():
    lin = pt.nn.Linear(2, 2, device="cpu")
    fwd = lin.forward
    assert pt.jit.to_static(lin) is lin
    traced = lin.forward
    assert isinstance(traced, pt.jit.TracedFunction)
    assert traced._orig_fn == fwd
    assert pt.jit.to_static(lin) is lin and lin.forward is traced
    assert pt.jit.to_static(traced) is traced
    respec = pt.jit.to_static(traced, input_spec=[None])
    assert respec is not traced and respec._orig_fn is traced._orig_fn
    def plain(v):
        return v
    assert pt.jit.not_to_static(plain) is plain and plain._not_to_static
    x = torch.ones(3, 2)
    torch.testing.assert_close(lin(x), fwd(x))


def test_grad_matches_reference():
    rng = np.random.RandomState(4)
    w = rng.randn(3).astype(np.float32)
    rw = paddle.to_tensor(w, stop_gradient=False)
    ru = paddle.to_tensor(w, stop_gradient=False)
    rg = paddle.grad([(rw * rw).sum()], [rw, ru])
    pw = _t(w).requires_grad_()
    pu = _t(w).requires_grad_()
    pg = pt.jit.grad([(pw * pw).sum()], [pw, pu])
    for a, b in zip(pg, rg):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL)
    assert pt.jit.grad((pw * pw).sum(), [pu], allow_unused=True) == [None]
    assert pw.grad is None


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_window_waits_match_reference(depth, monkeypatch):
    """The same admits (and a drain) wait on the same number of steps at
    each point as the reference's window."""
    ref_waits = []
    monkeypatch.setattr(ref_pipeline, "jax", types.SimpleNamespace(
        block_until_ready=lambda v: ref_waits.append(1)))
    ref_win = ref_pipeline.InFlightWindow(depth=depth)
    win = pipeline.InFlightWindow(depth=depth)
    for i in range(6):
        ref_win.admit([np.zeros(2)], label="step", step=i)
        win.admit([torch.zeros(2)], label="step", step=i)
        assert win.waits == len(ref_waits), i
        assert len(win) == len(ref_win) == min(i + 1, depth - 1)
    ref_win.drain()
    win.drain()
    assert win.waits == len(ref_waits) == 6
    assert len(win) == len(ref_win) == 0


def test_pipeline_depth_and_fetch_handle(monkeypatch):
    for value, want in (("5", 5), ("0", 1), ("x", 2)):
        monkeypatch.setenv(pipeline.ENV_PIPELINE_DEPTH, value)
        assert pipeline.pipeline_depth() == ref_pipeline.pipeline_depth() \
            == want
    monkeypatch.delenv(pipeline.ENV_PIPELINE_DEPTH)
    h = pipeline.FetchHandle(torch.arange(3.0), label="loss")
    assert h.shape == (3,) and h.is_ready() and len(h) == 3
    np.testing.assert_array_equal(np.asarray(h), [0.0, 1.0, 2.0])
    assert float(pipeline.FetchHandle(torch.tensor(2.5))) == 2.5
    pipeline.get_window().admit([torch.zeros(1)])
    pipeline.drain()
    assert len(pipeline.get_window()) == 0


TINY = dict(vocab_size=128, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=2, max_position_embeddings=64)


@pytest.fixture(scope="module")
def tiny_models():
    paddle.seed(3)
    ref = RefGPT(RefConfig(**TINY))
    ref.eval()
    port = pt.GPTForCausalLM(pt.GPTConfig(**TINY), device="cpu")
    pt.load_reference_state(
        port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    return ref, port


def test_engine_step_compiles_and_late_lora_match_reference(tiny_models,
                                                            monkeypatch):
    """A mixed trace (chunked prefills beside decodes): the same tokens,
    one step signature on both sides, and ``enable_lora`` refused after
    the first step."""
    monkeypatch.delenv("PADDLE_TPU_PIPELINE_DEPTH", raising=False)
    ref, port = tiny_models
    rng = np.random.default_rng(5)
    prompts = [list(rng.integers(1, 128, size=n)) for n in (9, 3, 14)]
    kw = dict(num_blocks=32, block_size=4, max_batch=3, max_model_len=64,
              prefill_chunk=8)
    engines = (RefEngine(ref, **kw), pt.GenerationEngine(port, device="cpu",
                                                         **kw))
    outs = []
    for eng in engines:
        ids = [eng.add_request(p, max_new_tokens=4) for p in prompts]
        while eng.has_unfinished():
            eng.step()
        outs.append([eng.result(i) for i in ids])
        with pytest.raises(RuntimeError, match="before the first step"):
            eng.enable_lora(rank=4)
    engines[0].close()
    assert outs[0] == outs[1]
    assert engines[1].stats()["step_compiles"] == \
        engines[0].stats()["step_compiles"] == 1


def test_recompute_under_capture_refuses_draws(monkeypatch):
    """Under capture, recompute cannot take and set a generator's state: a
    block whose dropout drew in its eager run raises, one that drew
    nothing (p = 0) runs without it.  The stream's capture status is set
    by hand: the CPU has no graphs."""
    from paddle_tpu_torch.distributed.fleet.recompute import recompute

    class Block(torch.nn.Module):
        def __init__(self, p):
            super().__init__()
            self.lin = pt.nn.Linear(4, 4, device="cpu")
            self.p = p
            self.generator = torch.Generator().manual_seed(0)

        def forward(self, x):
            return F.dropout(self.lin(x), self.p, training=True,
                             generator=self.generator)

    for p, draws in ((0.0, False), (0.5, True)):
        blk = Block(p)
        x = torch.ones(2, 4, requires_grad=True)
        recompute(blk, x).sum().backward()          # the eager run
        assert blk._recompute_draws is draws
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "is_initialized", lambda: True)
            m.setattr(torch.cuda, "is_current_stream_capturing",
                      lambda: True)
            if draws:
                with pytest.raises(NotImplementedError, match="draws"):
                    recompute(blk, x)
            else:
                recompute(blk, x).sum().backward()
