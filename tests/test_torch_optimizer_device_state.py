"""The optimizers' learning rate and step count on the device.

Each of the 13 optimizers that a CUDA graph can hold (all but ``LBFGS``)
takes 3 steps of a small MLP under a scheduler that changes the rate at
every step, through the port's ``jit.to_static``, against the reference's
EAGER steps on the same weights and data: the reference's own
``to_static`` bakes the rate and the step count into its trace (pinned by
`test_reference_to_static_freezes_the_rate`), the port's reads both from
device tensors.  Parameters are held within 1e-6 (absolute and relative);
``get_lr()`` is the reference's Python float, ``_step_count`` an int64
device tensor, and ``state_dict()["global_step"]`` round-trips bit for
bit.  ``LBFGS`` stays eager (``tests/test_torch_optimizer.py``).  The
captured and replayed steps on the card: ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
from paddle_tpu import nn as rnn

import paddle_tpu_torch as pt

TOL = 1e-6
STEPS = 3


def _sched(lib):
    lr = lib.optimizer.lr
    return lr.LinearWarmup(lr.CosineAnnealingDecay(1e-2, T_max=4,
                                                   eta_min=1e-3),
                           warmup_steps=2, start_lr=2e-3, end_lr=1e-2)


#: name -> builder(lib, params, scheduler)
CASES = {
    "SGD": lambda lib, ps, s: lib.optimizer.SGD(
        learning_rate=s, parameters=ps, weight_decay=0.01),
    "Momentum": lambda lib, ps, s: lib.optimizer.Momentum(
        learning_rate=s, momentum=0.9, parameters=ps, use_nesterov=True),
    "Adam": lambda lib, ps, s: lib.optimizer.Adam(
        learning_rate=s, parameters=ps, weight_decay=0.01),
    "AdamW": lambda lib, ps, s: lib.optimizer.AdamW(
        learning_rate=s, parameters=ps, weight_decay=0.01),
    "Adamax": lambda lib, ps, s: lib.optimizer.Adamax(
        learning_rate=s, parameters=ps),
    "Adagrad": lambda lib, ps, s: lib.optimizer.Adagrad(
        learning_rate=s, parameters=ps, initial_accumulator_value=0.1),
    "Adadelta": lambda lib, ps, s: lib.optimizer.Adadelta(
        learning_rate=s, parameters=ps, weight_decay=0.01),
    "RMSProp": lambda lib, ps, s: lib.optimizer.RMSProp(
        learning_rate=s, momentum=0.9, centered=True, parameters=ps),
    "Lamb": lambda lib, ps, s: lib.optimizer.Lamb(
        learning_rate=s, parameters=ps),
    "Rprop": lambda lib, ps, s: lib.optimizer.Rprop(
        learning_rate=s, parameters=ps),
    "ASGD": lambda lib, ps, s: lib.optimizer.ASGD(
        learning_rate=s, batch_num=2, parameters=ps, weight_decay=0.01),
    "NAdam": lambda lib, ps, s: lib.optimizer.NAdam(
        learning_rate=s, parameters=ps, weight_decay=0.01),
    "RAdam": lambda lib, ps, s: lib.optimizer.RAdam(
        learning_rate=s, parameters=ps, weight_decay=0.01),
}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _models(seed=3):
    paddle.seed(seed)
    ref = rnn.Sequential(rnn.Linear(6, 12), rnn.ReLU(), rnn.Linear(12, 3))
    port = pt.nn.Sequential(pt.nn.Linear(6, 12, device="cpu"), pt.nn.ReLU(),
                            pt.nn.Linear(12, 3, device="cpu"))
    with torch.no_grad():
        for (_, rp), pp in zip(sorted(ref.named_parameters()),
                               [p for _, p in sorted(port.named_parameters())]):
            pp.copy_(_t(rp.numpy()))
    return ref, port


def _data(step):
    rng = np.random.RandomState(40 + step)
    return (rng.randn(5, 6).astype(np.float32),
            rng.randn(5, 3).astype(np.float32))


def _ref_eager(case):
    ref, _ = _models()
    sched = _sched(paddle)
    opt = CASES[case](paddle, ref.parameters(), sched)
    lrs = []
    for i in range(STEPS):
        x, y = _data(i)
        loss = RF.mse_loss(ref(paddle.to_tensor(x)), paddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        lrs.append(opt.get_lr())
        sched.step()
    return [p.numpy() for _, p in sorted(ref.named_parameters())], lrs


def _port_traced(case):
    _, port = _models()
    sched = _sched(pt)
    opt = CASES[case](pt, port.parameters(), sched)

    def step(x, y):
        loss = ((port(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    fn = pt.jit.to_static(step)
    lrs = []
    for i in range(STEPS):
        x, y = _data(i)
        fn(_t(x), _t(y))
        lrs.append(opt.get_lr())
        sched.step()
    params = [p.detach().numpy() for _, p in sorted(port.named_parameters())]
    return params, lrs, opt, fn


def test_every_capturable_optimizer_has_a_case():
    names = set(pt.optimizer.__all__) & {
        n for n in dir(pt.optimizer)
        if isinstance(getattr(pt.optimizer, n), type)
        and issubclass(getattr(pt.optimizer, n), pt.optimizer.Optimizer)}
    assert names - {"Optimizer", "LBFGS"} == set(CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_scheduled_to_static_steps_match_reference_eager(case):
    want, ref_lrs = _ref_eager(case)
    got, lrs, opt, fn = _port_traced(case)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    assert all(type(v) is float for v in lrs)
    assert lrs == ref_lrs and len(set(lrs)) == STEPS
    assert opt._step_count.dtype == torch.int64
    assert opt._step_count.shape == () and int(opt._step_count) == STEPS
    assert opt._lr_tensor.dtype == torch.float32
    assert float(opt._lr_tensor) == np.float32(ref_lrs[-1])
    assert len(fn._cache) == 1 and fn.eager_calls == STEPS


@pytest.mark.parametrize("case", ["AdamW", "NAdam", "RAdam"])
def test_global_step_round_trips_bit_for_bit(case):
    _, _, opt, _ = _port_traced(case)
    sd = opt.state_dict()
    assert sd["global_step"].dtype == torch.int64
    assert int(sd["global_step"]) == STEPS
    _, port = _models()
    fresh = CASES[case](pt, port.parameters(), _sched(pt))
    fresh.set_state_dict(sd)
    assert torch.equal(fresh._step_count, opt._step_count)
    assert torch.equal(fresh.state_dict()["global_step"], sd["global_step"])
    fresh.set_state_dict({"global_step": np.int64(7)})
    assert int(fresh._step_count) == 7


def _unit_step(lib):
    """The 1 x 1 SGD under ``LambdaDecay(1, 10**e)``: a weight whose
    gradient is 1, so each step moves it by the rate."""
    if lib is paddle:
        lin = rnn.Linear(1, 1)
        lin.weight.set_value(np.zeros((1, 1), np.float32))
        x = paddle.ones([1, 1])
    else:
        lin = pt.nn.Linear(1, 1, device="cpu")
        with torch.no_grad():
            lin.weight.zero_()
        x = torch.ones(1, 1)
    sched = lib.optimizer.lr.LambdaDecay(1.0, lambda e: 10.0 ** e)
    opt = lib.optimizer.SGD(learning_rate=sched,
                            parameters=lin.parameters())

    def step():
        loss = lin(x).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    fn = lib.jit.to_static(step)
    moves, lrs, counts = [], [], []
    for _ in range(4):
        before = float(np.asarray(lin.weight.numpy()
                                  if lib is paddle else
                                  lin.weight.detach().numpy()).ravel()[0])
        lrs.append(opt.get_lr())
        fn()
        after = float(np.asarray(lin.weight.numpy()
                                 if lib is paddle else
                                 lin.weight.detach().numpy()).ravel()[0])
        moves.append(before - after)
        counts.append(int(np.asarray(opt._step_count.numpy())))
        sched.step()
    return moves, lrs, counts


def test_reference_to_static_freezes_the_rate():
    """The reference's to_static bakes the rate and the step count into
    its trace (its ``_sync_lr`` and the counter's update run while
    tracing); the port's replays read both.  If the reference is ever
    fixed, this test says so."""
    ref_moves, ref_lrs, ref_counts = _unit_step(paddle)
    moves, lrs, counts = _unit_step(pt)
    assert ref_lrs == lrs == [1.0, 10.0, 100.0, 1000.0]
    assert ref_moves == [1.0, 1.0, 1.0, 1.0]
    assert ref_counts == [1, 2, 2, 2]
    assert moves == [1.0, 10.0, 100.0, 1000.0]
    assert counts == [1, 2, 3, 4]


def test_set_lr_writes_the_device_rate_once():
    lin = pt.nn.Linear(2, 2, device="cpu")
    opt = pt.optimizer.SGD(learning_rate=0.5, parameters=lin.parameters())
    assert float(opt._lr_tensor) == 0.5 and opt.get_lr() == 0.5
    opt.set_lr(0.25)
    assert float(opt._lr_tensor) == 0.25 and type(opt.get_lr()) is float
    writes = []
    opt._lr_tensor.fill_ = lambda v: writes.append(v)  # noqa: E731
    opt._sync_lr()                       # unchanged: no write
    assert writes == []


def _small_decay_run(lib, lr, wd, steps=20):
    """``steps`` AdamW steps at a constant small rate over the MLP and a
    weight that the loss multiplies by 0: its gradient is 0, so AdamW
    moves it by the decoupled decay alone."""
    ref, port = _models()
    paddle.seed(5)
    ref_extra = rnn.Linear(8, 8).weight
    start = np.array(ref_extra.numpy(), np.float64)
    model = ref if lib is paddle else port
    if lib is paddle:
        extra = ref_extra
    else:
        extra = torch.nn.Parameter(_t(ref_extra.numpy()))
    opt = lib.optimizer.AdamW(
        learning_rate=lr, weight_decay=wd,
        parameters=list(model.parameters()) + [extra])
    for i in range(steps):
        x, y = _data(i)
        if lib is paddle:
            out, y = model(paddle.to_tensor(x)), paddle.to_tensor(y)
            loss = RF.mse_loss(out, y) + (extra * 0.0).sum()
        else:
            loss = ((model(_t(x)) - _t(y)) ** 2).mean() + \
                (extra * 0.0).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
    params = [np.asarray(p.numpy() if lib is paddle else
                         p.detach().numpy())
              for _, p in sorted(model.named_parameters())]
    end = np.asarray(extra.numpy() if lib is paddle
                     else extra.detach().numpy(), np.float64)
    return params, float(np.abs(start - end).sum())


@pytest.mark.parametrize("lr", [1e-5, 2e-5])
def test_adamw_small_decay_matches_reference(lr):
    """AdamW's decay at ``lr*wd`` of 1e-7 and 2e-7, a few times the f32
    spacing under 1.0 (6e-8): the decay kept inside the rounded sum, as
    the reference keeps it, moves the zero-gradient weight as far as the
    reference's does (a factor ``1 - lr*wd`` on the weight would round to
    ``1 - 1.19e-7`` or ``1 - 1.79e-7``: 19% too much or 11% too little)."""
    want, ref_move = _small_decay_run(paddle, lr, 0.01)
    got, move = _small_decay_run(pt, lr, 0.01)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    assert ref_move > 0
    assert abs(move - ref_move) <= 1e-2 * ref_move, (move, ref_move)
