"""The port's optimizers against the reference's, on the tiny GPT.

The tiny GPT of ``tests/test_torch_train.py`` (vocab 256, hidden 64, 2
layers, composite attention) is built in the reference from a seed and
its weights go to the port.  Both then train on the same ids and labels:
each of the 14 optimizers (``SGD``, ``Momentum``, ``Adam``, ``AdamW``,
``Adamax``, ``Adagrad``, ``Adadelta``, ``RMSProp``, ``Lamb``, ``Rprop``,
``ASGD``, ``NAdam``, ``RAdam``, ``LBFGS``) for 3 steps (RAdam 5, so that
its rectified branch runs), and variants: a learning-rate scheduler,
scheduled betas, parameter groups, ``L1Decay``/``L2Decay``, each of the
three clips, ``lr_ratio``, pre-step hooks with the ``_skip_apply`` latch,
``skip_step_on_nonfinite`` with a gradient poisoned by a hook, and
``minimize`` with ``parameters=``/``no_grad_set=``.  Every loss and every
parameter after the steps is held to the f32 gate (1e-4 abs + 1e-4 rel),
but for the elements whose gradient's sign the two packages do not fix:
at some step its reference value was within 10 times the packages'
difference.  An optimizer that normalises the gradient (Adam's family,
Adamax, Rprop) moves such an element by about the learning rate whatever
its gradient's size, so where the two packages' rounding gives it
opposite signs (the key slice of each ``qkv_proj.bias`` has a gradient
of 0 in exact arithmetic) their steps part by up to twice the learning
rate.  Those elements are held to 2 x steps x the largest step (the
learning rate; Rprop's step grows by 1.2 a step), as
``chip_smoke.hold_sign_free`` holds them on the card, and they must be
under 1% of the elements with a gradient.

State: the reference's ``state_dict`` (as numpy) loaded into a fresh
port optimizer gives the reference's next step; the port's own
``state_dict`` into a fresh model and optimizer gives the uninterrupted
run's next step bit for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTPretrainingCriterion as RefCriterion
from paddle_tpu.optimizer import optimizer as ref_opt_mod

import paddle_tpu_torch as pt
from paddle_tpu_torch.optimizer import optimizer as port_opt_mod
from test_torch_train import ATOL, RTOL, TINY, _batch, _pair


def _sched(lib):
    lr = lib.optimizer.lr
    return lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4, T_max=4,
                                                   eta_min=1e-5),
                           warmup_steps=2, start_lr=2e-5, end_lr=1e-4)


def _groups(params, **extra):
    params = list(params)
    return [{"params": params[:7]},
            {"params": params[7:], "weight_decay": 0.5, **extra}]


#: name -> (builder(lib, params), steps); ``lib`` is ``paddle`` or ``pt``
CASES = {
    "SGD": (lambda lib, ps: lib.optimizer.SGD(
        learning_rate=1e-2, parameters=ps, weight_decay=0.01), 3),
    "Momentum": (lambda lib, ps: lib.optimizer.Momentum(
        learning_rate=1e-2, momentum=0.9, parameters=ps,
        weight_decay=0.01), 3),
    "Momentum_nesterov": (lambda lib, ps: lib.optimizer.Momentum(
        learning_rate=1e-2, momentum=0.9, parameters=ps,
        use_nesterov=True), 3),
    "Adam": (lambda lib, ps: lib.optimizer.Adam(
        learning_rate=1e-4, parameters=ps, weight_decay=0.01), 3),
    "AdamW": (lambda lib, ps: lib.optimizer.AdamW(
        learning_rate=1e-4, parameters=ps, weight_decay=0.01), 3),
    "Adamax": (lambda lib, ps: lib.optimizer.Adamax(
        learning_rate=1e-4, parameters=ps), 3),
    "Adagrad": (lambda lib, ps: lib.optimizer.Adagrad(
        learning_rate=1e-4, parameters=ps, weight_decay=0.01,
        initial_accumulator_value=0.1), 3),
    "Adadelta": (lambda lib, ps: lib.optimizer.Adadelta(
        learning_rate=0.5, parameters=ps, weight_decay=0.01), 3),
    "RMSProp": (lambda lib, ps: lib.optimizer.RMSProp(
        learning_rate=1e-4, parameters=ps, weight_decay=0.01), 3),
    "RMSProp_centered": (lambda lib, ps: lib.optimizer.RMSProp(
        learning_rate=1e-4, momentum=0.9, centered=True, parameters=ps),
        3),
    "Lamb": (lambda lib, ps: lib.optimizer.Lamb(
        learning_rate=1e-3, parameters=ps,
        exclude_from_weight_decay_fn=lambda p: len(p.shape) == 1), 3),
    "Rprop": (lambda lib, ps: lib.optimizer.Rprop(
        learning_rate=1e-4, parameters=ps), 3),
    "ASGD": (lambda lib, ps: lib.optimizer.ASGD(
        learning_rate=1e-2, batch_num=2, parameters=ps,
        weight_decay=0.01), 3),
    "NAdam": (lambda lib, ps: lib.optimizer.NAdam(
        learning_rate=1e-4, parameters=ps, weight_decay=0.01), 3),
    "RAdam": (lambda lib, ps: lib.optimizer.RAdam(
        learning_rate=1e-4, parameters=ps, weight_decay=0.01), 5),
    "LBFGS": (lambda lib, ps: lib.optimizer.LBFGS(
        learning_rate=1e-2, max_iter=3, history_size=4, parameters=ps), 3),
    "LBFGS_strong_wolfe": (lambda lib, ps: lib.optimizer.LBFGS(
        learning_rate=1.0, max_iter=2, history_size=4,
        line_search_fn="strong_wolfe", parameters=ps), 2),
    # the variants
    "AdamW_lr_scheduler": (lambda lib, ps: lib.optimizer.AdamW(
        learning_rate=_sched(lib), parameters=ps, weight_decay=0.01), 4),
    "Adam_scheduled_betas": (lambda lib, ps: lib.optimizer.Adam(
        learning_rate=1e-4, beta1=lambda: 0.8, beta2=lambda: 0.99,
        parameters=ps), 3),
    "AdamW_lr_ratio": (lambda lib, ps: lib.optimizer.AdamW(
        learning_rate=1e-4, parameters=ps, lr_ratio=lambda p: 0.5), 3),
    "SGD_param_groups": (lambda lib, ps: lib.optimizer.SGD(
        learning_rate=1e-2, parameters=_groups(ps), weight_decay=0.01), 3),
    "AdamW_param_groups": (lambda lib, ps: lib.optimizer.AdamW(
        learning_rate=1e-4, parameters=_groups(ps, learning_rate=0.1)), 3),
    "SGD_L1Decay": (lambda lib, ps: lib.optimizer.SGD(
        learning_rate=1e-2, parameters=ps,
        weight_decay=lib.regularizer.L1Decay(1e-3)), 3),
    "Adam_L1Decay": (lambda lib, ps: lib.optimizer.Adam(
        learning_rate=1e-4, parameters=ps,
        weight_decay=lib.regularizer.L1Decay(1e-2)), 3),
    "Momentum_L2Decay": (lambda lib, ps: lib.optimizer.Momentum(
        learning_rate=1e-2, parameters=ps,
        weight_decay=lib.regularizer.L2Decay(0.05)), 3),
    "AdamW_L2Decay": (lambda lib, ps: lib.optimizer.AdamW(
        learning_rate=1e-4, parameters=ps,
        weight_decay=lib.regularizer.L2Decay(0.1)), 3),
    "SGD_clip_by_value": (lambda lib, ps: lib.optimizer.SGD(
        learning_rate=1e-1, parameters=ps,
        grad_clip=lib.nn.ClipGradByValue(2e-3)), 3),
    "SGD_clip_by_norm": (lambda lib, ps: lib.optimizer.SGD(
        learning_rate=1e-1, parameters=ps,
        grad_clip=lib.nn.ClipGradByNorm(0.02)), 3),
    "SGD_clip_by_global_norm": (lambda lib, ps: lib.optimizer.SGD(
        learning_rate=1e-1, parameters=ps,
        grad_clip=lib.nn.ClipGradByGlobalNorm(0.5, group_name="g")), 3),
}


#: an element whose reference gradient is within this many times the
#: packages' difference has a sign the comparison does not fix
SIGN_MARGIN = 10.0


def _track(small, ref, port):
    """Mark the elements of the current gradients whose sign the packages
    do not fix (``small[name]``; see `SIGN_MARGIN`), and those with a
    gradient other than 0 (``small[name, "moved"]``: the embedding rows of
    tokens and positions not in the batch get an exact 0 in both)."""
    own = dict(port.named_parameters())
    for name, p in ref.named_parameters():
        if p.grad is None:
            continue
        g = np.asarray(p.grad.numpy(), np.float32)
        d = np.abs(g - own[name].grad.detach().numpy())
        for key, m in ((name, np.abs(g) <= SIGN_MARGIN * d),
                       ((name, "moved"), g != 0)):
            small[key] = small[key] | m if key in small else m


def _assert_params_close(ref, port, small=None, bound=0.0):
    """Every parameter within the f32 gate, but the elements ``small``
    marks, which are held to ``bound`` and must be under 1% of those whose
    gradient was not exactly 0."""
    own = dict(port.named_parameters())
    marked = total = 0
    for name, p in ref.named_parameters():
        got, want = own[name].detach().numpy(), np.asarray(p.numpy())
        m = (small or {}).get(name)
        if m is not None:
            np.testing.assert_allclose(got[m], want[m], atol=bound, rtol=0,
                                       err_msg=name)
            got, want = got[~m], want[~m]
            moved = small[name, "moved"]
            marked += int((m & moved).sum())
            total += int(moved.sum())
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=name)
    assert marked <= 0.01 * total, (marked, total)


def _bound(case, steps):
    """2 x steps x the largest step an element with a sign-free gradient
    can take (`_assert_params_close`)."""
    opt = CASES[case][0](pt, [torch.nn.Parameter(torch.zeros(1))])
    lr = opt._learning_rate
    lr = max(getattr(lr, "base_lr", 0.0), getattr(lr, "end_lr", 0.0)) \
        if hasattr(lr, "base_lr") else float(lr)
    grow = 1.2 ** steps if case.startswith("Rprop") else 1.0
    return 2 * steps * lr * grow


def _losses(ref, port, batch=None):
    ids, labels = _batch() if batch is None else batch
    ref_crit, port_crit = RefCriterion(), pt.GPTPretrainingCriterion()
    return (lambda: ref_crit(ref(paddle.to_tensor(ids)),
                             paddle.to_tensor(labels)),
            lambda: port_crit(port(torch.from_numpy(ids)),
                              torch.from_numpy(labels)))


def _step(opt, loss_fn):
    """One training step of ``opt``: a closure-driven ``step`` for LBFGS,
    else backward, step, clear; then the scheduler's step, if any.
    Returns the loss as a float."""
    if "LBFGS" in type(opt).__name__:
        def closure():
            opt.clear_grad()
            loss = loss_fn()
            loss.backward()
            return loss
        loss = opt.step(closure)
    else:
        loss = loss_fn()
        loss.backward()
        _apply(opt)
    return _value(loss)


def _apply(opt):
    opt.step()
    opt.clear_grad()
    sched = opt._learning_rate
    if not isinstance(sched, (int, float)):
        sched.step()


def _value(loss):
    return float(np.asarray(loss.numpy() if hasattr(loss, "_value")
                            else loss.detach()))


def _step_both(ref, port, ref_opt, port_opt, small):
    """One step of each package; gradients `_track`ed into ``small``
    between the backward and the update (LBFGS, which needs no marks,
    takes its closure steps)."""
    ref_fn, port_fn = _losses(ref, port)
    if "LBFGS" in type(port_opt).__name__:
        return _step(ref_opt, ref_fn), _step(port_opt, port_fn)
    losses = []
    for fn in (ref_fn, port_fn):
        loss = fn()
        loss.backward()
        losses.append(_value(loss))
    _track(small, ref, port)
    _apply(ref_opt)
    _apply(port_opt)
    return tuple(losses)


def _run_both(build, steps, seed=12):
    ref, port = _pair(seed=seed)
    ref_opt = build(paddle, ref.parameters())
    port_opt = build(pt, port.parameters())
    small = {}
    losses = [_step_both(ref, port, ref_opt, port_opt, small)
              for _ in range(steps)]
    return ref, port, ref_opt, port_opt, losses, small


def test_every_optimizer_has_a_case():
    names = {n.split("_")[0] for n in CASES}
    want = set(paddle.optimizer.__all__) - {"Optimizer", "lr"} \
        if hasattr(paddle.optimizer, "__all__") else None
    ported = set(pt.optimizer.__all__) - {"Optimizer", "lr"}
    assert len(ported) == 14 and ported <= names
    if want is not None:
        assert want == ported


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_reference(case):
    build, steps = CASES[case]
    ref, port, ref_opt, port_opt, losses, small = _run_both(build, steps)
    for want, got in losses:
        assert abs(got - want) <= ATOL + RTOL * abs(want), losses
    assert port_opt._step_count == int(np.asarray(
        ref_opt._step_count.numpy())) == steps
    _assert_params_close(ref, port, small, _bound(case, steps))
    moved = sum(not torch.equal(p, q) for p, q in zip(
        port.parameters(), _pair(seed=12)[1].parameters()))
    assert moved > 0, "the optimizer must move the parameters"


def _with_hook(make_hook, body):
    """Register ``make_hook(lib)`` on both packages around ``body()``."""
    removers = [ref_opt_mod.register_pre_step_hook(make_hook(paddle)),
                port_opt_mod.register_pre_step_hook(make_hook(pt))]
    try:
        return body()
    finally:
        for remove in removers:
            remove()


def test_pre_step_hook_skip_apply_latch():
    """A hook sets ``_skip_apply`` at the second step: that step changes
    nothing (gradients kept, step count unchanged), in both packages."""
    ref, port = _pair(seed=12)
    opts = {paddle: paddle.optimizer.AdamW(learning_rate=1e-4,
                                           parameters=ref.parameters()),
            pt: pt.optimizer.AdamW(learning_rate=1e-4,
                                   parameters=port.parameters())}
    calls = {paddle: 0, pt: 0}

    def make_hook(lib):
        def hook(opt, params):
            if opt is opts[lib]:
                calls[lib] += 1
                if calls[lib] == 2:
                    opt._skip_apply = True
        return hook

    ref_loss, port_loss = _losses(ref, port)
    small = {}

    def body():
        for _ in range(3):
            ref_loss().backward()
            port_loss().backward()
            _track(small, ref, port)
            for lib in (paddle, pt):
                opts[lib].step()
                if calls[lib] != 2:
                    opts[lib].clear_grad()
    _with_hook(make_hook, body)
    assert calls == {paddle: 3, pt: 3}
    assert opts[pt]._step_count == 2 == int(np.asarray(
        opts[paddle]._step_count.numpy()))
    _assert_params_close(ref, port, small, 2 * 2 * 1e-4)


def test_skip_step_on_nonfinite_with_a_poisoned_gradient():
    """A hook poisons the first gradient at the second step;
    ``skip_step_on_nonfinite`` runs the hooks, finds it, names it and
    skips the update, in both packages."""
    ref, port = _pair(seed=12)
    opts = {paddle: paddle.optimizer.Adam(learning_rate=1e-4,
                                          parameters=ref.parameters()),
            pt: pt.optimizer.Adam(learning_rate=1e-4,
                                  parameters=port.parameters())}
    calls = {paddle: 0, pt: 0}

    def make_hook(lib):
        def hook(opt, params):
            if opt is opts[lib]:
                calls[lib] += 1
                if calls[lib] == 2:
                    params[0].grad = params[0].grad * float("inf")
        return hook

    ref_loss, port_loss = _losses(ref, port)
    skipped = {paddle: [], pt: []}
    small = {}

    def body():
        for _ in range(3):
            ref_loss().backward()
            port_loss().backward()
            _track(small, ref, port)
            for lib in (paddle, pt):
                skipped[lib].append(
                    lib.amp.debugging.skip_step_on_nonfinite(opts[lib]))
                opts[lib].clear_grad()
    _with_hook(make_hook, body)
    assert skipped[paddle] == skipped[pt] == [False, True, False]
    report = pt.amp.debugging.last_nonfinite()
    assert report["var_name"] == "gpt.wte.weight"
    assert report["kind"] == paddle.amp.debugging.last_nonfinite()["kind"]
    assert opts[pt]._step_count == 2
    _assert_params_close(ref, port, small, 2 * 2 * 1e-4)


@pytest.mark.parametrize("how", ["parameters", "no_grad_set"])
def test_minimize_restricts_the_update(how):
    ref, port = _pair(seed=12)
    opts = [paddle.optimizer.SGD(learning_rate=1e-2,
                                 parameters=ref.parameters()),
            pt.optimizer.SGD(learning_rate=1e-2,
                             parameters=port.parameters())]
    start = {n: p.detach().clone() for n, p in port.named_parameters()}
    ref_loss, port_loss = _losses(ref, port)
    for opt, model, fn in zip(opts, (ref, port), (ref_loss, port_loss)):
        params = list(model.parameters())
        for _ in range(2):
            if how == "parameters":
                opt.minimize(fn(), parameters=params[:5])
            else:
                opt.minimize(fn(), no_grad_set=set(params[:5]))
            opt.clear_grad()
    _assert_params_close(ref, port)
    names = [n for n, _ in port.named_parameters()]
    kept = names[5:] if how == "parameters" else names[:5]
    for n, p in port.named_parameters():
        assert torch.equal(p, start[n]) == (n in kept), n


def test_reference_state_dict_loads_into_the_port():
    """Two AdamW steps with a scheduler in the reference; its state (as
    numpy) and weights go into a fresh port model and optimizer; the next
    step of each agrees within the f32 gate."""
    ref, _ = _pair(seed=12)
    ref_opt = CASES["AdamW_lr_scheduler"][0](paddle, ref.parameters())
    ref_loss = _losses(ref, None)[0]
    for _ in range(2):
        _step(ref_opt, ref_loss)
    state = {k: (v if isinstance(v, (dict, list)) else np.asarray(v.numpy()))
             for k, v in ref_opt.state_dict().items()}
    _, port = _pair(seed=12)
    pt.load_reference_state(
        port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    port_opt = CASES["AdamW_lr_scheduler"][0](pt, port.parameters())
    port_opt.set_state_dict(state)
    assert port_opt._step_count == 2
    assert port_opt.get_lr() == ref_opt.get_lr()
    small = {}
    want, got = _step_both(ref, port, ref_opt, port_opt, small)
    assert abs(got - want) <= ATOL + RTOL * abs(want)
    _assert_params_close(ref, port, small, 2 * 1e-4)


@pytest.mark.parametrize("case", ["AdamW_lr_scheduler", "Lamb", "RMSProp",
                                  "Rprop"])
def test_port_state_round_trip_is_bit_identical(case):
    """3 steps, then ``state_dict`` (parameters and optimizer) into a
    fresh model and optimizer and one more step: bit-identical to 4
    uninterrupted steps."""
    build, _ = CASES[case]

    def model():
        return _pair(seed=12)[1]

    whole = model()
    whole_opt = build(pt, whole.parameters())
    loss = _losses(None, whole)[1]
    for _ in range(4):
        _step(whole_opt, loss)

    first = model()
    first_opt = build(pt, first.parameters())
    loss = _losses(None, first)[1]
    for _ in range(3):
        _step(first_opt, loss)
    params = {k: v.clone() for k, v in first.state_dict().items()}
    state = {k: v.clone() if isinstance(v, torch.Tensor) else v
             for k, v in first_opt.state_dict().items()}
    second = model()
    second.load_state_dict(params)
    second_opt = build(pt, second.parameters())
    second_opt.set_state_dict(state)
    _step(second_opt, _losses(None, second)[1])
    for (n, a), b in zip(whole.named_parameters(), second.parameters()):
        assert torch.equal(a, b), n
