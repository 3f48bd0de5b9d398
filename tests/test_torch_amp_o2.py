"""AMP O2, GradScaler and the training forms the port no longer refuses,
against the reference.

O2: the tiny GPT of ``tests/test_torch_train.py`` in both packages, each
``amp.decorate(level="O2", dtype="bfloat16")``-ed and run under
``auto_cast(level="O2")``.  The dtype each block and sublayer returns
must be the reference's (the reference casts the inputs of every op, the
port those of its functionals), then the loss within 1e-3 relative and
every (bf16) gradient within 5e-2 of its largest magnitude: the bf16 O1
test's bounds.  Three AdamW steps round the f32 update into the bf16
parameters in both, without f32 master weights.  Each parameter element
is held by the class it falls in (`_assert_o2_params_close`): within
2^-7 of its magnitude (one to two bf16 ulps) plus lr / 4; where a bf16
ulp of it is at least lr / 2, so that rounding decides whether a step
moves it at all, within one ulp a step; and where the sign of Adam's
first moment is not fixed by the packages' bf16 gradients, within
2 x steps x lr.  Every parameter that the reference moved must move.

GradScaler: dynamic scaling (growth every 2 good steps, backoff on a
bad one) over 6 steps with a gradient poisoned by a pre-step hook at
steps 2 and 5, in f32 and in bf16 O2: the scale after each step, the
skipped steps and the step count must be the reference's, the f32
parameters must meet the f32 gate and the bf16 ones stay finite.  Its
``state_dict`` round-trips.

Forms: ``cross_entropy`` with soft labels, label smoothing, class
weights, ``use_softmax=False``, another axis and each reduction (values
and gradients within the f32 gate), and hard labels routed by dtype as
the reference routes them; ``layer_norm`` and
``fused_residual_layer_norm`` without affine parameters or over two
axes; GPT's untied LM head (3 AdamW steps); ``recompute_sequential``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
from paddle_tpu.models.gpt import GPTPretrainingCriterion as RefCriterion
from paddle_tpu.optimizer import optimizer as ref_opt_mod

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.optimizer import optimizer as port_opt_mod
from test_torch_optimizer import (SIGN_MARGIN, _assert_params_close,
                                  _track)
from test_torch_train import ATOL, RTOL, _batch, _pair


def _o2_pair(seed=11, **over):
    ref, port = _pair(seed=seed, **over)
    paddle.amp.decorate(ref, level="O2", dtype="bfloat16")
    pt.amp.decorate(port, level="O2", dtype="bfloat16")
    return ref, port


def _o2_losses(ref, port):
    ids, labels = _batch()
    with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        rl = RefCriterion()(ref(paddle.to_tensor(ids)),
                            paddle.to_tensor(labels))
    with pt.amp.auto_cast(level="O2", dtype="bfloat16"):
        pl = pt.GPTPretrainingCriterion()(port(torch.from_numpy(ids)),
                                          torch.from_numpy(labels))
    return rl, pl


def _f32(t):
    return np.asarray(t.numpy(), np.float32) if hasattr(t, "_value") \
        else t.detach().float().numpy()


SUBLAYERS = ("ln_1", "attn", "ln_2", "mlp")


def test_o2_dtype_flow_matches_reference():
    """Every block's and sublayer's output dtype, the final norm's and the
    logits' under O2, as the reference's; the parameters are bf16."""
    ref, port = _o2_pair()
    seen = {"ref": [], "port": []}
    for model, key, register in (
            (ref, "ref", "register_forward_post_hook"),
            (port, "port", "register_forward_hook")):
        for i, blk in enumerate(model.gpt.h):
            for name in SUBLAYERS + ("",):
                layer = getattr(blk, name) if name else blk
                getattr(layer, register)(
                    lambda l, a, o, tag=f"h.{i}.{name or 'block'}", k=key:
                    seen[k].append((tag, str(o.dtype).split(".")[-1])))
        getattr(model.gpt.ln_f, register)(
            lambda l, a, o, k=key: seen[k].append(
                ("ln_f", str(o.dtype).split(".")[-1])))
    ids = _batch()[0]
    with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        ref_logits = ref(paddle.to_tensor(ids))
    with pt.amp.auto_cast(level="O2", dtype="bfloat16"):
        port_logits = port(torch.from_numpy(ids))
    assert seen["port"] == seen["ref"]
    assert ("h.0.ln_1", "float32") in seen["port"]
    assert ("h.0.block", "bfloat16") in seen["port"]
    assert str(ref_logits.dtype).endswith("bfloat16")
    assert port_logits.dtype == torch.bfloat16
    assert {p.dtype for p in port.parameters()} == {torch.bfloat16}


def _track_moment(moments, small, ref, port, beta1=0.9):
    """Follow Adam's first moment of each package's bf16 gradients in f32
    (``moments[name]``, the reference's and the port's) and mark in
    ``small[name]`` the elements whose first-moment sign the packages do
    not fix (see `SIGN_MARGIN`): their step may go either way."""
    own = dict(port.named_parameters())
    for name, p in ref.named_parameters():
        grads = (_f32(p.grad), _f32(own[name].grad))
        mr, mp = (beta1 * m + (1 - beta1) * g for m, g in zip(
            moments.get(name, (0.0, 0.0)), grads))
        moments[name] = (mr, mp)
        m = np.abs(mr) <= SIGN_MARGIN * np.abs(mr - mp)
        small[name] = small[name] | m if name in small else m


def _assert_o2_params_close(ref, port, start, small, steps, lr):
    """The bf16 parameters after ``steps`` steps of size about ``lr``,
    held by the classes of the module docstring; the sign-free elements
    must stay under 15% of all."""
    own = dict(port.named_parameters())
    marked = total = 0
    for name, p in ref.named_parameters():
        got, want = _f32(own[name]), _f32(p)
        assert own[name].dtype == torch.bfloat16
        ulp = np.spacing(np.abs(want)) * 2.0 ** 16      # bf16's ulp
        coarse = ulp >= lr / 2
        bound = np.where(coarse, steps * ulp, lr / 4 + 2 ** -7 * np.abs(want))
        bound = np.where(small[name], 2 * steps * lr, bound)
        diff = np.abs(got - want)
        assert (diff <= bound).all(), (name, float((diff - bound).max()))
        if (want != start[name]).any():
            assert (got != start[name]).any(), name
        marked += int(small[name].sum())
        total += small[name].size
    assert marked <= 0.15 * total, (marked, total)


def test_o2_loss_grads_and_steps_match_reference():
    ref, port = _o2_pair()
    opts = (paddle.optimizer.AdamW(learning_rate=1e-3,
                                   parameters=ref.parameters()),
            pt.optimizer.AdamW(learning_rate=1e-3,
                               parameters=port.parameters()))
    steps, lr = 3, 1e-3
    start = {name: _f32(p).copy() for name, p in ref.named_parameters()}
    moments, small = {}, {}
    for step in range(steps):
        rl, pl = _o2_losses(ref, port)
        want, got = float(rl.numpy()), float(pl.detach())
        assert pl.dtype == torch.float32
        assert abs(got - want) <= 1e-3 * abs(want)
        rl.backward()
        pl.backward()
        if step == 0:
            own = dict(port.named_parameters())
            for name, p in ref.named_parameters():
                g = own[name].grad
                assert g.dtype == torch.bfloat16, name
                want_g = _f32(p.grad)
                np.testing.assert_allclose(
                    _f32(g), want_g, rtol=0,
                    atol=5e-2 * float(np.abs(want_g).max()), err_msg=name)
        _track_moment(moments, small, ref, port)
        for opt in opts:
            opt.step()
            opt.clear_grad()
    _assert_o2_params_close(ref, port, start, small, steps, lr)
    # the optimizer's moments stay f32; no master copy of the weights
    state = opts[1].state_dict()
    assert {k.rsplit("_", 1)[1] for k in state if k.endswith(
        ("moment1", "moment2"))} == {"moment1", "moment2"}
    assert all(v.dtype == torch.float32 for k, v in state.items()
               if k.endswith(("moment1", "moment2")))


def _scaler_run(lib, model, opt, loss_fn, poison_at, steps=6):
    """``steps`` GradScaler steps of ``opt``; a pre-step hook poisons the
    first gradient at the steps in ``poison_at`` (the test runs the hooks
    before ``scaler.step``, so that the scaler's check sees the fault).
    Returns the scale after each step and the steps whose update the
    scaler skipped."""
    scaler = lib.amp.GradScaler(init_loss_scaling=2.0 ** 10,
                                incr_every_n_steps=2)
    mod = ref_opt_mod if lib is paddle else port_opt_mod
    state = {"step": 0}

    def poison(o, params):
        if o is opt and state["step"] in poison_at:
            params[0].grad = params[0].grad * float("inf")

    remove = mod.register_pre_step_hook(poison)
    scales, skipped = [], []
    try:
        for step in range(steps):
            state["step"] = step
            scaler.scale(loss_fn()).backward()
            mod.run_pre_step_hooks(opt, opt._params_with_grad())
            scaler.step(opt)
            opt.clear_grad()
            scales.append(scaler._scale)
            if scaler._found_inf:
                skipped.append(step)
    finally:
        remove()
    return scaler, scales, skipped


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_scaler_matches_reference(dtype):
    if dtype == "float32":
        ref, port = _pair(seed=12)
    else:
        ref, port = _o2_pair(seed=12)
    ref_opt = paddle.optimizer.SGD(learning_rate=1e-2,
                                   parameters=ref.parameters())
    port_opt = pt.optimizer.SGD(learning_rate=1e-2,
                                parameters=port.parameters())
    ids, labels = _batch()
    amp_kw = dict(level="O2", dtype="bfloat16", enable=dtype != "float32")

    def ref_loss():
        with paddle.amp.auto_cast(**amp_kw):
            return RefCriterion()(ref(paddle.to_tensor(ids)),
                                  paddle.to_tensor(labels))

    def port_loss():
        with pt.amp.auto_cast(**amp_kw):
            return pt.GPTPretrainingCriterion()(port(torch.from_numpy(ids)),
                                                torch.from_numpy(labels))

    poison_at = (1, 4)
    _, ref_scales, ref_skipped = _scaler_run(paddle, ref, ref_opt, ref_loss,
                                             poison_at)
    scaler, scales, skipped = _scaler_run(pt, port, port_opt, port_loss,
                                          poison_at)
    assert scales == ref_scales == [1024.0, 512.0, 512.0, 1024.0, 512.0,
                                    512.0]
    assert skipped == ref_skipped == list(poison_at)
    assert port_opt._step_count == 4 == int(np.asarray(
        ref_opt._step_count.numpy()))
    report = pt.amp.debugging.last_nonfinite()
    assert report["var_name"] == "gpt.wte.weight" and "inf" in report["kind"]
    if dtype == "float32":
        _assert_params_close(ref, port)
    else:
        # bf16 gradients differ by a few ulps between the packages, so the
        # SGD steps do too: the parameters are held to be finite (an
        # update that let the inf through would not be)
        assert all(bool(torch.isfinite(p).all()) for p in port.parameters())
    fresh = pt.amp.GradScaler(init_loss_scaling=1.0, incr_every_n_steps=2)
    fresh.load_state_dict(scaler.state_dict())
    assert fresh.state_dict() == scaler.state_dict()


# ---------------------------------------------------------------------
# the forms: cross_entropy, layer norms without affine parameters, the
# untied head, recompute_sequential
# ---------------------------------------------------------------------
def _ce_inputs(case, rng):
    n, c = 12, 7
    logits = rng.standard_normal((n, c)).astype(np.float32)
    hard = rng.integers(0, c, n)
    hard[3] = -100
    soft = rng.random((n, c)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    weight = (0.5 + rng.random(c)).astype(np.float32)
    kw, label = {}, hard
    if case.startswith("soft"):
        kw["soft_label"], label = True, soft
    if "smooth" in case:
        kw["label_smoothing"] = 0.1
    if "weight" in case:
        kw["weight"] = weight
    if case == "probs":
        logits = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        kw["use_softmax"] = False
    if case == "axis1":
        logits = rng.standard_normal((3, c, 5)).astype(np.float32)
        label = rng.integers(0, c, (3, 1, 5))
        kw["axis"] = 1
    for red in ("sum", "none"):
        if case.endswith(red):
            kw["reduction"] = red
    return logits, label, kw


CE_CASES = ["soft", "soft_smooth", "smooth", "weight", "weight_sum",
            "weight_smooth_none", "probs", "axis1", "soft_none"]


@pytest.mark.parametrize("case", CE_CASES)
def test_cross_entropy_forms_match_reference(case):
    logits, label, kw = _ce_inputs(case, np.random.default_rng(3))
    rx = paddle.to_tensor(logits, stop_gradient=False)
    rkw = dict(kw, weight=paddle.to_tensor(kw["weight"])) \
        if "weight" in kw else kw
    rout = RF.cross_entropy(rx, paddle.to_tensor(label), **rkw)
    rout.sum().backward()
    px = torch.from_numpy(logits).requires_grad_()
    pkw = dict(kw, weight=torch.from_numpy(kw["weight"])) \
        if "weight" in kw else kw
    pout = F.cross_entropy(px, torch.from_numpy(label), **pkw)
    pout.sum().backward()
    np.testing.assert_allclose(pout.detach().numpy(), _f32(rout), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(px.grad.numpy(), _f32(rx.grad), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "float64"])
def test_cross_entropy_hard_labels_route_as_reference(dtype, monkeypatch):
    """Hard labels over f32, bf16 or f16 logits reach the softmax
    cross-entropy kernels' wrapper, as the reference's fused path takes
    them (loss.py:46-51; on the card the wrapper raises for f16, which
    the kernels do not take yet); f64 logits take the composite.  The
    loss is the reference's either way."""
    seen = []
    fused = F.ops.fused_softmax_cross_entropy
    monkeypatch.setattr(F.ops, "fused_softmax_cross_entropy",
                        lambda x, lab: seen.append(x.dtype) or fused(x, lab))
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((12, 7)).astype(np.float32)
    label = rng.integers(0, 7, 12)
    label[3] = -100
    want = _f32(RF.cross_entropy(paddle.to_tensor(logits).astype(dtype),
                                 paddle.to_tensor(label)))
    got = F.cross_entropy(torch.from_numpy(logits).to(getattr(torch, dtype)),
                          torch.from_numpy(label))
    assert seen == ([] if dtype == "float64" else [getattr(torch, dtype)])
    np.testing.assert_allclose(_f32(got), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("form", ["none", "weight", "bias", "two_axes",
                                  "residual_none", "residual_weight"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_forms_match_reference(form, dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 6, 16)).astype(np.float32)
    r = rng.standard_normal((4, 6, 16)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    b = (0.1 * rng.standard_normal(16)).astype(np.float32)
    shape = [6, 16] if form == "two_axes" else 16
    if form == "two_axes":
        w = (1 + 0.1 * rng.standard_normal((6, 16))).astype(np.float32)
    weight = w if form in ("weight", "two_axes", "residual_weight") else None
    bias = b if form == "bias" else None
    outs = []
    for lib, fn, to in (
            (paddle, RF, lambda a: paddle.to_tensor(a).astype(dtype)),
            (pt, F, lambda a: torch.from_numpy(a).to(getattr(torch,
                                                             dtype)))):
        args = [to(x)]
        args[0].stop_gradient = False if lib is paddle else None
        if lib is pt:
            args[0].requires_grad_()
        opt = dict(weight=None if weight is None else to(weight),
                   bias=None if bias is None else to(bias), epsilon=1e-5)
        if form.startswith("residual"):
            out = fn.fused_residual_layer_norm(args[0], to(r), shape, **opt)
        else:
            out = fn.layer_norm(args[0], shape, **opt)
        out.astype("float32").sum().backward() if lib is paddle \
            else out.float().sum().backward()
        outs.append((out, args[0].grad))
    (ro, rg), (po, pg) = outs
    assert str(ro.dtype).split(".")[-1] == str(po.dtype).split(".")[-1]
    tol = dict(atol=ATOL, rtol=RTOL) if dtype == "float32" \
        else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_f32(po), _f32(ro), **tol)
    np.testing.assert_allclose(_f32(pg), _f32(rg), **tol)


def test_untied_head_trains_like_reference():
    """``tie_word_embeddings=False``: the port's ``lm_head`` takes the
    reference's weight by name; 3 AdamW steps (global-norm clip 1.0) give
    the reference's losses and parameters."""
    ref, port = _pair(seed=13, tie_word_embeddings=False)
    names = [n for n, _ in port.named_parameters()]
    assert names[-1] == "lm_head.weight" and port.lm_head.bias is None
    opts = (paddle.optimizer.AdamW(
                learning_rate=1e-4, parameters=ref.parameters(),
                grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0)),
            pt.optimizer.AdamW(
                learning_rate=1e-4, parameters=port.parameters(),
                grad_clip=pt.nn.ClipGradByGlobalNorm(1.0)))
    ids, labels = _batch()
    small = {}
    for _ in range(3):
        rl = RefCriterion()(ref(paddle.to_tensor(ids)),
                            paddle.to_tensor(labels))
        pl = pt.GPTPretrainingCriterion()(port(torch.from_numpy(ids)),
                                          torch.from_numpy(labels))
        want, got = float(rl.numpy()), float(pl.detach())
        assert abs(got - want) <= ATOL + RTOL * abs(want)
        rl.backward()
        pl.backward()
        _track(small, ref, port)
        for opt in opts:
            opt.step()
            opt.clear_grad()
    _assert_params_close(ref, port, small, 2 * 3 * 1e-4)


def test_recompute_sequential():
    """Two segments over Linear/Tanh layers: the output and the input
    gradient equal the reference's within the f32 gate, and output and
    every gradient equal the port's own plain forward bit for bit.  (The
    reference recomputes each segment as a closure, which its
    ``recompute`` cannot see the parameters of, so its weights get no
    gradient there; the port wraps a run of modules in a ``Sequential``
    and keeps them.)"""
    rng = np.random.default_rng(8)
    dims = [(16, 32), (32, 32), (32, 16)]
    ws = [(0.2 * rng.standard_normal(d)).astype(np.float32) for d in dims]
    bs = [(0.1 * rng.standard_normal(d[1])).astype(np.float32)
          for d in dims]
    x = rng.standard_normal((5, 16)).astype(np.float32)

    ref_layers = []
    for w, b in zip(ws, bs):
        lin = paddle.nn.Linear(*w.shape)
        lin.weight.set_value(w)
        lin.bias.set_value(b)
        ref_layers += [lin, paddle.nn.Tanh()]
    rx = paddle.to_tensor(x, stop_gradient=False)
    rout = paddle.distributed.fleet.recompute_sequential(
        {"segments": 2}, paddle.nn.Sequential(*ref_layers), rx)
    rout.sum().backward()

    def port_model():
        layers = []
        for w, b in zip(ws, bs):
            lin = pt.nn.Linear(*w.shape, device="cpu")
            with torch.no_grad():
                lin.weight.copy_(torch.from_numpy(w))
                lin.bias.copy_(torch.from_numpy(b))
            layers += [lin, torch.nn.Tanh()]
        return torch.nn.Sequential(*layers)

    runs = []
    for recompute in (True, False):
        model = port_model()
        px = torch.from_numpy(x).requires_grad_()
        out = pt.distributed.fleet.recompute_sequential(
            {"segments": 2}, model, px) if recompute else model(px)
        out.sum().backward()
        runs.append((out.detach(), px.grad,
                     [p.grad.clone() for p in model.parameters()]))
    (out, gx, gp), (out0, gx0, gp0) = runs
    assert torch.equal(out, out0) and torch.equal(gx, gx0)
    assert all(torch.equal(a, b) for a, b in zip(gp, gp0))
    np.testing.assert_allclose(out.numpy(), _f32(rout), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(gx.numpy(), _f32(rx.grad), atol=ATOL,
                               rtol=RTOL)
