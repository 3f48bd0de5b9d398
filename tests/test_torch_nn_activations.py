"""The port's activations and activation layers against the reference's
(``paddle_tpu.nn.functional.activation`` and ``nn.layer.activation_pool``).

Every function of the reference's ``activation.py`` runs on the same
seeded numpy input in both packages: the f32 output within 1e-5 abs +
rel, and the gradient with respect to each floating input under one
seeded upstream gradient within the same tolerance.  The cases are those
of the reference's ``tests/test_nn.py::test_activations`` and
``tests/test_functional_extras.py::test_softmin_and_losses``, with each
function's non-default arguments (both ``gelu`` forms, ``prelu`` with
one weight and per channel in both data formats, ``softplus`` past its
threshold, ``log_softmax`` with ``dtype=``, ...).  The in-place forms are
held on their value and on writing into their input.  Under ``auto_cast``
``softmax`` and ``log_softmax`` (O1's black list) return f32 from bf16
inputs, as the reference's do.

The random ones cannot match the reference's draws (JAX keys against a
``torch.Generator``), so their deterministic parts are held to it:
``rrelu`` in eval is the reference's; in training its slopes lie in
``[lower, upper)`` with their mean near the middle.  ``gumbel_softmax``
with ``hard=True`` gives one-hot rows, as the reference's does, its
gradient is the soft values' (straight through, from the same draw),
and the argmax of its draws follows ``softmax(x)`` (the Gumbel-max
property) within 0.02 over 20000 draws.

Each layer of the reference's ``_act_layer`` factory, ``RReLU``,
``PReLU`` and ``Softmax2D`` is built with the same positional and
keyword arguments in both packages and held to the reference's output;
``PReLU``'s ``state_dict`` keys and values equal the reference's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF

import paddle_tpu_torch as pt
from paddle_tpu_torch.nn import functional as F

TOL = 1e-5


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.numpy(), np.float32)


def _close(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=what)


def _run(fn_ref, fn_port, arrays, seed=0):
    """Both packages' outputs on ``arrays`` and the gradients of every
    input under one seeded upstream gradient."""
    rx = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    tx = [torch.from_numpy(a).requires_grad_() for a in arrays]
    rout, tout = fn_ref(*rx), fn_port(*tx)
    up = np.random.default_rng(seed + 99).standard_normal(
        tuple(tout.shape)).astype(np.float32)
    (rout * paddle.to_tensor(up)).sum().backward()
    (tout * torch.from_numpy(up)).sum().backward()
    _close(tout, rout, "output")
    for i, (r, t) in enumerate(zip(rx, tx)):
        _close(t.grad, r.grad, f"gradient of input {i}")


def _x(shape=(4, 6), seed=0, scale=2.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


#: name -> (call on (functional module, *inputs), inputs)
CASES = {
    "relu": (lambda M, x: M.relu(x), [_x()]),
    "relu6": (lambda M, x: M.relu6(x * 4), [_x()]),
    "gelu": (lambda M, x: M.gelu(x), [_x()]),
    "gelu_tanh": (lambda M, x: M.gelu(x, approximate=True), [_x()]),
    "sigmoid": (lambda M, x: M.sigmoid(x), [_x()]),
    "silu": (lambda M, x: M.silu(x), [_x()]),
    "swish": (lambda M, x: M.swish(x), [_x()]),
    "mish": (lambda M, x: M.mish(x), [_x()]),
    "hardswish": (lambda M, x: M.hardswish(x), [_x(scale=3.0)]),
    "hardsigmoid": (lambda M, x: M.hardsigmoid(x), [_x(scale=4.0)]),
    "hardsigmoid_slope": (lambda M, x: M.hardsigmoid(x, 0.3, 0.4),
                          [_x(scale=2.0)]),
    "hardtanh": (lambda M, x: M.hardtanh(x, -0.5, 1.5), [_x()]),
    "leaky_relu": (lambda M, x: M.leaky_relu(x, 0.1), [_x()]),
    "elu": (lambda M, x: M.elu(x, 0.5), [_x()]),
    "selu": (lambda M, x: M.selu(x), [_x()]),
    "celu": (lambda M, x: M.celu(x, 2.0), [_x()]),
    "prelu_one": (lambda M, x, w: M.prelu(x, w),
                  [_x((2, 3, 4)), np.array([0.3], np.float32)]),
    "prelu_nchw": (lambda M, x, w: M.prelu(x, w),
                   [_x((2, 3, 4, 5)), np.array([0.1, 0.2, 0.3], np.float32)]),
    "prelu_nhwc": (lambda M, x, w: M.prelu(x, w, data_format="NHWC"),
                   [_x((2, 4, 5, 3)), np.array([0.1, 0.2, 0.3], np.float32)]),
    "rrelu_eval": (lambda M, x: M.rrelu(x, 0.1, 0.4), [_x()]),
    "softplus": (lambda M, x: M.softplus(x), [_x()]),
    "softplus_threshold": (lambda M, x: M.softplus(x, 2.0, 3.0),
                           [_x(scale=3.0)]),
    "softshrink": (lambda M, x: M.softshrink(x, 0.3), [_x()]),
    "hardshrink": (lambda M, x: M.hardshrink(x, 0.3), [_x()]),
    "softsign": (lambda M, x: M.softsign(x), [_x()]),
    "tanhshrink": (lambda M, x: M.tanhshrink(x), [_x()]),
    "tanh": (lambda M, x: M.tanh(x), [_x()]),
    "log_sigmoid": (lambda M, x: M.log_sigmoid(x), [_x(scale=8.0)]),
    "log_softmax": (lambda M, x: M.log_softmax(x), [_x()]),
    "log_softmax_axis_dtype": (
        lambda M, x: M.log_softmax(x, axis=0, dtype="float32"), [_x()]),
    "softmax": (lambda M, x: M.softmax(x), [_x()]),
    "softmax_axis": (lambda M, x: M.softmax(x, 1), [_x((2, 5, 3))]),
    "glu": (lambda M, x: M.glu(x), [_x()]),
    "glu_axis": (lambda M, x: M.glu(x, axis=1), [_x((2, 4, 3))]),
    "maxout": (lambda M, x: M.maxout(x, 2), [_x((2, 6, 3, 3))]),
    "maxout_axis3": (lambda M, x: M.maxout(x, 3, axis=3),
                     [_x((2, 3, 2, 6))]),
    "thresholded_relu": (lambda M, x: M.thresholded_relu(x, 0.5, 0.1),
                         [_x()]),
    "softmin": (lambda M, x: M.softmin(x), [_x()]),
    "softmin_axis": (lambda M, x: M.softmin(x, axis=0),
                     [np.array([[1.0, 2.0, 3.0]], np.float32).T]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_activation_matches_reference(name):
    call, arrays = CASES[name]
    _run(lambda *t: call(RF, *t), lambda *t: call(F, *t), arrays)


def test_reference_cases():
    """The values of the reference's own test_activations."""
    x = torch.tensor([-1.0, 0.0, 2.0])
    np.testing.assert_allclose(F.relu(x).numpy(), [0, 0, 2])
    np.testing.assert_allclose(F.sigmoid(x).numpy(),
                               1 / (1 + np.exp(-x.numpy())), rtol=1e-5)
    np.testing.assert_allclose(F.leaky_relu(x, 0.1).numpy(),
                               [-0.1, 0, 2], rtol=1e-5)
    assert F.gelu(x).shape == (3,)
    assert float(F.softmax(x).sum()) == pytest.approx(1.0, rel=1e-5)
    m = torch.tensor([[1.0, 2.0, 3.0]])
    np.testing.assert_allclose(F.softmin(m).numpy(),
                               np.exp(-m.numpy()) / np.exp(-m.numpy()).sum(),
                               rtol=1e-5)


@pytest.mark.parametrize("name,args", [
    ("relu_", ()), ("elu_", (0.7,)), ("tanh_", ()), ("softmax_", (0,))])
def test_inplace_activation(name, args):
    a = _x((3, 4), seed=5)
    r = paddle.to_tensor(a)
    t = torch.from_numpy(a.copy())
    rout = getattr(RF, name)(r, *args)
    tout = getattr(F, name)(t, *args)
    assert tout is t
    _close(t, rout, name)
    _close(t, r, name)


def test_softmax_dtype_under_auto_cast():
    """O1's black list: softmax and log_softmax of bf16 give f32; an op on
    neither list keeps bf16, in both packages."""
    a = _x((2, 8))
    r = paddle.to_tensor(a).astype("bfloat16")
    t = torch.from_numpy(a).to(torch.bfloat16)
    with paddle.amp.auto_cast(dtype="bfloat16"):
        want = [RF.softmax(r), RF.log_softmax(r), RF.gelu(r)]
    with pt.amp.auto_cast(dtype="bfloat16"):
        got = [F.softmax(t), F.log_softmax(t), F.gelu(t)]
    for g, w in zip(got, want):
        assert str(w.dtype).endswith(str(g.dtype).split(".")[-1])
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_rrelu_training_draws():
    x = torch.from_numpy(_x((64, 64)))
    gen = torch.Generator().manual_seed(3)
    out = F.rrelu(x, 0.1, 0.3, training=True, generator=gen)
    pos = x >= 0
    assert torch.equal(out[pos], x[pos])
    slope = out[~pos] / x[~pos]
    assert float(slope.min()) >= 0.1 - 1e-6
    assert float(slope.max()) < 0.3 + 1e-6
    assert abs(float(slope.mean()) - 0.2) < 0.01
    again = F.rrelu(x, 0.1, 0.3, training=True,
                    generator=torch.Generator().manual_seed(3))
    assert torch.equal(out, again)
    layer = pt.nn.RReLU(0.1, 0.3, generator=torch.Generator().manual_seed(3))
    assert torch.equal(layer(x), out)
    layer.eval()
    _close(layer(x), RF.rrelu(paddle.to_tensor(x.numpy()), 0.1, 0.3))


def test_gumbel_softmax_hard_and_straight_through():
    a = _x((6, 5), seed=2)
    ref = RF.gumbel_softmax(paddle.to_tensor(a), temperature=0.5, hard=True)
    ref = _np(ref)
    # the reference's structure: one-hot rows
    assert set(np.unique(ref)) <= {0.0, 1.0}
    np.testing.assert_allclose(ref.sum(-1), 1.0)
    x = torch.from_numpy(a).requires_grad_()
    up = torch.from_numpy(_x((6, 5), seed=9))
    y_hard = F.gumbel_softmax(x, 0.5, hard=True,
                              generator=torch.Generator().manual_seed(4))
    assert set(torch.unique(y_hard.detach()).tolist()) <= {0.0, 1.0}
    assert torch.equal(y_hard.detach().sum(-1), torch.ones(6))
    (y_hard * up).sum().backward()
    g_hard = x.grad.clone()
    x.grad = None
    y_soft = F.gumbel_softmax(x, 0.5, hard=False,
                              generator=torch.Generator().manual_seed(4))
    assert torch.equal(y_soft.argmax(-1), y_hard.argmax(-1))
    (y_soft * up).sum().backward()
    torch.testing.assert_close(g_hard, x.grad, atol=1e-6, rtol=1e-6)


def test_gumbel_softmax_draws_follow_softmax():
    a = np.array([1.0, 0.0, -0.5, 2.0], np.float32)
    x = torch.from_numpy(np.tile(a, (20000, 1)))
    y = F.gumbel_softmax(x, 1.0, hard=True,
                         generator=torch.Generator().manual_seed(7))
    freq = y.mean(0).numpy()
    want = np.exp(a) / np.exp(a).sum()
    np.testing.assert_allclose(freq, want, atol=0.02)


#: (layer name, positional args, keyword args, input shape)
LAYERS = [
    ("ReLU", (), {}, (3, 4)), ("ReLU6", (), {}, (3, 4)),
    ("GELU", (True,), {}, (3, 4)), ("GELU", (), {"approximate": False},
                                     (3, 4)),
    ("Sigmoid", (), {}, (3, 4)), ("Silu", (), {}, (3, 4)),
    ("Swish", (), {}, (3, 4)), ("Mish", (), {}, (3, 4)),
    ("Hardswish", (), {}, (3, 4)), ("Hardsigmoid", (), {}, (3, 4)),
    ("Hardtanh", (-0.5,), {"max": 0.7}, (3, 4)),
    ("LeakyReLU", (0.2,), {}, (3, 4)), ("ELU", (), {"alpha": 0.3}, (3, 4)),
    ("SELU", (), {}, (3, 4)), ("CELU", (1.5,), {}, (3, 4)),
    ("Softplus", (2.0, 5.0), {}, (3, 4)), ("Softshrink", (0.2,), {}, (3, 4)),
    ("Hardshrink", (), {"threshold": 0.4}, (3, 4)),
    ("Softsign", (), {}, (3, 4)), ("Tanhshrink", (), {}, (3, 4)),
    ("LogSigmoid", (), {}, (3, 4)), ("LogSoftmax", (0,), {}, (3, 4)),
    ("Softmax", (), {"axis": 1}, (2, 3, 4)), ("Tanh", (), {}, (3, 4)),
    ("GLU", (), {}, (3, 4)), ("Maxout", (2,), {}, (2, 4, 3)),
    ("ThresholdedReLU", (0.3, 0.05), {}, (3, 4)),
    ("Softmax2D", (), {}, (2, 3, 4, 5)),
]


@pytest.mark.parametrize("name,args,kwargs,shape", LAYERS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(LAYERS)])
def test_activation_layer_matches_reference(name, args, kwargs, shape):
    rl = getattr(paddle.nn, name)(*args, **kwargs)
    tl = getattr(pt.nn, name)(*args, **kwargs)
    _run(rl, tl, [_x(shape, seed=len(name))])
    assert list(tl.state_dict()) == list(rl.state_dict())


@pytest.mark.parametrize("fmt,shape,n", [("NCHW", (2, 3, 4, 5), 3),
                                         ("NHWC", (2, 4, 5, 3), 3),
                                         ("NCHW", (2, 3, 4), 1)])
def test_prelu_layer_matches_reference(fmt, shape, n):
    rl = paddle.nn.PReLU(n, 0.2, data_format=fmt)
    tl = pt.nn.PReLU(n, 0.2, data_format=fmt, device="cpu")
    assert list(tl.state_dict()) == list(rl.state_dict()) == ["weight"]
    _close(tl.state_dict()["weight"], rl.state_dict()["weight"])
    a = _x(shape, seed=n)
    rx = paddle.to_tensor(a, stop_gradient=False)
    tx = torch.from_numpy(a).requires_grad_()
    rout, tout = rl(rx), tl(tx)
    _close(tout, rout)
    rout.sum().backward()
    tout.sum().backward()
    _close(tx.grad, rx.grad)
    _close(tl.weight.grad, rl.weight.grad)


def test_every_activation_is_ported():
    import paddle_tpu.nn.functional.activation as ref_act
    import paddle_tpu.nn.layer.activation_pool as ref_layers
    assert set(ref_act.__all__) <= set(F.__all__)
    assert set(ref_layers.__all__) <= set(pt.nn.__all__)
