"""LeNet and ResNet-18 in the port vs the JAX reference, from the same
weights and batch, and the port's initializers and constructors.

* LeNet (B=4, 1 x 28 x 28, the only input its classifier takes) with 3
  Adam steps, and ResNet-18 (10 classes, B=4, 3 x 64 x 64, batch norm in
  training mode) with 3 Momentum steps: the logits, the loss, every
  step-1 gradient, every parameter after 3 steps and (ResNet-18) every
  batch norm's running mean and variance after 3 steps.  f32: 1e-4 abs +
  rel, as the card's parity phases hold them (``chip_smoke.PARITY_TOL``),
  gradients against each one's largest magnitude; Adam's steps of
  elements whose gradient lay within that gate of 0 (their sign decided
  by rounding) are held to 2 x steps x lr.  relu's derivative steps at 0,
  so where an input lies within ``chip_smoke.KINK_BAND`` of 0 the port's
  relu takes the reference's derivative (``chip_smoke.ReluKinks``, which
  the card's parity phase also uses against the CPU): one input within
  rounding of 0 on the other side moves its channel's gradients by
  percent (`test_relu_kinks_keep_values_and_take_the_recorded_side`).
  Momentum runs at lr 1e-3 (``chip_smoke.VISION_MOMENTUM_LR``: at 0.01
  the loss on 4 images falls to 0.002 in 3 steps, where the loss gate's
  1e-5 relative is rounding; at the recipe's 0.1 it goes 2.0, 3.9,
  11.2).
* Under ``auto_cast(bf16, O1)`` ResNet-18's logits are bf16 (``fc`` is
  white-listed), its batch norms return f32 (black list) and the loss is
  f32, on both sides.
* The initializers: bounds, means and standard deviations against their
  formulas (the two packages' generators differ, so values are not
  compared), the fans of matrices and convolution kernels, the gains.
* Constructors: ``state_dict`` keys and shapes equal to the reference's
  for LeNet and ResNet-18 (the other constructors:
  ``test_torch_vision_models.py``), ``pretrained=True`` raising, the CUDA
  default raising on a host without one.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
from paddle_tpu.vision import models as RM

import chip_smoke
import paddle_tpu_torch as pt
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.vision import models as M

TOL = chip_smoke.PARITY_TOL


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    if hasattr(t, "numpy"):         # a reference Tensor
        t = t.numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _state(ref):
    return {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}


def _pair(make_ref, make_port, seed):
    paddle.seed(seed)
    ref = make_ref()
    port = make_port()
    pt.load_reference_state(port, _state(ref))
    return ref, port


def _train(ref, port, x, y, opts, steps=3):
    """``steps`` steps of both models on one batch, the port's relus at
    the reference's kinks: the logits of step 1, the losses, the step-1
    gradients and, for each parameter, the elements whose gradient lay
    within the gradient gate of 0 at some step (reference side)."""
    kinks = chip_smoke.ReluKinks()
    for layer in ref.sublayers():
        if isinstance(layer, paddle.nn.ReLU):
            layer.register_forward_post_hook(
                lambda _, inputs, out: kinks.record(
                    torch.from_numpy(_np(inputs[0]).copy())))
    hooks = kinks.attach(port, pt.nn.ReLU, record=False)
    rx, ry = paddle.to_tensor(x), paddle.to_tensor(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    ref_opt, port_opt = opts
    losses, logits, grads, small = [], None, None, {}
    for step in range(steps):
        rlog = ref(rx)
        plog = port(tx)
        rl, pl = RF.cross_entropy(rlog, ry), F.cross_entropy(plog, ty)
        rl.backward()
        pl.backward()
        losses.append((float(rl.numpy()), float(pl.detach())))
        own = dict(port.named_parameters())
        if step == 0:
            logits = (_np(rlog), _np(plog))
            grads = {n: (_np(p.grad), own[n].grad.numpy().copy())
                     for n, p in ref.named_parameters()}
        for n, p in ref.named_parameters():
            g = np.abs(_np(p.grad))
            m = g <= TOL["grad"] * g.max()
            small[n] = small[n] | m if n in small else m
        for opt in opts:
            opt.step()
            opt.clear_grad()
    for h in hooks:
        h.remove()
    assert kinks.calls == len(kinks.sides)
    return logits, losses, grads, small


def _hold(ref, port, logits, losses, grads, small=None, lr=0.0, steps=3):
    np.testing.assert_allclose(logits[1], logits[0], atol=TOL["grad"],
                               rtol=TOL["grad"])
    for want, got in losses:
        assert abs(got - want) <= TOL["loss"] * abs(want), losses
    assert losses[-1][1] < losses[0][1]
    assert len(grads) == len(list(port.parameters()))
    for name, (want, got) in grads.items():
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= TOL["grad"] * scale, name
    own = dict(port.named_parameters())
    atol, rtol = TOL["param"]
    for name, p in ref.named_parameters():
        got, want = own[name].detach().numpy(), _np(p)
        if small is not None:       # Adam: sign-free elements
            m = small[name]
            assert np.abs(got - want)[m].max(initial=0) \
                <= 2 * steps * lr, name
            got, want = got[~m], want[~m]
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                                   err_msg=name)


def test_lenet_adam_matches_reference():
    ref, port = _pair(lambda: RM.LeNet(num_classes=10),
                      lambda: M.LeNet(num_classes=10, device="cpu"), 21)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((4, 1, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, (4,))
    lr = chip_smoke.PARITY_LR
    opts = (paddle.optimizer.Adam(learning_rate=lr,
                                  parameters=ref.parameters()),
            pt.optimizer.Adam(learning_rate=lr,
                              parameters=port.parameters()))
    logits, losses, grads, small = _train(ref, port, x, y, opts)
    assert logits[1].shape == (4, 10)
    _hold(ref, port, logits, losses, grads, small, lr)


def test_resnet18_momentum_matches_reference_with_bn_buffers():
    ref, port = _pair(lambda: RM.resnet18(num_classes=10),
                      lambda: M.resnet18(num_classes=10, device="cpu"), 23)
    rng = np.random.default_rng(24)
    x = rng.standard_normal((4, 3, 64, 64)).astype(np.float32)
    y = rng.integers(0, 10, (4,))
    lr = chip_smoke.VISION_MOMENTUM_LR
    opts = (paddle.optimizer.Momentum(learning_rate=lr, momentum=0.9,
                                      parameters=ref.parameters()),
            pt.optimizer.Momentum(learning_rate=lr, momentum=0.9,
                                  parameters=port.parameters()))
    logits, losses, grads, _ = _train(ref, port, x, y, opts)
    _hold(ref, port, logits, losses, grads)
    atol, rtol = TOL["param"]
    want = _state(ref)
    bufs = dict(port.named_buffers())
    assert len(bufs) == 40 and all(n.endswith(("._mean", "._variance"))
                                   for n in bufs)
    for name, b in bufs.items():
        np.testing.assert_allclose(b.numpy(), want[name], atol=atol,
                                   rtol=rtol, err_msg=name)
    # three updates moved every running variance off its initial 1
    assert all(not torch.equal(b, torch.ones_like(b))
               for n, b in bufs.items() if n.endswith("_variance"))


def test_resnet18_o1_dtypes_match_reference():
    ref, port = _pair(lambda: RM.resnet18(num_classes=10),
                      lambda: M.resnet18(num_classes=10, device="cpu"), 25)
    x = np.random.default_rng(26).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    y = np.array([1, 7])
    seen = []
    port.bn1.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    port.conv1.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
        plog = port(torch.from_numpy(x))
        pl = F.cross_entropy(plog, torch.from_numpy(y))
    with paddle.amp.auto_cast(dtype="bfloat16", level="O1"):
        rlog = ref(paddle.to_tensor(x))
        rl = RF.cross_entropy(rlog, paddle.to_tensor(y))
    assert seen == [torch.bfloat16, torch.float32]
    assert plog.dtype == torch.bfloat16 and str(rlog.dtype).endswith(
        "bfloat16")
    assert pl.dtype == torch.float32 and str(rl.dtype).endswith("float32")
    assert abs(float(pl.detach()) - float(rl.numpy())) \
        <= 2e-2 * abs(float(rl.numpy()))


@pytest.mark.parametrize("name", ["LeNet", "resnet18"])
def test_state_dict_names_and_shapes_match_reference(name):
    paddle.seed(1)
    ref = getattr(RM, name)()
    port = getattr(M, name)(device="cpu")
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    assert all(p.param_name == n for n, p in port.named_parameters())
    pt.load_reference_state(port, _state(ref))


def test_relu_kinks_keep_values_and_take_the_recorded_side():
    """An input within the band takes the recorded run's derivative (0.5
    where that run's input was exactly 0), its value stays the holding
    run's own, and inputs outside the band are untouched."""
    kinks = chip_smoke.ReluKinks(band=1e-4)
    kinks.record(torch.tensor([-3e-5, 0.0, 2e-5, 0.5, -0.5]))
    x = torch.tensor([2e-5, 1e-6, -1e-5, 0.5, -0.5], requires_grad=True)
    out = kinks.hold(x, F.relu(x))
    assert torch.equal(out.detach(), F.relu(x).detach())
    out.sum().backward()
    assert x.grad.tolist() == [0.0, 0.5, 1.0, 1.0, 0.0]
    assert kinks.held == 3 and kinks.calls == 1


# ---------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------
def _draw(init, shape, seed=0, dtype=torch.float32):
    t = torch.empty(shape, dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    assert init(t, gen) is t
    return t.float()


def test_fans_and_gains_match_reference():
    from paddle_tpu.nn import initializer as RI
    for shape in ((), (7,), (30, 20), (16, 8, 3, 3), (4, 2, 5)):
        assert I.fans(shape) == RI._fans(shape)
    for args in (("tanh",), ("relu",), ("leaky_relu",),
                 ("leaky_relu", math.sqrt(5)), ("selu",), ("linear",)):
        assert I.calculate_gain(*args) == RI.calculate_gain(*args)


def test_initializers_bounds_and_moments():
    shape = (256, 64, 3, 3)             # fan_in 576, fan_out 2304
    n = math.prod(shape)
    fi, fo = 64 * 9, 256 * 9
    # a standard deviation's estimate from n draws is off by ~1/sqrt(2n)
    # of itself, a mean by ~std/sqrt(n): 6 of each
    mom = 6 / math.sqrt(n)

    def moments(t, std):
        assert abs(float(t.mean())) <= 6 * std / math.sqrt(n)
        assert abs(float(t.std()) / std - 1) <= 6 / math.sqrt(2 * n)

    t = _draw(I.Constant(0.25), shape)
    assert bool((t == 0.25).all())
    moments(_draw(I.Normal(0.0, 0.3), shape), 0.3)
    t = _draw(I.Normal(2.0, 0.5), (1000,), 1)
    assert abs(float(t.mean()) - 2.0) < 6 * 0.5 / math.sqrt(1000)
    t = _draw(I.Uniform(-0.2, 0.6), shape)
    assert float(t.min()) >= -0.2 and float(t.max()) <= 0.6
    assert abs(float(t.mean()) - 0.2) <= 6 * (0.8 / math.sqrt(12)) \
        / math.sqrt(n)
    moments(_draw(I.XavierNormal(), shape), math.sqrt(2 / (fi + fo)))
    limit = math.sqrt(6 / (fi + fo))
    t = _draw(I.XavierUniform(), shape)
    assert float(t.abs().max()) <= limit and float(t.abs().max()) > \
        limit * (1 - mom)
    moments(t, limit / math.sqrt(3))
    moments(_draw(I.KaimingNormal(), shape), math.sqrt(2) / math.sqrt(fi))
    # the convolution layers' default: a bound of 1 / sqrt(fan_in)
    t = _draw(I.KaimingUniform(negative_slope=math.sqrt(5),
                               nonlinearity="leaky_relu"), shape)
    limit = 1 / math.sqrt(fi)
    assert float(t.abs().max()) <= limit * (1 + 1e-6)
    moments(t, limit / math.sqrt(3))
    # the negative slope counts only for leaky_relu, as in the reference
    t = _draw(I.KaimingUniform(negative_slope=math.sqrt(5)), shape)
    assert float(t.abs().max()) > limit * 1.4
    # fan_in given, and Xavier's fans given
    t = _draw(I.KaimingUniform(fan_in=4), (50, 50))
    assert float(t.abs().max()) <= math.sqrt(2) * math.sqrt(3 / 4) + 1e-6
    t = _draw(I.XavierUniform(fan_in=1, fan_out=2), (100,))
    assert float(t.abs().max()) <= math.sqrt(2) + 1e-6
    # one seed, one draw; bf16 tensors get the f32 draw rounded
    assert torch.equal(_draw(I.Normal(), (64,), 5), _draw(I.Normal(), (64,),
                                                          5))
    bf = _draw(I.Normal(), (64,), 5, torch.bfloat16)
    assert torch.equal(bf, _draw(I.Normal(), (64,), 5).bfloat16().float())


def test_layer_defaults_follow_the_reference_initializers():
    conv = pt.nn.Conv2D(8, 16, 3, groups=2, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    assert conv.weight.shape == (16, 4, 3, 3)
    bound = 1 / math.sqrt(4 * 9)
    assert float(conv.weight.detach().abs().max()) <= bound
    assert float(conv.bias.detach().abs().max()) <= bound
    assert pt.nn.Conv2D(8, 16, 3, bias_attr=False, device="cpu").bias is None
    ref = paddle.nn.Conv2D(8, 16, 3, groups=2)
    assert set(ref.state_dict()) == set(conv.state_dict())
    for cls in (pt.nn.BatchNorm1D, pt.nn.BatchNorm2D, pt.nn.BatchNorm3D,
                pt.nn.BatchNorm):
        bn = cls(5, device="cpu")
        assert torch.equal(bn.weight, torch.ones(5))
        assert torch.equal(bn.bias, torch.zeros(5))
        assert torch.equal(bn._mean, torch.zeros(5))
    assert pt.nn.BatchNorm2D(5, weight_attr=False, bias_attr=False,
                             device="cpu").weight is None
    for make in (lambda: pt.nn.Conv2D(3, 4, 3, weight_attr="w", device="cpu"),
                 lambda: pt.nn.BatchNorm2D(4, bias_attr="b", device="cpu"),
                 lambda: pt.nn.Conv2D(3, 4, 3, padding_mode="reflect",
                                      device="cpu")):
        with pytest.raises(NotImplementedError):
            make()


# ---------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------
def test_vision_constructors_default_to_cuda_and_refuse_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    for make in (M.LeNet, M.resnet18, M.mobilenet_v2,
                 lambda **kw: M.vgg11(batch_norm=True, **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    model = M.LeNet(device="cpu", dtype="bfloat16")
    assert model.fc[0].weight.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="pretrained"):
        M.resnet50(pretrained=True, device="cpu")
    with pytest.raises(NotImplementedError, match="pretrained"):
        M.mobilenet_v2(pretrained=True, device="cpu")


def test_constructors_draw_from_the_generator_given():
    a = M.LeNet(device="cpu", generator=torch.Generator().manual_seed(7))
    b = M.LeNet(device="cpu", generator=torch.Generator().manual_seed(7))
    c = M.LeNet(device="cpu", generator=torch.Generator().manual_seed(8))
    for (n, p), q, r in zip(a.named_parameters(), b.parameters(),
                            c.parameters()):
        assert torch.equal(p, q), n
        if n.endswith("weight"):
            assert not torch.equal(p, r), n
    default = M.LeNet(device="cpu")
    seeded = M.LeNet(device="cpu", generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(p, q) for p, q in zip(default.parameters(),
                                                 seeded.parameters()))
