"""Every ported vision constructor against the reference's names and
shapes, the blocks of the larger models against the reference, and one
training step of each larger model.

* ``state_dict`` keys and shapes of each of the 9 ResNet constructors,
  the 8 VGGs (with and without batch norm) and MobileNetV2 equal the
  reference's, and ``load_reference_state`` loads the reference's state
  as it is, the batch norms' ``_mean`` and ``_variance`` included.  Only
  names and shapes are compared here, so the reference's initializers are
  replaced by zeros for the duration of each case (its random draws
  compile once a shape and take most of a build's time).
* A ResNeXt bottleneck (groups 4, downsample, stride 2) and a
  MobileNetV2 inverted residual (expansion 6, the depthwise convolution,
  ``ReLU6`` and the residual) against the reference in training mode,
  forward and backward, f32 within 1e-4 abs + rel, the parameters'
  gradients within 1e-4 of the block's largest (the expansion's batch
  norm weight gradient is ~0: the depthwise convolution and the next
  batch norm leave the block invariant to each channel's scale but for
  the norm's epsilon, so it is a sum that cancels to 1e-4 of the bias
  gradient's size), and their running statistics after the call.
* One forward and backward of ResNet-50, ``resnext50_32x4d``,
  ``vgg11(batch_norm=True)`` (its classifier: 120 M parameters) and
  MobileNetV2 at B=2, 32 x 32, 10 classes, in training mode (dropout on,
  from the model's generator): finite logits of shape [2, 10] and a
  finite gradient for every parameter.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import initializer as RI
from paddle_tpu.vision import models as RM
from paddle_tpu.vision.models import mobilenet as rmobilenet
from paddle_tpu.vision.models import resnet as rresnet

import paddle_tpu_torch as pt
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.vision import models as M
from paddle_tpu_torch.vision.models import mobilenet as tmobilenet

CONSTRUCTORS = [
    ("resnet18", {}), ("resnet34", {}), ("resnet50", {}), ("resnet101", {}),
    ("resnet152", {}), ("wide_resnet50_2", {}), ("wide_resnet101_2", {}),
    ("resnext50_32x4d", {}), ("mobilenet_v2", {})] + [
    (f"vgg{d}", {"batch_norm": bn}) for d in (11, 13, 16, 19)
    for bn in (False, True)]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    if hasattr(t, "numpy"):
        t = t.numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


@pytest.fixture
def zero_reference_init(monkeypatch):
    def zeros(self, shape, dtype):
        return jnp.zeros(shape, dtype)
    for cls in (RI.KaimingUniform, RI.Uniform, RI.XavierNormal,
                RI.Constant):
        monkeypatch.setattr(cls, "generate", zeros)


@pytest.mark.parametrize("name,kw", CONSTRUCTORS,
                         ids=[n + ("_bn" if k else "")
                              for n, k in CONSTRUCTORS])
def test_constructor_state_matches_reference(zero_reference_init, name, kw):
    ref = getattr(RM, name)(**kw)
    port = getattr(M, name)(device="cpu", **kw)
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    want = {k: v.shape for k, v in state.items()}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    assert any(k.endswith("._mean") for k in got) == (
        not name.startswith("vgg") or kw["batch_norm"])
    pt.load_reference_state(port, state)
    assert all(float(p.detach().abs().max()) == 0.0
               for p in port.parameters())


def _hold_block(ref, port, shape, seed):
    own = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    pt.load_reference_state(port, own)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    rx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_()
    rout, tout = ref(rx), port(tx)
    up = rng.standard_normal(tuple(tout.shape)).astype(np.float32)
    (rout * paddle.to_tensor(up)).sum().backward()
    (tout * torch.from_numpy(up)).sum().backward()
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(tout), _np(rout), **tol)
    np.testing.assert_allclose(_np(tx.grad), _np(rx.grad), **tol)
    params = dict(port.named_parameters())
    grads = {n: _np(p.grad) for n, p in ref.named_parameters()}
    scale = max(float(np.abs(g).max()) for g in grads.values())
    for n, g in grads.items():
        np.testing.assert_allclose(_np(params[n].grad), g,
                                   atol=1e-4 * scale, rtol=1e-4, err_msg=n)
    bufs = dict(port.named_buffers())
    for n, b in ref.state_dict().items():
        if n in bufs:
            np.testing.assert_allclose(_np(bufs[n]), _np(b), **tol,
                                       err_msg=n)


def test_resnext_bottleneck_matches_reference():
    paddle.seed(31)
    down = paddle.nn.Sequential(
        paddle.nn.Conv2D(32, 64, 1, stride=2, bias_attr=False),
        paddle.nn.BatchNorm2D(64))
    ref = rresnet.BottleneckBlock(32, 16, 2, down, groups=4, base_width=8)
    port = M.BottleneckBlock(
        32, 16, 2, pt.nn.Sequential(
            pt.nn.Conv2D(32, 64, 1, stride=2, bias_attr=False,
                         device="cpu"),
            pt.nn.BatchNorm2D(64, device="cpu")),
        groups=4, base_width=8, device="cpu")
    assert port.conv2.weight.shape == (8, 2, 3, 3)
    _hold_block(ref, port, (3, 32, 9, 9), 32)


def test_mobilenet_inverted_residual_matches_reference():
    paddle.seed(33)
    ref = rmobilenet.InvertedResidual(16, 16, 1, 6)
    kw = dict(device=torch.device("cpu"), dtype=torch.float32,
              generator=torch.Generator().manual_seed(0))
    port = tmobilenet.InvertedResidual(16, 16, 1, 6, kw=kw)
    assert port.use_res and port.conv[1][0].weight.shape == (96, 1, 3, 3)
    _hold_block(ref, port, (2, 16, 7, 7), 34)


@pytest.mark.parametrize("name,kw", [
    ("resnet50", {}), ("resnext50_32x4d", {}),
    ("vgg11", {"batch_norm": True}), ("mobilenet_v2", {})])
def test_large_models_train_one_step(name, kw):
    model = getattr(M, name)(num_classes=10, device="cpu", **kw)
    rng = np.random.default_rng(35)
    x = torch.from_numpy(rng.standard_normal((2, 3, 32, 32)).astype(
        np.float32))
    logits = model(x)
    assert logits.shape == (2, 10) and bool(torch.isfinite(logits).all())
    F.cross_entropy(logits, torch.tensor([3, 8])).backward()
    for n, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), n
