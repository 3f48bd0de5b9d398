"""The small nets, DenseNet and GoogLeNet of the port against the
reference: names and shapes, the blocks, and the whole nets.

* ``state_dict`` keys and shapes of every new constructor (AlexNet,
  SqueezeNet 1.0 and 1.1, MobileNetV1 at 1.0 and 0.25, ShuffleNetV2 at
  each of its five scales, DenseNet-121/161/169/201, GoogLeNet) equal the
  reference's, and ``load_reference_state`` loads the reference's state.
  The reference's initializers are replaced by numpy zeros for the
  duration of each case here and below (its random draws compile once a
  shape); below, the reference then takes the port's initial state.
* ``_Fire``, ``_DWSep``, ``_ShuffleUnit`` (stride 1 and 2),
  ``_DenseLayer``, ``_Transition`` and ``_Inception`` against the
  reference in training mode, forward and backward, f32 within 1e-4 abs
  + rel, the parameters' gradients within 1e-4 of the block's largest,
  and the running statistics after the call.
* SqueezeNet 1.1, AlexNet, MobileNetV1 (0.25) and ShuffleNetV2 (0.5)
  whole at B=2, 3 x 64 x 64, 10 classes, every dropout at rate 0, in
  training mode (batch statistics): logits within 1e-4 of their largest
  magnitude, and every running statistic after the forward.  The
  reference runs each whole net under its lazy mode (one compiled graph;
  its eager mode compiles every op shape and takes 2-3x as long); its
  result is its eager mode's.  The backward of the whole nets is not
  compared at B=2: with 8 values a channel in the last batch norms, f32
  moves the input gradient of MobileNetV1 by 3.5% from f64 on its own
  (the port against itself), so the blocks hold the backward.
* GoogLeNet returns its two aux heads in training mode and None for
  them in eval mode (and without classes).  The new models and layers
  run on the card unless given ``device="cpu"`` and raise without one.
* ``slow``: GoogLeNet (train mode, with its aux heads) and DenseNet-121
  whole against the reference at B=4, 96 x 96, forward, as above.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import initializer as RI
from paddle_tpu.ops import creation as rcreation
from paddle_tpu.vision import models as RM
from paddle_tpu.vision.models import densenet_googlenet as rdg
from paddle_tpu.vision.models import small_nets as rsmall

import paddle_tpu_torch as pt
from paddle_tpu_torch.vision import models as M
from paddle_tpu_torch.vision.models import densenet_googlenet as tdg
from paddle_tpu_torch.vision.models import small_nets as tsmall

CONSTRUCTORS = [
    ("alexnet", {}), ("squeezenet1_0", {}), ("squeezenet1_1", {}),
    ("mobilenet_v1", {}), ("mobilenet_v1", {"scale": 0.25}),
    ("shufflenet_v2_x1_0", {}), ("densenet121", {}), ("densenet161", {}),
    ("densenet169", {}), ("densenet201", {}), ("googlenet", {})] + [
    ("ShuffleNetV2", {"scale": s}) for s in (0.25, 0.5, 1.5, 2.0)]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    if hasattr(t, "numpy"):
        t = t.numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


@pytest.fixture
def zero_reference_init(monkeypatch):
    """The reference's initializers give numpy zeros, and its batch norms'
    ``_mean``/``_variance`` start from numpy zeros and ones (the values
    its own ``zeros``/``ones`` give, without compiling one op a width)."""
    def zeros(self, shape, dtype):
        return np.zeros(shape, np.float32)
    for cls in (RI.KaimingUniform, RI.Uniform, RI.XavierNormal,
                RI.Constant, RI.Normal):
        monkeypatch.setattr(cls, "generate", zeros)
    for name, fill in (("zeros", np.zeros), ("ones", np.ones)):
        monkeypatch.setattr(rcreation, name,
                            lambda shape, *a, _f=fill, **k: paddle.to_tensor(
                                _f(shape, np.float32)))


def _kw_id(name, kw):
    return name + "".join(f"_{v}" for v in kw.values())


@pytest.mark.parametrize("name,kw", CONSTRUCTORS,
                         ids=[_kw_id(n, k) for n, k in CONSTRUCTORS])
def test_constructor_state_matches_reference(zero_reference_init, name, kw):
    ref = getattr(RM, name)(**kw)
    port = getattr(M, name)(device="cpu", **kw)
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    want = {k: v.shape for k, v in state.items()}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    assert any(k.endswith("._mean") for k in got) == (
        name not in ("alexnet", "squeezenet1_0", "squeezenet1_1"))
    pt.load_reference_state(port, state)
    assert all(float(p.detach().abs().max()) == 0.0
               for p in port.parameters())


def _load_port_state(ref, port):
    """The port's initial state into the reference, so both compute from
    the port's draws."""
    ref.set_state_dict({k: paddle.to_tensor(v.detach().numpy())
                        for k, v in port.state_dict().items()})


def _hold_block(ref, port, shape, seed):
    _load_port_state(ref, port)
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
    assert set(grads) == set(params)
    scale = max(float(np.abs(g).max()) for g in grads.values())
    for n, g in grads.items():
        np.testing.assert_allclose(_np(params[n].grad), g,
                                   atol=1e-4 * scale, rtol=1e-4, err_msg=n)
    bufs = dict(port.named_buffers())
    for n, b in ref.state_dict().items():
        if n in bufs:
            np.testing.assert_allclose(_np(bufs[n]), _np(b), **tol,
                                       err_msg=n)


def _kw():
    return dict(device=torch.device("cpu"), dtype=torch.float32,
                generator=torch.Generator().manual_seed(0))


#: block -> (reference, port, input shape)
BLOCKS = {
    "fire": (lambda: rsmall._Fire(16, 8, 12, 12),
             lambda: tsmall._Fire(16, 8, 12, 12, kw=_kw()), (2, 16, 7, 6)),
    "dwsep": (lambda: rsmall._DWSep(8, 16, 2),
              lambda: tsmall._DWSep(8, 16, 2, kw=_kw()), (3, 8, 9, 8)),
    "shuffle_s1": (lambda: rsmall._ShuffleUnit(16, 16, 1),
                   lambda: tsmall._ShuffleUnit(16, 16, 1, kw=_kw()),
                   (2, 16, 6, 7)),
    "shuffle_s2": (lambda: rsmall._ShuffleUnit(8, 16, 2),
                   lambda: tsmall._ShuffleUnit(8, 16, 2, kw=_kw()),
                   (3, 8, 9, 8)),
    "dense_layer": (lambda: rdg._DenseLayer(12, 4, 2),
                    lambda: tdg._DenseLayer(12, 4, 2, kw=_kw()),
                    (2, 12, 6, 5)),
    "transition": (lambda: rdg._Transition(12, 6),
                   lambda: tdg._Transition(12, 6, kw=_kw()), (2, 12, 7, 6)),
    "inception": (lambda: rdg._Inception(12, 4, 6, 8, 2, 4, 4),
                  lambda: tdg._Inception(12, 4, 6, 8, 2, 4, 4, kw=_kw()),
                  (2, 12, 6, 5)),
}


@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_matches_reference(zero_reference_init, block):
    make_ref, make_port, shape = BLOCKS[block]
    _hold_block(make_ref(), make_port(), shape, 42)


def test_channel_shuffle_interleaves_the_halves():
    x = torch.arange(6.0).reshape(1, 6, 1, 1)
    got = tsmall._channel_shuffle(x, 2).reshape(-1).tolist()
    assert got == [0.0, 3.0, 1.0, 4.0, 2.0, 5.0]
    ref = rsmall._channel_shuffle(paddle.to_tensor(x.numpy()), 2)
    assert _np(ref).reshape(-1).tolist() == got


def _no_dropout(ref, port):
    for s in ref.sublayers():
        if type(s).__name__ == "Dropout":
            s.p = 0.0
    for m in port.modules():
        if isinstance(m, pt.nn.Dropout):
            m.p = 0.0


def _hold_whole(ref, port, shape, seed, outputs=1):
    """One training-mode forward of both from the port's initial state
    (the reference under its lazy mode): each output within 1e-4 of its
    largest magnitude, every running statistic after it within 1e-4."""
    _load_port_state(ref, port)
    _no_dropout(ref, port)
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    with paddle.incubate.lazy_eager():
        rout = ref(paddle.to_tensor(x))
        rout = [_np(o) for o in (rout if outputs > 1 else [rout])]
        rstate = {k: _np(v) for k, v in ref.state_dict().items()}
    with torch.no_grad():
        tout = port(torch.from_numpy(x))
    tout = [_np(o) for o in (tout if outputs > 1 else [tout])]
    for got, want in zip(tout, rout):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    for n, b in port.named_buffers():
        np.testing.assert_allclose(_np(b), rstate[n], atol=1e-4, rtol=1e-4,
                                   err_msg=n)
    return tout


#: whole net -> constructor arguments (both packages' own)
SMALL_NETS = {
    "squeezenet1_1": ("squeezenet1_1", {}),
    "alexnet": ("alexnet", {}),
    "mobilenet_v1_0.25": ("mobilenet_v1", {"scale": 0.25}),
    "shufflenet_v2_0.5": ("ShuffleNetV2", {"scale": 0.5}),
}


@pytest.mark.parametrize("net", list(SMALL_NETS))
def test_small_net_matches_reference(zero_reference_init, net):
    name, kw = SMALL_NETS[net]
    port = getattr(M, name)(num_classes=10, device="cpu", **kw)
    ref = getattr(RM, name)(num_classes=10, **kw)
    (logits,) = _hold_whole(ref, port, (2, 3, 64, 64), 43)
    assert logits.shape == (2, 10)


def test_googlenet_aux_heads_in_training_only():
    model = M.googlenet(num_classes=10, device="cpu")
    x = torch.from_numpy(np.random.default_rng(44).standard_normal(
        (2, 3, 64, 64)).astype(np.float32))
    out, aux1, aux2 = model(x)
    assert out.shape == aux1.shape == aux2.shape == (2, 10)
    model.eval()
    with torch.no_grad():
        out, aux1, aux2 = model(x)
    assert out.shape == (2, 10) and aux1 is None and aux2 is None
    bare = M.googlenet(num_classes=0, device="cpu")
    assert not hasattr(bare, "aux1_fc")
    out, aux1, aux2 = bare(x)
    assert out.shape == (2, 1024, 1, 1) and aux1 is None and aux2 is None


def test_new_entry_points_default_to_cuda_and_refuse_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from paddle_tpu_torch.vision import ops as TO
    for make in (M.alexnet, M.squeezenet1_1, M.mobilenet_v1,
                 lambda: M.ShuffleNetV2(scale=0.25), M.densenet121,
                 M.googlenet, lambda: TO.DeformConv2D(4, 4, 3, device=None),
                 lambda: pt.nn.GroupNorm(2, 4, device=None),
                 lambda: pt.nn.InstanceNorm2D(4, device=None),
                 lambda: pt.nn.SpectralNorm([4, 3], device=None),
                 lambda: pt.nn.Conv2DTranspose(4, 4, 3, device=None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_new_constructors_refuse_pretrained():
    for make in (M.alexnet, M.squeezenet1_1, M.mobilenet_v1,
                 M.shufflenet_v2_x1_0, M.densenet121, M.googlenet):
        with pytest.raises(NotImplementedError, match="pretrained"):
            make(pretrained=True, device="cpu")


@pytest.mark.slow
def test_googlenet_and_densenet121_match_reference(zero_reference_init):
    """GoogLeNet (training mode: out, aux1, aux2) and DenseNet-121 whole,
    B=4, 3 x 96 x 96, 10 classes, dropout 0.  At B=2 and 64 x 64
    GoogLeNet's last inceptions see 1 x 1 maps, their batch norms 2 values
    a channel, and f32 moves its logits by 0.25% from f64 on its own (the
    port against itself); at this size by 5e-5."""
    port = M.googlenet(num_classes=10, device="cpu")
    outs = _hold_whole(RM.googlenet(num_classes=10), port, (4, 3, 96, 96),
                       45, outputs=3)
    assert all(o.shape == (4, 10) for o in outs)
    port = M.densenet121(num_classes=10, device="cpu")
    (logits,) = _hold_whole(RM.densenet121(num_classes=10), port,
                            (4, 3, 96, 96), 46)
    assert logits.shape == (4, 10)
