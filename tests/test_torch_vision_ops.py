"""The vision functionals of the port vs the JAX reference, from the same
numpy inputs: convolutions, pooling, batch norm and the activations.

Each case runs the reference's functional (``paddle_tpu.nn.functional``)
and the port's (``paddle_tpu_torch.nn.functional``) on the same values,
forward and, through a random upstream gradient, backward to every
floating input.  f32 is held within 1e-5 abs + rel of the largest
reference magnitude (sums taken in another order); bf16 within 2^-7 of
it (about two bf16 ulps at that scale: the two packages round their
bf16 sums at other points), and the gradients of weights, biases and
the batch norm's affine parameters, each a sum over the batch and the
spatial positions (up to ~150 bf16 terms here, which the reference
accumulates in bf16), within 2^-5 of it (sqrt(150) half-ulps of drift).

* Convolutions: every padding form of the reference's ``_norm_padding``
  (an int, per-dim ints, asymmetric ``[lo, hi]`` pairs, the layout form,
  ``"SAME"`` with stride 2 and ``"VALID"``), groups and dilation, NCHW and
  NHWC, 1-D and 3-D; the dtype rule (f16 computed in f32, mixed operands
  promoted).
* Pooling: max and average, symmetric, asymmetric and ``"SAME"`` padding,
  ``exclusive`` on and off, ``divisor_override``; adaptive pools whose
  output does and does not divide the input; NCHW and NHWC; 1-D and 3-D.
  ``ceil_mode=True`` floors, as the reference.
* Transposed convolutions: symmetric and asymmetric padding,
  ``output_padding`` past the padding, groups and dilation, channels
  last, 1-D, 2-D and 3-D; string padding refused by both packages;
  ``output_size`` accepted where it equals the size computed; the
  layers.
* The masks of ``return_mask=True`` exactly equal to the reference's
  (ties included: integer-valued inputs), fixed and adaptive, 1-D, 2-D
  and 3-D; ``max_unpool*d`` against the reference and round-tripping a
  mask, with and without ``output_size``; the layers.
* Instance, group and local response norm, ``normalize`` and
  ``spectral_norm`` and their layers (names and shapes as the
  reference's); ``SyncBatchNorm`` raises.
* The initializers ``TruncatedNormal`` (bounds in units of ``std``),
  ``Orthogonal`` (orthonormal rows or columns times ``gain``), ``Dirac``
  and ``Assign`` (exactly the reference's values), and
  ``set_global_initializer`` (refused unless None).
* Batch norm in training and in eval, NCHW and NHWC, with its running
  statistics after one call (Paddle's momentum, the unbiased variance);
  the layers' buffers under the reference's names; the dtypes under O1.
* ``relu`` and ``relu6`` at exact 0 and 6: the reference's gradient 0.5
  at each tie.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF

import paddle_tpu_torch as pt
from paddle_tpu_torch.nn import functional as F

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
SUM_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    if hasattr(t, "numpy"):         # a reference Tensor
        t = t.numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, dtype, what="", tols=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = tols[dtype] * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tols[dtype],
                               err_msg=what)


def _run_both(ref_fn, port_fn, arrays, dtype, seed=0):
    """``ref_fn`` / ``port_fn`` on ``arrays`` (f32 numpy, cast to
    ``dtype`` inside the graph): outputs and the gradients of each input
    under one random upstream gradient."""
    rx = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    rout = ref_fn(*[t.astype(dtype) for t in rx])
    tx = [torch.from_numpy(a).requires_grad_() for a in arrays]
    tout = port_fn(*[t.to(_TORCH[dtype]) for t in tx])
    assert tout.dtype == _TORCH[dtype]
    assert str(rout.dtype).endswith(dtype)
    up = np.random.default_rng(seed + 99).standard_normal(
        tuple(tout.shape)).astype(np.float32)
    (rout.astype("float32") * paddle.to_tensor(up)).sum().backward()
    (tout.float() * torch.from_numpy(up)).sum().backward()
    return (rout, [t.grad for t in rx]), (tout, [t.grad for t in tx])


def _hold(ref, port, dtype):
    (rout, rgrads), (tout, tgrads) = ref, port
    _close(tout, rout, dtype, "output")
    for i, (g, r) in enumerate(zip(tgrads, rgrads)):
        _close(g, r, dtype, f"gradient of input {i}",
               TOL if i == 0 else SUM_TOL)


# ---------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------
#: (padding, stride, dilation, groups, bias)
CONV2D_CASES = {
    "int": (1, 1, 1, 1, True),
    "per_dim": ([1, 2], 1, 1, 1, True),
    "asymmetric": ([0, 1, 2, 0], 1, 1, 1, False),
    "pairs": ([[1, 0], [0, 2]], 2, 1, 1, True),
    "same_stride2": ("SAME", 2, 1, 1, True),
    "same_stride2_dilated": ("same", 2, 2, 1, False),
    "valid": ("VALID", 2, 1, 1, True),
    "groups_dilation": (2, 1, 2, 2, True),
    "depthwise": (1, 2, 1, 4, False),
}


#: the cases that also run channels last, and in bf16
NHWC_CONV = ("int", "asymmetric", "same_stride2", "depthwise")
BF16_CONV = ("int", "asymmetric", "pairs", "same_stride2",
             "groups_dilation", "depthwise")


@pytest.mark.parametrize("case,data_format,dtype", [
    (c, "NCHW", "float32") for c in CONV2D_CASES] + [
    (c, "NHWC", "float32") for c in NHWC_CONV] + [
    (c, "NCHW", "bfloat16") for c in BF16_CONV] + [
    ("int", "NHWC", "bfloat16")])
def test_conv2d_matches_reference(case, data_format, dtype):
    padding, stride, dilation, groups, bias = CONV2D_CASES[case]
    rng = np.random.default_rng(len(case))
    n, c, h, w, o = 2, 4, 9, 8, 6 if groups != 4 else 4
    shape = (n, c, h, w) if data_format == "NCHW" else (n, h, w, c)
    arrays = [rng.standard_normal(shape).astype(np.float32),
              (rng.standard_normal((o, c // groups, 3, 3)) * 0.3
               ).astype(np.float32)]
    if bias:
        arrays.append(rng.standard_normal(o).astype(np.float32))

    def call(mod):
        return lambda x, wt, *b: mod.conv2d(
            x, wt, b[0] if b else None, stride, padding, dilation, groups,
            data_format)
    _hold(*_run_both(call(RF), call(F), arrays, dtype), dtype)


@pytest.mark.parametrize("data_format", ["NCL", "NLC"])
@pytest.mark.parametrize("padding", [[1, 3], "SAME", 2])
def test_conv1d_matches_reference(padding, data_format):
    rng = np.random.default_rng(3)
    shape = (2, 3, 11) if data_format == "NCL" else (2, 11, 3)
    arrays = [rng.standard_normal(shape).astype(np.float32),
              rng.standard_normal((5, 3, 4)).astype(np.float32),
              rng.standard_normal(5).astype(np.float32)]

    def call(mod):
        return lambda x, wt, b: mod.conv1d(x, wt, b, 2, padding, 1, 1,
                                           data_format)
    _hold(*_run_both(call(RF), call(F), arrays, "float32"), "float32")


@pytest.mark.parametrize("data_format", ["NCDHW", "NDHWC"])
@pytest.mark.parametrize("padding", ["SAME", [0, 1, 1, 0, 2, 1], 1])
def test_conv3d_matches_reference(padding, data_format):
    rng = np.random.default_rng(4)
    shape = (1, 2, 5, 6, 7) if data_format == "NCDHW" else (1, 5, 6, 7, 2)
    arrays = [rng.standard_normal(shape).astype(np.float32),
              rng.standard_normal((3, 2, 3, 3, 2)).astype(np.float32)]

    def call(mod):
        return lambda x, wt: mod.conv3d(x, wt, None, 2, padding, 1, 1,
                                        data_format)
    _hold(*_run_both(call(RF), call(F), arrays, "float32"), "float32")


@pytest.mark.parametrize("nsp", [1, 2, 3])
@pytest.mark.parametrize("channels_last", [False, True])
def test_conv_layout_padding_form(nsp, channels_last):
    """The layout form pads each spatial dim by its own pair.  The
    reference takes pairs 2: of the list whatever the layout (so it would
    pad by the channels' pair in a channels-last layout), and in 2-D reads
    the 4 entries as flat ``lo, hi`` values and raises: the port is held to
    the reference given the spatial pairs alone."""
    pairs = [[1, 0], [0, 2], [2, 1]][:nsp]
    layout = [[0, 0]] + pairs + [[0, 0]] if channels_last \
        else [[0, 0], [0, 0]] + pairs
    df = {1: "NCL", 2: "NCHW", 3: "NCDHW"}[nsp]
    if channels_last:
        df = df[0] + df[2:] + "C"
    rng = np.random.default_rng(6 + nsp)
    spatial = (7, 6, 5)[:nsp]
    shape = (2,) + spatial + (3,) if channels_last else (2, 3) + spatial
    arrays = [rng.standard_normal(shape).astype(np.float32),
              rng.standard_normal((4, 3) + (3,) * nsp).astype(np.float32)]
    name = f"conv{nsp}d"
    ref, port = _run_both(
        lambda x, wt: getattr(RF, name)(x, wt, None, 1, pairs,
                                        data_format=df),
        lambda x, wt: getattr(F, name)(x, wt, None, 1, layout,
                                       data_format=df),
        arrays, "float32")
    _hold(ref, port, "float32")


def test_same_padding_puts_the_odd_element_high():
    from paddle_tpu_torch.nn.functional.conv import same_pads
    # 9 rows, stride 2, kernel 3: 5 outputs need 2 rows of padding (1, 1);
    # 8 columns: 4 outputs need 1 (0, 1); dilation 2 widens the kernel to 5
    assert same_pads((9, 8), (3, 3), (2, 2), (1, 1)) == [(1, 1), (0, 1)]
    assert same_pads((8,), (3,), (2,), (2,)) == [(1, 2)]
    assert same_pads((4,), (1,), (2,), (1,)) == [(0, 0)]


def test_conv_dtype_rule_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 6, 6)).astype(np.float32)
    w = (rng.standard_normal((4, 3, 3, 3)) * 0.3).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    # f16 operands: computed in f32, cast back to f16
    ref = RF.conv2d(paddle.to_tensor(x).astype("float16"),
                    paddle.to_tensor(w).astype("float16"), None, 1, 1)
    got = F.conv2d(torch.from_numpy(x).half(), torch.from_numpy(w).half(),
                   None, 1, 1)
    assert got.dtype == torch.float16 and str(ref.dtype).endswith("float16")
    np.testing.assert_allclose(_np(got), _np(ref), atol=2e-3, rtol=2e-3)
    # mixed operands promote; the f32 bias added after promotes the output
    ref = RF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w).astype(
        "bfloat16"), paddle.to_tensor(b), 1, "SAME")
    got = F.conv2d(torch.from_numpy(x), torch.from_numpy(w).bfloat16(),
                   torch.from_numpy(b), 1, "SAME")
    assert got.dtype == torch.float32 and str(ref.dtype).endswith("float32")
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-4, rtol=1e-4)
    got = F.conv2d(torch.from_numpy(x).bfloat16(),
                   torch.from_numpy(w).bfloat16(), torch.from_numpy(b))
    assert got.dtype == torch.float32      # bf16 conv + f32 bias


def test_conv_is_white_listed_under_o1():
    x, w = torch.randn(1, 2, 5, 5), torch.randn(3, 2, 3, 3)
    with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
        assert F.conv2d(x, w, torch.zeros(3)).dtype == torch.bfloat16
        assert F.conv1d(x[:, :, 0], w[:, :, 0]).dtype == torch.bfloat16
    with paddle.amp.auto_cast(dtype="bfloat16", level="O1"):
        ref = RF.conv2d(paddle.to_tensor(x.numpy()),
                        paddle.to_tensor(w.numpy()),
                        paddle.to_tensor(np.zeros(3, np.float32)))
    assert str(ref.dtype).endswith("bfloat16")


# ---------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------
#: (functional, kernel, stride, padding, keyword arguments)
POOL2D_CASES = {
    "max_resnet": ("max_pool2d", 3, 2, 1, {}),
    "max_k2": ("max_pool2d", 2, 2, 0, {}),
    "max_same": ("max_pool2d", 3, 2, "SAME", {}),
    "max_asymmetric": ("max_pool2d", 3, 2, [0, 1, 2, 1], {}),
    "max_valid": ("max_pool2d", [3, 2], [1, 2], "VALID", {}),
    "avg_exclusive": ("avg_pool2d", 3, 2, 1, {}),
    "avg_inclusive": ("avg_pool2d", 3, 2, 1, {"exclusive": False}),
    "avg_same": ("avg_pool2d", 3, 2, "SAME", {}),
    "avg_same_inclusive": ("avg_pool2d", 3, 2, "SAME",
                           {"exclusive": False}),
    "avg_asymmetric": ("avg_pool2d", 3, 2, [1, 0, 0, 2], {}),
    "avg_asymmetric_inclusive": ("avg_pool2d", 3, 2, [1, 0, 0, 2],
                                 {"exclusive": False}),
    "avg_divisor": ("avg_pool2d", 3, 2, 1, {"divisor_override": 4}),
    "avg_divisor_asymmetric": ("avg_pool2d", 2, 2, [0, 1, 1, 0],
                               {"divisor_override": 3}),
    "avg_no_pad": ("avg_pool2d", 2, None, 0, {}),
}


#: the cases that also run channels last, and in bf16
NHWC_POOL = ("max_resnet", "max_asymmetric", "avg_exclusive", "avg_same",
             "avg_divisor_asymmetric")
BF16_POOL = ("max_resnet", "max_same", "avg_exclusive",
             "avg_asymmetric_inclusive", "avg_divisor")


@pytest.mark.parametrize("case,data_format,dtype", [
    (c, "NCHW", "float32") for c in POOL2D_CASES] + [
    (c, "NHWC", "float32") for c in NHWC_POOL] + [
    (c, "NCHW", "bfloat16") for c in BF16_POOL] + [
    ("max_resnet", "NHWC", "bfloat16")])
def test_pool2d_matches_reference(case, data_format, dtype):
    name, kernel, stride, padding, kw = POOL2D_CASES[case]
    rng = np.random.default_rng(len(case) + 7)
    shape = (2, 3, 9, 8) if data_format == "NCHW" else (2, 9, 8, 3)
    x = rng.standard_normal(shape).astype(np.float32)

    def call(mod):
        return lambda v: getattr(mod, name)(
            v, kernel, stride, padding, data_format=data_format, **kw)
    _hold(*_run_both(call(RF), call(F), [x], dtype), dtype)


@pytest.mark.parametrize("case", ["max1d", "avg1d", "max3d", "avg3d",
                                  "avg3d_divisor", "max3d_ndhwc",
                                  "avg1d_nlc"])
def test_pool1d_and_3d_match_reference(case):
    rng = np.random.default_rng(11)
    three = "3d" in case
    last = case.endswith(("ndhwc", "nlc"))
    shape = (1, 2, 5, 6, 7) if three else (2, 3, 13)
    if last:
        shape = (shape[0],) + shape[2:] + (shape[1],)
    df = ("NDHWC" if three else "NLC") if last else \
        ("NCDHW" if three else "NCL")
    x = rng.standard_normal(shape).astype(np.float32)
    name = ("max_pool" if case.startswith("max") else "avg_pool") \
        + ("3d" if three else "1d")
    kw = {"divisor_override": 5} if "divisor" in case else {}

    def call(mod):
        return lambda v: getattr(mod, name)(v, 3, 2, 1, data_format=df,
                                            **kw)
    _hold(*_run_both(call(RF), call(F), [x], "float32"), "float32")


#: (functional, input spatial shape, output size, data format)
ADAPTIVE_CASES = {
    "avg2d_divides": ("adaptive_avg_pool2d", (8, 6), (1, 1), "NCHW"),
    "avg2d_divides_4x3": ("adaptive_avg_pool2d", (8, 6), (4, 3), "NCHW"),
    "avg2d_uneven": ("adaptive_avg_pool2d", (7, 9), (3, 5), "NCHW"),
    "avg2d_upsamples": ("adaptive_avg_pool2d", (2, 3), (7, 7), "NCHW"),
    "avg2d_nhwc": ("adaptive_avg_pool2d", (7, 9), (3, 4), "NHWC"),
    "max2d_divides": ("adaptive_max_pool2d", (8, 10), (4, 5), "NCHW"),
    "max2d_uneven": ("adaptive_max_pool2d", (8, 10), (3, 4), "NCHW"),
    "avg1d": ("adaptive_avg_pool1d", (10,), 4, "NCL"),
    "max1d": ("adaptive_max_pool1d", (10,), 3, "NCL"),
    "avg3d_ndhwc": ("adaptive_avg_pool3d", (4, 5, 6), (2, 3, 4), "NDHWC"),
    "max3d": ("adaptive_max_pool3d", (4, 5, 6), (3, 2, 4), "NCDHW"),
}


#: the cases also run in bf16 (max pooling's ties among rounded values)
BF16_ADAPTIVE = ("avg2d_uneven", "max2d_uneven", "max1d", "max3d")


@pytest.mark.parametrize("case,dtype", [
    (c, "float32") for c in ADAPTIVE_CASES] + [
    (c, "bfloat16") for c in BF16_ADAPTIVE])
def test_adaptive_pool_matches_reference(case, dtype):
    name, spatial, out, df = ADAPTIVE_CASES[case]
    rng = np.random.default_rng(len(case) + 13)
    shape = (2, 3) + spatial if df.startswith("NC") \
        else (2,) + spatial + (3,)
    x = rng.standard_normal(shape).astype(np.float32)
    kw = {} if df in ("NCHW", "NCL", "NCDHW") else {"data_format": df}

    def call(mod):
        return lambda v: getattr(mod, name)(v, out, **kw)
    _hold(*_run_both(call(RF), call(F), [x], dtype), dtype)


def test_ceil_mode_return_mask_and_unpool_raise():
    """``ceil_mode`` is ignored as in the reference (floored windows:
    2 x 2 on 5 x 5, where torch's ceil gives 3 x 3); what still raises:
    a 2-D channels-last mask (the reference reads it as NCHW), a 1-D
    channels-last unpool (read as NCL there), an unpool index past the
    output (as there) and ``divisor_override`` with string padding."""
    x = np.random.default_rng(12).standard_normal((1, 2, 5, 5)).astype(
        np.float32)
    tx, rx = torch.from_numpy(x), paddle.to_tensor(x)
    for name in ("max_pool2d", "avg_pool2d"):
        got = getattr(F, name)(tx, 2, 2, ceil_mode=True)
        want = getattr(RF, name)(rx, 2, 2, ceil_mode=True)
        assert tuple(got.shape) == tuple(want.shape) == (1, 2, 2, 2)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)
    got = pt.nn.MaxPool2D(3, 2, ceil_mode=True)(tx)
    want = paddle.nn.MaxPool2D(3, 2, ceil_mode=True)(rx)
    assert tuple(got.shape) == tuple(want.shape) == (1, 2, 2, 2)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)
    with pytest.raises(NotImplementedError, match="NCHW"):
        F.max_pool2d(tx.permute(0, 2, 3, 1), 2, return_mask=True,
                     data_format="NHWC")
    with pytest.raises(NotImplementedError, match="NCL"):
        F.max_unpool1d(tx[:, :, 0], tx[:, :, 0].long(), 2,
                       data_format="NLC")
    _, mask = F.max_pool2d(tx, 2, 2, return_mask=True)
    with pytest.raises(ValueError, match="output_size"):
        F.max_unpool2d(tx[:, :, :2, :2], mask + 16, 2)
    with pytest.raises(NotImplementedError, match="string padding"):
        F.avg_pool2d(tx, 2, 2, "SAME", divisor_override=2)


# ---------------------------------------------------------------------
# batch norm
# ---------------------------------------------------------------------
@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_matches_reference(training, dtype, data_format):
    rng = np.random.default_rng(17)
    c = 5
    shape = (4, c, 3, 2) if data_format == "NCHW" else (4, 3, 2, c)
    x = (rng.standard_normal(shape) * 2 + 0.7).astype(np.float32)
    wt = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    b = (0.3 * rng.standard_normal(c)).astype(np.float32)
    rm = (0.1 * rng.standard_normal(c)).astype(np.float32)
    rv = (1 + 0.1 * rng.random(c)).astype(np.float32)
    ref_stats = [paddle.to_tensor(a) for a in (rm, rv)]
    port_stats = [torch.from_numpy(a.copy()) for a in (rm, rv)]

    def ref_fn(v, w_, b_):
        return RF.batch_norm(v, *ref_stats, w_, b_, training=training,
                             momentum=0.8, epsilon=1e-5,
                             data_format=data_format).astype(dtype)

    def port_fn(v, w_, b_):
        return F.batch_norm(v, *port_stats, w_, b_, training=training,
                            momentum=0.8, epsilon=1e-5,
                            data_format=data_format).to(_TORCH[dtype])
    # x in dtype; the affine parameters stay f32, as a model's do
    ref, port = _run_both(
        lambda v, w_, b_: ref_fn(v, w_.astype("float32"),
                                 b_.astype("float32")),
        lambda v, w_, b_: port_fn(v, w_.float(), b_.float()),
        [x, wt, b], dtype)
    _hold(ref, port, dtype)
    for got, want in zip(port_stats, ref_stats):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6,
                                   rtol=1e-6)
    if training:     # Paddle's momentum and the unbiased variance
        axes = tuple(i for i in range(4) if i != shape.index(c))
        xv = torch.from_numpy(x).to(_TORCH[dtype]).float().numpy()
        n = x.size // c
        np.testing.assert_allclose(
            port_stats[0].numpy(), 0.8 * rm + 0.2 * xv.mean(axes),
            atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(
            port_stats[1].numpy(),
            0.8 * rv + 0.2 * xv.var(axes) * n / (n - 1), atol=1e-5,
            rtol=1e-5)
    else:
        assert np.array_equal(port_stats[0].numpy(), rm)


def test_batch_norm_layers_buffers_and_o1_dtypes():
    bn = pt.nn.BatchNorm2D(4, device="cpu")
    assert list(bn.state_dict()) == ["weight", "bias", "_mean", "_variance"]
    assert torch.equal(bn._variance, torch.ones(4)) and bn.training
    ref = paddle.nn.BatchNorm2D(4)
    assert set(ref.state_dict()) == set(bn.state_dict())
    x = torch.randn(3, 4, 2, 2).bfloat16()
    with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
        out = bn(x)
        assert out.dtype == torch.float32            # black list
        assert F.relu(out).dtype == torch.float32    # on neither list
        bn.eval()
        assert bn(x).dtype == torch.float32    # bf16 x, f32 weight
    with paddle.amp.auto_cast(dtype="bfloat16", level="O1"):
        rout = ref(paddle.to_tensor(x.float().numpy()).astype("bfloat16"))
    assert str(rout.dtype).endswith("float32")
    one = pt.nn.BatchNorm1D(3, momentum=0.5, device="cpu")
    v = torch.randn(6, 3)
    one(v)
    np.testing.assert_allclose(one._mean.numpy(), 0.5 * v.mean(0).numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(one._variance.numpy(),
                               0.5 + 0.5 * v.var(0).numpy(), atol=1e-6)


def test_batch_norm_use_global_stats_in_training():
    x = np.random.default_rng(19).standard_normal((4, 3, 2, 2)).astype(
        np.float32)
    rm, rv = np.full(3, 0.5, np.float32), np.full(3, 2.0, np.float32)
    stats = [torch.from_numpy(a.copy()) for a in (rm, rv)]
    got = F.batch_norm(torch.from_numpy(x), *stats, training=True,
                       use_global_stats=True)
    want = RF.batch_norm(paddle.to_tensor(x), paddle.to_tensor(rm),
                         paddle.to_tensor(rv), training=True,
                         use_global_stats=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6)
    assert np.array_equal(stats[0].numpy(), rm)


# ---------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["relu", "relu6"])
def test_relu_ties_take_the_reference_gradient(name, dtype):
    x = np.array([-1.0, 0.0, 2.0, 6.0, 7.0, -0.0], np.float32)
    ref, port = _run_both(getattr(RF, name), getattr(F, name), [x], dtype)
    _hold(ref, port, dtype)
    want = {"relu": [0, 0.5, 1, 1, 1, 0.5],
            "relu6": [0, 0.5, 1, 0.5, 0, 0.5]}[name]
    up = np.random.default_rng(99).standard_normal(6).astype(np.float32)
    np.testing.assert_allclose(_np(port[1][0]),
                               np.asarray(want, np.float32) * _np(
                                   torch.from_numpy(up).to(_TORCH[dtype])),
                               rtol=1e-6)
    assert torch.equal(getattr(pt.nn, name.upper().replace(
        "RELU", "ReLU"))()(torch.from_numpy(x)), getattr(F, name)(
        torch.from_numpy(x)))


def test_relu_inplace():
    x = torch.tensor([-2.0, 0.0, 3.0])
    assert F.relu_(x) is x and x.tolist() == [0.0, 0.0, 3.0]
    leaf = torch.tensor([-1.0, 0.0, 1.0], requires_grad=True)
    y = leaf * 1.0
    F.relu_(y).sum().backward()
    assert leaf.grad.tolist() == [0.0, 0.5, 1.0]


# ---------------------------------------------------------------------
# transposed convolutions
# ---------------------------------------------------------------------
#: (dims, padding, stride, dilation, groups, output_padding, layout)
CONV_T_CASES = {
    "2d_int": (2, 1, 2, 1, 1, 0, "NCHW"),
    "2d_output_padding": (2, 1, 2, 1, 1, 1, "NCHW"),
    "2d_asymmetric": (2, [0, 1, 2, 0], 2, 1, 2, 1, "NCHW"),
    "2d_pairs": (2, [[1, 0], [0, 2]], 2, 1, 1, 0, "NCHW"),
    "2d_groups_dilation": (2, 0, 3, 2, 2, [2, 1], "NCHW"),
    "2d_output_padding_past_padding": (2, 0, 2, 1, 1, 1, "NCHW"),
    "2d_nhwc": (2, 2, 2, 1, 1, 1, "NHWC"),
    "1d_asymmetric": (1, [1, 3], 2, 1, 1, 1, "NCL"),
    "1d_nlc": (1, 2, 2, 1, 2, 0, "NLC"),
    "3d": (3, [0, 1, 1, 0, 2, 1], 2, 1, 1, 0, "NCDHW"),
    "3d_ndhwc": (3, 1, 2, 1, 1, 1, "NDHWC"),
}


@pytest.mark.parametrize("case", list(CONV_T_CASES))
def test_conv_transpose_matches_reference(case):
    nsp, padding, stride, dilation, groups, opad, df = CONV_T_CASES[case]
    rng = np.random.default_rng(len(case) + 60)
    spatial = (6, 5, 4)[:nsp]
    shape = (2, 4) + spatial if df.startswith("NC") \
        else (2,) + spatial + (4,)
    arrays = [rng.standard_normal(shape).astype(np.float32),
              (0.3 * rng.standard_normal((4, 6 // groups) + (3,) * nsp)
               ).astype(np.float32),
              rng.standard_normal(6).astype(np.float32)]
    name = f"conv{nsp}d_transpose"

    def call(mod):
        return lambda x, wt, b: getattr(mod, name)(
            x, wt, b, stride, padding, opad, groups, dilation,
            data_format=df)
    _hold(*_run_both(call(RF), call(F), arrays, "float32"), "float32")


def test_conv_transpose_bf16_and_f16_match_reference():
    rng = np.random.default_rng(61)
    arrays = [rng.standard_normal((2, 4, 5, 6)).astype(np.float32),
              (0.3 * rng.standard_normal((4, 3, 3, 3))).astype(np.float32)]

    def call(mod):
        return lambda x, wt: mod.conv2d_transpose(x, wt, None, 2,
                                                  [1, 0, 0, 1], 1)
    _hold(*_run_both(call(RF), call(F), arrays, "bfloat16"), "bfloat16")
    x, w = (torch.from_numpy(a).half() for a in arrays)
    got = F.conv2d_transpose(x, w, None, 2, 1)
    want = RF.conv2d_transpose(*(paddle.to_tensor(a).astype("float16")
                                 for a in arrays), None, 2, 1)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-3, rtol=2e-3)


def test_conv_transpose_asymmetric_crop_follows_the_reference():
    """Length (in - 1) * s + d * (k - 1) + 1 - lo - hi + output_padding;
    the full transposed convolution cropped by lo below, and by hi less
    output_padding above (zeros past its end)."""
    x = torch.randn(1, 1, 4)
    w = torch.randn(1, 1, 3)
    full = F.conv1d_transpose(x, w, None, 2, 0)
    assert full.shape[-1] == (4 - 1) * 2 + 3
    for lo, hi, opad in ((0, 2, 0), (2, 0, 1), (1, 3, 1), (0, 0, 1)):
        got = F.conv1d_transpose(x, w, None, 2, [lo, hi], opad)
        want = torch.cat([full, torch.zeros(1, 1, 1)], -1)[
            ..., lo:full.shape[-1] - hi + opad]
        assert got.shape[-1] == 9 - lo - hi + opad
        torch.testing.assert_close(got, want)
        ref = RF.conv1d_transpose(paddle.to_tensor(x.numpy()),
                                  paddle.to_tensor(w.numpy()), None, 2,
                                  [lo, hi], opad)
        np.testing.assert_allclose(_np(got), _np(ref), atol=1e-6)


def test_conv_transpose_refuses_string_padding_and_other_output_size():
    x = np.zeros((1, 2, 5, 5), np.float32)
    w = np.zeros((2, 3, 3, 3), np.float32)
    for pad in ("SAME", "VALID"):
        with pytest.raises(NotImplementedError, match="string padding"):
            F.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                               None, 2, pad)
        # the reference refuses it inside XLA
        with pytest.raises(ValueError, match="String padding"):
            RF.conv2d_transpose(paddle.to_tensor(x), paddle.to_tensor(w),
                                None, 2, pad)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    assert F.conv2d_transpose(tx, tw, None, 2, 1, output_size=[9, 9]
                              ).shape == (1, 3, 9, 9)
    with pytest.raises(NotImplementedError, match="output_size"):
        F.conv2d_transpose(tx, tw, None, 2, 1, output_size=[10, 10])


@pytest.mark.parametrize("nsp", [1, 2, 3])
def test_conv_transpose_layers_match_reference(nsp):
    cls = f"Conv{nsp}DTranspose"
    ref = getattr(paddle.nn, cls)(4, 6, 3, stride=2, padding=1, groups=2)
    port = getattr(pt.nn, cls)(4, 6, 3, stride=2, padding=1, groups=2,
                               device="cpu")
    assert tuple(port.weight.shape) == (4, 3) + (3,) * nsp
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {
        k: tuple(v.shape) for k, v in ref.state_dict().items()}
    pt.load_reference_state(port, {k: np.asarray(v.numpy())
                                   for k, v in ref.state_dict().items()})
    x = np.random.default_rng(62).standard_normal(
        (2, 4) + (5, 4, 3)[:nsp]).astype(np.float32)
    got = port(torch.from_numpy(x))
    want = ref(paddle.to_tensor(x))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    size = list(got.shape[2:])
    assert port(torch.from_numpy(x), output_size=size).shape == got.shape


# ---------------------------------------------------------------------
# pooling masks and unpooling
# ---------------------------------------------------------------------
#: (functional, input shape, arguments, keyword arguments)
MASK_CASES = {
    "2d_resnet": ("max_pool2d", (2, 3, 9, 8), (3, 2, 1), {}),
    "2d_k2": ("max_pool2d", (2, 3, 9, 8), (2, 2, 0), {}),
    "2d_rect": ("max_pool2d", (2, 3, 9, 8), ([3, 2], [1, 2], [1, 0]), {}),
    "2d_same": ("max_pool2d", (2, 3, 9, 8), (2, 2, "SAME"), {}),
    "1d": ("max_pool1d", (2, 3, 13), (3, 2, 1), {}),
    "3d": ("max_pool3d", (1, 2, 5, 6, 7), (3, 2, 1), {}),
    "3d_ndhwc": ("max_pool3d", (1, 5, 6, 7, 2), (3, 2, 1),
                 {"data_format": "NDHWC"}),
    "adaptive1d": ("adaptive_max_pool1d", (2, 3, 10), (4,), {}),
    "adaptive2d_divides": ("adaptive_max_pool2d", (2, 3, 8, 10), ((4, 5),),
                           {}),
    "adaptive2d_uneven": ("adaptive_max_pool2d", (2, 3, 9, 8), ((3, 5),),
                          {}),
    "adaptive3d": ("adaptive_max_pool3d", (1, 2, 5, 6, 7), ((3, 2, 4),),
                   {}),
}


@pytest.mark.parametrize("case", list(MASK_CASES))
def test_pool_masks_equal_reference(case):
    """Integer-valued inputs tie often: the first maximum a window, as
    numpy's (and the reference's ``jnp``) ``argmax`` takes it."""
    name, shape, args, kw = MASK_CASES[case]
    x = np.random.default_rng(len(case) + 70).integers(0, 3, shape).astype(
        np.float32)
    rout, rmask = getattr(RF, name)(paddle.to_tensor(x), *args,
                                    return_mask=True, **kw)
    tout, tmask = getattr(F, name)(torch.from_numpy(x), *args,
                                   return_mask=True, **kw)
    assert tmask.dtype == torch.int64
    assert np.array_equal(tmask.numpy(), _np(rmask))
    np.testing.assert_array_equal(_np(tout), _np(rout))


@pytest.mark.parametrize("case", ["1d", "2d", "2d_output_size", "2d_nhwc",
                                  "3d", "3d_ndhwc"])
def test_unpool_round_trips_the_mask(case):
    nsp = int(case[0])
    last = case.endswith(("nhwc", "ndhwc"))
    spatial = {1: (11,), 2: (9, 8), 3: (5, 6, 7)}[nsp]
    df = {1: "NCL", 2: "NCHW", 3: "NCDHW"}[nsp]
    rng = np.random.default_rng(len(case) + 80)
    # positive values: pooling the unpooled map finds each maximum again
    x = (np.abs(rng.standard_normal((2, 3) + spatial)) + 0.1).astype(
        np.float32)
    pool, unpool = f"max_pool{nsp}d", f"max_unpool{nsp}d"
    out, mask = getattr(F, pool)(torch.from_numpy(x), 2, 2,
                                 return_mask=True)
    size = list(spatial) if case.endswith("output_size") or nsp != 2 \
        else None
    if last:
        out, mask = out.movedim(1, -1), mask.movedim(1, -1)
        df = df[0] + df[2:] + "C"
    got = getattr(F, unpool)(out, mask, 2, 2, data_format=df,
                             output_size=size)
    want = getattr(RF, unpool)(paddle.to_tensor(out.numpy()),
                               paddle.to_tensor(mask.numpy()), 2, 2,
                               data_format=df, output_size=size)
    np.testing.assert_array_equal(_np(got), _np(want))
    # the round trip: each window's maximum back where it came from
    back = got.movedim(-1, 1) if last else got
    if size is None:
        assert back.shape[2:] == (8, 8)
    dense = torch.zeros((2, 3) + spatial)
    dense.reshape(2, 3, -1).scatter_(
        2, (mask.movedim(-1, 1) if last else mask).reshape(2, 3, -1),
        (out.movedim(-1, 1) if last else out).reshape(2, 3, -1))
    if size is not None:
        assert torch.equal(back, dense)
    repooled = getattr(F, pool)(back, 2, 2)
    assert torch.equal(repooled, out.movedim(-1, 1) if last else out)


def test_unpool_layers_and_gradient():
    x = torch.rand(1, 2, 6, 6) + 0.1
    out, mask = F.max_pool2d(x, 2, 2, return_mask=True)
    v = out.clone().requires_grad_()
    got = pt.nn.MaxUnPool2D(2, 2)(v, mask)
    got.sum().backward()
    assert torch.equal(v.grad, torch.ones_like(v))
    assert torch.equal(F.max_pool2d(got.detach(), 2, 2), out)
    o1, m1 = F.max_pool1d(x[:, :, 0], 2, 2, return_mask=True)
    assert torch.equal(pt.nn.MaxUnPool1D(2)(o1, m1),
                       F.max_unpool1d(o1, m1, 2))
    o3, m3 = F.max_pool3d(x[:, :, None].expand(1, 2, 2, 6, 6), 2,
                          return_mask=True)
    assert pt.nn.MaxUnPool3D(2)(o3, m3).shape == (1, 2, 2, 6, 6)


# ---------------------------------------------------------------------
# the other norms
# ---------------------------------------------------------------------
#: (functional, input shape, arguments, keyword arguments, parameters)
NORM_CASES = {
    "instance": ("instance_norm", (2, 4, 5, 6), (), {}, 2),
    "instance_nhwc": ("instance_norm", (2, 5, 6, 4), (),
                      {"data_format": "NHWC"}, 2),
    "instance_3d": ("instance_norm", (2, 3, 3, 4, 5), (), {}, 0),
    "group": ("group_norm", (2, 6, 5, 4), (3,), {}, 2),
    "group_nhwc": ("group_norm", (2, 5, 4, 6), (2,),
                   {"data_format": "NHWC"}, 2),
    "lrn": ("local_response_norm", (2, 7, 4, 3), (5,), {}, 0),
    "lrn_even": ("local_response_norm", (2, 6, 4, 3), (4,),
                 {"alpha": 1e-2, "beta": 0.5, "k": 2.0}, 0),
    "lrn_nhwc": ("local_response_norm", (2, 4, 3, 7), (3,),
                 {"data_format": "NHWC"}, 0),
    "normalize": ("normalize", (3, 5, 4), (), {}, 0),
    "normalize_p1": ("normalize", (3, 5, 4), (), {"p": 1, "axis": -1}, 0),
}


@pytest.mark.parametrize("case,dtype", [(c, "float32") for c in NORM_CASES]
                         + [(c, "bfloat16") for c in ("instance", "group",
                                                      "lrn")])
def test_norm_matches_reference(case, dtype):
    name, shape, args, kw, n_params = NORM_CASES[case]
    rng = np.random.default_rng(len(case) + 90)
    arrays = [(1.5 * rng.standard_normal(shape) + 0.5).astype(np.float32)]
    caxis = -1 if kw.get("data_format", "NC").startswith("NH") else 1
    for _ in range(n_params):
        arrays.append((1 + 0.3 * rng.standard_normal(shape[caxis])
                       ).astype(np.float32))

    def call(mod):
        fn = getattr(mod, name)
        if name == "instance_norm":
            return lambda x, *wb: fn(x, weight=wb[0] if wb else None,
                                     bias=wb[1] if wb else None, **kw)
        if name == "group_norm":
            return lambda x, w_, b_: fn(x, *args, weight=w_, bias=b_, **kw)
        return lambda x: fn(x, *args, **kw)
    _hold(*_run_both(call(RF), call(F), arrays, dtype), dtype)


def test_instance_norm_with_running_stats_matches_reference():
    rng = np.random.default_rng(95)
    x = rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
    rm = rng.standard_normal(3).astype(np.float32)
    rv = (1 + rng.random(3)).astype(np.float32)
    got = F.instance_norm(torch.from_numpy(x), torch.from_numpy(rm),
                          torch.from_numpy(rv), use_input_stats=False)
    want = RF.instance_norm(paddle.to_tensor(x), paddle.to_tensor(rm),
                            paddle.to_tensor(rv), use_input_stats=False)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="running_mean"):
        F.instance_norm(torch.from_numpy(x), use_input_stats=False)


@pytest.mark.parametrize("dim,iters", [(0, 1), (1, 3)])
def test_spectral_norm_matches_reference(dim, iters):
    rng = np.random.default_rng(96 + dim)
    w = rng.standard_normal((4, 3, 2, 2)).astype(np.float32)
    h = w.shape[dim]
    u = rng.standard_normal(h).astype(np.float32)
    v = rng.standard_normal(w.size // h).astype(np.float32)

    (rout, rgrads), (tout, tgrads) = _run_both(
        lambda w_: RF.spectral_norm(w_, paddle.to_tensor(u),
                                    paddle.to_tensor(v), dim, iters),
        lambda w_: F.spectral_norm(w_, torch.from_numpy(u),
                                   torch.from_numpy(v), dim, iters),
        [w], "float32")
    _hold((rout, rgrads), (tout, tgrads), "float32")


def test_norm_layers_match_reference_names_and_outputs():
    rng = np.random.default_rng(97)
    x = rng.standard_normal((2, 6, 4, 3)).astype(np.float32)
    pairs = [
        (paddle.nn.GroupNorm(3, 6), pt.nn.GroupNorm(3, 6, device="cpu")),
        (paddle.nn.InstanceNorm2D(6), pt.nn.InstanceNorm2D(6, device="cpu")),
        (paddle.nn.InstanceNorm1D(6, bias_attr=False),
         pt.nn.InstanceNorm1D(6, bias_attr=False, device="cpu")),
        (paddle.nn.LocalResponseNorm(3), pt.nn.LocalResponseNorm(3)),
    ]
    for ref, port in pairs:
        assert {k: tuple(v.shape) for k, v in port.state_dict().items()} \
            == {k: tuple(v.shape) for k, v in ref.state_dict().items()}
        xs = x[:, :, :, 0] if isinstance(port, pt.nn.InstanceNorm1D) else x
        np.testing.assert_allclose(_np(port(torch.from_numpy(xs))),
                                   _np(ref(paddle.to_tensor(xs))),
                                   atol=1e-5, rtol=1e-5)
    ref = paddle.nn.SpectralNorm([6, 4, 3], dim=1, power_iters=2)
    port = pt.nn.SpectralNorm([6, 4, 3], dim=1, power_iters=2, device="cpu")
    assert list(port.state_dict()) == ["weight_u", "weight_v"]
    assert not list(port.parameters())
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {
        k: tuple(v.shape) for k, v in ref.state_dict().items()}
    pt.load_reference_state(port, {k: np.asarray(v.numpy())
                                   for k, v in ref.state_dict().items()})
    w = x[0, :, :, :]
    np.testing.assert_allclose(_np(port(torch.from_numpy(w))),
                               _np(ref(paddle.to_tensor(w))), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(NotImplementedError, match="SyncBatchNorm"):
        pt.nn.SyncBatchNorm(4, device="cpu")


# ---------------------------------------------------------------------
# the other initializers
# ---------------------------------------------------------------------
def test_truncated_normal_bounds_are_in_std_units():
    from paddle_tpu_torch.nn import initializer as I
    gen = torch.Generator().manual_seed(98)
    t = I.TruncatedNormal(mean=3.0, std=0.5, a=-1.0, b=2.0)(
        torch.empty(200000), gen)
    # mean + std * z, z in [a, b]: [2.5, 4.0]; the output itself is not
    # truncated to [a, b]
    assert float(t.min()) >= 2.5 and float(t.max()) <= 4.0
    assert float(t.min()) < 2.51 and float(t.max()) > 3.99
    z = (t.double() - 3.0) / 0.5
    # moments of the standard normal truncated to [-1, 2]
    from math import erf, exp, pi, sqrt
    phi = [exp(-v * v / 2) / sqrt(2 * pi) for v in (-1.0, 2.0)]
    mass = 0.5 * (erf(2 / sqrt(2)) - erf(-1 / sqrt(2)))
    assert abs(float(z.mean()) - (phi[0] - phi[1]) / mass) < 0.01
    ref = paddle.nn.initializer.TruncatedNormal(3.0, 0.5, -1.0, 2.0
                                                ).generate((50000,),
                                                           jnp.float32)
    ref = np.asarray(ref)
    assert ref.min() >= 2.5 and ref.max() <= 4.0
    assert abs(float(ref.mean()) - float(t.mean())) < 0.01


@pytest.mark.parametrize("shape", [(3, 5), (6, 2), (4, 2, 3, 3), (5,)])
def test_orthogonal_rows_or_columns_are_orthonormal(shape):
    from paddle_tpu_torch.nn import initializer as I
    t = I.Orthogonal(gain=1.7)(torch.empty(shape),
                               torch.Generator().manual_seed(99))
    rows = shape[0]
    m = t.reshape(rows, -1).double() / 1.7
    if rows <= m.shape[1]:
        gram = m @ m.T
    else:
        gram = m.T @ m
    torch.testing.assert_close(gram, torch.eye(gram.shape[0],
                                               dtype=torch.float64),
                               atol=1e-5, rtol=0)
    ref = np.asarray(paddle.nn.initializer.Orthogonal(1.7).generate(
        shape, jnp.float32)).reshape(rows, -1) / 1.7
    rgram = ref @ ref.T if rows <= ref.shape[1] else ref.T @ ref
    np.testing.assert_allclose(rgram, np.eye(rgram.shape[0]), atol=1e-5)


@pytest.mark.parametrize("shape,groups", [((4, 4, 3, 3), 1),
                                          ((6, 2, 3), 2), ((4, 2, 3, 5, 5),
                                                           2),
                                          ((3, 5, 3, 3), 1)])
def test_dirac_and_assign_equal_reference(shape, groups):
    from paddle_tpu_torch.nn import initializer as I
    got = I.Dirac(groups)(torch.empty(shape))
    want = np.asarray(paddle.nn.initializer.Dirac(groups).generate(
        shape, jnp.float32))
    assert np.array_equal(got.numpy(), want)
    value = np.arange(np.prod(shape), dtype=np.float32) / 7
    for v in (value, value.tolist(), torch.from_numpy(value)):
        got = I.Assign(v)(torch.empty(shape))
        want = np.asarray(paddle.nn.initializer.Assign(value).generate(
            shape, jnp.float32))
        assert np.array_equal(got.numpy(), want)


def test_set_global_initializer_refuses_initializers():
    from paddle_tpu_torch.nn import initializer as I
    I.set_global_initializer(None)
    I.set_global_initializer(None, None)
    with pytest.raises(NotImplementedError, match="never applies"):
        I.set_global_initializer(I.Constant(0.0))
    with pytest.raises(NotImplementedError):
        I.set_global_initializer(None, I.Constant(0.0))
