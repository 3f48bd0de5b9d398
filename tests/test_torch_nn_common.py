"""The port's common functionals and layers, ``flash_attn_unpadded`` and
``nn.utils`` against the reference's (``paddle_tpu.nn.functional.common``,
``nn.layer.common``, ``nn.functional.flash_attention``, ``nn.utils``).

Every function of the reference's ``common.py`` runs on the same seeded
numpy inputs in both packages, in f32 and bf16: the output and the
gradient of every floating input under one seeded upstream gradient,
held to the largest reference magnitude of each (f32: 1e-5 abs + rel;
bf16: 2^-6 of the largest magnitude, four bf16 ulps there, since the two
packages round their bf16 intermediates at other places).  The cases
cover every ``interpolate`` mode at up and down scale (``"nearest"``
against PyTorch's ``"nearest-exact"``; the linear family, ``"area"`` and
``"bicubic"`` antialiased when shrinking), ``align_corners``,
``align_mode=1`` and channels-last input; every ``pad`` mode in every
form (spatial pairs channels-first and channels-last, the last dims, the
full form over the batch and channel dims); ``embedding``'s
``padding_idx`` output and gradient; ``grid_sample`` in each mode,
padding and alignment.  The random ones are held by their structure:
the kept or dropped channels of ``dropout2d``/``dropout3d``, the mean and
variance ``alpha_dropout`` keeps, ``downscale_in_infer``; at ``p = 0``
and in eval they equal the reference's.  Each layer of the reference's
``nn/layer/common.py`` is built alike in both packages (``Bilinear``
from the reference's weights) and held to its output.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
from paddle_tpu import nn as rnn

import paddle_tpu_torch as pt
from paddle_tpu_torch.nn import functional as F

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
DTYPES = ("float32", "bfloat16")


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.astype("float32").numpy(), np.float32)


def _close(got, want, dtype="float32", what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=TOL[dtype],
                                   rtol=TOL[dtype], err_msg=what)
    else:
        top = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max()) / top
        assert err <= TOL[dtype], (what, err)


def _run(call, arrays, dtype="float32", grad=None, seed=0):
    """``call(M, *inputs)`` with ``M`` the reference's and the port's
    functional module; floating inputs (those in ``grad``, by default
    all) are f32 leaves cast to ``dtype``; the outputs and the leaves'
    gradients under one upstream gradient are held to `TOL`."""
    grad = [i for i, a in enumerate(arrays) if a.dtype.kind == "f"] \
        if grad is None else grad
    rx = [paddle.to_tensor(a, stop_gradient=i not in grad)
          for i, a in enumerate(arrays)]
    tx = [torch.from_numpy(a.copy()).requires_grad_(i in grad)
          for i, a in enumerate(arrays)]
    rin = [t.astype(dtype) if a.dtype.kind == "f" else t
           for t, a in zip(rx, arrays)]
    tin = [t.to(getattr(torch, dtype)) if a.dtype.kind == "f" else t
           for t, a in zip(tx, arrays)]
    rout, tout = call(RF, *rin), call(F, *tin)
    _close(tout, rout, dtype, "output")
    if not grad:
        return
    up = np.random.default_rng(seed + 99).standard_normal(
        tuple(tout.shape)).astype(np.float32)
    (rout.astype("float32") * paddle.to_tensor(up)).sum().backward()
    (tout.float() * torch.from_numpy(up)).sum().backward()
    for i in grad:
        _close(tx[i].grad, rx[i].grad, dtype, f"gradient of input {i}")


def _x(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


X4 = _x(2, 3, 7, 9)


def _interp(**kw):
    return lambda M, x: M.interpolate(x, **kw)


#: name -> (call on (functional module, *inputs), inputs)
INTERP = {
    "nearest_up": (_interp(scale_factor=2), [X4]),
    "nearest_down": (_interp(size=[4, 5]), [X4]),
    "nearest_3d": (_interp(size=[13]), [_x(2, 3, 7)]),
    "nearest_5d": (_interp(size=[3, 5, 4]), [_x(1, 2, 4, 6, 5)]),
    "bilinear_up": (_interp(size=[10, 13], mode="bilinear"), [X4]),
    "bilinear_down": (_interp(size=[4, 5], mode="bilinear"), [X4]),
    "bilinear_scale": (_interp(scale_factor=0.6, mode="bilinear"), [X4]),
    "bilinear_nhwc": (_interp(size=[4, 13], mode="bilinear",
                              data_format="NHWC"), [_x(2, 7, 9, 3)]),
    "linear_up": (_interp(size=[15], mode="linear", data_format="NCW"),
                  [_x(2, 3, 7)]),
    "linear_down": (_interp(size=[3], mode="linear", data_format="NCW"),
                    [_x(2, 3, 7)]),
    "trilinear_up": (_interp(size=[6, 9, 7], mode="trilinear",
                             data_format="NCDHW"), [_x(1, 2, 4, 6, 5)]),
    "trilinear_down": (_interp(size=[3, 4, 2], mode="trilinear",
                               data_format="NCDHW"), [_x(1, 2, 4, 6, 5)]),
    "bicubic_up": (_interp(size=[10, 13], mode="bicubic"), [X4]),
    "bicubic_down": (_interp(size=[4, 5], mode="bicubic"), [X4]),
    "area_down": (_interp(size=[4, 5], mode="area"), [X4]),
    "area_up": (_interp(scale_factor=2, mode="area"), [X4]),
    "align_corners_up": (_interp(size=[10, 13], mode="bilinear",
                                 align_corners=True), [X4]),
    "align_corners_down": (_interp(size=[4, 5], mode="bilinear",
                                   align_corners=True), [X4]),
    "align_corners_to_1": (_interp(size=[1, 5], mode="bilinear",
                                   align_corners=True), [X4]),
    "align_corners_linear": (_interp(size=[11], mode="linear",
                                     align_corners=True, data_format="NCW"),
                             [_x(2, 3, 7)]),
    "align_mode1_up": (_interp(size=[10, 13], mode="bilinear",
                               align_mode=1), [X4]),
    "align_mode1_down": (_interp(size=[4, 5], mode="bilinear",
                                 align_mode=1), [X4]),
    "align_mode1_trilinear": (_interp(size=[6, 3, 7], mode="trilinear",
                                      align_mode=1, data_format="NCDHW"),
                              [_x(1, 2, 4, 6, 5)]),
    "upsample": (lambda M, x: M.upsample(x, scale_factor=[2, 1.5],
                                         mode="bilinear"), [X4]),
}


#: the cases also held in bf16: each resize path once
BF16_INTERP = ("nearest_down", "bilinear_down", "trilinear_up",
               "bicubic_down", "align_corners_up", "align_mode1_down")


@pytest.mark.parametrize("name,dtype", [(n, "float32") for n in INTERP]
                         + [(n, "bfloat16") for n in BF16_INTERP])
def test_interpolate_matches_reference(name, dtype):
    call, arrays = INTERP[name]
    _run(call, arrays, dtype)


def test_interpolate_equivalences():
    """The reference's resize is PyTorch's ``nearest-exact`` and
    antialiased bilinear/bicubic, not the same-named plain modes: the
    plain ones part from it at these shapes (so the tests above would
    catch a port that took them)."""
    x = torch.from_numpy(X4)
    r = paddle.to_tensor(X4)
    tf = torch.nn.functional
    for mode, size in (("nearest", [10, 13]), ("bilinear", [4, 5]),
                       ("bicubic", [4, 5])):
        want = _np(RF.interpolate(r, size=size, mode=mode))
        plain = _np(tf.interpolate(x, size=size, mode=mode))
        assert np.abs(plain - want).max() > 0.1, mode
    # "area" resizes as the linear family, antialiased (a quirk kept)
    _close(F.interpolate(x, size=[4, 5], mode="area"),
           F.interpolate(x, size=[4, 5], mode="bilinear"))


PAD_FORMS = {
    "nchw_spatial": (_x(2, 3, 5, 6), [1, 2, 2, 1], "NCHW"),
    "nhwc_spatial": (_x(2, 5, 6, 3), [2, 1, 1, 2], "NHWC"),
    "ncl": (_x(2, 3, 6), [2, 3], "NCL"),
    "ncdhw": (_x(1, 2, 4, 5, 6), [1, 2, 2, 1, 1, 1], "NCDHW"),
    "last_dim": (_x(2, 3, 5, 6), [2, 1], "NCHW"),
    "full_form": (_x(3, 4, 5, 6), [1, 2, 2, 1, 1, 1, 2, 2], "NCHW"),
}


PAD_MODES = ("constant", "reflect", "replicate", "circular")


@pytest.mark.parametrize("form,mode,dtype", [
    (f, m, "float32") for f in PAD_FORMS for m in PAD_MODES] + [
    ("nchw_spatial", m, "bfloat16") for m in PAD_MODES])
def test_pad_matches_reference(form, mode, dtype):
    x, p, fmt = PAD_FORMS[form]
    _run(lambda M, t: M.pad(t, p, mode=mode, value=0.5, data_format=fmt),
         [x], dtype)


IDS = np.array([[1, 0, 3, 5], [5, 2, 0, 0]], np.int64)
LABELS = np.eye(6, dtype=np.float32)[np.array([0, 3, 5, 1])]
THETA = np.array([[[0.9, 0.2, 0.1], [-0.15, 1.1, -0.2]],
                  [[1.2, -0.3, 0.3], [0.25, 0.8, 0.15]]], np.float32)
#: sample points inside and past the image
GRID = (1.4 * np.random.default_rng(7).uniform(-1, 1, (2, 5, 4, 2))
        ).astype(np.float32)

CASES = {
    "zeropad2d": (lambda M, x: M.zeropad2d(x, [1, 0, 2, 1]),
                  [_x(2, 3, 4, 5)]),
    "cosine_similarity": (lambda M, a, b: M.cosine_similarity(a, b),
                          [_x(4, 6, 3), _x(4, 6, 3, seed=1)]),
    "cosine_similarity_last": (
        lambda M, a, b: M.cosine_similarity(a, b, axis=-1, eps=1e-3),
        [_x(4, 6), _x(4, 6, seed=1, scale=1e-4)]),
    "pixel_shuffle": (lambda M, x: M.pixel_shuffle(x, 2),
                      [_x(2, 8, 3, 4)]),
    "pixel_shuffle_nhwc": (lambda M, x: M.pixel_shuffle(x, 2, "NHWC"),
                           [_x(2, 3, 4, 8)]),
    "pixel_unshuffle": (lambda M, x: M.pixel_unshuffle(x, 2),
                        [_x(2, 3, 4, 6)]),
    "pixel_unshuffle_nhwc": (lambda M, x: M.pixel_unshuffle(x, 2, "NHWC"),
                             [_x(2, 4, 6, 3)]),
    "unfold": (lambda M, x: M.unfold(x, 3), [_x(2, 3, 6, 7)]),
    "unfold_options": (lambda M, x: M.unfold(x, [3, 2], strides=[2, 1],
                                             paddings=[1, 0, 2, 1],
                                             dilations=[1, 2]),
                       [_x(2, 3, 6, 7)]),
    "fold": (lambda M, x: M.fold(x, [6, 7], 3), [_x(2, 27, 20)]),
    "fold_options": (lambda M, x: M.fold(x, [6, 7], [3, 2], strides=[2, 1],
                                         paddings=[1, 0, 2, 1],
                                         dilations=[1, 2]),
                     [_x(2, 18, 24)]),
    "one_hot": (lambda M, i: M.one_hot(i, 6), [IDS]),
    "embedding": (lambda M, i, w: M.embedding(i, w), [IDS, _x(6, 4)]),
    "embedding_padding_idx": (lambda M, i, w: M.embedding(i, w,
                                                          padding_idx=0),
                              [IDS, _x(6, 4)]),
    "label_smooth": (lambda M, y: M.label_smooth(y, epsilon=0.1), [LABELS]),
    "label_smooth_prior": (
        lambda M, y, p: M.label_smooth(y, p, epsilon=0.2),
        [LABELS, np.full((1, 6), 1 / 6, np.float32)]),
    "bilinear": (lambda M, a, b, w, c: M.bilinear(a, b, w, c),
                 [_x(4, 3), _x(4, 5, seed=1), _x(2, 3, 5, seed=2),
                  _x(1, 2, seed=3)]),
    "bilinear_no_bias": (lambda M, a, b, w: M.bilinear(a, b, w),
                         [_x(4, 3), _x(4, 5, seed=1), _x(2, 3, 5, seed=2)]),
    "channel_shuffle": (lambda M, x: M.channel_shuffle(x, 3),
                        [_x(2, 6, 3, 4)]),
    "channel_shuffle_nhwc": (lambda M, x: M.channel_shuffle(x, 2, "NHWC"),
                             [_x(2, 3, 4, 6)]),
    "pairwise_distance": (lambda M, a, b: M.pairwise_distance(a, b),
                          [_x(5, 4), _x(5, 4, seed=1)]),
    "pairwise_distance_p1_keepdim": (
        lambda M, a, b: M.pairwise_distance(a, b, p=1.0, keepdim=True),
        [_x(5, 4), _x(5, 4, seed=1)]),
    "pairwise_distance_p3": (lambda M, a, b: M.pairwise_distance(a, b, 3.0),
                             [_x(5, 4), _x(5, 4, seed=1)]),
    "affine_grid": (lambda M, t: M.affine_grid(t, [2, 3, 5, 7]), [THETA]),
    "affine_grid_unaligned": (
        lambda M, t: M.affine_grid(t, [2, 3, 5, 7], align_corners=False),
        [THETA]),
    "temporal_shift": (lambda M, x: M.temporal_shift(x, 2),
                       [_x(4, 8, 3, 2)]),
    "temporal_shift_nhwc": (
        lambda M, x: M.temporal_shift(x, 3, 0.2, data_format="NHWC"),
        [_x(6, 3, 2, 10)]),
}
for _mode in ("bilinear", "nearest"):
    for _pad in ("zeros", "border", "reflection"):
        for _align in (True, False):
            CASES[f"grid_sample_{_mode}_{_pad}_{int(_align)}"] = (
                lambda M, x, g, m=_mode, p=_pad, a=_align: M.grid_sample(
                    x, g, mode=m, padding_mode=p, align_corners=a),
                [_x(2, 3, 6, 7), GRID])


#: the cases also held in bf16: each function once
BF16_CASES = ("zeropad2d", "cosine_similarity", "pixel_shuffle",
              "pixel_unshuffle", "unfold_options", "fold_options",
              "embedding_padding_idx", "label_smooth_prior", "bilinear",
              "channel_shuffle", "pairwise_distance", "affine_grid",
              "temporal_shift", "grid_sample_bilinear_zeros_1",
              "grid_sample_bilinear_reflection_0",
              "grid_sample_nearest_border_0")


@pytest.mark.parametrize("name,dtype", [(n, "float32") for n in CASES]
                         + [(n, "bfloat16") for n in BF16_CASES])
def test_function_matches_reference(name, dtype):
    call, arrays = CASES[name]
    if name == "one_hot":
        _close(call(F, torch.from_numpy(arrays[0])),
               call(RF, paddle.to_tensor(arrays[0])))
        return
    # the nearest sample's position has no gradient (round), in both; in
    # bf16 the reflected positions' rounding moves samples across pixel
    # edges, where the gradient with respect to the grid jumps, so bf16
    # holds the grid's gradient for the other paddings only
    grad = [0] if name.startswith("grid_sample_nearest") or (
        name.startswith("grid_sample_bilinear_reflection")
        and dtype == "bfloat16") else None
    _run(call, arrays, dtype, grad)


#: the random ones where they draw nothing: in eval and at p = 0
NO_DRAW = {
    "dropout_eval": (lambda M, x: M.dropout(x, 0.3, training=False),
                     [_x(4, 5)]),
    "dropout_p0": (lambda M, x: M.dropout(x, 0.0, axis=1), [_x(4, 5)]),
    "dropout_downscale_eval": (
        lambda M, x: M.dropout(x, 0.3, training=False,
                               mode="downscale_in_infer"), [_x(4, 5)]),
    "dropout2d_eval": (lambda M, x: M.dropout2d(x, 0.5, training=False),
                       [_x(2, 3, 4, 4)]),
    "dropout3d_p0": (lambda M, x: M.dropout3d(x, 0.0), [_x(2, 3, 2, 4, 4)]),
    "alpha_dropout_eval": (lambda M, x: M.alpha_dropout(x, 0.4,
                                                        training=False),
                           [_x(4, 5)]),
    "feature_alpha_dropout_p0": (
        lambda M, x: M.feature_alpha_dropout(x, 0.0), [_x(2, 3, 4)]),
}


def test_random_ones_without_draws_match_reference():
    for name, (call, arrays) in NO_DRAW.items():
        _close(call(F, torch.from_numpy(arrays[0])),
               call(RF, paddle.to_tensor(arrays[0])), what=name)


def test_embedding_padding_idx_row_and_gradient():
    """The padded id's lookups are zeros and its row gets no gradient,
    as in the reference (torch's own ``padding_idx`` only zeroes the
    gradient); the layer starts that row at zeros."""
    w = _x(6, 4)
    t = torch.from_numpy(w.copy()).requires_grad_()
    out = F.embedding(torch.from_numpy(IDS), t, padding_idx=5)
    assert torch.equal(out[IDS == 5], torch.zeros(2, 4))
    out.sum().backward()
    assert torch.equal(t.grad[5], torch.zeros(4))
    assert float(t.grad[0].sum()) == pytest.approx(3 * 4)
    layer = pt.nn.Embedding(6, 4, padding_idx=2, device="cpu")
    assert torch.equal(layer.weight[2], torch.zeros(4))
    ref = rnn.Embedding(6, 4, padding_idx=2)
    assert np.array_equal(ref.weight.numpy()[2], np.zeros(4))


def test_class_center_sample_matches_reference():
    lab = np.array([7, 2, 9, 2, 4], np.int64)
    for n in (2, 3, 6):
        got = F.class_center_sample(torch.from_numpy(lab), 12, n)
        want = RF.class_center_sample(paddle.to_tensor(lab), 12, n)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), w.numpy())


def test_flash_attn_unpadded_matches_reference():
    """Packed sequences of 3, 5 and 4 tokens (queries) against 4, 2 and
    6 keys, 2 heads of 8, causal within each sequence and not, f32 and
    bf16; a causal query whose sequence has no key at or before it sees
    nothing and gives 0, in both."""
    rng = np.random.default_rng(3)
    cu_q = np.array([0, 3, 8, 12], np.int32)
    cu_k = np.array([0, 4, 6, 12], np.int32)
    q = rng.standard_normal((12, 2, 8)).astype(np.float32)
    k = rng.standard_normal((12, 2, 8)).astype(np.float32)
    v = rng.standard_normal((12, 2, 8)).astype(np.float32)
    for causal in (False, True):
        for dtype in DTYPES:
            def call(M, a, b, c, causal=causal):
                cq = paddle.to_tensor(cu_q) if M is RF \
                    else torch.from_numpy(cu_q)
                ck = paddle.to_tensor(cu_k) if M is RF \
                    else torch.from_numpy(cu_k)
                return M.flash_attn_unpadded(a, b, c, cq, ck, 5, 6, 0.35,
                                             causal=causal)[0]
            _run(call, [q, k, v], dtype)
    out, none = F.flash_attn_unpadded(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(cu_q), torch.from_numpy(np.array([0, 4, 4, 12],
                                                          np.int32)),
        5, 6, 0.35)
    assert none is None and torch.equal(out[3:8], torch.zeros(5, 2, 8))


def test_flash_attn_unpadded_dropout_draws():
    """With dropout the probabilities are kept or zeroed from the
    caller's generator: the same seed gives the same output, and
    ``training=False`` drops nothing."""
    q = torch.from_numpy(_x(6, 2, 4))
    cu = torch.tensor([0, 2, 6], dtype=torch.int32)
    run = [F.flash_attn_unpadded(q, q, q, cu, cu, 4, 4, 0.5, dropout=0.5,
                                 generator=torch.Generator().manual_seed(1))
           [0] for _ in range(2)]
    assert torch.equal(run[0], run[1])
    plain = F.flash_attn_unpadded(q, q, q, cu, cu, 4, 4, 0.5)[0]
    assert not torch.allclose(run[0], plain)
    _close(F.flash_attn_unpadded(q, q, q, cu, cu, 4, 4, 0.5, dropout=0.5,
                                 training=False)[0], plain)


def test_dropout_structure():
    """The keep masks drawn from the generator: whole channels for
    ``dropout2d``/``dropout3d`` (kept ones scaled by 1/(1-p)), one draw
    along ``axis``, ``downscale_in_infer`` keeping values unscaled in
    training and scaling by 1-p in eval; the same seed, the same
    masks."""
    x = torch.ones(8, 16, 5, 5)

    def gen():
        return torch.Generator().manual_seed(0)
    for fn, shape in ((F.dropout2d, (8, 16, 5, 5)),
                      (F.dropout3d, (8, 16, 2, 5, 5))):
        out = fn(torch.ones(shape), 0.4, generator=gen())
        per = out.reshape(8, 16, -1)
        assert torch.equal(per.amin(-1), per.amax(-1))
        assert torch.unique(per).tolist() == [0.0, pytest.approx(1 / 0.6)]
        assert torch.equal(out, fn(torch.ones(shape), 0.4, generator=gen()))
    out = F.dropout(x, 0.5, axis=[0, 2], generator=gen())
    assert torch.equal(out.amin((1, 3)), out.amax((1, 3)))
    down = F.dropout(x, 0.5, mode="downscale_in_infer", generator=gen())
    assert set(torch.unique(down).tolist()) == {0.0, 1.0}
    assert torch.equal(F.dropout(x, 0.5, training=False,
                                 mode="downscale_in_infer"), x * 0.5)
    nhwc = F.dropout2d(torch.ones(4, 3, 3, 8), 0.5, data_format="NHWC",
                       generator=gen())
    assert torch.equal(nhwc.amin((1, 2)), nhwc.amax((1, 2)))


def test_reference_functional_extras_cases():
    """The cases of the reference's ``tests/test_functional_extras.py``
    that reach this module, on the port."""
    t = torch.tensor
    np.testing.assert_allclose(
        F.pairwise_distance(t([[3.0, 4.0]]), t([[0.0, 0.0]])).numpy(), [5.0],
        rtol=1e-4)
    x = np.arange(8, dtype=np.float32).reshape(1, 4, 1, 2)
    want = x.reshape(1, 2, 2, 1, 2).transpose(0, 2, 1, 3, 4).reshape(
        1, 4, 1, 2)
    np.testing.assert_allclose(F.channel_shuffle(t(x), 2).numpy(), want)
    img = np.random.default_rng(0).normal(size=(1, 2, 5, 7)).astype(
        np.float32)
    grid = F.affine_grid(t([[[1.0, 0, 0], [0, 1.0, 0]]]), [1, 2, 5, 7])
    for mode in ("bilinear", "nearest"):
        np.testing.assert_allclose(
            F.grid_sample(t(img), grid, mode=mode).numpy(), img, atol=1e-5)
    ones = torch.ones(1, 1, 2, 2)
    far = F.affine_grid(t([[[1.0, 0, 5.0], [0, 1.0, 5.0]]]), [1, 1, 2, 2])
    assert torch.equal(F.grid_sample(ones, far), torch.zeros_like(ones))
    assert torch.equal(F.grid_sample(ones, far, padding_mode="border"), ones)
    seq = np.arange(16, dtype=np.float32).reshape(4, 4, 1, 1)
    out = F.temporal_shift(t(seq), seg_num=2, shift_ratio=0.25).numpy()
    assert out[0, 0, 0, 0] == seq[1, 0, 0, 0] and out[1, 0, 0, 0] == 0.0
    np.testing.assert_allclose(out[:, 2:], seq[:, 2:])
    nhwc = F.temporal_shift(t(seq.transpose(0, 2, 3, 1)), seg_num=2,
                            data_format="NHWC").numpy()
    np.testing.assert_allclose(nhwc.transpose(0, 3, 1, 2), out)
    fa = F.feature_alpha_dropout(torch.ones(2, 3, 4, 4), 0.5,
                                 generator=torch.Generator().manual_seed(0))
    per = fa.reshape(2, 3, -1)
    assert torch.equal(per.amin(-1), per.amax(-1))
    assert torch.equal(F.feature_alpha_dropout(torch.ones(2, 3), 0.5,
                                               training=False),
                       torch.ones(2, 3))
    ad = F.alpha_dropout(torch.from_numpy(np.random.default_rng(9).normal(
        size=(200000,)).astype(np.float32)), 0.5,
        generator=torch.Generator().manual_seed(3))
    assert abs(float(ad.var()) - 1.0) < 0.05
    assert abs(float(ad.mean())) < 0.02


def _layer_cases():
    """name -> (maker on (nn module, reference?), inputs)."""
    return {
        "Identity": (lambda N, r: N.Identity(3, k=1), [_x(2, 3)]),
        "Dropout2D": (lambda N, r: N.Dropout2D(0.5).eval(),
                      [_x(2, 3, 4, 4)]),
        "Dropout3D": (lambda N, r: N.Dropout3D(0.5).eval(),
                      [_x(2, 3, 2, 4, 4)]),
        "AlphaDropout": (lambda N, r: N.AlphaDropout(0.5).eval(),
                         [_x(2, 3)]),
        "Upsample": (lambda N, r: N.Upsample(size=[4, 5], mode="bicubic"),
                     [X4]),
        "UpsamplingNearest2D": (lambda N, r: N.UpsamplingNearest2D(
            scale_factor=2), [X4]),
        "UpsamplingBilinear2D": (lambda N, r: N.UpsamplingBilinear2D(
            size=[10, 4]), [X4]),
        "Pad1D": (lambda N, r: N.Pad1D([2, 1], mode="reflect"),
                  [_x(2, 3, 6)]),
        "Pad2D": (lambda N, r: N.Pad2D([1, 2, 0, 1], mode="replicate"),
                  [_x(2, 3, 4, 5)]),
        "Pad3D": (lambda N, r: N.Pad3D([1, 0, 1, 1, 2, 0], mode="circular"),
                  [_x(1, 2, 3, 4, 5)]),
        "ZeroPad2D": (lambda N, r: N.ZeroPad2D([1, 1, 2, 0]),
                      [_x(2, 3, 4, 5)]),
        "CosineSimilarity": (lambda N, r: N.CosineSimilarity(axis=2),
                             [_x(3, 4, 5), _x(3, 4, 5, seed=1)]),
        "Unfold": (lambda N, r: N.Unfold(2, strides=2), [_x(2, 3, 6, 6)]),
        "Fold": (lambda N, r: N.Fold([6, 6], 2, strides=2),
                 [_x(2, 12, 9)]),
        "PixelShuffle": (lambda N, r: N.PixelShuffle(3), [_x(1, 9, 2, 3)]),
        "PixelUnshuffle": (lambda N, r: N.PixelUnshuffle(2),
                           [_x(1, 2, 4, 6)]),
        "Unflatten": (lambda N, r: N.Unflatten(1, [2, 3]), [_x(4, 6, 5)]),
        "Unflatten_negative": (lambda N, r: N.Unflatten(-1, [5, 1]),
                               [_x(4, 6, 5)]),
        "PairwiseDistance": (lambda N, r: N.PairwiseDistance(1.5),
                             [_x(5, 4), _x(5, 4, seed=1)]),
        "ChannelShuffle": (lambda N, r: N.ChannelShuffle(2),
                           [_x(2, 4, 3, 3)]),
        "Flatten": (lambda N, r: N.Flatten(1, 2), [_x(2, 3, 4, 5)]),
    }


@pytest.mark.parametrize("name", list(_layer_cases()))
def test_layer_matches_reference(name):
    """The layers' outputs (their functionals' gradients are held
    above)."""
    make, arrays = _layer_cases()[name]
    _close(make(pt.nn, False)(*(torch.from_numpy(a) for a in arrays)),
           make(rnn, True)(*(paddle.to_tensor(a) for a in arrays)), what=name)


def test_bilinear_layer_state_and_output():
    ref = rnn.Bilinear(3, 5, 2)
    port = pt.nn.Bilinear(3, 5, 2, device="cpu")
    state = {k: v.numpy() for k, v in ref.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: v.shape for k, v in state.items()}
    pt.load_reference_state(port, state)
    _run(lambda M, a, b: (ref if M is RF else port)(a, b),
         [_x(4, 3), _x(4, 5, seed=1)])
    assert pt.nn.Bilinear(3, 5, 2, bias_attr=False, device="cpu").bias is None
    init = pt.nn.Bilinear(3, 5, 2, weight_attr=pt.nn.initializer.Constant(
        0.5), device="cpu")
    assert torch.equal(init.weight, torch.full((2, 3, 5), 0.5))
    with pytest.raises(NotImplementedError):
        pt.nn.Bilinear(3, 5, 2, weight_attr="w", device="cpu")


def test_parameter_list_and_layer_dict_names():
    rp = rnn.ParameterList([rnn.Parameter(np.ones(3, np.float32))
                            for _ in range(2)])
    tp = pt.nn.ParameterList([torch.nn.Parameter(torch.ones(3))
                              for _ in range(2)])
    assert list(dict(rp.named_parameters())) == \
        list(dict(tp.named_parameters()))
    rd = rnn.LayerDict({"a": rnn.Linear(2, 3), "b": rnn.Linear(3, 1)})
    td = pt.nn.LayerDict({"a": pt.nn.Linear(2, 3, device="cpu"),
                          "b": pt.nn.Linear(3, 1, device="cpu")})
    assert sorted(rd.state_dict()) == sorted(td.state_dict())
    assert list(td.keys()) == ["a", "b"] and "a" in td and len(td) == 2


def _grads_pair(seed=0):
    """Two parameters with gradients, in both packages."""
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    gs = [3 * rng.standard_normal(w.shape).astype(np.float32) for w in ws]
    rp = [rnn.Parameter(w) for w in ws]
    # copies: JAX may alias an aligned numpy buffer, which the port's
    # in-place updates would otherwise write under the reference
    tp = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in ws]
    for r, t, g in zip(rp, tp, gs):
        (r * paddle.to_tensor(g)).sum().backward()
        (t * torch.from_numpy(g)).sum().backward()
    return rp, tp


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_reference(norm_type):
    rp, tp = _grads_pair()
    want = paddle.nn.utils.clip_grad_norm_(rp, 2.5, norm_type)
    got = pt.nn.clip_grad_norm_(tp, 2.5, norm_type)
    _close(got, want)
    for r, t in zip(rp, tp):
        _close(t.grad, r.grad)
    assert pt.nn.clip_grad_norm_ is pt.nn.utils.clip_grad_norm_
    assert float(pt.nn.clip_grad_norm_([torch.nn.Parameter(
        torch.ones(2))], 1.0)) == 0.0


def test_clip_grad_value_and_parameter_vectors():
    rp, tp = _grads_pair(1)
    paddle.nn.utils.clip_grad_value_(rp, 0.7)
    pt.nn.clip_grad_value_(tp, 0.7)
    for r, t in zip(rp, tp):
        _close(t.grad, r.grad)
    u = pt.nn.utils
    vec = u.parameters_to_vector(tp)
    _close(vec, paddle.nn.utils.parameters_to_vector(rp))
    u.vector_to_parameters(vec * 2, tp)
    paddle.nn.utils.vector_to_parameters(
        paddle.nn.utils.parameters_to_vector(rp) * 2, rp)
    for r, t in zip(rp, tp):
        _close(t, r)


def _conv_pair():
    ref = rnn.Conv2D(3, 4, 3)
    port = pt.nn.Conv2D(3, 4, 3, device="cpu")
    return ref, port, _x(2, 3, 6, 6)


def _linear_pair():
    return rnn.Linear(5, 3), pt.nn.Linear(5, 3, device="cpu"), _x(4, 5)


@pytest.mark.parametrize("pair,dim", [(_linear_pair, 0), (_linear_pair, 1),
                                      (_conv_pair, 0), (_conv_pair, 1)])
def test_weight_norm_matches_reference(pair, dim):
    """``weight_norm`` on a Linear and a Conv2D: the state names, the
    output and the gradients of ``weight_g``/``weight_v`` equal the
    reference's."""
    ref, port, x = pair()
    pt.load_reference_state(port, {k: v.numpy() for k, v in
                                   ref.state_dict().items()})
    paddle.nn.utils.weight_norm(ref, dim=dim)
    pt.nn.utils.weight_norm(port, dim=dim)
    state = {k: v.numpy() for k, v in ref.state_dict().items()}
    assert sorted(state) == sorted(port.state_dict())
    pt.load_reference_state(port, state)
    _run(lambda M, t: (ref if M is RF else port)(t), [x])
    rg = {k: p.grad for k, p in ref.named_parameters()}
    for k, p in port.named_parameters():
        _close(p.grad, rg[k], what=k)


def test_remove_weight_norm_folds_over_axis_0():
    """``remove_weight_norm`` folds ``g`` and ``v`` back over axis 0
    whatever ``dim`` was (the reference's quirk, kept): after ``dim=0``
    the weight comes back; after ``dim=1`` on a square weight it is
    another weight, the reference's; on a weight that is not square the
    fold fails in both."""
    w = _x(4, 4)
    for dim in (0, 1):
        ref, port = rnn.Linear(4, 4), pt.nn.Linear(4, 4, device="cpu")
        ref.weight.set_value(paddle.to_tensor(w))
        pt.load_reference_state(port, {k: v.numpy() for k, v in
                                       ref.state_dict().items()})
        for utils, layer in ((paddle.nn.utils, ref), (pt.nn.utils, port)):
            utils.weight_norm(layer, dim=dim)
            utils.remove_weight_norm(layer)
        assert sorted(ref.state_dict()) == sorted(port.state_dict())
        _close(port.weight, ref.weight, what=f"dim {dim}")
        assert np.allclose(_np(port.weight), w, atol=1e-6) == (dim == 0)
    ref, port = rnn.Linear(5, 3), pt.nn.Linear(5, 3, device="cpu")
    paddle.nn.utils.weight_norm(ref, dim=1)
    pt.nn.utils.weight_norm(port, dim=1)
    with pytest.raises(Exception):
        paddle.nn.utils.remove_weight_norm(ref)
    with pytest.raises(RuntimeError):
        pt.nn.utils.remove_weight_norm(port)


@pytest.mark.parametrize("pair", [_linear_pair, _conv_pair])
def test_spectral_norm_matches_reference(pair):
    ref, port, x = pair()
    paddle.nn.utils.spectral_norm(ref, n_power_iterations=3)
    pt.nn.utils.spectral_norm(port, n_power_iterations=3)
    state = {k: v.numpy() for k, v in ref.state_dict().items()}
    assert sorted(state) == sorted(port.state_dict())
    pt.load_reference_state(port, state)
    _run(lambda M, t: (ref if M is RF else port)(t), [x])
    rg = {k: p.grad for k, p in ref.named_parameters()
          if p.grad is not None}
    for k, p in port.named_parameters():
        _close(p.grad, rg[k], what=k)
