"""The detection ops of the port (``paddle_tpu_torch.vision.ops``) against
the reference's (``paddle_tpu.vision.ops``), from the same numpy inputs.

* ``box_iou`` within 1e-6; ``nms`` indices exactly equal, without scores,
  with distinct scores, per category (categories found and given) and
  with ``top_k``, and on no boxes.
* ``roi_align`` (aligned or not, ``sampling_ratio`` -1 and 3, boxes
  reaching past the map) forward within 1e-5 of the largest magnitude and
  the gradients of the features and the boxes within 1e-4 of their
  largest; ``roi_pool`` forward within 1e-5; the layers.
* ``box_coder`` encode and decode (``axis`` 0 and 1, variances None, a
  list and a tensor, normalised or not) within 1e-5 relative;
  ``yolo_box`` within 1e-5 relative, with boxes and scores zero under
  ``conf_thresh``; ``iou_aware`` raises in both.
* ``deform_conv2d`` v1 and v2 (stride 2, dilation 2, offsets of several
  pixels, some samples outside the map) forward within 1e-5 and the
  gradients of x, the offsets, the mask, the weight and the bias within
  1e-4 of their largest; ``groups`` over 1 raises in both;
  ``DeformConv2D`` has the reference's parameter names and shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import ops as RO

from paddle_tpu_torch.vision import ops as TO


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    if hasattr(t, "numpy"):
        t = t.numpy()
    return np.asarray(jnp.asarray(t))


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1.0),
                               err_msg=what)


def _boxes(rng, n, lo=0.0, hi=50.0, size=(2.0, 20.0)):
    c = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(*size, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)


def _both(fn_ref, fn_port, arrays, grad=()):
    """Both functions on the arrays (the ones indexed in ``grad`` with
    gradients), and under one random upstream gradient the gradients of
    those inputs: ((ref out, ref grads), (port out, port grads))."""
    rx = [paddle.to_tensor(a, stop_gradient=i not in grad)
          for i, a in enumerate(arrays)]
    tx = [torch.from_numpy(a).requires_grad_(i in grad)
          if a.dtype.kind == "f" else torch.from_numpy(a)
          for i, a in enumerate(arrays)]
    rout, tout = fn_ref(*rx), fn_port(*tx)
    if not grad:
        return (rout, []), (tout, [])
    up = np.random.default_rng(7).standard_normal(tuple(tout.shape)).astype(
        np.float32)
    (rout * paddle.to_tensor(up)).sum().backward()
    (tout * torch.from_numpy(up)).sum().backward()
    return ((rout, [rx[i].grad for i in grad]),
            (tout, [tx[i].grad for i in grad]))


def test_box_iou_matches_reference():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 9), _boxes(rng, 5)
    _close(TO.box_iou(torch.from_numpy(a), torch.from_numpy(b)),
           RO.box_iou(paddle.to_tensor(a), paddle.to_tensor(b)), 1e-6)


@pytest.mark.parametrize("case", ["plain", "scores", "categories",
                                  "given_categories", "top_k"])
def test_nms_indices_equal_reference(case):
    rng = np.random.default_rng(1)
    boxes = _boxes(rng, 80)
    scores = (rng.permutation(80) / 80).astype(np.float32)   # distinct
    cats = rng.integers(0, 4, 80)
    kw = {"plain": {}, "scores": {"scores": scores},
          "categories": {"scores": scores, "category_idxs": cats},
          "given_categories": {"scores": scores, "category_idxs": cats,
                               "categories": [2, 0, 3]},
          "top_k": {"scores": scores, "category_idxs": cats,
                    "top_k": 7}}[case]
    want = RO.nms(paddle.to_tensor(boxes), 0.3, **{
        k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
        for k, v in kw.items()})
    got = TO.nms(torch.from_numpy(boxes), 0.3, **{
        k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        for k, v in kw.items()})
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), _np(want))
    assert 0 < len(got) < 80


def test_nms_of_no_boxes():
    got = TO.nms(torch.zeros((0, 4)), 0.5)
    assert got.shape == (0,) and got.dtype == torch.int64


#: (output_size, spatial_scale, sampling_ratio, aligned)
ROI_ALIGN_CASES = {"aligned": ((3, 4), 0.5, -1, True),
                   "unaligned_ratio3": (2, 0.5, 3, False),
                   "scale1": ((2, 3), 1.0, 2, True)}


@pytest.mark.parametrize("case", list(ROI_ALIGN_CASES))
def test_roi_align_matches_reference(case):
    out, scale, ratio, aligned = ROI_ALIGN_CASES[case]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 11, 13)).astype(np.float32)
    # some boxes reach past the map's edges: samples there are zero
    boxes = _boxes(rng, 7, -4.0, 28.0, (2.0, 14.0))
    num = np.array([3, 4], np.int32)
    ref, port = _both(
        lambda v, b, n: RO.roi_align(v, b, n, out, scale, ratio, aligned),
        lambda v, b, n: TO.roi_align(v, b, n, out, scale, ratio, aligned),
        [x, boxes, num], grad=(0, 1))
    _close(port[0], ref[0], 1e-5, "output")
    for i, (g, r) in enumerate(zip(port[1], ref[1])):
        _close(g, r, 1e-4, f"gradient {i}")


def test_roi_pool_and_layers_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 12, 10)).astype(np.float32)
    boxes = _boxes(rng, 6, 0.0, 20.0, (2.0, 12.0))
    num = np.array([2, 4], np.int32)
    args = [paddle.to_tensor(a) for a in (x, boxes, num)]
    targs = [torch.from_numpy(a) for a in (x, boxes, num)]
    _close(TO.roi_pool(*targs, 3, 0.5), RO.roi_pool(*args, 3, 0.5), 1e-5)
    _close(TO.RoIPool((2, 3), 0.5)(*targs), RO.RoIPool((2, 3), 0.5)(*args),
           1e-5)
    _close(TO.RoIAlign(2, 0.5)(*targs), RO.RoIAlign(2, 0.5)(*args), 1e-5)


@pytest.mark.parametrize("var", ["none", "list", "tensor"])
@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder_encode_matches_reference(var, normalized):
    rng = np.random.default_rng(4)
    prior = _boxes(rng, 6)
    target = _boxes(rng, 5)
    v = {"none": None, "list": [0.1, 0.1, 0.2, 0.2],
         "tensor": rng.uniform(0.1, 0.3, (6, 4)).astype(np.float32)}[var]
    rv = paddle.to_tensor(v) if var == "tensor" else v
    tv = torch.from_numpy(v) if var == "tensor" else v
    want = RO.box_coder(paddle.to_tensor(prior), rv,
                        paddle.to_tensor(target),
                        box_normalized=normalized)
    got = TO.box_coder(torch.from_numpy(prior), tv,
                       torch.from_numpy(target), box_normalized=normalized)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("axis", [0, 1])
def test_box_coder_decode_matches_reference(axis):
    rng = np.random.default_rng(5)
    prior = _boxes(rng, 6)
    deltas = (0.3 * rng.standard_normal((6, 3, 4))).astype(np.float32)
    if axis == 1:
        deltas = np.ascontiguousarray(deltas.transpose(1, 0, 2))
    var = [0.1, 0.1, 0.2, 0.2]
    want = RO.box_coder(paddle.to_tensor(prior), var,
                        paddle.to_tensor(deltas), "decode_center_size",
                        False, axis)
    got = TO.box_coder(torch.from_numpy(prior), var,
                       torch.from_numpy(deltas), "decode_center_size",
                       False, axis)
    _close(got, want, 1e-5)
    with pytest.raises(ValueError, match="prior count"):
        TO.box_coder(torch.from_numpy(prior), var,
                     torch.from_numpy(deltas), "decode_center_size",
                     False, 1 - axis)


@pytest.mark.parametrize("clip,sxy", [(True, 1.0), (False, 1.05)])
def test_yolo_box_matches_reference(clip, sxy):
    rng = np.random.default_rng(6)
    classes, anchors = 4, [10, 13, 16, 30, 33, 23]
    x = rng.standard_normal((2, 3 * (5 + classes), 5, 6)).astype(np.float32)
    size = np.array([[320, 416], [288, 256]], np.int32)
    want = RO.yolo_box(paddle.to_tensor(x), paddle.to_tensor(size), anchors,
                       classes, 0.5, 32, clip, scale_x_y=sxy)
    got = TO.yolo_box(torch.from_numpy(x), torch.from_numpy(size), anchors,
                      classes, 0.5, 32, clip, scale_x_y=sxy)
    for g, w, what in zip(got, want, ("boxes", "scores")):
        _close(g, w, 1e-5, what)
    dropped = (got[1] == 0).all(-1)
    assert 0 < int(dropped.sum()) < dropped.numel()
    assert bool((got[0][dropped] == 0).all())
    for ops_ in (RO, TO):
        with pytest.raises(NotImplementedError, match="iou_aware"):
            ops_.yolo_box(None, None, anchors, classes, 0.5, 32,
                          iou_aware=True)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_deform_conv2d_matches_reference(version):
    rng = np.random.default_rng(8)
    stride, padding, dilation = 2, 2, 2
    x = rng.standard_normal((2, 3, 10, 9)).astype(np.float32)
    w = (0.3 * rng.standard_normal((4, 3, 3, 3))).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    oh, ow = 5, 5
    off = (2.5 * rng.standard_normal((2, 18, oh, ow))).astype(np.float32)
    arrays = [x, off, w, b]
    if version == "v2":
        arrays.append(rng.uniform(0, 1, (2, 9, oh, ow)).astype(np.float32))

    def call(ops_):
        return lambda v, o, wt, bias, *m: ops_.deform_conv2d(
            v, o, wt, bias, stride, padding, dilation,
            mask=m[0] if m else None)
    ref, port = _both(call(RO), call(TO), arrays,
                      grad=tuple(range(len(arrays))))
    assert tuple(port[0].shape) == (2, 4, oh, ow)
    _close(port[0], ref[0], 1e-5, "output")
    for i, (g, r) in enumerate(zip(port[1], ref[1])):
        _close(g, r, 1e-4, f"gradient {i}")


def test_deform_conv2d_refusals_and_layer():
    x = torch.zeros(1, 4, 5, 5)
    off = torch.zeros(1, 18, 5, 5)
    for kw in ({"groups": 2}, {"deformable_groups": 2}):
        with pytest.raises(NotImplementedError, match="groups"):
            TO.deform_conv2d(x, off, torch.zeros(4, 2, 3, 3), padding=1,
                             **kw)
        with pytest.raises(NotImplementedError, match="groups"):
            RO.deform_conv2d(paddle.to_tensor(x.numpy()),
                             paddle.to_tensor(off.numpy()),
                             paddle.to_tensor(np.zeros((4, 2, 3, 3),
                                                       np.float32)),
                             padding=1, **kw)
    layer = TO.DeformConv2D(4, 6, 3, padding=1, device="cpu")
    ref = RO.DeformConv2D(4, 6, 3, padding=1)
    assert {k: tuple(v.shape) for k, v in layer.state_dict().items()} == {
        k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert layer(x, off).shape == (1, 6, 5, 5)
    assert torch.equal(layer.bias, torch.zeros(6))
    assert TO.DeformConv2D(4, 6, 3, bias_attr=False,
                           device="cpu").bias is None
