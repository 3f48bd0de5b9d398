"""The port's losses and loss layers against the reference's
(``paddle_tpu.nn.functional.loss`` and ``nn.layer.loss``).

Every function of the reference's ``loss.py`` runs on the same seeded
numpy inputs in both packages, in each of its reductions (``"mean"``,
``"sum"``, ``"none"``, and ``"batchmean"`` for ``kl_div``; the functions
without a reduction once): the f32 loss within 1e-5 abs + rel, and the
gradient with respect to each floating input (labels and weights
included) under one seeded upstream gradient within the same
tolerance.  The cases are those of the reference's
``tests/test_nn.py::test_losses``, ``::test_cross_entropy_ignore_index``,
``::test_loss_parity_vs_torch`` and
``tests/test_functional_extras.py::test_softmin_and_losses``, with each
function's options: cross-entropy with ignored labels, class weights,
soft labels and smoothing; ``nll_loss``'s weighted mean over the kept
targets; ``ctc_loss`` with unequal input and label lengths and
``norm_by_times``; ``hsigmoid_loss`` over the default tree and a custom
one; ``triplet_margin_with_distance_loss`` with a distance of its own.

``softmax_with_cross_entropy`` goes through ``cross_entropy``'s kernel
route: on the CPU its wrapper takes the plain version, and the test
counts no launch.  Each loss layer is built with the same arguments in
both packages and held to the reference's loss; ``HSigmoidLoss``'s
``state_dict`` keys and shapes equal the reference's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF

import paddle_tpu_torch as pt
from paddle_tpu_torch import ops
from paddle_tpu_torch.nn import functional as F

TOL = 1e-5
REDUCTIONS = ("mean", "sum", "none")


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    if isinstance(t, np.ndarray):
        return t
    return np.asarray(t.numpy(), np.float32)


def _close(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=what)


def _run(fn_ref, fn_port, arrays, seed=0):
    """Both packages' losses on ``arrays`` and the gradients of every
    floating input under one seeded upstream gradient."""
    def grads(a):
        return a.dtype.kind == "f"
    rx = [paddle.to_tensor(a, stop_gradient=not grads(a)) for a in arrays]
    tx = [torch.from_numpy(a).requires_grad_(grads(a)) for a in arrays]
    rout, tout = fn_ref(*rx), fn_port(*tx)
    up = np.random.default_rng(seed + 99).standard_normal(
        tuple(tout.shape)).astype(np.float32)
    (rout * paddle.to_tensor(up)).sum().backward()
    (tout * torch.from_numpy(up)).sum().backward()
    _close(tout, rout, "loss")
    for i, (r, t) in enumerate(zip(rx, tx)):
        if not grads(arrays[i]) or (r.grad is None and t.grad is None):
            continue    # an input the loss only compares has no gradient
        zero = np.zeros(arrays[i].shape, np.float32)
        _close(zero if t.grad is None else t.grad,
               zero if r.grad is None else r.grad, f"gradient of input {i}")


def _rng(seed):
    return np.random.default_rng(seed)


def _f(shape, seed=0, scale=1.0):
    return (scale * _rng(seed).standard_normal(shape)).astype(np.float32)


def _u(shape, seed=0, lo=0.05, hi=0.95):
    return _rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _i(shape, hi, seed=0, lo=0):
    return _rng(seed).integers(lo, hi, shape).astype(np.int64)


def _sign(shape, seed=0):
    return np.where(_rng(seed).standard_normal(shape) >= 0, 1.0,
                    -1.0).astype(np.float32)


def _labels_with_ignored():
    lab = _i((6,), 10, seed=3)
    lab[[1, 4]] = -100
    return lab


def _logp():
    x = _f((6, 10), 1)
    return (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(np.float32)


def _tree_paths():
    table = np.array([[0, 1, 3], [0, 1, -1], [0, 2, 4], [0, 2, -1]],
                     np.int64)
    code = np.array([[0, 1, 0], [1, 0, 0], [1, 1, 0], [0, 0, 0]], np.int64)
    return table, code


def _l1_dist(u, v):
    return (u - v).abs().sum(-1)


#: name -> (call on (functional module, reduction, *inputs), inputs,
#: reductions); reduction None: the function takes none
CASES = {
    "cross_entropy": (
        lambda M, r, x, y: M.cross_entropy(x, y, reduction=r),
        [_f((6, 10)), _i((6,), 10)], REDUCTIONS),
    "cross_entropy_ignore_index": (
        lambda M, r, x, y: M.cross_entropy(x, y, reduction=r),
        [_f((6, 10)), _labels_with_ignored()], REDUCTIONS),
    "cross_entropy_weight": (
        lambda M, r, x, y, w: M.cross_entropy(x, y, weight=w, reduction=r),
        [_f((6, 10)), _labels_with_ignored(), _u((10,), 4)], REDUCTIONS),
    "cross_entropy_soft_smoothed": (
        lambda M, r, x, y: M.cross_entropy(x, y, soft_label=True,
                                           label_smoothing=0.1,
                                           reduction=r),
        [_f((6, 10)), _u((6, 10), 5)], REDUCTIONS),
    "cross_entropy_hard_smoothed": (
        lambda M, r, x, y: M.cross_entropy(x, y, label_smoothing=0.1,
                                           reduction=r),
        [_f((6, 10)), _i((6,), 10)], REDUCTIONS),
    "softmax_with_cross_entropy": (
        lambda M, r, x, y: M.softmax_with_cross_entropy(x, y),
        [_f((6, 10)), _i((6, 1), 10)], (None,)),
    "softmax_with_cross_entropy_soft": (
        lambda M, r, x, y: M.softmax_with_cross_entropy(
            x, y, soft_label=True),
        [_f((6, 10)), _u((6, 10), 5)], (None,)),
    "mse_loss": (lambda M, r, a, b: M.mse_loss(a, b, r),
                 [_f((4, 5)), _f((4, 5), 1)], REDUCTIONS),
    "square_error_cost": (lambda M, r, a, b: M.square_error_cost(a, b),
                          [_f((4, 5)), _f((4, 5), 1)], (None,)),
    "l1_loss": (lambda M, r, a, b: M.l1_loss(a, b, r),
                [_f((4, 5)), _f((4, 5), 1)], REDUCTIONS),
    "nll_loss": (lambda M, r, x, y: M.nll_loss(x, y, reduction=r),
                 [_logp(), _labels_with_ignored()], REDUCTIONS),
    "nll_loss_weight": (
        lambda M, r, x, y, w: M.nll_loss(x, y, w, reduction=r),
        [_logp(), _labels_with_ignored(), _u((10,), 4)], REDUCTIONS),
    "binary_cross_entropy": (
        lambda M, r, p, y, w: M.binary_cross_entropy(p, y, w, r),
        [_u((4, 5)), _u((4, 5), 1, 0.0, 1.0), _u((4, 5), 2)], REDUCTIONS),
    "binary_cross_entropy_with_logits": (
        lambda M, r, z, y: M.binary_cross_entropy_with_logits(
            z, y, reduction=r),
        [_f((4, 5), scale=3.0), _u((4, 5), 1, 0.0, 1.0)], REDUCTIONS),
    "binary_cross_entropy_with_logits_weights": (
        lambda M, r, z, y, w, pw: M.binary_cross_entropy_with_logits(
            z, y, w, r, pw),
        [_f((4, 5), scale=3.0), _u((4, 5), 1, 0.0, 1.0), _u((4, 5), 2),
         _u((5,), 3, 0.5, 2.0)], REDUCTIONS),
    "smooth_l1_loss": (
        lambda M, r, a, b: M.smooth_l1_loss(a, b, r, delta=0.5),
        [_f((4, 5)), _f((4, 5), 1)], REDUCTIONS),
    "kl_div": (lambda M, r, x, y: M.kl_div(x, y, r),
               [_logp(), _u((6, 10), 2)], REDUCTIONS + ("batchmean",)),
    "kl_div_log_target": (
        lambda M, r, x, y: M.kl_div(x, y, r, log_target=True),
        [_logp(), np.log(_u((6, 10), 2))], REDUCTIONS + ("batchmean",)),
    "margin_ranking_loss": (
        lambda M, r, a, b, y: M.margin_ranking_loss(a, b, y, 0.3, r),
        [_f((8,)), _f((8,), 1), _sign((8,), 2)], REDUCTIONS),
    "hinge_embedding_loss": (
        lambda M, r, x, y: M.hinge_embedding_loss(x, y, 1.2, r),
        [_f((4, 5)), _sign((4, 5), 1)], REDUCTIONS),
    "cosine_embedding_loss": (
        lambda M, r, a, b, y: M.cosine_embedding_loss(a, b, y, 0.2, r),
        [_f((4, 6)), _f((4, 6), 1), _sign((4,), 2)], REDUCTIONS),
    "triplet_margin_loss": (
        lambda M, r, a, p, n: M.triplet_margin_loss(a, p, n, reduction=r),
        [_f((4, 6)), _f((4, 6), 1), _f((4, 6), 2)], REDUCTIONS),
    "triplet_margin_loss_p1_swap": (
        lambda M, r, a, p, n: M.triplet_margin_loss(a, p, n, 2.0, 1.0,
                                                    swap=True, reduction=r),
        [_f((4, 6)), _f((4, 6), 1), _f((4, 6), 2)], REDUCTIONS),
    "triplet_margin_with_distance_loss": (
        lambda M, r, a, p, n: M.triplet_margin_with_distance_loss(
            a, p, n, reduction=r),
        [_f((4, 6)), _f((4, 6), 1), _f((4, 6), 2)], REDUCTIONS),
    "triplet_margin_with_distance_loss_l1": (
        lambda M, r, a, p, n: M.triplet_margin_with_distance_loss(
            a, p, n, _l1_dist, 3.0, True, r),
        [_f((4, 6)), _f((4, 6), 1), _f((4, 6), 2)], REDUCTIONS),
    "log_loss": (lambda M, r, p, y: M.log_loss(p, y),
                 [_u((4, 1)), _u((4, 1), 1, 0.0, 1.0)], (None,)),
    "sigmoid_focal_loss": (
        lambda M, r, z, y: M.sigmoid_focal_loss(z, y, reduction=r),
        [_f((4, 5), scale=2.0), _u((4, 5), 1, 0.0, 1.0)], REDUCTIONS),
    "sigmoid_focal_loss_normalizer": (
        lambda M, r, z, y, n: M.sigmoid_focal_loss(z, y, n, 0.5, 1.5, r),
        [_f((4, 5), scale=2.0), _u((4, 5), 1, 0.0, 1.0),
         np.array([3.0], np.float32)], REDUCTIONS),
    "dice_loss": (lambda M, r, p, y: M.dice_loss(p, y),
                  [_u((3, 4, 5)), _i((3, 4, 1), 5)], (None,)),
    "npair_loss": (lambda M, r, a, p, y: M.npair_loss(a, p, y),
                   [_f((4, 6)), _f((4, 6), 1),
                    np.array([0, 1, 0, 2], np.int64)], (None,)),
    "poisson_nll_loss": (
        lambda M, r, x, y: M.poisson_nll_loss(x, y, reduction=r),
        [_f((4, 5)), _u((4, 5), 1, 0.0, 4.0)], REDUCTIONS),
    "poisson_nll_loss_full": (
        lambda M, r, x, y: M.poisson_nll_loss(x, y, False, True,
                                              reduction=r),
        [_u((4, 5), 0, 0.5, 3.0), _u((4, 5), 1, 0.0, 4.0)], REDUCTIONS),
    "multi_label_soft_margin_loss": (
        lambda M, r, x, y, w: M.multi_label_soft_margin_loss(x, y, w, r),
        [_f((4, 5)), _u((4, 5), 1, 0.0, 1.0), _u((4,), 2)], REDUCTIONS),
    "soft_margin_loss": (
        lambda M, r, x, y: M.soft_margin_loss(x, y, r),
        [_f((4, 5)), _sign((4, 5), 1)], REDUCTIONS),
    "ctc_loss": (
        lambda M, r, lp, lab, il, ll: M.ctc_loss(lp, lab, il, ll,
                                                 reduction=r),
        [_f((7, 3, 5)), _i((3, 3), 5, 1, lo=1),
         np.array([7, 5, 6], np.int64), np.array([3, 2, 1], np.int64)],
        REDUCTIONS),
    "ctc_loss_norm_by_times": (
        lambda M, r, lp, lab, il, ll: M.ctc_loss(lp, lab, il, ll, 0, r,
                                                 norm_by_times=True),
        [_f((7, 3, 5)), _i((3, 3), 5, 1, lo=1),
         np.array([7, 5, 6], np.int64), np.array([3, 2, 1], np.int64)],
        REDUCTIONS),
    "multi_margin_loss": (
        lambda M, r, x, y: M.multi_margin_loss(x, y, reduction=r),
        [_f((5, 4)), _i((5,), 4, 1)], REDUCTIONS),
    "multi_margin_loss_p2_weight": (
        lambda M, r, x, y, w: M.multi_margin_loss(x, y, 2, 0.5, w, r),
        [_f((5, 4)), _i((5,), 4, 1), _u((4,), 2)], REDUCTIONS),
    "hsigmoid_loss": (
        lambda M, r, x, y, w, b: M.hsigmoid_loss(x, y, 6, w, b),
        [_f((4, 3)), _i((4,), 6, 1), _f((5, 3), 2), _f((5, 1), 3)],
        (None,)),
    "hsigmoid_loss_custom_tree": (
        lambda M, r, x, y, w, t, c: M.hsigmoid_loss(x, y, 5, w, None, t, c),
        [_f((4, 3)), _i((4,), 5, 1), _f((5, 3), 2), *_tree_paths()],
        (None,)),
    "huber_loss": (lambda M, r, a, b: M.huber_loss(a, b, 0.8, r),
                   [_f((4, 5)), _f((4, 5), 1)], REDUCTIONS),
    "gaussian_nll_loss": (
        lambda M, r, mu, y, var: M.gaussian_nll_loss(mu, y, var, True,
                                                     reduction=r),
        [_f((4, 5)), _f((4, 5), 1), _u((4, 5), 2, 0.0, 2.0)], REDUCTIONS),
}


@pytest.mark.parametrize("name,reduction", [
    (n, r) for n, (_, _, rs) in CASES.items() for r in rs])
def test_loss_matches_reference(name, reduction):
    call, arrays, _ = CASES[name]
    _run(lambda *t: call(RF, reduction, *t),
         lambda *t: call(F, reduction, *t), arrays)


def test_reference_cases():
    """The values of the reference's own test_losses,
    test_cross_entropy_ignore_index and test_softmin_and_losses."""
    logits = torch.from_numpy(_f((4, 10), 7))
    labels = torch.tensor([1, 2, 3, 4])
    lp = torch.log_softmax(logits, -1).numpy()
    np.testing.assert_allclose(F.cross_entropy(logits, labels).numpy(),
                               -lp[np.arange(4), labels.numpy()].mean(),
                               rtol=1e-5)
    np.testing.assert_allclose(
        F.mse_loss(logits, torch.zeros_like(logits)).numpy(),
        (logits.numpy() ** 2).mean(), rtol=1e-5)
    lab = torch.tensor([1, -100, 3, -100])
    np.testing.assert_allclose(
        F.cross_entropy(logits[:, :5], lab, ignore_index=-100).numpy(),
        -(torch.log_softmax(logits[:, :5], -1)[0, 1]
          + torch.log_softmax(logits[:, :5], -1)[2, 3]).numpy() / 2,
        rtol=1e-5)
    hl = F.huber_loss(torch.tensor([0.0, 3.0]), torch.tensor([0.5, 0.0]),
                      delta=1.0, reduction="none").numpy()
    np.testing.assert_allclose(hl, [0.125, 2.5], rtol=1e-6)
    g = F.gaussian_nll_loss(torch.tensor([0.0]), torch.tensor([1.0]),
                            torch.tensor([4.0]), reduction="sum")
    np.testing.assert_allclose(float(g), 0.5 * (np.log(4.0) + 0.25),
                               rtol=1e-5)


def test_softmax_with_cross_entropy_routes_to_the_kernel_wrapper():
    """Hard labels go through ``ops.fused_softmax_cross_entropy`` (rows
    8a/8b): on CPU tensors it runs the plain version and counts no
    launch; ``return_softmax`` adds the reference's softmax."""
    x = torch.from_numpy(_f((6, 10)))
    y = torch.from_numpy(_i((6, 1), 10))
    calls = []
    real = ops.fused_softmax_cross_entropy
    n0 = ops.softmax_xent_fwd.launches
    try:
        import paddle_tpu_torch.nn.functional.loss as L
        L.ops.fused_softmax_cross_entropy = \
            lambda *a: calls.append(1) or real(*a)
        loss, sm = F.softmax_with_cross_entropy(x, y, return_softmax=True)
    finally:
        L.ops.fused_softmax_cross_entropy = real
    assert calls == [1] and ops.softmax_xent_fwd.launches == n0
    rloss, rsm = RF.softmax_with_cross_entropy(
        paddle.to_tensor(x.numpy()), paddle.to_tensor(y.numpy()),
        return_softmax=True)
    _close(loss, rloss)
    _close(sm, rsm)


#: (layer name, positional args, keyword args, inputs)
LAYERS = [
    ("CrossEntropyLoss", (), {"label_smoothing": 0.1},
     [_f((6, 10)), _i((6,), 10)]),
    ("CrossEntropyLoss", (None, -100, "sum"), {},
     [_f((6, 10)), _labels_with_ignored()]),
    ("MSELoss", (), {}, [_f((4, 5)), _f((4, 5), 1)]),
    ("MSELoss", ("sum",), {}, [_f((4, 5)), _f((4, 5), 1)]),
    ("L1Loss", (), {"reduction": "none"}, [_f((4, 5)), _f((4, 5), 1)]),
    ("NLLLoss", (), {}, [_logp(), _labels_with_ignored()]),
    ("BCELoss", (), {}, [_u((4, 5)), _u((4, 5), 1, 0.0, 1.0)]),
    ("BCEWithLogitsLoss", (), {"reduction": "sum"},
     [_f((4, 5)), _u((4, 5), 1, 0.0, 1.0)]),
    ("SmoothL1Loss", (), {"delta": 0.5}, [_f((4, 5)), _f((4, 5), 1)]),
    ("KLDivLoss", ("batchmean",), {}, [_logp(), _u((6, 10), 2)]),
    ("MarginRankingLoss", (0.3,), {},
     [_f((8,)), _f((8,), 1), _sign((8,), 2)]),
    ("HingeEmbeddingLoss", (), {}, [_f((4, 5)), _sign((4, 5), 1)]),
    ("CosineEmbeddingLoss", (0.2,), {},
     [_f((4, 6)), _f((4, 6), 1), _sign((4,), 2)]),
    ("TripletMarginLoss", (), {"swap": True},
     [_f((4, 6)), _f((4, 6), 1), _f((4, 6), 2)]),
    ("PoissonNLLLoss", (), {}, [_f((4, 5)), _u((4, 5), 1, 0.0, 4.0)]),
    ("MultiLabelSoftMarginLoss", (), {},
     [_f((4, 5)), _u((4, 5), 1, 0.0, 1.0)]),
    ("SoftMarginLoss", (), {}, [_f((4, 5)), _sign((4, 5), 1)]),
    ("HuberLoss", (), {"delta": 0.8}, [_f((4, 5)), _f((4, 5), 1)]),
    ("GaussianNLLLoss", (True,), {},
     [_f((4, 5)), _f((4, 5), 1), _u((4, 5), 2, 0.0, 2.0)]),
    ("MultiMarginLoss", (2, 0.5), {}, [_f((5, 4)), _i((5,), 4, 1)]),
    ("TripletMarginWithDistanceLoss", (_l1_dist,), {},
     [_f((4, 6)), _f((4, 6), 1), _f((4, 6), 2)]),
    ("CTCLoss", (), {},
     [_f((7, 3, 5)), _i((3, 3), 5, 1, lo=1),
      np.array([7, 5, 6], np.int64), np.array([3, 2, 1], np.int64)]),
]


@pytest.mark.parametrize("name,args,kwargs,arrays", LAYERS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(LAYERS)])
def test_loss_layer_matches_reference(name, args, kwargs, arrays):
    rl = getattr(paddle.nn, name)(*args, **kwargs)
    tl = getattr(pt.nn, name)(*args, **kwargs)
    assert list(tl.state_dict()) == list(rl.state_dict()) == []
    _run(rl, tl, arrays)


@pytest.mark.parametrize("bias", [True, False])
def test_hsigmoid_loss_layer(bias):
    kw = {} if bias else {"bias_attr": False}
    rl = paddle.nn.HSigmoidLoss(3, 6, **kw)
    tl = pt.nn.HSigmoidLoss(3, 6, **kw, device="cpu")
    rsd, tsd = rl.state_dict(), tl.state_dict()
    assert list(tsd) == list(rsd)
    for k in rsd:
        assert tuple(tsd[k].shape) == tuple(rsd[k].shape)
        tsd[k].copy_(torch.from_numpy(_np(rsd[k]).copy()))
    _run(rl, tl, [_f((4, 3)), _i((4,), 6, 1)])
    _close(tl.weight.grad, rl.weight.grad)


def test_every_loss_is_ported():
    import paddle_tpu.nn.functional.loss as ref_loss
    import paddle_tpu.nn.layer.loss as ref_layers
    assert set(ref_loss.__all__) <= set(F.__all__)
    assert set(ref_layers.__all__) <= set(pt.nn.__all__)
