"""float16, ``amp.auto_cast()``'s default dtype, through every kernel row's
plain version against the reference, on the CPU.

Each row's plain PyTorch version (what its wrapper runs on CPU tensors,
and what the card's f16 route is held to in ``tests/test_torch_cuda.py``)
takes the same seeded numpy inputs in f16 as the reference's Pallas
entry point, called directly in interpret mode as
``tests/test_pallas_kernels.py`` calls it; every row's Pallas kernel
takes f16 there, so no row falls back to an XLA composite:

* rows 1 and 10, ragged paged attention (float and int8 pools):
  ``pallas_ragged.ragged_paged_attention``;
* rows 2 and 6, layer norm forward and backward: ``pallas_kernels.
  fused_layer_norm`` and its ``jax.vjp``;
* rows 3 and 7, the matmul epilogue forward and backward:
  ``pallas_fused.fused_linear_act`` and its ``jax.vjp``;
* rows 4-5, flash attention forward, dq and dk/dv: ``pallas_kernels.
  flash_attention`` and its ``jax.vjp``;
* rows 8a/8b, softmax cross-entropy: ``pallas_kernels.
  fused_softmax_cross_entropy`` and its ``jax.vjp``;
* row 9, paged decode attention: ``pallas_kernels.paged_attention``;
* row 11, the int8 epilogue: ``pallas_fused.fused_linear_act_int8``;
* row 12, RMS norm: ``pallas_kernels.fused_rms_norm`` and its vjp;
* row 13, the residual layer norm: ``pallas_fused.
  fused_layer_norm_residual`` and its vjp;
* rows 14a/14b, the grouped matmul and its dw: ``pallas_grouped.
  grouped_linear_act`` and its vjp;
* row 15, the SGMV epilogue: ``pallas_grouped.lora_segment_epilogue``
  and its vjp.

Tolerance: 5e-3 abs + rel (about five f16 ulps at unit scale: both sides
round f32 results to f16, some in other orders), and for column sums
(dgamma, dbeta, db, dw: sums over up to 300 rows) 5e-3 of the largest
magnitude plus 5e-3 rel, as ``_sum_tol`` holds bf16's; the f32 losses
and statistics 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_fused as pf
from paddle_tpu.ops import pallas_grouped as pg
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.ops import pallas_ragged as pr
from paddle_tpu_torch import ops as tops

TOL = 5e-3


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _j(a):
    return jnp.asarray(a).astype(jnp.float16)


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a)).to(torch.float16) \
        .requires_grad_(grad)


def _close(got, want, tol=TOL, what=""):
    if isinstance(got, torch.Tensor) and got.is_floating_point() \
            and tol == TOL:
        assert got.dtype == torch.float16, what
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol,
                               err_msg=what)


def _close_sum(got, want, what=""):
    scale = max(float(np.abs(_np(want)).max()), 1.0)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL * scale,
                               rtol=TOL, err_msg=what)


def _rng(seed):
    return np.random.default_rng(seed)


def _ragged(int8):
    qls, ctxs = [12, 1, 1], [30, 25, 9]
    block_q = pr.ragged_q_block(jnp.float16)
    assert block_q == tops.ragged_q_block(torch.float16)
    sid = tops.ragged_segments(qls, ctxs, block_q)[0]
    sid, qs, qv, _, _ = tops.ragged_segments(
        qls, ctxs, block_q, num_q_blocks=len(sid) + 1, num_seqs=3)
    rng = _rng(30)
    H, D, bs, W = 4, 32, 16, 4
    q = rng.standard_normal((len(sid) * block_q, H, D), np.float32)
    nb = 3 * W + 1
    tables = np.zeros((3, W), np.int32)
    for s, c in enumerate(ctxs):
        for w in range(-(-c // bs)):
            tables[s, w] = 1 + s * W + w
    ints = [tables, np.asarray(ctxs, np.int32), sid, qs, qv]
    kw_j, kw_t = dict(block_q=block_q), dict(block_q=block_q)
    if int8:
        pools = [rng.integers(-127, 128, (nb, H, bs, D)).astype(np.int8)
                 for _ in range(2)]
        scales = [rng.uniform(0.005, 0.02, (nb, bs, 1)).astype(np.float32)
                  for _ in range(2)]
        jp, tp = [jnp.asarray(p) for p in pools], \
            [torch.from_numpy(p) for p in pools]
        kw_j.update(k_scales=jnp.asarray(scales[0]),
                    v_scales=jnp.asarray(scales[1]))
        kw_t.update(k_scales=torch.from_numpy(scales[0]),
                    v_scales=torch.from_numpy(scales[1]))
    else:
        pools = [rng.standard_normal((nb, H, bs, D), np.float32)
                 for _ in range(2)]
        jp, tp = [_j(p) for p in pools], [_t(p) for p in pools]
    want = pr.ragged_paged_attention(_j(q), *jp,
                                     *(jnp.asarray(a) for a in ints), **kw_j)
    got = tops.ragged_paged_attention(
        _t(q), *tp, *(torch.from_numpy(a) for a in ints), **kw_t)
    _close(got, want)


@pytest.mark.parametrize("int8", [False, True], ids=["row1", "row10"])
def test_ragged_attention_float16(int8):
    _ragged(int8)


def test_layer_norm_float16():
    """Rows 2 and 6: out, mu, rstd and dx, dgamma, dbeta."""
    rng = _rng(3)
    x = rng.standard_normal((37, 96), np.float32) * 3 + 1
    gamma = rng.standard_normal(96, np.float32) + 1
    beta = rng.standard_normal(96, np.float32)
    dout = rng.standard_normal((37, 96), np.float32)
    out_ref, vjp = jax.vjp(lambda a, g, b: pk.fused_layer_norm(a, g, b),
                           _j(x), _j(gamma), _j(beta))
    grads_ref = vjp(_j(dout))
    _, (_, _, mu_ref, rstd_ref) = pk._fused_layer_norm_2d_fwd(
        _j(x), _j(gamma), _j(beta), 1e-5)
    _, mu, rstd = tops.fused_layer_norm(_t(x), _t(gamma), _t(beta))
    _close(mu, np.asarray(mu_ref)[:37, 0], 1e-5)
    _close(rstd, np.asarray(rstd_ref)[:37, 0], 1e-4)
    tx, tg, tb = _t(x, True), _t(gamma, True), _t(beta, True)
    out = tops.layer_norm(tx, tg, tb)
    out.backward(_t(dout))
    _close(out, out_ref, what="out")
    _close(tx.grad, grads_ref[0], what="dx")
    _close_sum(tg.grad, grads_ref[1], "dgamma")
    _close_sum(tb.grad, grads_ref[2], "dbeta")


@pytest.mark.parametrize("act", tops.ACTIVATIONS)
def test_matmul_epilogue_float16(act):
    """Rows 3 and 7: out, and dx, dw, db through the backward kernel's
    plain version."""
    rng = _rng(50)
    x = rng.standard_normal((45, 64), np.float32)
    w = rng.standard_normal((64, 80), np.float32) * 0.2
    b = rng.standard_normal(80, np.float32) * 0.5
    g = rng.standard_normal((45, 80), np.float32)
    out_ref, vjp = jax.vjp(lambda a, ww, bb: pf.fused_linear_act(
        a, ww, bb, act), _j(x), _j(w), _j(b))
    dx_ref, dw_ref, db_ref = vjp(_j(g))
    tx, tw, tb = (_t(a, True) for a in (x, w, b))
    out = tops.linear_act(tx, tw, tb, act)
    out.backward(_t(g))
    _close(out, out_ref, what="out")
    _close_sum(tb.grad, db_ref, "db")
    _close_sum(tx.grad, dx_ref, "dx")
    _close_sum(tw.grad, dw_ref, "dw")


def test_softmax_cross_entropy_float16():
    """Rows 8a/8b: the f32 loss and the f16 dlogits."""
    rng = _rng(60)
    rows, V = 29, 1000
    logits = rng.standard_normal((rows, V), np.float32) * 3
    labels = rng.integers(0, V, rows).astype(np.int64)
    labels[[2, 7]] = -1
    g = rng.uniform(0.1, 2.0, rows).astype(np.float32)
    loss_ref, vjp = jax.vjp(lambda a: pk.fused_softmax_cross_entropy(
        a, jnp.asarray(labels.astype(np.int32))), _j(logits))
    (dl_ref,) = vjp(jnp.asarray(g).astype(loss_ref.dtype))
    tl = _t(logits, True)
    loss = tops.fused_softmax_cross_entropy(tl, torch.from_numpy(labels))
    loss.backward(torch.from_numpy(g))
    assert loss.dtype == torch.float32
    _close(loss, loss_ref, 1e-5, "loss")
    _close(tl.grad, dl_ref, what="dlogits")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_float16(causal):
    """Rows 4-5: out and dq, dk, dv."""
    rng = _rng(70)
    B, Sq, Sk, H, D = 1, 40, 40 if causal else 56, 2, 64
    q, k, v = (rng.standard_normal((B, s, H, D), np.float32)
               for s in (Sq, Sk, Sk))
    g = rng.standard_normal((B, Sq, H, D), np.float32)
    want, vjp = jax.vjp(lambda a, b, c: pk.flash_attention(
        a, b, c, causal=causal), _j(q), _j(k), _j(v))
    grads_ref = vjp(_j(g))
    tq, tk, tv = (_t(a, True) for a in (q, k, v))
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    got.backward(_t(g))
    _close(got, want, what="out")
    for name, t, r in zip(("dq", "dk", "dv"), (tq, tk, tv), grads_ref):
        _close(t.grad, r, what=name)


def test_paged_attention_float16():
    """Row 9: decode attention over scattered pages."""
    rng = _rng(80)
    B, H, D, bs, W = 3, 2, 64, 16, 4
    ctx = np.array([40, 1, 17], np.int32)
    nb = B * W + 1
    tables = (1 + rng.permutation(nb - 1)[:B * W]).reshape(B, W) \
        .astype(np.int32)
    q = rng.standard_normal((B, 1, H, D), np.float32)
    k, v = (rng.standard_normal((nb, H, bs, D), np.float32)
            for _ in range(2))
    want = pk.paged_attention(_j(q), _j(k), _j(v), jnp.asarray(tables),
                              jnp.asarray(ctx))
    got = tops.paged_attention(_t(q), _t(k), _t(v),
                               torch.from_numpy(tables),
                               torch.from_numpy(ctx))
    _close(got, want)


def test_matmul_epilogue_int8_float16():
    """Row 11: int8 codes, an f32 scale and an f16 bias."""
    rng = _rng(90)
    x = rng.standard_normal((40, 96), np.float32)
    q = rng.integers(-127, 128, (96, 72)).astype(np.int8)
    s = rng.uniform(0.001, 0.01, 72).astype(np.float32)
    b = rng.standard_normal(72, np.float32)
    want = pf.fused_linear_act_int8(_j(x), jnp.asarray(q), jnp.asarray(s),
                                    _j(b), "gelu_tanh")
    got = tops.fused_linear_act_int8(_t(x), torch.from_numpy(q),
                                     torch.from_numpy(s), _t(b), "gelu_tanh")
    _close(got, want)


def test_rms_norm_float16():
    """Row 12: out, dx and dgamma."""
    rng = _rng(100)
    x = rng.standard_normal((37, 128), np.float32) * 2
    gamma = rng.standard_normal(128, np.float32) + 1
    dout = rng.standard_normal((37, 128), np.float32)
    out_ref, vjp = jax.vjp(lambda a, g: pk.fused_rms_norm(a, g), _j(x),
                           _j(gamma))
    dx_ref, dg_ref = vjp(_j(dout))
    tx, tg = _t(x, True), _t(gamma, True)
    out = tops.rms_norm(tx, tg)
    out.backward(_t(dout))
    _close(out, out_ref, what="out")
    _close(tx.grad, dx_ref, what="dx")
    _close_sum(tg.grad, dg_ref, "dgamma")


def test_layer_norm_residual_float16():
    """Row 13: out and the stored sum s in f16, and the gradients of x,
    the residual, gamma and beta."""
    rng = _rng(110)
    x, r = (rng.standard_normal((37, 96), np.float32) for _ in range(2))
    gamma = rng.standard_normal(96, np.float32) + 1
    beta = rng.standard_normal(96, np.float32)
    dout = rng.standard_normal((37, 96), np.float32)
    j = [_j(a) for a in (x, r, gamma, beta)]
    out_ref, vjp = jax.vjp(
        lambda a, b, g, bb: pf.fused_layer_norm_residual(a, b, g, bb), *j)
    grads_ref = vjp(_j(dout))
    _, (s_ref, _, _, _) = pf._fused_ln_residual_2d_fwd(*j, 1e-5)
    s = tops.fused_layer_norm_residual(*(_t(a) for a in (x, r, gamma,
                                                         beta)))[1]
    _close(s, np.asarray(s_ref)[:37], what="s")
    leaves = [_t(a, True) for a in (x, r, gamma, beta)]
    out = tops.layer_norm_residual(*leaves)
    out.backward(_t(dout))
    _close(out, out_ref, what="out")
    for name, t, g in zip(("dx", "dr"), leaves[:2], grads_ref[:2]):
        _close(t.grad, g, what=name)
    for name, t, g in zip(("dgamma", "dbeta"), leaves[2:], grads_ref[2:]):
        _close_sum(t.grad, g, name)


def test_grouped_matmul_float16():
    """Rows 14a/14b: the grouped forward and, through its backward, dx
    (the forward kernel on the transposed weights), dw and db."""
    rng = _rng(120)
    E, K, N, bm = 3, 48, 40, 16
    gid = np.array([0, 0, 1, 2, 2, 3], np.int32)     # block 5: null
    x = rng.standard_normal((len(gid) * bm, K), np.float32)
    w = rng.standard_normal((E, K, N), np.float32) * 0.2
    b = rng.standard_normal((E, N), np.float32)
    g = rng.standard_normal((len(gid) * bm, N), np.float32)
    out_ref, vjp = jax.vjp(lambda a, ww, bb: pg.grouped_linear_act(
        a, ww, bb, block_group=jnp.asarray(gid), act="gelu"),
        _j(x), _j(w), _j(b))
    grads_ref = vjp(_j(g))
    tx, tw, tb = (_t(a, True) for a in (x, w, b))
    out = tops.grouped_linear_act(tx, tw, tb,
                                  block_group=torch.from_numpy(gid),
                                  act="gelu")
    out.backward(_t(g))
    _close(out, out_ref, what="out")
    _close(tx.grad, grads_ref[0], what="dx")
    _close_sum(tw.grad, grads_ref[1], "dw")
    _close_sum(tb.grad, grads_ref[2], "db")


def test_lora_segment_epilogue_float16():
    """Row 15: out and the gradients of z, x and both factor stacks."""
    rng = _rng(130)
    L, K, N, r, bm = 3, 40, 48, 8, 16
    aid = np.array([2, 0, 3, 1, 0], np.int32)         # 3: a null block
    z = rng.standard_normal((len(aid) * bm, N), np.float32)
    x = rng.standard_normal((len(aid) * bm, K), np.float32)
    a = rng.standard_normal((L, K, r), np.float32) * 0.2
    bb = rng.standard_normal((L, r, N), np.float32) * 0.2
    g = rng.standard_normal((len(aid) * bm, N), np.float32)
    out_ref, vjp = jax.vjp(
        lambda zz, xx, aa, b2: pg.lora_segment_epilogue(
            zz, xx, aa, b2, block_adapter=jnp.asarray(aid), act="silu"),
        *(_j(v) for v in (z, x, a, bb)))
    grads_ref = vjp(_j(g))
    leaves = [_t(v, True) for v in (z, x, a, bb)]
    out = tops.lora_segment_epilogue(*leaves,
                                     block_adapter=torch.from_numpy(aid),
                                     act="silu")
    out.backward(_t(g))
    _close(out, out_ref, what="out")
    for name, t, want in zip(("dz", "dx", "da", "db"), leaves, grads_ref):
        _close_sum(t.grad, want, name)
