"""The port's backward kernels' plain versions, held against the JAX
package's Pallas kernels.

Each differentiable entry point of ``paddle_tpu_torch.ops`` on CPU
tensors runs its plain forward and its plain backward (the functions the
CUDA kernels are compared with on the card), through its
``torch.autograd.Function``.  Its gradients are compared with
``jax.vjp`` of the reference's Pallas entry point, called directly in
interpret mode on the CPU, on the same inputs and the same upstream
gradient, made from a seed with numpy:

* ``pk.fused_layer_norm``: dx, dgamma, dbeta, at 37 and 300 rows (not
  multiples of the reference's row block);
* ``pf.fused_linear_act``: dx, dw, db for all five activations;
* ``pk.fused_softmax_cross_entropy``: the loss and dlogits, with labels
  < 0 (ignored), a vocab of 1000 (not a multiple of the vocab block) and
  a non-uniform upstream gradient.

Tolerances, abs and rel unless stated: f32 1e-5 for layer norm's output
and dx and for the cross-entropy loss and dlogits; 1e-4 for dgamma and
dbeta (sums over up to 300 rows in another order); 2e-4 for everything
of the epilogue (K- and M-long f32 sums in another order).  bf16 2e-2
(about two bf16 ulps at unit scale) for values rounded once to bf16,
column sums included (they accumulate in f32 before that rounding); the
epilogue's bf16 dx and dw at 2e-2 of the output's largest magnitude
plus 2e-2 rel, since a sum of bf16 products can cancel to a value far
below its terms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_fused as pf
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch import ops as tops

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _jax(a, dtype):
    return jnp.asarray(a).astype(_JAX[dtype])


def _torch(a, dtype, grad=True):
    return torch.from_numpy(a).to(_TORCH[dtype]).requires_grad_(grad)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [37, 300])
def test_layer_norm_backward_matches_pallas_vjp(dtype, rows):
    rng = np.random.default_rng(40 + rows)
    n = 96
    x = rng.standard_normal((rows, n), np.float32) * 2 + 0.5
    gamma = rng.standard_normal(n, np.float32) + 1
    beta = rng.standard_normal(n, np.float32)
    dout = rng.standard_normal((rows, n), np.float32)
    jx, jg, jb = (_jax(a, dtype) for a in (x, gamma, beta))
    out_ref, vjp = jax.vjp(lambda a, g, b: pk.fused_layer_norm(a, g, b),
                           jx, jg, jb)
    dx_ref, dg_ref, db_ref = vjp(_jax(dout, dtype))
    tx, tg, tb = (_torch(a, dtype) for a in (x, gamma, beta))
    out = tops.layer_norm(tx, tg, tb)
    out.backward(_torch(dout, dtype, grad=False))
    tol = 1e-5 if dtype == "float32" else 2e-2
    sum_tol = 1e-4 if dtype == "float32" else 2e-2
    _close(out, out_ref, tol)
    _close(tx.grad, dx_ref, tol)
    _close(tg.grad, dg_ref, sum_tol)
    _close(tb.grad, db_ref, sum_tol)
    assert tx.grad.dtype == tg.grad.dtype == _TORCH[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", tops.ACTIVATIONS)
def test_matmul_epilogue_backward_matches_pallas_vjp(dtype, act):
    rng = np.random.default_rng(50)
    x = rng.standard_normal((45, 64), np.float32)
    w = rng.standard_normal((64, 80), np.float32) * 0.2
    b = rng.standard_normal(80, np.float32) * 0.5
    g = rng.standard_normal((45, 80), np.float32)
    jx, jw, jb = (_jax(a, dtype) for a in (x, w, b))
    out_ref, vjp = jax.vjp(lambda a, ww, bb: pf.fused_linear_act(
        a, ww, bb, act), jx, jw, jb)
    dx_ref, dw_ref, db_ref = vjp(_jax(g, dtype))
    tx, tw, tb = (_torch(a, dtype) for a in (x, w, b))
    out = tops.linear_act(tx, tw, tb, act)
    out.backward(_torch(g, dtype, grad=False))
    tol = 2e-4 if dtype == "float32" else 2e-2
    _close(out, out_ref, tol)
    _close(tb.grad, db_ref, tol)
    for got, want in ((tx.grad, dx_ref), (tw.grad, dw_ref)):
        if dtype == "float32":
            _close(got, want, tol)
        else:
            scale = float(np.abs(_np(want)).max())
            np.testing.assert_allclose(_np(got), _np(want),
                                       atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_cross_entropy_matches_pallas_vjp(dtype):
    rng = np.random.default_rng(60)
    rows, V = 29, 1000
    logits = rng.standard_normal((rows, V), np.float32) * 3
    labels = rng.integers(0, V, rows).astype(np.int64)
    labels[[2, 7, 19]] = -1
    g = rng.uniform(0.1, 2.0, rows).astype(np.float32)
    jl = _jax(logits, dtype)
    loss_ref, vjp = jax.vjp(
        lambda a: pk.fused_softmax_cross_entropy(
            a, jnp.asarray(labels.astype(np.int32))), jl)
    (dl_ref,) = vjp(jnp.asarray(g))
    tl = _torch(logits, dtype)
    loss = tops.fused_softmax_cross_entropy(tl, torch.from_numpy(labels))
    loss.backward(torch.from_numpy(g))
    assert loss.dtype == torch.float32 and tl.grad.dtype == _TORCH[dtype]
    _close(loss, loss_ref, 1e-5)
    assert float(loss[2].detach()) == 0.0
    assert float(tl.grad[7].abs().sum()) == 0.0
    _close(tl.grad, dl_ref, 1e-5 if dtype == "float32" else 2e-2)


def test_softmax_cross_entropy_label_past_the_vocab_picks_nothing():
    """A label >= V picks no logit: its loss is the row's lse, as in the
    reference for labels past its padded vocab (V rounded up to 128 for
    V = 50; below that the reference picks its own -1e30 padding)."""
    rng = np.random.default_rng(61)
    logits = rng.standard_normal((3, 50), np.float32)
    labels = np.array([4, 128, 500], np.int64)
    want = pk.fused_softmax_cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(labels.astype(np.int32)))
    loss, lse = tops.softmax_xent_fwd(torch.from_numpy(logits),
                                      torch.from_numpy(labels))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(loss.numpy()[1:], lse.numpy()[1:])


def test_backward_wrappers_count_no_cpu_launches():
    before = {k: f.launches for k, f in tops.KERNELS.items()}
    x = torch.randn(4, 8, requires_grad=True)
    tops.layer_norm(x, torch.ones(8), torch.zeros(8)).sum().backward()
    tops.linear_act(x, torch.ones(8, 3), torch.zeros(3),
                    "silu").sum().backward()
    tops.fused_softmax_cross_entropy(
        x, torch.tensor([1, -1, 3, 7])).sum().backward()
    assert {k: f.launches for k, f in tops.KERNELS.items()} == before
    with pytest.raises(RuntimeError):
        tops.fused_layer_norm_bwd(*(torch.zeros(2, 4, device="meta"),
                                    torch.ones(4, device="meta"),
                                    torch.zeros(2), torch.ones(2),
                                    torch.zeros(2, 4, device="meta")))
    with pytest.raises(RuntimeError):
        tops.softmax_xent_fwd(torch.zeros(2, 4, device="meta"),
                              torch.zeros(2, dtype=torch.int64))
