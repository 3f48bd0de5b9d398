"""The port's flash attention, held against the JAX package's Pallas
kernels.

``paddle_tpu_torch.ops.flash_attention`` on CPU tensors runs the plain
forward and, through its ``torch.autograd.Function``, the plain dq and
dk/dv backward: the functions the CUDA kernels are compared with on the
card.  They are held against ``paddle_tpu.ops.pallas_kernels``'s
``flash_attention`` (and its ``lse``), called directly in interpret mode
on the CPU as ``tests/test_pallas_kernels.py`` calls it, and its
gradients against ``jax.vjp`` of it, on the same inputs and the same
upstream gradient made from a seed with numpy.  Cases: causal and not,
S not a multiple of any tile, cross lengths (Sq=24, Sk=40), Sq > Sk
causal (rows with no visible key), Sq=1 decode, and heads of 256 and
160 (the widest the reference routes to its kernel, and one the card's
kernels zero-pad to 256).

Tolerances:
* f32: the output and lse within 2e-5 abs + rel (the reference's own
  kernel-vs-composite tolerance); each gradient within 1e-4 of its
  largest magnitude (sums over keys or queries in another order);
* bf16: both sides compute in f32 from the same bf16 inputs and round
  once to bf16, so an element may land one bf16 ulp apart (2^-8
  relative) where the f32 values straddle a rounding boundary: the
  output within 2^-7 abs + rel.  The gradients carry the same ulp
  through delta = rowsum(dout * out) (each side's bf16 output): each
  within 2^-6 of its largest magnitude;
* rows that see no key: output and dq exactly 0.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.nn import functional as F

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_OUT_TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}
_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}

#: (B, Sq, Sk, H, D, causal)
_CASES = {
    "causal_uneven": (2, 100, 100, 2, 64, True),
    "full_uneven": (1, 100, 100, 2, 64, False),
    "causal_160": (1, 160, 160, 2, 32, True),
    "cross_causal": (1, 24, 40, 2, 32, True),
    "cross_full": (2, 24, 40, 2, 32, False),
    "sq_gt_sk_causal": (1, 48, 16, 2, 32, True),
    "decode": (2, 1, 40, 2, 64, True),
    "causal_d256": (1, 70, 70, 2, 256, True),
    "full_d160": (1, 40, 40, 1, 160, False),
}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _inputs(B, Sq, Sk, H, D, seed=7):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D), np.float32)
    k = rng.standard_normal((B, Sk, H, D), np.float32)
    v = rng.standard_normal((B, Sk, H, D), np.float32)
    g = rng.standard_normal((B, Sq, H, D), np.float32)
    return q, k, v, g


def _reference_lse(jq, jk, jv, causal):
    """The Pallas forward's lse, ``[B, H, Sq]``, from its stat lanes."""
    B, Sq, H, D = jq.shape
    Sk = jk.shape[1]
    to_bh = lambda x, s: jnp.swapaxes(x, 1, 2).reshape(B * H, s, D)  # noqa
    _, res = pk._flash_attention_bhsd_fwd(to_bh(jq, Sq), to_bh(jk, Sk),
                                          to_bh(jv, Sk), 1.0 / D ** 0.5,
                                          causal)
    return np.asarray(res[4][:, :Sq, 0]).reshape(B, H, Sq)


def _run(case, dtype):
    B, Sq, Sk, H, D, causal = _CASES[case]
    q, k, v, g = _inputs(B, Sq, Sk, H, D)
    jq, jk, jv, jg = (jnp.asarray(a).astype(_JAX[dtype]) for a in (q, k, v, g))
    want, vjp = jax.vjp(lambda a, b, c: pk.flash_attention(
        a, b, c, causal=causal), jq, jk, jv)
    want_grads = vjp(jg)
    tq, tk, tv = (torch.from_numpy(a).to(_TORCH[dtype]).requires_grad_()
                  for a in (q, k, v))
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    got.backward(torch.from_numpy(g).to(_TORCH[dtype]))
    return (jq, jk, jv, causal), want, want_grads, (tq, tk, tv), got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(_CASES))
def test_flash_forward_and_grads_match_pallas(case, dtype):
    jargs, want, want_grads, (tq, tk, tv), got = _run(case, dtype)
    assert got.dtype == _TORCH[dtype] and got.shape == tq.shape
    tol = _OUT_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    for name, t, w in zip("qkv", (tq, tk, tv), want_grads):
        assert t.grad.dtype == _TORCH[dtype]
        scale = float(np.abs(_np(w)).max())
        np.testing.assert_allclose(_np(t.grad), _np(w),
                                   atol=_GRAD_TOL[dtype] * scale, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", list(_CASES))
def test_flash_lse_matches_pallas(case):
    B, Sq, Sk, H, D, causal = _CASES[case]
    q, k, v, _ = _inputs(B, Sq, Sk, H, D)
    want = _reference_lse(*(jnp.asarray(a) for a in (q, k, v)), causal)
    _, lse = tops.flash_attention_ref(*(torch.from_numpy(a)
                                        for a in (q, k, v)), causal)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    np.testing.assert_allclose(lse.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_without_keys_give_exact_zeros(dtype):
    # Sq=48 > Sk=16, causal: rows 0..31 see no key
    jargs, want, want_grads, (tq, tk, tv), got = _run("sq_gt_sk_causal",
                                                      dtype)
    assert float(got.detach()[:, :32].abs().max()) == 0.0
    assert float(tq.grad[:, :32].abs().max()) == 0.0
    assert float(tq.grad[:, 32:].abs().max()) > 0.0
    _, lse = tops.flash_attention_ref(tq.detach(), tk.detach(), tv.detach(),
                                      True)
    assert bool((lse[..., :32] == -1e30).all())
    lse_safe, _ = tops.flash_bwd_stats(got.detach(), got.detach(), lse)
    assert bool((lse_safe[..., :32] == 1e30).all())


def test_backward_wrappers_split_the_plain_backward():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(1, 24, 40, 2, 32))
    out, lse = tops.fused_flash_attention_fwd(q, k, v, True)
    lse, delta = tops.flash_bwd_stats(out, g, lse)
    dq, dk, dv = tops.flash_attention_bwd_ref(q, k, v, g, lse, delta, True)
    assert torch.equal(tops.fused_flash_attention_bwd_dq(
        q, k, v, g, lse, delta, True), dq)
    dk2, dv2 = tops.fused_flash_attention_bwd_dkv(q, k, v, g, lse, delta,
                                                  True)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)
    names = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    assert all(tops.KERNELS[n].launches == 0 for n in names), \
        "a CPU call is not a kernel launch"


def test_sdpa_routes_as_the_reference(monkeypatch):
    calls = []
    real = tops.flash_attention

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(tops, "flash_attention", spy)
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 20, 20, 2, 32))
    flash = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert len(calls) == 1
    with F.sdp_kernel(enable_flash=False):
        comp = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        assert len(calls) == 1
    # the composite and the flash path compute the same attention
    torch.testing.assert_close(comp, flash, atol=2e-5, rtol=2e-5)
    F.scaled_dot_product_attention(q, k, v, attn_mask=torch.zeros(20, 20))
    F.scaled_dot_product_attention(q.half(), k.half(), v.half())
    assert len(calls) == 1, "a mask or fp16 takes the composite"
    out, none = F.flash_attention(q, k, v, causal=True)
    assert none is None and torch.equal(out, flash) and len(calls) == 2
    # attention dropout in training takes the composite, as the
    # reference's does; in eval the rate is ignored and flash runs
    gen = torch.Generator().manual_seed(0)
    assert F.scaled_dot_product_attention(
        q, k, v, dropout_p=0.1, generator=gen).shape == q.shape
    assert len(calls) == 2
    assert F.scaled_dot_product_attention(
        q, k, v, dropout_p=0.1, training=False).shape == q.shape
    assert len(calls) == 3
    # head_dim and the reference's 8 MB K+V cap (head_dim padded to 128)
    assert F._use_flash(128, 8192, torch.float32)
    assert F._use_flash(256, 4096, torch.float32)
    assert not F._use_flash(257, 16, torch.float32)
    assert not F._use_flash(64, 8193, torch.float32)
    assert F._use_flash(64, 16384, torch.bfloat16)


def test_mask_composite_matches_reference():
    rf = importlib.import_module("paddle_tpu.nn.functional.flash_attention")
    q, k, v, _ = _inputs(1, 12, 12, 2, 32)
    bias = np.where(np.random.default_rng(3).random((12, 12)) < 0.3,
                    -1e30, 0.0).astype(np.float32)
    bias[4] = -1e30                          # a row with no visible key
    want = rf._sdpa_ref(*(jnp.asarray(a) for a in (q, k, v)),
                        jnp.asarray(bias), False, 1.0 / 32 ** 0.5)
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        attn_mask=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    assert float(got[:, 4].abs().max()) == 0.0


def test_entry_point_takes_strided_views():
    qkv = torch.randn(2, 30, 3, 2, 32, generator=torch.Generator()
                      .manual_seed(0))
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    got = tops.flash_attention(q, k, v, causal=True)
    want = tops.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True)
    assert torch.equal(got, want)
