"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (sm_90a, the kernels are built for
Hopper) and ``nvcc``; without a CUDA device each one skips.  The file
imports torch and the port only, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

Small shapes with ragged edges (rows not a multiple of a block, vocab
50304 and odd vocabularies, all activations; RMS norm also at the LLaMA
paths' shapes and on a misaligned view); the main path's shapes are
covered by ``chip_smoke.py``.  Tolerances: f32 1e-4 abs + rel (sums
in another order), bf16 2e-2 abs + rel (about two bf16 ulps at unit
scale); column sums (dgamma, dbeta, db) f32 1e-4·sqrt(rows) abs, bf16
2e-2; cross-entropy loss and lse (f32 whatever the logits' type) 1e-4
abs + 1e-5 rel; flash attention's lse 1e-4 abs + 1e-5 rel, and its
output and gradients as any other value: in f32 both versions compute
in f32 on the same values and round once; in bf16 the kernels run their
products on the tensor cores with f32 sums and round P and dS to bf16
before the second product (one bf16 rounding, 2^-9 relative, per term,
which averages out over the sum), so they stay within the same gate of
about two bf16 ulps at unit scale.  bf16
ragged attention is also held to the plain version run in f32, which
keeps the probabilities in f32 as the kernel does, within one bf16 ulp
(rtol 2^-7) plus 2^-8 of the output's RMS.  The int8 kernels (int8
weights of the matmul epilogue, int8 KV pools of ragged attention) are
held to their plain versions with the same tolerances, on shapes off the
16-byte grid and off the tile, with an all-zero weight channel and with
a scale per pool slot.  The fused residual layer norm is held to its
plain version forward (out, s, mu, rstd) and backward (the layer-norm
backward kernel on the saved s) at odd row counts; flash attention also
at heads of 160 and 256 (the widest the reference routes to its kernel),
of 40 and 96 (zero-filled columns of the 64 and 128 instantiations) and
of 129 (misaligned rows: the element-wise staging), on the views
``qkv.unbind(2)`` gives at S = 1024 (many key tiles through the double
buffer), and at BERT-base's non-causal shape; its backward is
bit-identical from run to run, and the tensor-core fragments of
``csrc/mma.cuh`` are held exactly to ``torch.mm`` on their own.  The grouped-expert matmul's
forward (both weight layouts) and dw kernels are held to their plain
versions at block rows 8, 16 and 128 with empty experts and an all-null
buffer (exact zeros there), dw as a column sum.  The LoRA SGMV epilogue
is held to its plain version (out and the saved sum) over blocks mixing
adapters, null blocks (which give act(z), and s = z exactly) and an
adapter with no block, at N off the 64-column tile and at ranks 8-64;
its autograd function (the grouped kernels on the adapter stacks, read
transposed, with N = r = 16 under the tile) against the same function on
the CPU.  Paged decode attention is held to its plain version with a
context-0 row, padded table entries and contexts off the page, at head
dims 64-256 and pages of 8-32; outside its domain (head_dim 257, pages
of 12, fp16) and on a CPU table it raises.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops.matmul_epilogue import act_f32

pytestmark = pytest.mark.cuda

_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
_DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, dtype):
    tol = _TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", _DTYPES)
def test_layer_norm_kernel(gen, dtype):
    x = (3 * torch.randn(37, 300, device="cuda", generator=gen) + 1).to(dtype)
    g = torch.randn(300, device="cuda", generator=gen).to(dtype)
    b = torch.randn(300, device="cuda", generator=gen).to(dtype)
    n0 = ops.fused_layer_norm.launches
    out, mu, rstd = ops.fused_layer_norm(x, g, b)
    want, mu_ref, rstd_ref = ops.layer_norm_ref(x, g, b)
    assert ops.fused_layer_norm.launches == n0 + 1
    _close(out, want, dtype)
    _close(mu, mu_ref, torch.float32)
    _close(rstd, rstd_ref, torch.float32)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("act", ops.ACTIVATIONS)
def test_matmul_epilogue_kernel(gen, dtype, act):
    x = torch.randn(70, 200, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(200, 130, device="cuda", generator=gen) / 14).to(dtype)
    b = torch.randn(130, device="cuda", generator=gen).to(dtype)
    out, z = ops.fused_linear_act(x, w, b, act, return_z=True)
    want, z_ref = ops.linear_act_ref(x, w, b, act, return_z=True)
    _close(out, want, dtype)
    _close(z, z_ref, dtype)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("M,K,N", [(33, 1000, 70), (4, 2048, 520),
                                   (88, 8192, 130)])
def test_matmul_epilogue_split_k_kernel(gen, dtype, M, K, N):
    """Few output tiles over a long K: the forward sums K in chunks
    (split-K, 8, 6 and 12 of them on 132 SMs, the last chunk ragged) and
    adds them in a second pass that applies the epilogue."""
    from paddle_tpu_torch.ops.matmul_epilogue import split_k
    assert split_k(M, K, N, torch.cuda.get_device_properties(
        0).multi_processor_count) > 1
    x = torch.randn(M, K, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(K, N, device="cuda", generator=gen) / K ** 0.5).to(dtype)
    b = torch.randn(N, device="cuda", generator=gen).to(dtype)
    out, z = ops.fused_linear_act(x, w, b, "gelu_tanh", return_z=True)
    want, z_ref = ops.linear_act_ref(x, w, b, "gelu_tanh", return_z=True)
    _close(out, want, dtype)
    _close(z, z_ref, dtype)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("qlens,ctxs,pad", [
    ([1, 1, 1], [60, 17, 5], 0),
    ([20], [20], 0),
    ([12, 1, 1], [30, 25, 9], 1),
    ([1, 0], [25, 0], 2),
])
def test_ragged_attention_kernel(gen, dtype, qlens, ctxs, pad):
    H, D, bs, W = 4, 64, 16, 4
    block_q = ops.ragged_q_block(dtype)
    S = len(qlens)
    nqb = len(ops.ragged_segments(qlens, ctxs, block_q)[0]) + pad
    sid, qs, qv, _, _ = ops.ragged_segments(qlens, ctxs, block_q,
                                            num_q_blocks=nqb, num_seqs=S)
    tables = np.zeros((S, W), np.int32)
    for s, c in enumerate(ctxs):
        tables[s, :-(-c // bs)] = 1 + s * W + np.arange(-(-c // bs))
    nb = S * W + 1
    q = torch.randn(nqb * block_q, H, D, device="cuda",
                    generator=gen).to(dtype)
    k = torch.randn(nb, H, bs, D, device="cuda", generator=gen).to(dtype)
    v = torch.randn(nb, H, bs, D, device="cuda", generator=gen).to(dtype)
    ints = [torch.from_numpy(a).cuda() for a in
            (tables, np.asarray(ctxs, np.int32), sid, qs, qv)]
    out = ops.ragged_paged_attention(q, k, v, *ints, block_q=block_q)
    want = ops.ragged_attention_ref(q, k, v, *ints, block_q=block_q)
    _close(out, want, dtype)
    if dtype == torch.bfloat16:
        # the plain version in f32 on the same values keeps the
        # probabilities in f32 as the kernel does: one bf16 ulp of the
        # output, plus 2^-8 of its RMS for values near zero
        want32 = ops.ragged_attention_ref(q.float(), k.float(), v.float(),
                                          *ints, block_q=block_q)
        rms = float(want32.pow(2).mean().sqrt())
        torch.testing.assert_close(out.float(), want32, atol=2 ** -8 * rms,
                                   rtol=2 ** -7)
    if pad:
        assert float(out[-pad * block_q:].abs().sum()) == 0.0


def _sum_tol(dtype, rows):
    """Tolerance of a column sum over ``rows`` rows taken in another
    order: f32 1e-4 per sqrt(rows) of accumulated rounding; bf16 one
    rounding of the result (2e-2)."""
    return 1e-4 * rows ** 0.5 if dtype == torch.float32 else 2e-2


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("rows,n", [(37, 300), (1030, 2048), (3, 7000)])
def test_layer_norm_bwd_kernel(gen, dtype, rows, n):
    x = (2 * torch.randn(rows, n, device="cuda", generator=gen) + 1).to(dtype)
    g = (1 + 0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    b = torch.randn(n, device="cuda", generator=gen).to(dtype)
    do = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
    _, mu, rstd = ops.fused_layer_norm(x, g, b)
    n0 = ops.fused_layer_norm_bwd.launches
    dx, dg, db = ops.fused_layer_norm_bwd(x, g, mu, rstd, do)
    want = ops.layer_norm_bwd_ref(x, g, mu, rstd, do)
    assert ops.fused_layer_norm_bwd.launches == n0 + 1
    _close(dx, want[0], dtype)
    tol = _sum_tol(dtype, rows)
    for got, ref in ((dg, want[1]), (db, want[2])):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=_TOL[dtype])


#: RMS norm: LLaMA-2 7B's decode step and prefill, the LLaMA training
#: drive's rows, and ragged widths (bf16 300 and 299 rows take one value
#: a load, the others 16 bytes)
_RMS_SHAPES = [(4, 4096), (512, 4096), (8192, 1024), (37, 300), (5, 299)]


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("rows,n", _RMS_SHAPES)
def test_rms_norm_kernels(gen, dtype, rows, n):
    x = (2 * torch.randn(rows, n, device="cuda", generator=gen) + 1).to(dtype)
    g = (1 + 0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    do = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
    n0 = (ops.fused_rms_norm.launches, ops.fused_rms_norm_bwd.launches)
    out, rstd = ops.fused_rms_norm(x, g)
    want, rstd_ref = ops.rms_norm_ref(x, g)
    _close(out, want, dtype)
    _close(rstd, rstd_ref, torch.float32)
    dx, dg = ops.fused_rms_norm_bwd(x, g, rstd_ref, do)
    dx_ref, dg_ref = ops.rms_norm_bwd_ref(x, g, rstd_ref, do)
    assert (ops.fused_rms_norm.launches,
            ops.fused_rms_norm_bwd.launches) == (n0[0] + 1, n0[1] + 1)
    _close(dx, dx_ref, dtype)
    assert dg.dtype == dtype
    torch.testing.assert_close(dg.float(), dg_ref.float(),
                               atol=_sum_tol(dtype, rows), rtol=_TOL[dtype])


@pytest.mark.parametrize("dtype", _DTYPES)
def test_rms_norm_autograd_on_a_misaligned_view(gen, dtype):
    """x starting one value past a 16-byte boundary takes the one-value
    path; the differentiable entry point runs both kernels."""
    rows, n = 33, 512
    base = torch.randn(rows * n + 1, device="cuda", generator=gen).to(dtype)
    x = base[1:].view(rows, n).requires_grad_()
    g = (1 + 0.1 * torch.randn(n, device="cuda", generator=gen)).to(
        dtype).requires_grad_()
    do = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
    out = ops.rms_norm(x, g)
    out.backward(do)
    want, rstd = ops.rms_norm_ref(x.detach(), g.detach())
    dx, dg = ops.rms_norm_bwd_ref(x.detach(), g.detach(), rstd, do)
    _close(out, want, dtype)
    _close(x.grad, dx, dtype)
    torch.testing.assert_close(g.grad.float(), dg.float(),
                               atol=_sum_tol(dtype, rows), rtol=_TOL[dtype])


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("act", ops.ACTIVATIONS)
def test_matmul_epilogue_bwd_kernel(gen, dtype, act):
    M, N = 70, 130
    z = (2 * torch.randn(M, N, device="cuda", generator=gen)).to(dtype)
    g = torch.randn(M, N, device="cuda", generator=gen).to(dtype)
    dz, db = ops.fused_linear_act_bwd(z, g, act)
    dz_ref, db_ref = ops.linear_act_bwd_ref(z, g, act)
    _close(dz, dz_ref, dtype)
    torch.testing.assert_close(db.float(), db_ref.float(),
                               atol=_sum_tol(dtype, M), rtol=_TOL[dtype])


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("rows,V", [(33, 50304), (70, 1001), (5, 37)])
def test_softmax_xent_kernels(gen, dtype, rows, V):
    x = (3 * torch.randn(rows, V, device="cuda", generator=gen)).to(dtype)
    labels = torch.randint(0, V, (rows,), device="cuda", generator=gen)
    labels[::4] = -1                        # ignored rows
    labels[1] = V + 3                       # past the vocab: picks nothing
    loss, lse = ops.softmax_xent_fwd(x, labels)
    loss_ref, lse_ref = ops.softmax_xent_fwd_ref(x, labels)
    torch.testing.assert_close(loss, loss_ref, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    assert float(loss[0]) == 0.0
    g = torch.rand(rows, device="cuda", generator=gen) + 0.5
    dx = ops.softmax_xent_bwd(x, labels, lse, g)
    dx_ref = ops.softmax_xent_bwd_ref(x, labels, lse, g)
    _close(dx, dx_ref, dtype)
    assert float(dx[0].float().abs().sum()) == 0.0


def test_wrappers_refuse_bad_inputs(gen):
    x = torch.randn(4, 8, device="cuda", generator=gen)
    with pytest.raises(TypeError):
        ops.fused_layer_norm(x.half(), torch.ones(8, device="cuda").half(),
                             torch.zeros(8, device="cuda").half())
    with pytest.raises(ValueError):
        ops.fused_layer_norm(x, torch.ones(8), torch.zeros(8))  # on the CPU
    with pytest.raises(ValueError):
        ops.fused_linear_act(x.t(), torch.ones(4, 3, device="cuda"),
                             torch.zeros(3, device="cuda"))  # not contiguous
    with pytest.raises(ValueError):
        ops.softmax_xent_fwd(x, torch.zeros(4, dtype=torch.int32,
                                            device="cuda"))  # not int64
    with pytest.raises(ValueError):
        ops.fused_linear_act_bwd(x, x.t().contiguous(), "relu")  # shape
    with pytest.raises(ValueError):
        ops.fused_rms_norm(x, torch.ones(8, device="cuda").to(
            torch.bfloat16))                                   # gamma type
    with pytest.raises(ValueError):
        ops.fused_rms_norm_bwd(x, torch.ones(8, device="cuda"),
                               torch.ones(3, device="cuda"), x)  # rstd rows


#: (B, Sq, Sk, causal, view): view takes q, k, v as the views
#: ``qkv.unbind(2)`` gives (strided rows, one allocation), else separate
#: tensors
_FLASH_CASES = [(2, 100, 100, True, False), (2, 100, 100, False, False),
                (3, 1, 300, True, False), (1, 70, 30, True, False),
                (1, 33, 150, False, False), (2, 1024, 1024, True, True),
                (2, 70, 70, False, True)]


def _flash_inputs(gen, dtype, B, Sq, Sk, H, D, view):
    if view:
        qkv = torch.randn(B, Sq, 3, H, D, device="cuda",
                          generator=gen).to(dtype)
        q, k, v = qkv.unbind(2)
    else:
        q, k, v = (torch.randn(B, s, H, D, device="cuda",
                               generator=gen).to(dtype)
                   for s in (Sq, Sk, Sk))
    g = torch.randn(B, Sq, H, D, device="cuda", generator=gen).to(dtype)
    return q, k, v, g


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("D", [64, 128, 160, 256, 40, 96, 129])
@pytest.mark.parametrize("B,Sq,Sk,causal,view", _FLASH_CASES)
def test_flash_attention_kernels(gen, dtype, D, B, Sq, Sk, causal, view):
    H = 3
    q, k, v, g = _flash_inputs(gen, dtype, B, Sq, Sk, H, D, view)
    n0 = [ops.KERNELS[n].launches for n in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")]
    out, lse = ops.fused_flash_attention_fwd(q, k, v, causal)
    want, lse_ref = ops.flash_attention_ref(q, k, v, causal)
    _close(out, want, dtype)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    lse_s, delta = ops.flash_bwd_stats(want, g, lse_ref)
    args = (q, k, v, g, lse_s, delta, causal)
    dq = ops.fused_flash_attention_bwd_dq(*args)
    dk, dv = ops.fused_flash_attention_bwd_dkv(*args)
    for got, ref in zip((dq, dk, dv), ops.flash_attention_bwd_ref(*args)):
        assert got.dtype == dtype
        _close(got, ref, dtype)
    if Sq > Sk and causal:        # rows that see no key: exact zeros
        empty = Sq - Sk
        assert float(out[:, :empty].abs().max()) == 0.0
        assert float(dq[:, :empty].abs().max()) == 0.0
        assert bool((lse[..., :empty] == -1e30).all())
    assert [ops.KERNELS[n].launches for n in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")] == [c + 1 for c in n0]


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("D", [128, 129])
def test_flash_attention_backward_is_deterministic(gen, dtype, D):
    """dq, dk and dv sum over tiles in a fixed order with no atomics: two
    runs on the same inputs are bit-identical (causal, S = 1024, the
    views ``qkv.unbind(2)`` gives)."""
    q, k, v, g = _flash_inputs(gen, dtype, 2, 1024, 1024, 4, D, True)
    out, lse = ops.fused_flash_attention_fwd(q, k, v, True)
    lse_s, delta = ops.flash_bwd_stats(out, g, lse)
    args = (q, k, v, g, lse_s, delta, True)
    first = (ops.fused_flash_attention_bwd_dq(*args),
             *ops.fused_flash_attention_bwd_dkv(*args))
    second = (ops.fused_flash_attention_bwd_dq(*args),
              *ops.fused_flash_attention_bwd_dkv(*args))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_mma_fragments_match_torch_mm(gen):
    """`csrc/mma.cuh` on its own: one warp multiplies 16 x 16 bf16 tiles
    staged swizzled, through ldmatrix.trans ([depth][col], as V), through
    ldmatrix ([col][depth], as K) and with the product fed back as an A
    fragment in registers (as P); small integers keep every sum exact, so
    each result equals torch.mm in f32 bit for bit."""
    from paddle_tpu_torch.ops import cuda_lib
    a = torch.randint(-2, 3, (16, 16), device="cuda",
                      generator=gen).to(torch.bfloat16)
    b = torch.randint(-2, 3, (16, 16), device="cuda",
                      generator=gen).to(torch.bfloat16)
    c = torch.full((3, 16, 16), float("nan"), device="cuda")
    rc = cuda_lib.library().ptt_mma_check(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), a.device.index,
        cuda_lib.stream_handle(a.device))
    cuda_lib.check(rc, "mma_check")
    ab = torch.mm(a.float(), b.float())
    want = torch.stack([ab, ab, torch.mm(ab, b.float())])
    for i in range(3):
        assert torch.equal(c[i], want[i]), i


@pytest.mark.parametrize("dtype", _DTYPES)
def test_flash_attention_autograd_on_strided_views(gen, dtype):
    qkv = torch.randn(2, 90, 3, 4, 64, device="cuda",
                      generator=gen).to(dtype).requires_grad_()
    q, k, v = qkv.unbind(2)
    out = ops.flash_attention(q, k, v, causal=True)
    g = torch.randn_like(out)
    out.backward(g)
    ref = qkv.detach().clone().requires_grad_()
    rq, rk, rv = ref.unbind(2)
    want, lse = ops.flash_attention_ref(rq, rk, rv, True)
    lse_s, delta = ops.flash_bwd_stats(want, g, lse)
    grads = ops.flash_attention_bwd_ref(rq.detach(), rk.detach(), rv.detach(),
                                        g, lse_s, delta, True)
    _close(out, want, dtype)
    _close(qkv.grad, torch.stack(grads, dim=2), dtype)


def test_dense_flash_attention_raises_on_the_card(gen):
    # the functional routes to the flash kernels on the card (head_dim up
    # to 256, as the reference routes it), a head of 160 included (zero-
    # padded to the kernels' 256); the kernels refuse a head wider than
    # 256 and a type they are not built for, and there is no fallback
    from paddle_tpu_torch.nn import functional as F
    n0 = ops.fused_flash_attention_fwd.launches
    for d in (16, 160):
        q = torch.randn(1, 8, 2, d, device="cuda", generator=gen)
        out = F.scaled_dot_product_attention(q, q, q, is_causal=True)
        with F.sdp_kernel(enable_flash=False):
            want = F.scaled_dot_product_attention(q, q, q, is_causal=True)
        _close(out, want, torch.float32)
    assert ops.fused_flash_attention_fwd.launches == n0 + 2
    wide = torch.randn(1, 8, 2, 257, device="cuda", generator=gen)
    with pytest.raises(ValueError, match="head_dim"):
        ops.fused_flash_attention_fwd(wide, wide, wide, True)
    with pytest.raises(TypeError):
        ops.fused_flash_attention_fwd(q.half(), q.half(), q.half(), True)
    assert ops.fused_flash_attention_fwd.launches == n0 + 2


@pytest.mark.parametrize("dtype", _DTYPES)
def test_flash_attention_at_bert_shape(gen, dtype):
    """BERT-base's attention (12 heads of 64, S = 128, no mask, not
    causal) on the views ``qkv.unbind(2)`` gives, forward and backward
    through autograd, against the plain versions."""
    qkv = torch.randn(2, 128, 3, 12, 64, device="cuda",
                      generator=gen).to(dtype).requires_grad_()
    n0 = [ops.KERNELS[n].launches for n in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")]
    out = ops.flash_attention(*qkv.unbind(2), causal=False)
    g = torch.randn_like(out)
    out.backward(g)
    rq, rk, rv = qkv.detach().unbind(2)
    want, lse = ops.flash_attention_ref(rq, rk, rv, False)
    lse_s, delta = ops.flash_bwd_stats(want, g, lse)
    grads = ops.flash_attention_bwd_ref(rq, rk, rv, g, lse_s, delta, False)
    _close(out, want, dtype)
    _close(qkv.grad, torch.stack(grads, dim=2), dtype)
    assert [ops.KERNELS[n].launches for n in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")] == [c + 1 for c in n0]


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("rows,n", [(37, 768), (300, 768), (5, 300)])
def test_layer_norm_residual_kernel(gen, dtype, rows, n):
    """Row counts off any block, widths off the 256-thread stride: the
    forward's out, s, mu and rstd, and the gradients through autograd
    (the layer-norm backward kernel on the saved s) against the plain
    versions; x's and the residual's gradients are one tensor's values."""
    x = (2 * torch.randn(rows, n, device="cuda", generator=gen)
         + 0.5).to(dtype).requires_grad_()
    r = torch.randn(rows, n, device="cuda", generator=gen).to(
        dtype).requires_grad_()
    g = (1 + 0.1 * torch.randn(n, device="cuda", generator=gen)).to(
        dtype).requires_grad_()
    b = (0.1 * torch.randn(n, device="cuda", generator=gen)).to(
        dtype).requires_grad_()
    n0 = ops.fused_layer_norm_residual.launches, \
        ops.fused_layer_norm_bwd.launches
    got = ops.fused_layer_norm_residual(x.detach(), r.detach(), g.detach(),
                                        b.detach())
    want = ops.layer_norm_residual_ref(x.detach(), r.detach(), g.detach(),
                                       b.detach())
    for a, w, dt in zip(got, want, (dtype, dtype, torch.float32,
                                    torch.float32)):
        assert a.dtype == w.dtype == dt
        _close(a, w, dt)
    out = ops.layer_norm_residual(x, r, g, b)
    dout = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
    out.backward(dout)
    _, s, mu, rstd = want
    dx, dg, db = ops.layer_norm_bwd_ref(s, g.detach(), mu, rstd, dout)
    _close(x.grad, dx, dtype)
    assert torch.equal(x.grad, r.grad)
    for a, w in ((g.grad, dg), (b.grad, db)):
        torch.testing.assert_close(a.float(), w.float(),
                                   atol=_sum_tol(dtype, rows),
                                   rtol=_TOL[dtype])
    assert (ops.fused_layer_norm_residual.launches,
            ops.fused_layer_norm_bwd.launches) == (n0[0] + 2, n0[1] + 1)
    with pytest.raises(ValueError, match="residual"):
        ops.fused_layer_norm_residual(x.detach(), r.detach().double(),
                                      g.detach(), b.detach())


def _int8_weight(K, N, gen, dead=(0,)):
    """Per-channel int8 codes and f32 scales of a random [K, N] weight
    with all-zero columns ``dead`` (scale 1.0, as convert_to_int8 gives
    them)."""
    from paddle_tpu_torch.quantization import quantize_weight_int8
    w = torch.randn(K, N, device="cuda", generator=gen) / K ** 0.5
    w[:, list(dead)] = 0.0
    return quantize_weight_int8(w, axis=1)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("act", ops.ACTIVATIONS)
@pytest.mark.parametrize("M,K,N", [(70, 200, 130), (64, 256, 128),
                                   (5, 17, 9), (33, 1000, 70)])
def test_matmul_epilogue_int8_kernel(gen, dtype, act, M, K, N):
    """Off the 16-byte grid (N = 130, 9, 70: one code a load) and off the
    64x64 tile, and on both (64 x 256 x 128); split-K (33 x 1000 x 70);
    bias in x's type and f32."""
    x = torch.randn(M, K, device="cuda", generator=gen).to(dtype)
    w_q, scale = _int8_weight(K, N, gen)
    assert float(scale[0]) == 1.0
    for b in (torch.randn(N, device="cuda", generator=gen).to(dtype),
              torch.randn(N, device="cuda", generator=gen)):
        n0 = ops.fused_linear_act_int8.launches
        out = ops.fused_linear_act_int8(x, w_q, scale, b, act)
        want = ops.linear_act_int8_ref(x, w_q, scale, b, act)
        assert ops.fused_linear_act_int8.launches == n0 + 1
        assert out.dtype == dtype and out.shape == (M, N)
        _close(out, want, dtype)
        # the dead channel: act(b) in every row
        _close(out[:, 0], act_f32(b[0].float().expand(M), act), dtype)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("qlens,ctxs,pad,D", [
    ([1, 1, 1], [60, 17, 5], 0, 64),
    ([20], [20], 0, 64),
    ([12, 1, 1], [30, 25, 9], 1, 128),
    ([1, 0], [25, 0], 2, 64),
    ([3, 1], [40, 9], 0, 40),              # D off the 16-byte grid
])
def test_ragged_attention_int8_kernel(gen, dtype, qlens, ctxs, pad, D):
    from paddle_tpu_torch.inference.serving.attention import \
        _quantize_tokens
    H, bs, W = 4, 16, 4
    block_q = ops.ragged_q_block(dtype)
    S = len(qlens)
    nqb = len(ops.ragged_segments(qlens, ctxs, block_q)[0]) + pad
    sid, qs, qv, _, _ = ops.ragged_segments(qlens, ctxs, block_q,
                                            num_q_blocks=nqb, num_seqs=S)
    tables = np.zeros((S, W), np.int32)
    for s, c in enumerate(ctxs):
        tables[s, :-(-c // bs)] = 1 + s * W + np.arange(-(-c // bs))
    nb = S * W + 1
    q = torch.randn(nqb * block_q, H, D, device="cuda",
                    generator=gen).to(dtype)
    pools, scales = [], []
    for _ in range(2):
        # a different magnitude in every slot, so every slot's scale differs
        f = torch.randn(nb, bs, H, D, device="cuda", generator=gen) * (
            0.1 + 3 * torch.rand(nb, bs, 1, 1, device="cuda", generator=gen))
        codes, sc = _quantize_tokens(f.reshape(-1, H, D), 1)
        pools.append(codes.reshape(nb, bs, H, D).transpose(1, 2)
                     .contiguous())
        scales.append(sc.reshape(nb, bs, 1).contiguous())
    assert scales[0].unique().numel() == nb * bs
    ints = [torch.from_numpy(a).cuda() for a in
            (tables, np.asarray(ctxs, np.int32), sid, qs, qv)]
    n0 = (ops.ragged_paged_attention.launches,
          ops.ragged_paged_attention_int8.launches)
    out = ops.ragged_paged_attention(q, *pools, *ints, block_q=block_q,
                                     k_scales=scales[0], v_scales=scales[1])
    assert (ops.ragged_paged_attention.launches,
            ops.ragged_paged_attention_int8.launches) == (n0[0], n0[1] + 1)
    want = ops.ragged_attention_ref(q, *pools, *ints, block_q=block_q,
                                    k_scales=scales[0], v_scales=scales[1])
    _close(out, want, dtype)
    if dtype == torch.bfloat16:
        want32 = ops.ragged_attention_ref(q.float(), *pools, *ints,
                                          block_q=block_q,
                                          k_scales=scales[0],
                                          v_scales=scales[1])
        rms = float(want32.pow(2).mean().sqrt())
        torch.testing.assert_close(out.float(), want32, atol=2 ** -8 * rms,
                                   rtol=2 ** -7)
    if pad:
        assert float(out[-pad * block_q:].abs().sum()) == 0.0


def test_int8_wrappers_refuse_missing_scales(gen):
    block_q = ops.ragged_q_block(torch.float32)
    sid, qs, qv, _, _ = ops.ragged_segments([1], [9], block_q)
    ints = [torch.from_numpy(a).cuda() for a in
            (np.ones((1, 1), np.int32), np.asarray([9], np.int32), sid, qs,
             qv)]
    q = torch.randn(block_q, 2, 64, device="cuda", generator=gen)
    pool = torch.ones(2, 2, 16, 64, dtype=torch.int8, device="cuda")
    scales = torch.ones(2, 16, 1, device="cuda")
    n0 = ops.ragged_paged_attention_int8.launches
    with pytest.raises(ValueError, match="k_scales"):
        ops.ragged_paged_attention(q, pool, pool, *ints, block_q=block_q)
    with pytest.raises(ValueError, match="k_scales"):
        ops.ragged_paged_attention_int8(q, pool, pool, scales, None, *ints,
                                        block_q=block_q)
    with pytest.raises(ValueError, match="k_scales"):
        ops.ragged_paged_attention_int8(q, pool, pool, scales[:, :8],
                                        scales, *ints, block_q=block_q)
    w_q, scale = _int8_weight(64, 32, gen)
    b = torch.zeros(32, device="cuda")
    n1 = ops.fused_linear_act_int8.launches
    with pytest.raises(ValueError, match="scale"):
        ops.fused_linear_act_int8(q[:, 0], w_q, None, b)
    with pytest.raises(ValueError, match="scale"):
        ops.fused_linear_act_int8(q[:, 0], w_q, scale.to(torch.bfloat16), b)
    with pytest.raises(ValueError, match="int8"):
        ops.fused_linear_act_int8(q[:, 0], w_q.float(), scale, b)
    assert ops.ragged_paged_attention_int8.launches == n0
    assert ops.fused_linear_act_int8.launches == n1


def _grouped_buffer(counts, bm, K, gen, dtype):
    """x [R, K] with each expert's rows in its blocks (padding rows zero)
    for ``counts`` at block rows ``bm``, and the int32 block ids."""
    nb = ops.num_group_blocks(sum(counts), len(counts), bm)
    gid, offsets = ops.group_segments(torch.tensor(counts), bm, nb)
    x = torch.zeros(nb * bm, K, device="cuda")
    for e, c in enumerate(counts):
        o = int(offsets[e])
        x[o:o + c] = torch.randn(c, K, device="cuda", generator=gen)
    return x.to(dtype), gid.cuda()


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("act", ops.ACTIVATIONS)
@pytest.mark.parametrize("counts,bm", [([7, 0, 21, 4], 16), ([5, 0, 9, 3], 8),
                                       ([300, 0, 120, 60], 128),
                                       ([0, 0, 0, 0], 16)])
def test_grouped_matmul_kernel(gen, dtype, act, counts, bm):
    """Row tiles of 16 (bm = 16), 8 (bm = 8, f32 only: bf16 blocks are
    16-row multiples), 64 (bm = 128); an empty buffer of null blocks
    only; ragged K (200) and N (130).  Both weight layouts: [E, K, N] and
    the backward's transposed read of [E, N, K]."""
    if dtype == torch.bfloat16 and bm % 16:
        bm = 16
    K, N, E = 200, 130, len(counts)
    x, gid = _grouped_buffer(counts, bm, K, gen, dtype)
    w = (torch.randn(E, K, N, device="cuda", generator=gen) / 14).to(dtype)
    b = torch.randn(E, N, device="cuda", generator=gen).to(dtype)
    n0 = ops.fused_grouped_linear_act.launches
    out, z = ops.fused_grouped_linear_act(x, w, b, gid, act, return_z=True)
    assert ops.fused_grouped_linear_act.launches == n0 + 1
    want = ops.grouped_linear_act_ref(x, w, b, block_group=gid, act=act)
    z_ref = ops.grouped_linear_act_ref(x, w, b, block_group=gid)
    _close(out, want, dtype)
    _close(z, z_ref, dtype)
    null = (gid == E).repeat_interleave(bm)
    assert not out[null].any() and not z[null].any()
    wt = w.transpose(1, 2).contiguous()          # [E, N, K]
    y = torch.randn(x.shape[0], N, device="cuda", generator=gen).to(dtype)
    dx = ops.fused_grouped_linear_act(y, w, None, gid, transpose_w=True)
    _close(dx, ops.grouped_linear_act_ref(y, wt, None, block_group=gid),
           dtype)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("counts,bm", [([7, 0, 21, 4], 16), ([5, 0, 9, 3], 8),
                                       ([300, 0, 120, 60], 128),
                                       ([0, 0, 0, 0], 16)])
def test_grouped_dw_kernel(gen, dtype, counts, bm):
    """dw[e] against the plain per-block sum, at K = 200, N = 130 (ragged
    64-wide tiles); an expert with no block (and an all-null buffer)
    gives exact zeros.  Sums over up to 300 rows: the column-sum bound of
    the other backward kernels."""
    if dtype == torch.bfloat16 and bm % 16:
        bm = 16
    K, N, E = 200, 130, len(counts)
    x, gid = _grouped_buffer(counts, bm, K, gen, dtype)
    dz = torch.randn(x.shape[0], N, device="cuda", generator=gen).to(dtype)
    n0 = ops.fused_grouped_dw.launches
    dw = ops.fused_grouped_dw(x, dz, gid, E)
    assert ops.fused_grouped_dw.launches == n0 + 1
    want = ops.grouped_dw_ref(x, dz, gid, E)
    torch.testing.assert_close(dw.float(), want.float(),
                               atol=_sum_tol(dtype, max(counts) or 1),
                               rtol=_TOL[dtype])
    for e, c in enumerate(counts):
        if c == 0:
            assert not dw[e].any()


@pytest.mark.parametrize("dtype", _DTYPES)
def test_grouped_linear_act_gradients_on_the_card(gen, dtype):
    """The autograd function on the card (forward kernel; dx through the
    forward kernel on the transposed weights, dw through the dw kernel,
    dz and db in plain torch) against the same function on the CPU."""
    counts, bm = [37, 0, 80, 11], 32
    K, N, E = 96, 160, 4
    x, gid = _grouped_buffer(counts, bm, K, gen, dtype)
    w = (torch.randn(E, K, N, device="cuda", generator=gen) / 10).to(dtype)
    b = torch.randn(E, N, device="cuda", generator=gen).to(dtype)
    g = torch.randn(x.shape[0], N, device="cuda", generator=gen).to(dtype)
    grads = {}
    for dev in ("cuda", "cpu"):
        xs, ws, bs = (t.detach().to(dev).requires_grad_()
                      for t in (x, w, b))
        out = ops.grouped_linear_act(xs, ws, bs, block_group=gid.to(dev),
                                     act="gelu_tanh")
        out.backward(g.to(dev))
        grads[dev] = [t.detach().cpu() for t in (out, xs.grad, ws.grad,
                                                 bs.grad)]
    for name, got, want in zip(("out", "dx", "dw", "db"), grads["cuda"],
                               grads["cpu"]):
        tol = _TOL[dtype] * (10 if name in ("dw", "db") else 1)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=_TOL[dtype],
                                   msg=lambda m, name=name: f"{name}: {m}")
    assert not grads["cuda"][2][1].any() and not grads["cuda"][3][1].any()


# ---------------------------------------------------------------------
# the LoRA SGMV epilogue
# ---------------------------------------------------------------------
def _lora_case(gen, dtype, K, N, r, aid, bm, L=4):
    R = len(aid) * bm
    z = torch.randn(R, N, device="cuda", generator=gen).to(dtype)
    x = torch.randn(R, K, device="cuda", generator=gen).to(dtype)
    a = (torch.randn(L, K, r, device="cuda", generator=gen) / 5).to(dtype)
    b = (torch.randn(L, r, N, device="cuda", generator=gen) / 5).to(dtype)
    return z, x, a, b, torch.tensor(aid, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("act", ops.ACTIVATIONS)
@pytest.mark.parametrize("K,N,r", [(200, 130, 16), (1024, 3072, 16),
                                   (64, 16, 8), (96, 70, 64)])
def test_lora_sgmv_kernel(gen, dtype, act, K, N, r):
    """Blocks [0, null, 2, 2, null, 0, 3]: adapter 1 owns none.  Ragged
    K and N off the 64-column tile; r = 64 at block rows 16 fills the
    kernel's 1024 low-rank entries from 256 threads."""
    bm = 16 if dtype == torch.bfloat16 else 8
    aid = [0, 4, 2, 2, 4, 0, 3]
    z, x, a, b, gid = _lora_case(gen, dtype, K, N, r, aid, bm)
    n0 = ops.fused_lora_segment_epilogue.launches
    out, s = ops.fused_lora_segment_epilogue(z, x, a, b, gid, act)
    assert ops.fused_lora_segment_epilogue.launches == n0 + 1
    want, s_ref = ops.lora.fused_lora_segment_epilogue(
        z.cpu(), x.cpu(), a.cpu(), b.cpu(), gid.cpu(), act)
    _close(out.cpu(), want, dtype)
    _close(s.cpu(), s_ref, dtype)
    null = (gid == 4).repeat_interleave(bm)
    assert torch.equal(s[null], z[null])
    _close(out[null], act_f32(z[null].float(), act).to(dtype), dtype)


@pytest.mark.parametrize("dtype", _DTYPES)
def test_lora_segment_gradients_on_the_card(gen, dtype):
    """The autograd function on the card (the SGMV kernel forward; u, dx
    and t through the grouped forward kernel on the adapter stacks, dA
    and dB through the grouped dw kernel after the sort by adapter)
    against the same function on the CPU.  r = N = 16 puts the
    transposed products' output under the 64-column tile."""
    bm = 16 if dtype == torch.bfloat16 else 8
    aid = [3, 0, 4, 3, 3, 0, 4, 2]
    z, x, a, b, gid = _lora_case(gen, dtype, 48, 16, 16, aid, bm)
    g = torch.randn(z.shape, device="cuda", generator=gen).to(dtype)
    n_fwd = ops.fused_grouped_linear_act.launches
    n_dw = ops.fused_grouped_dw.launches
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in (z, x, a, b)]
        out = ops.lora_segment_epilogue(*leaves, block_adapter=gid.to(dev),
                                        act="gelu_tanh")
        out.backward(g.to(dev))
        grads[dev] = [out.detach().cpu()] + [t.grad.cpu() for t in leaves]
    assert ops.fused_grouped_linear_act.launches == n_fwd + 3
    assert ops.fused_grouped_dw.launches == n_dw + 2
    for name, got, want in zip(("out", "dz", "dx", "dA", "dB"),
                               grads["cuda"], grads["cpu"]):
        tol = _TOL[dtype] * (10 if name in ("dA", "dB") else 1)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=_TOL[dtype], msg=name)
    assert not grads["cuda"][3][1].any() and not grads["cuda"][4][1].any()


def test_lora_wrapper_refuses_bad_inputs(gen):
    z, x, a, b, gid = _lora_case(gen, torch.float32, 32, 40, 8, [0, 4], 8)
    with pytest.raises(ValueError, match="int32"):
        ops.fused_lora_segment_epilogue(z, x, a, b, gid.long())
    with pytest.raises(ValueError, match="is torch.bfloat16"):
        ops.fused_lora_segment_epilogue(z, x, a.bfloat16(), b, gid)
    h = _lora_case(gen, torch.float16, 32, 40, 16, [0, 4], 16)
    with pytest.raises(TypeError):
        ops.fused_lora_segment_epilogue(*h)
    with pytest.raises(ValueError, match="on cpu"):
        ops.fused_lora_segment_epilogue(z, x, a.cpu(), b, gid)
    with pytest.raises(ValueError, match="exceeds"):
        big_a = torch.zeros(4, 32, 512, device="cuda")
        ops.fused_lora_segment_epilogue(z, x, big_a,
                                        torch.zeros(4, 512, 40,
                                                    device="cuda"), gid)


# ---------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------
def _paged_case(gen, dtype, B, H, D, bs, ctxs, W):
    nb = sum(-(-c // bs) for c in ctxs) + 3      # 0 and two never read
    q = torch.randn(B, 1, H, D, device="cuda", generator=gen).to(dtype)
    k = torch.randn(nb, H, bs, D, device="cuda", generator=gen).to(dtype)
    v = torch.randn(nb, H, bs, D, device="cuda", generator=gen).to(dtype)
    perm = torch.randperm(nb - 1, device="cuda", generator=gen) + 1
    tables = torch.zeros(B, W, dtype=torch.int32, device="cuda")
    used = 0
    for i, c in enumerate(ctxs):
        n = -(-c // bs)
        tables[i, :n] = perm[used:used + n]
        used += n
    ctx = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
    return q, k, v, tables, ctx


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("D,bs", [(128, 16), (64, 8), (256, 32), (80, 16)])
@pytest.mark.parametrize("ctxs", [[129, 0, 192, 150], [1, 7, 33]])
def test_paged_attention_kernel(gen, dtype, D, bs, ctxs):
    """Contexts off the page (and 0: zeros), padded table entries; bf16
    also against the plain version run in f32 (f32 probabilities, as the
    kernel keeps them) within one bf16 ulp plus 2^-8 of the RMS."""
    W = max(-(-c // bs) for c in ctxs) + 2
    q, k, v, tables, ctx = _paged_case(gen, dtype, len(ctxs), 4, D, bs,
                                       ctxs, W)
    n0 = ops.paged_attention.launches
    out = ops.paged_attention(q, k, v, tables, ctx)
    assert ops.paged_attention.launches == n0 + 1
    want = ops.paged_attention_ref(q, k, v, tables, ctx)
    _close(out, want, dtype)
    for i, c in enumerate(ctxs):
        if c == 0:
            assert not out[i].any()
    if dtype == torch.bfloat16:
        w32 = ops.paged_attention_ref(q.float(), k.float(), v.float(),
                                      tables, ctx)
        rms = float(w32.pow(2).mean().sqrt())
        diff = (out.float() - w32).abs()
        assert bool((diff <= 2.0 ** -8 * rms + 2.0 ** -7 * w32.abs()).all())
    scaled = ops.paged_attention(q, k, v, tables, ctx, scale=0.05)
    _close(scaled, ops.paged_attention_ref(q, k, v, tables, ctx, 0.05),
           dtype)


def test_paged_attention_refuses_outside_its_domain(gen):
    q, k, v, tables, ctx = _paged_case(gen, torch.float32, 2, 2, 64, 16,
                                       [20, 3], 3)
    n0 = ops.paged_attention.launches
    with pytest.raises(ValueError, match="head_dim 257"):
        q2, k2, v2, t2, c2 = _paged_case(gen, torch.float32, 2, 2, 257, 16,
                                         [20, 3], 3)
        ops.paged_attention(q2, k2, v2, t2, c2)
    with pytest.raises(ValueError, match="block_size 12"):
        q2, k2, v2, t2, c2 = _paged_case(gen, torch.float32, 2, 2, 64, 12,
                                         [20, 3], 3)
        ops.paged_attention(q2, k2, v2, t2, c2)
    with pytest.raises(TypeError):
        ops.paged_attention(q.half(), k.half(), v.half(), tables, ctx)
    with pytest.raises(ValueError, match="on cpu"):
        ops.paged_attention(q, k, v, tables.cpu(), ctx)
    with pytest.raises(ValueError, match="int32"):
        ops.paged_attention(q, k, v, tables.long(), ctx)
    with pytest.raises(ValueError, match="1 token"):
        ops.paged_attention(q.expand(2, 2, 2, 64).contiguous(), k, v,
                            tables, ctx)
    assert ops.paged_attention.launches == n0
