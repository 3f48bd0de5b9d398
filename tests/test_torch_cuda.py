"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (sm_90a, the kernels are built for
Hopper) and ``nvcc``; without a CUDA device each one skips.  The file
imports torch and the port only, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

Small shapes with ragged edges (rows not a multiple of a block, vocab
50304 and odd vocabularies, all activations; RMS norm also at the LLaMA
paths' shapes, past the backward's register route (9000) and on a
misaligned view, each backward launch's route held to the Python rule,
the library's and the wrapper's counts, its block count to the
library's, 10 reruns bit-identical; layer norm forward and backward
at the drives' widths 768, 1024 and 2048, at 300, 7000 and 9000 and off
16 bytes, each launch's route held to the Python rule, the library's and
the wrapper's counts, a misaligned view on the scalar routes, 100 runs
of each bit-identical); the main path's shapes are covered by
``chip_smoke.py``.  Tolerances: f32 1e-4 abs + rel (sums
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
(rtol 2^-7) plus 2^-8 of the output's RMS; also at the serving drives'
steps (a mixed step and a decode-only step, 16 heads of 128 and of 64,
33-40 pages a sequence, bf16 and int8 pools) on the tensor-core route,
each small case's route read from the wrappers' counters (bf16 at D 64
or 128 on the tensor cores, D = 40 element by element, f32 its own) and
held to the Python and the library's rule, and the mixed step 100 times
bit-identical.  The int8 kernels (int8
weights of the matmul epilogue, int8 KV pools of ragged attention) are
held to their plain versions with the same tolerances, on shapes off the
16-byte grid and off the tile, with an all-zero weight channel and with
a scale per pool slot.  The fused residual layer norm is held to its
plain version forward (out, s, mu, rstd) and backward (the layer-norm
backward kernel on the saved s) at odd row counts, the BERT drive's
[8192, 768] and past its register route (9000), each forward launch's
route held to both rules and the counts, 10 reruns bit-identical;
flash attention also
at heads of 160 and 256 (the widest the reference routes to its kernel),
of 40 and 96 (zero-filled columns of the 64 and 128 instantiations) and
of 129 (misaligned rows: the element-wise staging), on the views
``qkv.unbind(2)`` gives at S = 1024 (many key tiles through the double
buffer), and at BERT-base's non-causal shape; its backward is
bit-identical from run to run, and the tensor-core fragments of
``csrc/mma.cuh`` are held exactly to ``torch.mm`` on their own, as is
``csrc/wgmma.cuh``'s TMA-fed, transpose-B ``wgmma`` product.  The bf16
matmul epilogue (``wgmma``) and its int8 twin are also held at the
GPT_1P3B paths' shapes (serving fc1, decode steps of 4 and 8 rows, the
training drive's 4096 rows with z; int8 qkv, out, fc1 and fc2), counted
by staging route (TMA, or element by element for rows off 16 bytes), and
100 repeats are bit-identical; tanh-GELU's negative tail (z in [-6, -1],
exact products) within two bf16 ulps of the plain version.  The grouped-expert matmul's
forward (both weight layouts) and dw kernels are held to their plain
versions at block rows 8, 16 and 128 with empty experts and an all-null
buffer (exact zeros there), dw as a column sum; the bf16 forward also
with row tiles spanning blocks of 16 (one id, unsorted alternating ids,
null blocks inside) at grids that pick each of its tiles, at N or K of
16 and 70, the dw with its rows split into slices (an expert of one
block, an empty one), and both rows 100 times bit-identical at the
f32 gradient test's layout and LoRA's dA shape.  The LoRA SGMV epilogue
is held to its plain version (out and the saved sum) over blocks mixing
adapters, null blocks (which give act(z), and s = z exactly) and an
adapter with no block, at N off the 64-column tile and at ranks 8-64,
each launch counted by route (the tensor-core route for bf16 with
16-byte rows), and at the serving and fine-tuning drives' shapes (100
runs bit-identical); with act "none" the wrapper returns s as out; its
autograd function (the grouped kernels on the adapter stacks, read
transposed, with N = r = 16 under the tile) against the same function on
the CPU.  Paged decode attention is held to its plain version with a
context-0 row, padded table entries and contexts off the page, at head
dims 64-256 and pages of 8-32; outside its domain (head_dim 257, pages
of 12, fp16) and on a CPU table it raises; at the drives' decode steps
(phase 25's and 4 x 4096 keys) on the vector route by the counters and
both rules, 100 runs bit-identical; a page of NaNs behind every padding
entry never reaching the output; a misaligned q on the element-wise
route.  The epilogue backward at the drives' fc1 shapes ([4096, 8192],
[8192, 8192], [8192, 4096], [8192, 3072], [8192, 768]) and every
activation on the vector route by the counters and both rules, N = 130
on the element-wise route, and 100 runs bit-identical.  The softmax
cross-entropy rows also at the vision drives' logits ([64, 10] and [32,
1000]), and one ResNet-18 Momentum step on the card against the CPU;
the vision ops of ``chip_smoke.py`` phase 34 (transposed convolutions,
norms, pooling masks and unpooling, the detection ops) and 3 Momentum
steps of SqueezeNet 1.1 and AlexNet, card against CPU.  ``jit.to_static``
on CUDA graphs: a replay of rows 2 and 3 bit-identical to eager calls,
launch counters after replays equal to eager calls', dropout masks that
follow the generator's seed and differ between replays, a host read
raising at capture (and the card usable after it), ``GradScaler`` and a
callable beta refused under capture, scheduled AdamW steps replayed bit
for bit with ``global_step``, a closure captured, and the engine's
captured tokens equal to its eager tokens.
"""
import copy

import numpy as np
import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops.matmul_epilogue import act_f32

pytestmark = pytest.mark.cuda

#: f16: 5e-3 abs + rel, about five f16 ulps at unit scale (the kernel and
#: the plain version each round one f32 result, summed in other orders)
_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 5e-3}
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


#: layer norm (rows 2 and 6): the drives' widths (BERT 768, LLaMA-sized
#: and multi-LoRA 1024, GPT 2048; 368 rows: the serving step's budget),
#: 300 (bf16 off 16 bytes), 7 (off 16 bytes in both), 7000 and 9000 (past
#: the register route: the scalar route)
_LN_SHAPES = [(37, 300), (5, 768), (1030, 1024), (368, 2048), (1030, 2048),
              (3, 7000), (9, 7), (2, 9000)]


def _ln_route(n, *tensors):
    """The route the Python rule gives, held equal to the library's rule
    and to the wrapper's count of the launch just made."""
    from paddle_tpu_torch.ops import cuda_lib
    from paddle_tpu_torch.ops.layer_norm import vector_route
    route = vector_route(n, *tensors)
    assert bool(cuda_lib.library().ptt_layer_norm_vector_route(
        *(t.data_ptr() for t in tensors), n, tensors[0].element_size())) \
        == route
    if n in (768, 1024, 2048):
        assert route, "a model width must take the vector route"
    return route


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("rows,n", _LN_SHAPES)
def test_layer_norm_kernel(gen, dtype, rows, n):
    x = (3 * torch.randn(rows, n, device="cuda", generator=gen)
         + 1).to(dtype)
    g = torch.randn(n, device="cuda", generator=gen).to(dtype)
    b = torch.randn(n, device="cuda", generator=gen).to(dtype)
    fn = ops.fused_layer_norm
    n0 = fn.launches, fn.vector_launches, fn.scalar_launches
    out, mu, rstd = ops.fused_layer_norm(x, g, b)
    want, mu_ref, rstd_ref = ops.layer_norm_ref(x, g, b)
    assert ops.fused_layer_norm.launches == n0[0] + 1
    vec = _ln_route(n, x, g, b, out)
    assert (fn.vector_launches, fn.scalar_launches) == \
        (n0[1] + vec, n0[2] + (not vec))
    _close(out, want, dtype)
    _close(mu, mu_ref, torch.float32)
    _close(rstd, rstd_ref, torch.float32)


@pytest.mark.parametrize("dtype", _DTYPES)
def test_layer_norm_misaligned_view(gen, dtype):
    """x one element past a 16-byte boundary at a model width: the scalar
    routes, forward and backward, still right."""
    buf = (2 * torch.randn(64 * 2048 + 1, device="cuda", generator=gen)
           + 1).to(dtype)
    x = buf[1:].view(64, 2048)
    assert x.data_ptr() % 16 != 0
    g = (1 + 0.1 * torch.randn(2048, device="cuda", generator=gen)).to(dtype)
    b = torch.randn(2048, device="cuda", generator=gen).to(dtype)
    do = torch.randn(64, 2048, device="cuda", generator=gen).to(dtype)
    s0 = ops.fused_layer_norm.scalar_launches, \
        ops.fused_layer_norm_bwd.scalar_launches
    out, mu, rstd = ops.fused_layer_norm(x, g, b)
    want, mu_ref, rstd_ref = ops.layer_norm_ref(x, g, b)
    _close(out, want, dtype)
    _close(rstd, rstd_ref, torch.float32)
    dx, dg, db = ops.fused_layer_norm_bwd(x, g, mu, rstd, do)
    ref = ops.layer_norm_bwd_ref(x, g, mu, rstd, do)
    _close(dx, ref[0], dtype)
    for got, r in ((dg, ref[1]), (db, ref[2])):
        torch.testing.assert_close(got.float(), r.float(),
                                   atol=_sum_tol(dtype, 64),
                                   rtol=_TOL[dtype])
    assert (ops.fused_layer_norm.scalar_launches,
            ops.fused_layer_norm_bwd.scalar_launches) == \
        (s0[0] + 1, s0[1] + 1)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("rows,n", [(368, 2048), (4096, 2048), (8192, 768)])
def test_layer_norm_kernels_repeat_bit_identical(gen, dtype, rows, n):
    """100 runs of the forward and of the backward (its dgamma/dbeta
    summed in two passes without atomics) equal the first bit for bit."""
    x = (2 * torch.randn(rows, n, device="cuda", generator=gen)
         + 0.5).to(dtype)
    g = (1 + 0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    b = torch.randn(n, device="cuda", generator=gen).to(dtype)
    do = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
    first = ops.fused_layer_norm(x, g, b)
    first_bwd = ops.fused_layer_norm_bwd(x, g, first[1], first[2], do)
    for _ in range(100):
        again = ops.fused_layer_norm(x, g, b)
        assert all(torch.equal(a, f) for a, f in zip(again, first))
        again = ops.fused_layer_norm_bwd(x, g, first[1], first[2], do)
        assert all(torch.equal(a, f) for a, f in zip(again, first_bwd))


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


#: ragged attention's small cases (query lengths, context lengths, null
#: q-blocks padded on): float pools at D = 64, and int8 pools at a D each
_RAGGED_CASES = [
    ([1, 1, 1], [60, 17, 5], 0),
    ([20], [20], 0),
    ([12, 1, 1], [30, 25, 9], 1),
    ([1, 0], [25, 0], 2),
]
_RAGGED_INT8_CASES = [
    ([1, 1, 1], [60, 17, 5], 0, 64),
    ([20], [20], 0, 64),
    ([12, 1, 1], [30, 25, 9], 1, 128),
    ([1, 0], [25, 0], 2, 64),
    ([3, 1], [40, 9], 0, 40),              # D off the 16-byte grid
]


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("qlens,ctxs,pad", _RAGGED_CASES)
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
    order: f32 1e-4 per sqrt(rows) of accumulated rounding; bf16 and f16
    one rounding of the result (their `_TOL`)."""
    return 1e-4 * rows ** 0.5 if dtype == torch.float32 else _TOL[dtype]


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("rows,n", _LN_SHAPES + [(8192, 768)])
def test_layer_norm_bwd_kernel(gen, dtype, rows, n):
    x = (2 * torch.randn(rows, n, device="cuda", generator=gen) + 1).to(dtype)
    g = (1 + 0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    b = torch.randn(n, device="cuda", generator=gen).to(dtype)
    do = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
    _, mu, rstd = ops.fused_layer_norm(x, g, b)
    fn = ops.fused_layer_norm_bwd
    n0 = fn.launches, fn.vector_launches, fn.scalar_launches
    dx, dg, db = ops.fused_layer_norm_bwd(x, g, mu, rstd, do)
    want = ops.layer_norm_bwd_ref(x, g, mu, rstd, do)
    assert ops.fused_layer_norm_bwd.launches == n0[0] + 1
    vec = _ln_route(n, x, g, do, dx)
    assert (fn.vector_launches, fn.scalar_launches) == \
        (n0[1] + vec, n0[2] + (not vec))
    _close(dx, want[0], dtype)
    tol = _sum_tol(dtype, rows)
    for got, ref in ((dg, want[1]), (db, want[2])):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=_TOL[dtype])


#: RMS norm: LLaMA-2 7B's decode step and prefill, the LLaMA training
#: drive's rows, and ragged widths (bf16 300 and 299 rows take one value
#: a load, the others 16 bytes; the backward's scalar route there and at
#: 9000, past its register route; 1030 rows of 1024 leave the vector
#: route's last row group partly empty)
_RMS_SHAPES = [(4, 4096), (512, 4096), (8192, 1024), (37, 300), (5, 299),
               (1030, 1024), (3, 9000)]


def _rms_route(rows, n, x, g, do, dx):
    """The backward's route by the Python rule, held equal to the library's
    rule, and its first pass's blocks to the library's count."""
    from paddle_tpu_torch.ops import cuda_lib
    from paddle_tpu_torch.ops.rms_norm import bwd_blocks, vector_route
    lib = cuda_lib.library()
    route = vector_route(n, x, g, do, dx)
    assert bool(lib.ptt_rms_norm_vector_route(
        x.data_ptr(), g.data_ptr(), do.data_ptr(), dx.data_ptr(), n,
        x.element_size())) == route
    assert bwd_blocks(rows, n, x.element_size(), route,
                      cuda_lib.sm_count(x.device.index)) == \
        lib.ptt_rms_norm_bwd_blocks(rows, n, x.element_size(), int(route),
                                    x.device.index)
    if n in (1024, 4096):
        assert route, "a model width must take the vector route"
    return route


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("rows,n", _RMS_SHAPES)
def test_rms_norm_kernels(gen, dtype, rows, n):
    """Forward and backward against the plain versions, the backward's
    launch counted under its route, and 10 reruns of the backward (dgamma
    summed in two passes without atomics) bit-identical."""
    x = (2 * torch.randn(rows, n, device="cuda", generator=gen) + 1).to(dtype)
    g = (1 + 0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    do = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
    fn = ops.fused_rms_norm_bwd
    n0 = (ops.fused_rms_norm.launches, fn.launches, fn.vector_launches,
          fn.scalar_launches)
    out, rstd = ops.fused_rms_norm(x, g)
    want, rstd_ref = ops.rms_norm_ref(x, g)
    _close(out, want, dtype)
    _close(rstd, rstd_ref, torch.float32)
    dx, dg = fn(x, g, rstd_ref, do)
    dx_ref, dg_ref = ops.rms_norm_bwd_ref(x, g, rstd_ref, do)
    assert (ops.fused_rms_norm.launches,
            ops.fused_rms_norm_bwd.launches) == (n0[0] + 1, n0[1] + 1)
    vec = _rms_route(rows, n, x, g, do, dx)
    assert (fn.vector_launches, fn.scalar_launches) == \
        (n0[2] + vec, n0[3] + (not vec))
    _close(dx, dx_ref, dtype)
    assert dg.dtype == dtype
    torch.testing.assert_close(dg.float(), dg_ref.float(),
                               atol=_sum_tol(dtype, rows), rtol=_TOL[dtype])
    for _ in range(10):
        again = fn(x, g, rstd_ref, do)
        assert torch.equal(again[0], dx) and torch.equal(again[1], dg)


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


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("rows,V", [(64, 10), (32, 1000)])
def test_softmax_xent_kernels_at_vision_shapes(gen, dtype, rows, V):
    """LeNet's logits [64, 10] (246 of the 256 threads of a row's block
    hold no column) and ResNet-50's [32, 1000], forward and backward."""
    x = (3 * torch.randn(rows, V, device="cuda", generator=gen)).to(dtype)
    labels = torch.randint(0, V, (rows,), device="cuda", generator=gen)
    labels[::7] = -1
    loss, lse = ops.softmax_xent_fwd(x, labels)
    loss_ref, lse_ref = ops.softmax_xent_fwd_ref(x, labels)
    torch.testing.assert_close(loss, loss_ref, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    g = torch.full((rows,), 1.0 / rows, device="cuda")
    dx = ops.softmax_xent_bwd(x, labels, lse, g)
    dx_ref = ops.softmax_xent_bwd_ref(x, labels, lse, g)
    tol = _TOL[dtype] / rows
    torch.testing.assert_close(dx.float(), dx_ref.float(), atol=tol,
                               rtol=_TOL[dtype])


def test_resnet18_step_on_the_card_matches_the_cpu(gen):
    """One Momentum step of ResNet-18 (10 classes, B=4, 3 x 64 x 64, f32,
    TF32 off, batch norm in training mode) on the card and on the CPU
    from the same weights: the loss, every gradient (against its largest
    magnitude), every parameter and running statistic after the step
    within 1e-4; the card's relus take the CPU's derivative within
    ``chip_smoke.KINK_BAND`` of 0 (``chip_smoke.ReluKinks``)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    import paddle_tpu_torch as pt
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        rng = np.random.default_rng(40)
        x = rng.standard_normal((4, 3, 64, 64)).astype(np.float32)
        y = rng.integers(0, 10, (4,))
        state = pt.vision.models.resnet18(num_classes=10,
                                          device="cpu").state_dict()
        kinks = chip_smoke.ReluKinks()
        runs = {}
        for device, record in (("cpu", True), ("cuda", False)):
            model = pt.vision.models.resnet18(num_classes=10, device=device)
            model.load_state_dict(state)
            hooks = kinks.attach(model, pt.nn.ReLU, record)
            opt = pt.optimizer.Momentum(learning_rate=1e-3, momentum=0.9,
                                        parameters=model.parameters())
            loss = pt.nn.functional.cross_entropy(
                model(torch.from_numpy(x).to(device)),
                torch.from_numpy(y).to(device))
            loss.backward()
            grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
            opt.step()
            for h in hooks:
                h.remove()
            runs[device] = (float(loss.detach()), grads, {
                n: t.detach().cpu() for n, t in model.state_dict().items()})
        (l_gpu, g_gpu, s_gpu), (l_cpu, g_cpu, s_cpu) = runs["cuda"], \
            runs["cpu"]
        assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
        for n, g in g_cpu.items():
            assert float((g_gpu[n] - g).abs().max()) \
                <= 1e-4 * float(g.abs().max()), n
        for n, t in s_cpu.items():
            torch.testing.assert_close(s_gpu[n], t, atol=1e-4, rtol=1e-4,
                                       msg=n)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def _chip_smoke():
    """``chip_smoke`` with the launch counts by route zeroed, as its phase
    2 leaves them: its phases' `check_routes` then sees only their own
    launches, not those of the route tests run before in this process."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    chip_smoke.reset_routes(ops)
    return chip_smoke


@pytest.fixture
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = prev


def test_vision_ops_on_the_card_match_the_cpu(gen, no_tf32):
    """``chip_smoke.phase_vision_ops_parity``: every transposed
    convolution form, the other norms, the pooling masks and unpooled maps
    (exactly), roi_align and roi_pool, box_coder, yolo_box, deform_conv2d
    v1 and v2, forward and backward, and nms (exactly) on the card against
    the CPU, within ``chip_smoke.VISION_OPS_TOL`` of each output's
    largest magnitude."""
    import paddle_tpu_torch as pt
    out = _chip_smoke().phase_vision_ops_parity(pt)
    assert out["nms"] == "exact" and out["deform_conv2d_v2"] <= 1e-4


@pytest.mark.parametrize("name", ["squeezenet1_1", "alexnet"])
def test_small_net_steps_on_the_card_match_the_cpu(gen, no_tf32, name):
    """3 Momentum steps of SqueezeNet 1.1 or AlexNet (10 classes, B=4, 3 x
    64 x 64, f32, dropout 0) on the card against the CPU within
    ``chip_smoke.PARITY_TOL`` (``chip_smoke.vision_parity``; AlexNet with
    cuDNN off, as phase 33 runs it), rows 8a/8b launched once a step."""
    import paddle_tpu_torch as pt
    cs = _chip_smoke()
    out = cs.vision_parity(
        pt, ops, f"{name} parity", lambda d: cs.vision_model(pt, name, d),
        cs.VISION_PARITY_II_SHAPE, 10, "momentum", "f32",
        cudnn=cs.VISION_PARITY_II[name][4])
    assert out["dtype"] == "float32"
    assert out["grad_max_rel_err"] <= cs.PARITY_TOL["grad"]


def test_wrappers_refuse_bad_inputs(gen):
    x = torch.randn(4, 8, device="cuda", generator=gen)
    with pytest.raises(TypeError):      # f32, bf16 and f16 only
        ops.fused_layer_norm(x.double(), torch.ones(8, device="cuda").double(),
                             torch.zeros(8, device="cuda").double())
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
    with pytest.raises(TypeError):      # f32, bf16 and f16 only
        ops.fused_flash_attention_fwd(q.double(), q.double(), q.double(),
                                      True)
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
@pytest.mark.parametrize("rows,n", [(37, 768), (300, 768), (5, 300),
                                    (8192, 768), (3, 9000)])
def test_layer_norm_residual_kernel(gen, dtype, rows, n):
    """Row counts off any block, widths off the 256-thread stride, the BERT
    drive's [8192, 768] and a width past the register route: the forward's
    out, s, mu and rstd, its launch counted under its route (the Python
    rule held to the library's), 10 reruns bit-identical, and the
    gradients through autograd (the layer-norm backward kernel on the saved
    s) against the plain versions; x's and the residual's gradients are
    one tensor's values."""
    x = (2 * torch.randn(rows, n, device="cuda", generator=gen)
         + 0.5).to(dtype).requires_grad_()
    r = torch.randn(rows, n, device="cuda", generator=gen).to(
        dtype).requires_grad_()
    g = (1 + 0.1 * torch.randn(n, device="cuda", generator=gen)).to(
        dtype).requires_grad_()
    b = (0.1 * torch.randn(n, device="cuda", generator=gen)).to(
        dtype).requires_grad_()
    fn = ops.fused_layer_norm_residual
    n0 = fn.launches, ops.fused_layer_norm_bwd.launches, \
        fn.vector_launches, fn.scalar_launches
    args = (x.detach(), r.detach(), g.detach(), b.detach())
    got = fn(*args)
    want = ops.layer_norm_residual_ref(*args)
    for a, w, dt in zip(got, want, (dtype, dtype, torch.float32,
                                    torch.float32)):
        assert a.dtype == w.dtype == dt
        _close(a, w, dt)
    from paddle_tpu_torch.ops import cuda_lib
    from paddle_tpu_torch.ops.layer_norm import vector_route
    tensors = (*args, got[0], got[1])
    vec = vector_route(n, *tensors)
    assert bool(cuda_lib.library().ptt_layer_norm_residual_vector_route(
        *(t.data_ptr() for t in tensors), n, x.element_size())) == vec
    assert vec == (n in (300, 768) and n * x.element_size() % 16 == 0)
    assert (fn.vector_launches, fn.scalar_launches) == \
        (n0[2] + vec, n0[3] + (not vec))
    for _ in range(10):
        assert all(torch.equal(a, f) for a, f in zip(fn(*args), got))
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
    assert (fn.launches, ops.fused_layer_norm_bwd.launches) == \
        (n0[0] + 12, n0[1] + 1)
    with pytest.raises(ValueError, match="residual"):
        fn(x.detach(), r.detach().double(), g.detach(), b.detach())


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


def test_wgmma_check_matches_torch_mm(gen):
    """`csrc/wgmma.cuh` on its own (``csrc/wgmma_check.cu``): one
    warpgroup multiplies a [64, 64] tile by a [64, 128] one (w as stored,
    [K, N]: the MN-major transpose-B form), once TMA-loaded and once
    staged by the threads; small integers keep every sum exact, so both
    equal torch.mm bit for bit."""
    from paddle_tpu_torch.ops import cuda_lib
    a = torch.randint(-3, 4, (64, 64), device="cuda",
                      generator=gen).to(torch.bfloat16)
    b = torch.randint(-3, 4, (64, 128), device="cuda",
                      generator=gen).to(torch.bfloat16)
    c = torch.full((2, 64, 128), float("nan"), device="cuda")
    rc = cuda_lib.library().ptt_wgmma_check(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), a.device.index,
        cuda_lib.stream_handle(a.device))
    cuda_lib.check(rc, "wgmma_check")
    want = torch.mm(a.float(), b.float())
    assert torch.equal(c[0], want) and torch.equal(c[1], want)


def _routes(fn):
    return fn.tma_launches, fn.elementwise_launches


#: row 3 at the model shapes (M, K, N, z): serving fc1 (the token budget's
#: 368 rows), two decode steps (split-K), the training drive's 4096 rows
_ME_MODEL_SHAPES = [(368, 2048, 8192, False), (4, 2048, 8192, False),
                    (8, 2048, 8192, False), (4096, 2048, 8192, True)]


@pytest.mark.parametrize("M,K,N,with_z", _ME_MODEL_SHAPES)
def test_matmul_epilogue_model_shapes(gen, M, K, N, with_z):
    """The bf16 forward at the GPT_1P3B paths' shapes, through TMA."""
    x = torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16)
    w = (torch.randn(K, N, device="cuda", generator=gen)
         / K ** 0.5).to(torch.bfloat16)
    b = (0.1 * torch.randn(N, device="cuda", generator=gen)).to(
        torch.bfloat16)
    r0 = _routes(ops.fused_linear_act)
    got = ops.fused_linear_act(x, w, b, "gelu_tanh", return_z=with_z)
    want = ops.linear_act_ref(x, w, b, "gelu_tanh", return_z=with_z)
    assert _routes(ops.fused_linear_act) == (r0[0] + 1, r0[1])
    for g_, w_ in zip(*((got, want) if with_z else ((got,), (want,)))):
        _close(g_, w_, torch.bfloat16)


#: row 11 at the serving step's 368 rows: qkv, out, fc1 and fc2 (K, N, act)
_ME_INT8_SHAPES = [(2048, 6144, "none"), (2048, 2048, "none"),
                   (2048, 8192, "gelu_tanh"), (8192, 2048, "none")]


@pytest.mark.parametrize("K,N,act", _ME_INT8_SHAPES)
def test_matmul_epilogue_int8_model_shapes(gen, K, N, act):
    """The int8-weight forward at GPT_1P3B's serving shapes, through TMA
    (the codes widened in shared memory), bias in f32."""
    x = torch.randn(368, K, device="cuda", generator=gen).to(torch.bfloat16)
    w_q, scale = _int8_weight(K, N, gen)
    b = 0.1 * torch.randn(N, device="cuda", generator=gen)
    r0 = _routes(ops.fused_linear_act_int8)
    out = ops.fused_linear_act_int8(x, w_q, scale, b, act)
    assert _routes(ops.fused_linear_act_int8) == (r0[0] + 1, r0[1])
    _close(out, ops.linear_act_int8_ref(x, w_q, scale, b, act),
           torch.bfloat16)


@pytest.mark.parametrize("int8", [False, True])
def test_matmul_epilogue_staging_routes(gen, int8):
    """Each bf16 launch counts under the route it takes: TMA where x and
    w have 16-byte aligned rows (N = 128), element by element where they
    do not (N = 130; for int8 codes N = 136 too) or x's base is off 16
    bytes; both give the plain version's values."""
    x = torch.randn(70, 200, device="cuda", generator=gen).to(torch.bfloat16)
    xv = torch.randn(70 * 200 + 1, device="cuda", generator=gen).to(
        torch.bfloat16)[1:].view(70, 200)
    fn = ops.fused_linear_act_int8 if int8 else ops.fused_linear_act
    cases = [(x, 128, "tma"), (x, 130, "elementwise"),
             (xv, 128, "elementwise")]
    if int8:
        cases.append((x, 136, "elementwise"))
    for xi, N, route in cases:
        b = torch.randn(N, device="cuda", generator=gen).to(torch.bfloat16)
        r0 = _routes(fn)
        if int8:
            w_q, scale = _int8_weight(200, N, gen)
            out = fn(xi, w_q, scale, b, "gelu")
            want = ops.linear_act_int8_ref(xi, w_q, scale, b, "gelu")
        else:
            w = (torch.randn(200, N, device="cuda", generator=gen)
                 / 14).to(torch.bfloat16)
            out = fn(xi, w, b, "gelu")
            want = ops.linear_act_ref(xi, w, b, "gelu")
        tma, elem = _routes(fn)
        assert (tma - r0[0], elem - r0[1]) == (
            (1, 0) if route == "tma" else (0, 1)), (N, route)
        _close(out, want, torch.bfloat16)


#: (weights, M, K, N): serving fc1 (TMA), a decode step's 4 rows
#: (split-K's second pass), N = 130 (element-wise staging)
_GELU_TAIL_CASES = [("bf16", 368, 2048, 8192), ("bf16", 4, 2048, 8192),
                    ("bf16", 70, 200, 130), ("int8", 368, 2048, 8192),
                    ("int8", 4, 2048, 8192)]


@pytest.mark.parametrize("weights,M,K,N", _GELU_TAIL_CASES)
def test_matmul_epilogue_gelu_tanh_tail(gen, weights, M, K, N):
    """tanh-GELU for z in [-6, -1], where 1 + tanh cancels, within two
    bf16 ulps of the plain version (`assert_gelu_tail`; the products
    exact, so both sides see the same z): an approximate tanh shows
    here, not under the 2e-2 gate."""
    from test_torch_matmul_epilogue_emulated import (assert_gelu_tail,
                                                     gelu_tail_inputs)
    x, w, b, z = gelu_tail_inputs(M, K, N, weights == "int8", gen, "cuda")
    if weights == "int8":
        out = ops.fused_linear_act_int8(x, *w, b, "gelu_tanh")
        want = ops.linear_act_int8_ref(x, *w, b, "gelu_tanh")
    else:
        out = ops.fused_linear_act(x, w, b, "gelu_tanh")
        want = ops.linear_act_ref(x, w, b, "gelu_tanh")
    assert_gelu_tail(out, want, z)


def test_matmul_epilogue_route_rule_matches_the_kernel(gen):
    """The wrappers count routes by `tma_route`, a Python copy of the
    kernel's rule: both answer the same on card tensors."""
    from paddle_tpu_torch.ops import cuda_lib
    from paddle_tpu_torch.ops.matmul_epilogue import tma_route
    from test_torch_matmul_epilogue_emulated import (ROUTE_CASES,
                                                     route_operands)
    lib = cuda_lib.library()
    for case in ROUTE_CASES:
        x, w = route_operands(*case[:-1], device="cuda")
        K, N = w.shape
        assert tma_route(x, w, K, N) == case[-1], case
        assert lib.ptt_matmul_epilogue_tma_route(
            x.data_ptr(), w.data_ptr(), K, N, w.element_size()) == case[-1]


def test_matmul_epilogue_deterministic(gen):
    """100 repeats bit-identical: the serving fc1 and a split-K decode
    step (fixed-order second pass), bf16 weights with z and int8."""
    from paddle_tpu_torch.ops.matmul_epilogue import split_k
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert split_k(8, 2048, 8192, sms, wgmma=True) > 1
    for M in (368, 8):
        x = torch.randn(M, 2048, device="cuda",
                        generator=gen).to(torch.bfloat16)
        w = (torch.randn(2048, 8192, device="cuda", generator=gen)
             / 45).to(torch.bfloat16)
        b = torch.randn(8192, device="cuda", generator=gen).to(
            torch.bfloat16)
        w_q, scale = _int8_weight(2048, 8192, gen)
        first = ops.fused_linear_act(x, w, b, "gelu_tanh", return_z=True)
        first8 = ops.fused_linear_act_int8(x, w_q, scale, b, "gelu_tanh")
        for _ in range(100):
            out, z = ops.fused_linear_act(x, w, b, "gelu_tanh",
                                          return_z=True)
            assert torch.equal(out, first[0]) and torch.equal(z, first[1])
            assert torch.equal(ops.fused_linear_act_int8(
                x, w_q, scale, b, "gelu_tanh"), first8)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("qlens,ctxs,pad,D", _RAGGED_INT8_CASES)
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


def _ragged_step(gen, qlens, ctxs, H, D, dtype, int8, pad=0, bs=16,
                 nqb=None):
    """A ragged step on the card: descriptors of (qlens, ctxs) padded to
    ``nqb`` q-blocks (or by ``pad``) with the null segment, block tables
    scattered over the pool, bf16 or f32 pools, or int8 codes with a
    scale per slot.  Returns (args, kwargs) of the wrappers."""
    block_q = ops.ragged_q_block(dtype)
    S = len(qlens)
    if nqb is None:
        nqb = len(ops.ragged_segments(qlens, ctxs, block_q)[0]) + pad
    sid, qs, qv, _, _ = ops.ragged_segments(qlens, ctxs, block_q,
                                            num_q_blocks=nqb, num_seqs=S)
    W = max(1, max(-(-c // bs) for c in ctxs))
    nb = 1 + S * W
    perm = 1 + np.random.default_rng(S * 100 + D).permutation(nb - 1)
    tables = np.zeros((S, W), np.int32)
    for s, c in enumerate(ctxs):
        n = -(-c // bs)
        tables[s, :n] = perm[s * W:s * W + n]
    q = torch.randn(nqb * block_q, H, D, device="cuda",
                    generator=gen).to(dtype)
    kw = dict(block_q=block_q)
    pools = []
    for side in ("k_scales", "v_scales"):
        f = torch.randn(nb, H, bs, D, device="cuda", generator=gen)
        if int8:
            f = f * (0.1 + 3 * torch.rand(nb, 1, bs, 1, device="cuda",
                                          generator=gen))
            amax = f.abs().amax(dim=(1, 3))
            sc = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
            pools.append(torch.clamp(torch.round(
                f / sc[:, None, :, None]), -127, 127).to(torch.int8))
            kw[side] = sc[..., None].contiguous()
        else:
            pools.append(f.to(dtype))
    ints = [torch.from_numpy(a).cuda() for a in
            (tables, np.asarray(ctxs, np.int32), sid, qs, qv)]
    return (q, *pools, *ints), kw


def _ragged_route(args, kw, int8):
    """Run the wrapper once; the route its counters moved ("mma", "f32"
    or "elementwise"), held equal to the Python rule and to the library's
    rule.  Returns (route, out)."""
    from paddle_tpu_torch.ops import cuda_lib
    from paddle_tpu_torch.ops.ragged import mma_route
    fn = ops.ragged_paged_attention_int8 if int8 \
        else ops.ragged_paged_attention
    names = ("mma_launches", "f32_launches", "elementwise_launches")
    n0 = [getattr(fn, a) for a in names]
    out = ops.ragged_paged_attention(*args, **kw)
    moved = [a.split("_")[0] for a, b in zip(names, n0)
             if getattr(fn, a) != b]
    assert len(moved) == 1, moved
    q, k, v = args[:3]
    ks, vs = kw.get("k_scales"), kw.get("v_scales")
    rule = mma_route(q, k, v, out, kw["block_q"], ks, vs)
    assert rule == bool(cuda_lib.library().ptt_ragged_attention_mma_route(
        *(None if t is None else t.data_ptr() for t in (q, k, v, ks, vs,
                                                        out)),
        q.shape[2], k.shape[2], kw["block_q"],
        cuda_lib.dtype_code(q.dtype)))
    assert moved[0] == ("mma" if rule else "f32"
                        if q.dtype == torch.float32 else "elementwise")
    return moved[0], out


def _ragged_gates(out, args, kw):
    """The card's gates of ragged attention: the plain version within
    `_TOL`, and in bf16 the plain version with f32 probabilities within
    2^-8 of its RMS + 2^-7 relative."""
    q, pools, ints = args[0], args[1:3], args[3:]
    _close(out, ops.ragged_attention_ref(*args, **kw), q.dtype)
    if q.dtype == torch.bfloat16:
        pools32 = pools if "k_scales" in kw else [p.float() for p in pools]
        want32 = ops.ragged_attention_ref(q.float(), *pools32, *ints, **kw)
        rms = float(want32.pow(2).mean().sqrt())
        torch.testing.assert_close(out.float(), want32, atol=2 ** -8 * rms,
                                   rtol=2 ** -7)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("qlens,ctxs,pad,D,int8",
                         [(*c, 64, False) for c in _RAGGED_CASES]
                         + [(*c, True) for c in _RAGGED_INT8_CASES])
def test_ragged_attention_routes(gen, dtype, qlens, ctxs, pad, D, int8):
    """The small cases' routes, read from the wrappers' counters: every
    bf16 case at D 64 or 128 on the tensor cores, D = 40 element by
    element, f32 on its own route."""
    args, kw = _ragged_step(gen, qlens, ctxs, 4, D, dtype, int8, pad=pad)
    route, out = _ragged_route(args, kw, int8)
    want = "f32" if dtype == torch.float32 else \
        "mma" if D in (64, 128) else "elementwise"
    assert route == want
    _ragged_gates(out, args, kw)


#: the drives' steps: the serving drive's mixed step (a 256-token prefill
#: chunk at positions 256..511 and seven decode rows at contexts 520-622:
#: 33-39 pages), and a decode-only step (8 rows at contexts 577-640),
#: each padded to the token budget's 23 q-blocks
_RAGGED_DRIVE = {"mixed": ([1] * 7 + [256],
                           [520 + 17 * i for i in range(7)] + [512]),
                 "decode": ([1] * 8, [577 + 9 * i for i in range(8)])}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("D", [128, 64])
@pytest.mark.parametrize("case", list(_RAGGED_DRIVE))
def test_ragged_attention_drive_shapes(gen, case, D, int8):
    """Rows 1 and 10 at the serving drives' shapes (16 heads of 128, the
    multi-LoRA drive's 16 of 64), bf16 queries: the tensor-core route,
    within the gates."""
    args, kw = _ragged_step(gen, *_RAGGED_DRIVE[case], 16, D,
                            torch.bfloat16, int8, nqb=23)
    route, out = _ragged_route(args, kw, int8)
    assert route == "mma"
    _ragged_gates(out, args, kw)
    null = (args[5] == len(_RAGGED_DRIVE[case][0])).repeat_interleave(16)
    assert float(out[null].abs().sum()) == 0.0     # the null q-blocks


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_ragged_attention_repeats(gen, int8):
    """The mixed step 100 times: every output equal to the first bit for
    bit (the partial states merge in warp order, no atomics)."""
    args, kw = _ragged_step(gen, *_RAGGED_DRIVE["mixed"], 16, 128,
                            torch.bfloat16, int8, nqb=23)
    first = ops.ragged_paged_attention(*args, **kw)
    for _ in range(100):
        assert torch.equal(ops.ragged_paged_attention(*args, **kw), first)


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


def _ids_buffer(ids, bm, K, gen, dtype, E):
    """x [len(ids) * bm, K] over blocks with the given ids (in any order;
    an id >= E is a null block, its rows zero) and the int32 ids."""
    gid = torch.tensor(ids, dtype=torch.int32, device="cuda")
    x = torch.randn(len(ids) * bm, K, device="cuda", generator=gen)
    x[(gid >= E).repeat_interleave(bm)] = 0
    return x.to(dtype), gid


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("pattern", ["uniform", "alternating", "nulls"])
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("grid", ["mid", "wide", "wide2"])
def test_grouped_matmul_spanned_tiles(gen, dtype, pattern, trans, grid):
    """Blocks of 16 rows, so a bf16 row tile of 128 spans 8 blocks:
    one id for all, ids alternating over 4 experts in unsorted order (a
    thread block per id of a tile, each storing its own rows), and null
    blocks inside spanned tiles; K 200 and N 130 off the tile.  The rows
    make grids of 128 x 128 tiles that pick each bf16 tile: under one
    tile an SM (128 x 64), one to two (128 x 128), two or more (128 x 128
    at two blocks an SM)."""
    sms = torch.cuda.get_device_properties("cuda").multi_processor_count
    row_tiles = {"mid": 3, "wide": -(-sms // 2), "wide2": sms}[grid]
    E, bm, K, N, nb = 4, 16, 200, 130, row_tiles * 8
    ids = {"uniform": [2] * nb,
           "alternating": [(3, 0, 2, 1)[i % 4] for i in range(nb)],
           "nulls": [E if i % 5 in (1, 3) else (i * 7) % E
                     for i in range(nb)]}[pattern]
    x, gid = _ids_buffer(ids, bm, K, gen, dtype, E)
    shape = (E, N, K) if trans else (E, K, N)
    w = (torch.randn(*shape, device="cuda", generator=gen) / 14).to(dtype)
    b = None if trans else torch.randn(E, N, device="cuda",
                                       generator=gen).to(dtype)
    out, z = ops.fused_grouped_linear_act(x, w, b, gid, "gelu_tanh",
                                          return_z=True, transpose_w=trans)
    wk = w.transpose(1, 2) if trans else w
    _close(out, ops.grouped_linear_act_ref(x, wk, b, block_group=gid,
                                           act="gelu_tanh"), dtype)
    _close(z, ops.grouped_linear_act_ref(x, wk, b, block_group=gid), dtype)
    null = (gid >= E).repeat_interleave(bm)
    assert not out[null].any() and not z[null].any()


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("K,N", [(1024, 16), (70, 16), (16, 1024),
                                 (16, 70), (16, 16)])
@pytest.mark.parametrize("trans", [False, True])
def test_grouped_matmul_narrow(gen, dtype, K, N, trans):
    """N = 16 (LoRA's u and t: the 16-column tile) and K = 16 (dx: one
    step at depth 16), each also off the 16-byte grid (70), both weight
    layouts, over unsorted adapter ids with a null block."""
    E = 3
    bm = 16 if dtype == torch.bfloat16 else 8
    ids = [1, 0, 3, 2, 2, 0, 1, 1, 3, 0, 2]
    x, gid = _ids_buffer(ids, bm, K, gen, dtype, E)
    shape = (E, N, K) if trans else (E, K, N)
    w = (torch.randn(*shape, device="cuda", generator=gen) / 5).to(dtype)
    out = ops.fused_grouped_linear_act(x, w, None, gid, transpose_w=trans)
    wk = w.transpose(1, 2) if trans else w
    _close(out, ops.grouped_linear_act_ref(x, wk, None, block_group=gid),
           dtype)
    assert not out[(gid >= E).repeat_interleave(bm)].any()


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("K,N", [(64, 16), (16, 64), (64, 64), (70, 130)])
def test_grouped_dw_row_split(gen, dtype, K, N):
    """Few output tiles over many rows: each expert's rows split into S > 1
    slices whose f32 partials a second launch sums in a fixed order (one
    call, one launch counted).  Expert 1 owns a single block, expert 2
    none (exact zeros)."""
    counts, bm, E = [8000, 16, 0, 300], 16, 4
    x, gid = _grouped_buffer(counts, bm, K, gen, dtype)
    dz = torch.randn(x.shape[0], N, device="cuda", generator=gen).to(dtype)
    assert ops.grouped_dw_slices(x, dz, E) > 1
    n0 = ops.fused_grouped_dw.launches
    dw = ops.fused_grouped_dw(x, dz, gid, E)
    assert ops.fused_grouped_dw.launches == n0 + 1
    want = ops.grouped_dw_ref(x, dz, gid, E)
    torch.testing.assert_close(dw.float(), want.float(),
                               atol=_sum_tol(dtype, max(counts)),
                               rtol=_TOL[dtype])
    assert not dw[2].any()


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("layout", ["card_test", "lora_dA"])
def test_grouped_kernels_are_deterministic(gen, dtype, layout):
    """Rows 14a and 14b, 100 runs each on the same inputs, every output
    bit-identical to the first: at the layout of
    `test_grouped_linear_act_gradients_on_the_card` (counts [37, 0, 80,
    11], blocks of 32, K 96, N 160, gelu_tanh, z saved) and at LoRA's dA
    shape (8192 rows of 1024 against rank 16, one adapter: the forward's
    t = x @ A and the dw over x and u with its rows split)."""
    if layout == "card_test":
        counts, bm, K, N, E = [37, 0, 80, 11], 32, 96, 160, 4
        x, gid = _grouped_buffer(counts, bm, K, gen, dtype)
        act = "gelu_tanh"
    else:
        bm, K, N, E, R = (16 if dtype == torch.bfloat16 else 8), 1024, 16, \
            1, 8192
        gid = torch.zeros(R // bm, dtype=torch.int32, device="cuda")
        x = torch.randn(R, K, device="cuda", generator=gen).to(dtype)
        act = "none"
    w = (torch.randn(E, K, N, device="cuda", generator=gen) / 10).to(dtype)
    b = torch.randn(E, N, device="cuda", generator=gen).to(dtype)
    dz = torch.randn(x.shape[0], N, device="cuda", generator=gen).to(dtype)
    if layout == "lora_dA":
        assert ops.grouped_dw_slices(x, dz, E) > 1

    def run():
        out, z = ops.fused_grouped_linear_act(x, w, b, gid, act,
                                              return_z=True)
        return out, z, ops.fused_grouped_dw(x, dz, gid, E)
    first = run()
    _close(first[0], ops.grouped_linear_act_ref(x, w, b, block_group=gid,
                                                act=act), dtype)
    for _ in range(99):
        again = run()
        assert all(torch.equal(a, c) for a, c in zip(again, first))


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


def _lora_routes():
    fn = ops.fused_lora_segment_epilogue
    return (fn.launches, fn.mma_launches, fn.f32_launches,
            fn.elementwise_launches)


def _lora_route(n0, K, N, r, *tensors):
    """The route the Python rule gives for the launch just made, held
    equal to the library's rule and to the wrapper's counts since
    ``n0`` (`_lora_routes`)."""
    from paddle_tpu_torch.ops import cuda_lib
    from paddle_tpu_torch.ops.lora import mma_route
    mma = mma_route(K, N, r, *tensors)
    assert bool(cuda_lib.library().ptt_lora_sgmv_mma_route(
        *(None if t is None else t.data_ptr() for t in tensors), K, N, r,
        cuda_lib.dtype_code(tensors[1].dtype))) == mma
    f32 = tensors[1].dtype == torch.float32
    assert _lora_routes() == (n0[0] + 1, n0[1] + mma, n0[2] + f32,
                              n0[3] + (not mma and not f32))
    return mma


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("act", ops.ACTIVATIONS)
@pytest.mark.parametrize("K,N,r", [(200, 130, 16), (1024, 3072, 16),
                                   (64, 16, 8), (96, 70, 64)])
def test_lora_sgmv_kernel(gen, dtype, act, K, N, r):
    """Blocks [0, null, 2, 2, null, 0, 3]: adapter 1 owns none.  Ragged
    K and N (130 and 70: bf16's element-wise route); r = 64 at block rows
    16 fills the f32 and element-wise kernel's 1024 low-rank entries from
    256 threads; r = 8 pads the tensor-core route's t to 16 columns.  Each
    launch counted under the route the rule gives."""
    bm = 16 if dtype == torch.bfloat16 else 8
    aid = [0, 4, 2, 2, 4, 0, 3]
    z, x, a, b, gid = _lora_case(gen, dtype, K, N, r, aid, bm)
    n0 = _lora_routes()
    out, s = ops.fused_lora_segment_epilogue(z, x, a, b, gid, act)
    mma = _lora_route(n0, K, N, r, z, x, a, b, None if out is s else out, s)
    assert mma == (dtype == torch.bfloat16 and N % 8 == 0)
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


#: the SGMV epilogue at the drives' shapes (chip_smoke.py's LORA_CASES and
#: LORA_TRAIN_CASES): (rows, K, N, act, slots); the serving step's 368
#: rows (23 blocks of 16) over 16 slots, adapters 0, 3, 6, 9 in turn and a
#: null block every third; fine-tuning's 8192 rows, one adapter
_LORA_DRIVE = {"serve_qkv": (368, 1024, 3072, "none", 16),
               "serve_out": (368, 1024, 1024, "none", 16),
               "serve_fc1": (368, 1024, 4096, "gelu_tanh", 16),
               "serve_fc2": (368, 4096, 1024, "none", 16),
               "train_qkv": (8192, 1024, 3072, "none", 1),
               "train_out": (8192, 1024, 1024, "none", 1),
               "train_fc2": (8192, 4096, 1024, "none", 1)}


@pytest.mark.parametrize("case", list(_LORA_DRIVE))
def test_lora_sgmv_drive_shapes(gen, case):
    """bf16 rank 16 at each drive shape: the tensor-core route, within 2e-2
    of the plain version, s = z bit for bit on null rows, and 100 runs
    bit-identical to the first."""
    rows, K, N, act, slots = _LORA_DRIVE[case]
    dtype, bm = torch.bfloat16, 16
    nb = rows // bm
    aid = [0] * nb if slots == 1 else \
        [slots if i % 3 == 2 else (0, 3, 6, 9)[i % 4] for i in range(nb)]
    z, x, a, b, gid = _lora_case(gen, dtype, K, N, 16, aid, bm, L=slots)
    n0 = _lora_routes()
    first = ops.fused_lora_segment_epilogue(z, x, a, b, gid, act)
    out, s = first
    assert _lora_route(n0, K, N, 16, z, x, a, b,
                       None if out is s else out, s)
    want, s_want = ops.lora.fused_lora_segment_epilogue(
        z.cpu(), x.cpu(), a.cpu(), b.cpu(), gid.cpu(), act)
    _close(out.cpu(), want, dtype)
    _close(s.cpu(), s_want, dtype)
    null = (gid == slots).repeat_interleave(bm)
    assert torch.equal(s[null], z[null])
    for _ in range(100):
        again = ops.fused_lora_segment_epilogue(z, x, a, b, gid, act)
        assert all(torch.equal(u, v) for u, v in zip(again, first))


@pytest.mark.parametrize("dtype", _DTYPES)
def test_lora_out_is_s_on_the_card(gen, dtype):
    """act "none": the kernel writes s alone and the wrapper returns it as
    out (another activation: two tensors); the autograd function on the
    saved alias gives the CPU's gradients."""
    bm = 16 if dtype == torch.bfloat16 else 8
    aid = [3, 0, 4, 3, 3, 0, 4, 2]
    z, x, a, b, gid = _lora_case(gen, dtype, 64, 136, 16, aid, bm)
    for act in ops.ACTIVATIONS:
        out, s = ops.fused_lora_segment_epilogue(z, x, a, b, gid, act)
        assert (out is s) == (act == "none"), act
    g = torch.randn(z.shape, device="cuda", generator=gen).to(dtype)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in (z, x, a, b)]
        out = ops.lora_segment_epilogue(*leaves, block_adapter=gid.to(dev),
                                        act="none")
        out.backward(g.to(dev))
        grads[dev] = [out.detach().cpu()] + [t.grad.cpu() for t in leaves]
    for name, got, want in zip(("out", "dz", "dx", "dA", "dB"),
                               grads["cuda"], grads["cpu"]):
        tol = _TOL[dtype] * (10 if name in ("dA", "dB") else 1)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=_TOL[dtype], msg=name)


def test_lora_wrapper_refuses_bad_inputs(gen):
    z, x, a, b, gid = _lora_case(gen, torch.float32, 32, 40, 8, [0, 4], 8)
    with pytest.raises(ValueError, match="int32"):
        ops.fused_lora_segment_epilogue(z, x, a, b, gid.long())
    with pytest.raises(ValueError, match="is torch.bfloat16"):
        ops.fused_lora_segment_epilogue(z, x, a.bfloat16(), b, gid)
    h = _lora_case(gen, torch.float64, 32, 40, 16, [0, 4], 16)
    with pytest.raises(TypeError):      # f32, bf16 and f16 only
        ops.fused_lora_segment_epilogue(*h)
    with pytest.raises(ValueError, match="on cpu"):
        ops.fused_lora_segment_epilogue(z, x, a.cpu(), b, gid)
    # more than 2048 entries of t (block rows x r): f32, and bf16's
    # tensor-core route (r = 144 at block rows 16)
    with pytest.raises(ValueError, match="exceeds"):
        big_a = torch.zeros(4, 32, 512, device="cuda")
        ops.fused_lora_segment_epilogue(z, x, big_a,
                                        torch.zeros(4, 512, 40,
                                                    device="cuda"), gid)
    h = _lora_case(gen, torch.bfloat16, 32, 40, 144, [0, 4], 16)
    with pytest.raises(ValueError, match="exceeds"):
        ops.fused_lora_segment_epilogue(*h)


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
    with pytest.raises(TypeError):      # f32, bf16 and f16 only
        ops.paged_attention(q.double(), k.double(), v.double(), tables, ctx)
    with pytest.raises(ValueError, match="on cpu"):
        ops.paged_attention(q, k, v, tables.cpu(), ctx)
    with pytest.raises(ValueError, match="int32"):
        ops.paged_attention(q, k, v, tables.long(), ctx)
    with pytest.raises(ValueError, match="1 token"):
        ops.paged_attention(q.expand(2, 2, 2, 64).contiguous(), k, v,
                            tables, ctx)
    assert ops.paged_attention.launches == n0


# ---------------------------------------------------------------------
# the vector routes of paged attention (row 9) and of the epilogue
# backward (row 7)
# ---------------------------------------------------------------------
def _paged_route(args):
    fn = ops.paged_attention
    n0 = (fn.launches, fn.vector_launches, fn.elementwise_launches)
    out = fn(*args)
    moved = (fn.launches - n0[0], fn.vector_launches - n0[1],
             fn.elementwise_launches - n0[2])
    return out, moved


#: the drives' decode steps: phase 25's (4 sequences at 129-192 keys and
#: one at 0, tables 16 wide) and a long decode (4 x 4096 keys)
_PAGED_DRIVE = {"decode": ([129, 150, 171, 192, 0], 16),
                "long": ([4096] * 4, 256)}


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("case", list(_PAGED_DRIVE))
def test_paged_attention_drive_shapes(gen, case, dtype):
    """16 heads of 128, pages of 16: the vector route (by the counters
    and the Python and library rules), 100 runs bit-identical."""
    from paddle_tpu_torch.ops import cuda_lib
    from paddle_tpu_torch.ops.paged import vector_route
    ctxs, W = _PAGED_DRIVE[case]
    args = _paged_case(gen, dtype, len(ctxs), 16, 128, 16, ctxs, W)
    out, moved = _paged_route(args)
    assert moved == (1, 1, 0)
    q, k, v = args[:3]
    assert vector_route(q, k, v, out)
    assert cuda_lib.library().ptt_paged_attention_vector_route(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 128,
        cuda_lib.dtype_code(dtype)) == 1
    _close(out, ops.paged_attention_ref(*args), dtype)
    for _ in range(100):
        assert torch.equal(ops.paged_attention(*args), out)


@pytest.mark.parametrize("dtype", _DTYPES)
def test_paged_attention_never_reads_padding(gen, dtype):
    """Page 0 of both pools holds NaNs and every padding entry of the
    tables points at it; contexts 0, 1, 17 and 300 (several splits): no
    NaN reaches the output, and the rest matches the plain version on the
    pools with page 0 zeroed."""
    ctxs = [0, 1, 17, 300]
    q, k, v, tables, ctx = _paged_case(gen, dtype, 4, 4, 128, 16, ctxs, 24)
    k[0], v[0] = float("nan"), float("nan")
    out = ops.paged_attention(q, k, v, tables, ctx)
    assert bool(torch.isfinite(out).all())
    assert not out[0].any()
    k[0], v[0] = 0.0, 0.0
    _close(out, ops.paged_attention_ref(q, k, v, tables, ctx), dtype)


@pytest.mark.parametrize("dtype", _DTYPES)
def test_paged_attention_elementwise_route(gen, dtype):
    """A q view one element off 16 bytes takes the element-wise route,
    by the counters, and agrees with the plain version."""
    q, k, v, tables, ctx = _paged_case(gen, dtype, 3, 4, 64, 16,
                                       [20, 0, 70], 6)
    buf = torch.empty(q.numel() + 1, dtype=dtype, device="cuda")
    qs = buf[1:].view(q.shape)
    qs.copy_(q)
    out, moved = _paged_route((qs, k, v, tables, ctx))
    assert moved == (1, 0, 1)
    _close(out, ops.paged_attention_ref(q, k, v, tables, ctx), dtype)


#: the drives' fc1 backward shapes (rows, N), tanh-GELU: the training
#: drive, phase 8's flash drive, phase 24's LoRA fine-tuning, BERT's fc1
#: and MLM head transform
_ME_BWD_DRIVE = [(4096, 8192), (8192, 8192), (8192, 4096), (8192, 3072),
                 (8192, 768)]


def _bwd_route(z, g, act):
    fn = ops.fused_linear_act_bwd
    n0 = (fn.launches, fn.vector_launches, fn.elementwise_launches)
    dz, db = fn(z, g, act)
    moved = (fn.launches - n0[0], fn.vector_launches - n0[1],
             fn.elementwise_launches - n0[2])
    return dz, db, moved


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("M,N", _ME_BWD_DRIVE)
def test_matmul_epilogue_bwd_drive_shapes(gen, dtype, M, N):
    """The vector route (by the counters and the Python and library
    rules), dz and db against the plain version."""
    from paddle_tpu_torch.ops import cuda_lib
    from paddle_tpu_torch.ops.matmul_epilogue import bwd_vector_route
    z = (2 * torch.randn(M, N, device="cuda", generator=gen)).to(dtype)
    g = torch.randn(M, N, device="cuda", generator=gen).to(dtype)
    dz, db, moved = _bwd_route(z, g, "gelu_tanh")
    assert moved == (1, 1, 0)
    assert bwd_vector_route(z, g, dz)
    assert cuda_lib.library().ptt_matmul_epilogue_bwd_vector_route(
        z.data_ptr(), g.data_ptr(), dz.data_ptr(), N,
        cuda_lib.dtype_code(dtype)) == 1
    dz_ref, db_ref = ops.linear_act_bwd_ref(z, g, "gelu_tanh")
    _close(dz, dz_ref, dtype)
    torch.testing.assert_close(db.float(), db_ref.float(),
                               atol=_sum_tol(dtype, M), rtol=_TOL[dtype])


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("act", ops.ACTIVATIONS)
def test_matmul_epilogue_bwd_vector_route_activations(gen, dtype, act):
    """Every activation on the vector route at rows off the 4-row unroll
    and a width of three column spans (768), and the element-wise route
    (N = 130) by the counters."""
    for M, N, want in ((131, 768, (1, 1, 0)), (70, 130, (1, 0, 1))):
        z = (2 * torch.randn(M, N, device="cuda", generator=gen)).to(dtype)
        g = torch.randn(M, N, device="cuda", generator=gen).to(dtype)
        dz, db, moved = _bwd_route(z, g, act)
        assert moved == want
        dz_ref, db_ref = ops.linear_act_bwd_ref(z, g, act)
        _close(dz, dz_ref, dtype)
        torch.testing.assert_close(db.float(), db_ref.float(),
                                   atol=_sum_tol(dtype, M),
                                   rtol=_TOL[dtype])


@pytest.mark.parametrize("dtype", _DTYPES)
def test_matmul_epilogue_bwd_repeats(gen, dtype):
    """The training drive's [4096, 8192]: 100 runs bit-identical."""
    z = (2 * torch.randn(4096, 8192, device="cuda", generator=gen)).to(dtype)
    g = torch.randn(4096, 8192, device="cuda", generator=gen).to(dtype)
    dz, db = ops.fused_linear_act_bwd(z, g, "gelu_tanh")
    for _ in range(100):
        dz2, db2 = ops.fused_linear_act_bwd(z, g, "gelu_tanh")
        assert torch.equal(dz2, dz) and torch.equal(db2, db)


# -- jit.to_static on CUDA graphs ---------------------------------------
def _ln_epilogue_step(x, gamma, beta, w, b):
    """Rows 2 and 3: layer norm, then the GELU matmul epilogue."""
    return ops.linear_act(ops.layer_norm(x, gamma, beta), w, b, "gelu_tanh")


def _ln_epilogue_inputs(gen, dtype=torch.bfloat16, M=368, K=2048, N=8192):
    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    return r(M, K), r(K), r(K), r(K, N) * 0.02, r(N)


def test_to_static_replay_equals_eager_bit_for_bit(gen):
    from paddle_tpu_torch import jit
    args = _ln_epilogue_inputs(gen)
    fn = jit.to_static(_ln_epilogue_step)
    for i in range(4):
        x = torch.randn(args[0].shape, device="cuda", generator=gen).to(
            args[0].dtype)
        got = fn(x, *args[1:])
        want = _ln_epilogue_step(x, *args[1:])
        assert torch.equal(got, want), i
    assert fn.captures == 1 and fn.replays == 3 and fn.eager_calls == 1
    assert len(fn._cache) == 1


def test_to_static_counts_replayed_launches(gen):
    from paddle_tpu_torch import jit
    args = _ln_epilogue_inputs(gen)
    fns = (ops.fused_layer_norm, ops.fused_linear_act)

    def counts():
        return [(f.launches, getattr(f, "vector_launches", None),
                 getattr(f, "tma_launches", None)) for f in fns]

    start = counts()
    for _ in range(5):
        _ln_epilogue_step(*args)
    per_eager = [tuple(b - a if a is not None else None
                       for a, b in zip(s, e))
                 for s, e in zip(start, counts())]
    fn = jit.to_static(_ln_epilogue_step)
    start = counts()
    for _ in range(5):
        fn(*args)
    torch.cuda.synchronize()
    per_traced = [tuple(b - a if a is not None else None
                        for a, b in zip(s, e))
                  for s, e in zip(start, counts())]
    assert per_traced == per_eager and per_eager[0][0] == 5
    assert fn.replays == 4


def test_to_static_dropout_masks_follow_the_generator():
    from paddle_tpu_torch import jit
    import paddle_tpu_torch.nn.functional as F
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones(4096, device="cuda")

    def draws(traced, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)

        def f(v):
            return F.dropout(v, 0.5, training=True, generator=g)
        fn = jit.to_static(f) if traced else f
        return [fn(x) for _ in range(5)], fn

    eager, _ = draws(False, 3)
    traced, fn = draws(True, 3)
    assert fn.replays == 4
    for a, b in zip(eager, traced):
        assert torch.equal(a, b)
    assert not torch.equal(traced[3], traced[4])
    # the default generator too (the reference's rng-threading case)
    torch.manual_seed(5)
    f = jit.to_static(lambda v: F.dropout(v, 0.5, training=True))
    outs = [f(x) for _ in range(4)]
    assert not torch.equal(outs[2], outs[3]) and f.replays == 3


def test_to_static_host_read_raises_at_capture(gen):
    from paddle_tpu_torch import jit
    x = torch.randn(64, device="cuda", generator=gen)

    def host_read(v):
        return v * float(v.sum().item())

    fn = jit.to_static(host_read)
    stream = torch.cuda.current_stream()
    fn(x)                                   # eager discovery
    with pytest.raises(RuntimeError, match=r"host_read.*item\(\)") as info:
        fn(x)
    assert info.value.__cause__ is not None
    torch.cuda.synchronize()
    assert fn.replays == 0
    # the failed capture is undone: the current stream, the default
    # generator's draws, and a later capture all work
    assert torch.cuda.current_stream() == stream
    torch.rand(8, device="cuda")
    torch.testing.assert_close(x * 2, x + x)
    ok = jit.to_static(lambda v: v * 3)
    outs = [ok(x) for _ in range(3)]
    assert ok.replays == 2 and torch.equal(outs[2], x * 3)


def test_grad_scaler_under_capture_raises(gen):
    import paddle_tpu_torch as pt
    lin = pt.nn.Linear(8, 8, device="cuda")
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())
    scaler = pt.amp.GradScaler()
    x = torch.randn(4, 8, device="cuda", generator=gen)

    def step(v):
        loss = lin(v).square().mean()
        scaler.minimize(opt, scaler.scale(loss))
        opt.clear_grad()
        return loss.detach()

    fn = pt.jit.to_static(step)
    fn(x)
    with pytest.raises(RuntimeError, match="GradScaler"):
        fn(x)


def _scheduled_adamw(pt, seed, beta1=0.9):
    torch.manual_seed(seed)
    model = pt.nn.Sequential(pt.nn.Linear(16, 32, device="cuda"),
                             pt.nn.ReLU(),
                             pt.nn.Linear(32, 4, device="cuda"))
    lr = pt.optimizer.lr
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-2, T_max=4,
                                                    eta_min=1e-3),
                            warmup_steps=2, start_lr=1e-3, end_lr=1e-2)
    opt = pt.optimizer.AdamW(learning_rate=sched, beta1=beta1,
                             parameters=model.parameters(),
                             grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))

    def step(x, y):
        loss = (model(x) - y).square().mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()
    return model, opt, sched, step


def test_to_static_scheduled_adamw_equals_eager_bit_for_bit(gen):
    import paddle_tpu_torch as pt
    x = torch.randn(8, 16, device="cuda", generator=gen)
    y = torch.randn(8, 4, device="cuda", generator=gen)
    runs = []
    for traced in (False, True):
        model, opt, sched, step = _scheduled_adamw(pt, 1)
        fn = pt.jit.to_static(step) if traced else step
        losses = []
        for _ in range(6):
            losses.append(fn(x, y))
            sched.step()
        runs.append((torch.stack(losses), [p.detach().clone() for p in
                                           model.parameters()],
                     opt.state_dict()["global_step"]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert int(runs[0][2]) == int(runs[1][2]) == 6
    assert fn.replays == 5


def test_to_static_callable_beta_under_capture_raises(gen):
    import paddle_tpu_torch as pt
    x = torch.randn(8, 16, device="cuda", generator=gen)
    y = torch.randn(8, 4, device="cuda", generator=gen)
    _, _, _, step = _scheduled_adamw(pt, 2, beta1=lambda: 0.9)
    fn = pt.jit.to_static(step)
    fn(x, y)
    with pytest.raises(RuntimeError) as info:
        fn(x, y)
    assert isinstance(info.value.__cause__, NotImplementedError)
    assert "callable (scheduled) beta" in str(info.value.__cause__)


def test_to_static_closure_is_captured_on_the_card(gen):
    """The closure rule: no tensor argument, the discovery run returned a
    CUDA tensor, so the closure is captured."""
    import paddle_tpu_torch as pt
    lin = pt.nn.Linear(8, 8, device="cuda")
    x = torch.randn(2, 8, device="cuda", generator=gen)
    fn = pt.jit.to_static(lambda: lin(x))
    outs = [fn() for _ in range(3)]
    assert fn.captures == 1 and fn.replays == 2
    assert all(torch.equal(o, outs[0]) for o in outs)
    with torch.no_grad():
        lin.weight.zero_()
    torch.testing.assert_close(fn(), lin.bias.expand(2, 8))


def test_engine_captured_tokens_equal_eager_tokens():
    import paddle_tpu_torch as pt
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = pt.GPTConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                       num_attention_heads=4, max_position_embeddings=256)
    model = pt.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=0)
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(1, 512, size=n)) for n in (40, 7, 90, 23)]
    outs = []
    for captured in (False, True):
        eng = pt.GenerationEngine(model, max_batch=3, prefill_chunk=32,
                                  max_model_len=256, num_blocks=64)
        traced = eng._step_fn
        if not captured:
            eng._step_fn = traced._orig_fn
            traced._cache.clear()
        outs.append(eng.generate(prompts, max_new_tokens=12, do_sample=True,
                                 top_k=20, top_p=0.9, temperature=0.8,
                                 seed=4))
        if captured:
            assert traced.captures == 1 and traced.replays > 10
            assert eng.stats()["step_compiles"] == 1
    assert outs[0] == outs[1]


def _mlp_and_step(pt, seed, opt_cls=None, **opt_kw):
    torch.manual_seed(seed)
    model = pt.nn.Sequential(pt.nn.Linear(16, 32, device="cuda"),
                             pt.nn.ReLU(),
                             pt.nn.Linear(32, 4, device="cuda"))
    opt = (opt_cls or pt.optimizer.AdamW)(
        parameters=model.parameters(), **opt_kw)
    return model, opt


def test_to_static_gradients_reach_an_optimizer_outside(gen):
    """Backward inside the captured step, ``opt.step(); opt.clear_grad()``
    outside it: each replay hands the parameters that call's gradients
    again, so the optimizer steps on them, bit for bit as eagerly."""
    import paddle_tpu_torch as pt
    x = torch.randn(8, 16, device="cuda", generator=gen)
    y = torch.randn(8, 4, device="cuda", generator=gen)
    runs = []
    for traced in (False, True):
        model, opt = _mlp_and_step(pt, 3, learning_rate=1e-2)

        def step(a, b):
            loss = (model(a) - b).square().mean()
            loss.backward()
            return loss.detach()

        fn = pt.jit.to_static(step) if traced else step
        losses, grads = [], []
        for _ in range(4):
            losses.append(fn(x, y))
            grads.append([p.grad.clone() for p in model.parameters()])
            opt.step()
            opt.clear_grad()
        assert all(p.grad is None for p in model.parameters())
        runs.append((torch.stack(losses), grads,
                     [p.detach().clone() for p in model.parameters()]))
    assert fn.replays == 3
    assert torch.equal(runs[0][0], runs[1][0])
    for ga, gb in zip(runs[0][1], runs[1][1]):
        assert all(torch.equal(a, b) for a, b in zip(ga, gb))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][2], runs[1][2]))
    assert not torch.equal(runs[1][0][0], runs[1][0][-1])


def test_to_static_grad_scaler_scale_follows_update(gen):
    """``scaler.scale(loss).backward()`` captured, ``scaler.step(opt);
    scaler.update()`` outside, the scale doubling after every step: each
    replay scales by the current scale (its device tensor), so the steps
    equal the eager ones bit for bit."""
    import paddle_tpu_torch as pt
    x = torch.randn(8, 16, device="cuda", generator=gen)
    y = torch.randn(8, 4, device="cuda", generator=gen)
    runs = []
    for traced in (False, True):
        model, opt = _mlp_and_step(pt, 4, pt.optimizer.SGD,
                                   learning_rate=0.1)
        scaler = pt.amp.GradScaler(init_loss_scaling=2.0 ** 4,
                                   incr_every_n_steps=1)

        def step(a, b):
            loss = (model(a) - b).square().mean()
            scaler.scale(loss).backward()
            return loss.detach()

        fn = pt.jit.to_static(step) if traced else step
        for _ in range(5):
            fn(x, y)
            scaler.step(opt)
            opt.clear_grad()
        assert scaler._scale == 2.0 ** 9
        runs.append([p.detach().clone() for p in model.parameters()])
    assert fn.replays == 4
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ---------------------------------------------------------------------
# float16: every row's route on the card (auto_cast's default dtype)
# ---------------------------------------------------------------------
_F16 = torch.float16


def _f16(gen, *shape, scale=1.0):
    return (scale * torch.randn(*shape, device="cuda",
                                generator=gen)).to(_F16)


def _f16_norms(gen, n):
    rows = 37
    x = (2 * torch.randn(rows, n, device="cuda", generator=gen) + 1).to(_F16)
    gamma = (1 + 0.1 * torch.randn(n, device="cuda", generator=gen)).to(_F16)
    beta, dout = _f16(gen, n), _f16(gen, rows, n)
    r = _f16(gen, rows, n)
    got = ops.fused_layer_norm(x, gamma, beta)
    want = ops.layer_norm_ref(x, gamma, beta)
    yield got[0], want[0], _TOL[_F16]
    for a, b in zip(got[1:], want[1:]):
        yield a, b, 1e-4
    mu, rstd = want[1], want[2]
    for a, b in zip(ops.fused_layer_norm_bwd(x, gamma, mu, rstd, dout),
                    ops.layer_norm_bwd_ref(x, gamma, mu, rstd, dout)):
        yield a, b, _sum_tol(_F16, rows)
    for a, b in zip(ops.fused_layer_norm_residual(x, r, gamma, beta),
                    ops.layer_norm_residual_ref(x, r, gamma, beta)):
        yield a, b, _TOL[_F16] if a.dtype == _F16 else 1e-4
    got = ops.fused_rms_norm(x, gamma)
    want = ops.rms_norm_ref(x, gamma)
    yield got[0], want[0], _TOL[_F16]
    yield got[1], want[1], 1e-4
    for a, b in zip(ops.fused_rms_norm_bwd(x, gamma, want[1], dout),
                    ops.rms_norm_bwd_ref(x, gamma, want[1], dout)):
        yield a, b, _sum_tol(_F16, rows)


def _f16_epilogue(gen, n):
    M, K = 70, 136
    x, w, b = _f16(gen, M, K), _f16(gen, K, n, scale=K ** -0.5), \
        _f16(gen, n)
    for act in ops.ACTIVATIONS:
        got = ops.fused_linear_act(x, w, b, act, return_z=True)
        want = ops.linear_act_ref(x, w, b, act, return_z=True)
        for a, c in zip(got, want):
            yield a, c, _TOL[_F16]
        g = _f16(gen, M, n)
        for a, c in zip(ops.fused_linear_act_bwd(got[1], g, act),
                        ops.linear_act_bwd_ref(got[1], g, act)):
            yield a, c, _sum_tol(_F16, M)
    w_q = torch.randint(-127, 128, (K, n), device="cuda", generator=gen,
                        dtype=torch.int64).to(torch.int8)
    scale = (0.01 + 0.01 * torch.rand(n, device="cuda", generator=gen))
    for bias in (b, b.float()):
        yield (ops.fused_linear_act_int8(x, w_q, scale, bias, "gelu_tanh"),
               ops.linear_act_int8_ref(x, w_q, scale, bias, "gelu_tanh"),
               _TOL[_F16])


def _f16_xent(gen, n):
    rows = 33
    x = _f16(gen, rows, n, scale=3.0)
    labels = torch.randint(0, n, (rows,), device="cuda", generator=gen)
    labels[3] = -100
    got = ops.softmax_xent_fwd(x, labels)
    want = ops.softmax_xent_fwd_ref(x, labels)
    for a, c in zip(got, want):
        yield a, c, 1e-4
    g = torch.rand(rows, device="cuda", generator=gen)
    yield (ops.softmax_xent_bwd(x, labels, want[1], g),
           ops.softmax_xent_bwd_ref(x, labels, want[1], g), _TOL[_F16])


def _f16_flash(gen, n):
    for Sq, Sk, causal in ((70, 70, True), (1, 93, False)):
        q, k, v = (_f16(gen, 2, s, 2, n) for s in (Sq, Sk, Sk))
        out, lse = ops.fused_flash_attention_fwd(q, k, v, causal)
        w_out, w_lse = ops.flash_attention_ref(q, k, v, causal)
        yield out, w_out, _TOL[_F16]
        yield lse, w_lse, 1e-4
        do = _f16(gen, 2, Sq, 2, n)
        lse_b, delta = ops.flash_bwd_stats(w_out, do, w_lse)
        want = ops.flash_attention_bwd_ref(q, k, v, do, lse_b, delta, causal)
        yield (ops.fused_flash_attention_bwd_dq(q, k, v, do, lse_b, delta,
                                                causal), want[0], _TOL[_F16])
        for a, c in zip(ops.fused_flash_attention_bwd_dkv(
                q, k, v, do, lse_b, delta, causal), want[1:]):
            yield a, c, _TOL[_F16]


def _f16_attention(gen, n):
    bs, H, S = 16, 2, 3
    qlens, ctxs = [5, 1, 1], [40, 17, 1]
    block_q = ops.ragged_q_block(_F16)
    sid, qs, qv, _, _ = ops.ragged_segments(qlens, ctxs, block_q)
    nb = 1 + S * 3
    tables = torch.arange(1, nb, dtype=torch.int32,
                          device="cuda").view(S, 3)
    ints = [tables, torch.tensor(ctxs, dtype=torch.int32, device="cuda"),
            *(torch.as_tensor(a, device="cuda") for a in (sid, qs, qv))]
    q = _f16(gen, len(sid) * block_q, H, n)
    kp, vp = _f16(gen, nb, H, bs, n), _f16(gen, nb, H, bs, n)
    before = ops.ragged_paged_attention.f16_launches
    yield (ops.ragged_paged_attention(q, kp, vp, *ints),
           ops.ragged_attention_ref(q, kp, vp, *ints), _TOL[_F16])
    assert ops.ragged_paged_attention.f16_launches == before + 1
    ks = 0.01 + torch.rand(nb, bs, 1, device="cuda", generator=gen)
    vs = 0.01 + torch.rand(nb, bs, 1, device="cuda", generator=gen)
    k8 = torch.randint(-127, 128, kp.shape, device="cuda", generator=gen,
                       dtype=torch.int64).to(torch.int8)
    v8 = torch.randint(-127, 128, vp.shape, device="cuda", generator=gen,
                       dtype=torch.int64).to(torch.int8)
    yield (ops.ragged_paged_attention_int8(q, k8, v8, ks, vs, *ints),
           ops.ragged_attention_ref(q, k8, v8, *ints, k_scales=ks,
                                    v_scales=vs), _TOL[_F16])
    qd = _f16(gen, S, 1, H, n)
    yield (ops.paged_attention(qd, kp, vp, tables, ints[1]),
           ops.paged_attention_ref(qd, kp, vp, tables, ints[1]), _TOL[_F16])


def _f16_grouped(gen, n):
    E, K, bm = 3, 40, 16
    bg = torch.tensor([0, 0, 2, 3, 1], dtype=torch.int32, device="cuda")
    x = _f16(gen, len(bg) * bm, K)
    w, b = _f16(gen, E, K, n, scale=K ** -0.5), _f16(gen, E, n)
    for a, c in zip(
            ops.fused_grouped_linear_act(x, w, b, bg, "gelu",
                                         return_z=True),
            ops.grouped.fused_grouped_linear_act(x.cpu(), w.cpu(), b.cpu(),
                                                 bg.cpu(), "gelu",
                                                 return_z=True)):
        yield a, c, _TOL[_F16]
    bs = torch.sort(bg.clamp(max=E)).values
    dz = _f16(gen, len(bg) * bm, n)
    yield (ops.fused_grouped_dw(x, dz, bs, E),
           ops.grouped_dw_ref(x, dz, bs, E), _sum_tol(_F16, len(bg) * bm))
    L, r = 2, 8
    a_st = _f16(gen, L, K, r, scale=0.2)
    b_st = _f16(gen, L, r, n, scale=0.2)
    z = _f16(gen, len(bg) * bm, n)
    aid = torch.tensor([0, 2, 1, 1, 0], dtype=torch.int32, device="cuda")
    before = ops.fused_lora_segment_epilogue.f16_launches
    got = ops.fused_lora_segment_epilogue(z, x, a_st, b_st, aid, "silu")
    want = ops.lora.fused_lora_segment_epilogue(
        *(t.cpu() for t in (z, x, a_st, b_st, aid)), "silu")
    assert ops.fused_lora_segment_epilogue.f16_launches == before + 1
    for a, c in zip(got, want):
        yield a, c, _TOL[_F16]


_F16_ROWS = {"norms": _f16_norms, "epilogue": _f16_epilogue,
             "xent": _f16_xent, "flash": _f16_flash,
             "attention": _f16_attention, "grouped": _f16_grouped}


@pytest.mark.parametrize("n", [64, 72])
@pytest.mark.parametrize("rows", list(_F16_ROWS))
def test_float16_routes(gen, rows, n):
    """Every row's float16 route (rows 2, 6, 12, 13; 3, 7, 11; 8a/8b;
    4-5; 1, 9, 10; 14a/14b, 15) against its plain version on the same
    f16 inputs at `_TOL` [float16] (5e-3 abs + rel; column sums at
    `_sum_tol`; the f32 statistics at 1e-4), at a width of whole 16-byte
    vectors (64) and one off them on the vector routes' rule (72 is whole
    too for 2-byte types, so the ragged widths come from the row counts
    and the lengths); each call run twice, bit-identical."""
    cases = list(_F16_ROWS[rows](gen, n))
    assert cases
    for got, want, tol in cases:
        assert got.dtype == want.dtype
        torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                                   atol=tol, rtol=tol)
    again = list(_F16_ROWS[rows](
        torch.Generator(device="cuda").manual_seed(0), n))
    first = list(_F16_ROWS[rows](
        torch.Generator(device="cuda").manual_seed(0), n))
    for (a, _, _), (b, _, _) in zip(again, first):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------
# the rest of nn (chip_smoke.py phases 44-46 at small sizes)
# ---------------------------------------------------------------------
def _twin(make, device):
    """``make(device)`` with the weights of ``make("cpu")``."""
    cpu = make("cpu")
    card = make(device)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def _kernel_counts():
    return {k: f.launches for k, f in ops.KERNELS.items()}


def _close_to_max(got, want, tol=_TOL[torch.float32]):
    """Within ``tol`` of ``want``'s largest magnitude (at least 1): a
    recurrence's or a stack's sums run in other orders on the two
    devices."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= tol * max(float(want.abs().max()), 1.0), err


def _leaf(t, dev):
    return t.detach().to(dev).clone().requires_grad_()


def test_transformer_routes_on_the_card(gen):
    """A post-norm Transformer (64 wide, 4 heads, 2 + 2 layers) under the
    causal ``tgt_mask``: output and input gradients within f32's `_TOL`
    of the CPU twin's largest magnitudes, and one forward and backward
    launch the flash
    kernels for the 4 unmasked attentions, the epilogue for the 4
    feed-forward blocks and the residual layer norm for the 10
    sublayers, forward and backward."""
    import paddle_tpu_torch as pt
    cpu, card = _twin(lambda d: pt.nn.Transformer(
        64, 4, 2, 2, 128, dropout=0.0, device=d), "cuda")
    x = torch.randn(2, 20, 64, generator=gen, device="cuda")
    y = torch.randn(2, 24, 64, generator=gen, device="cuda")
    outs = []
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        xs, ys = (_leaf(t, dev) for t in (x, y))
        mask = model.generate_square_subsequent_mask(24, device=dev)
        before = _kernel_counts()
        out = model(xs, ys, tgt_mask=mask)
        out.square().sum().backward()
        counts = {k: v - before[k] for k, v in _kernel_counts().items()}
        outs.append((out, xs.grad, ys.grad, counts))
    for a, b in zip(outs[0][:3], outs[1][:3]):
        _close_to_max(a, b)
    want = {"flash_attention_fwd": 4, "flash_attention_bwd_dq": 4,
            "flash_attention_bwd_dkv": 4, "matmul_epilogue": 4,
            "matmul_epilogue_bwd": 4, "layer_norm_residual": 10,
            "layer_norm_bwd": 10}
    assert {k: v for k, v in outs[0][3].items() if v} == want
    assert not any(outs[1][3].values()), "a CPU call is not a launch"


def test_transformer_cached_decoding_on_the_card(gen):
    """Cached decoding (flash with one query row a step) gives the
    tokens of the full recompute under the causal mask and of the CPU."""
    import paddle_tpu_torch as pt
    cpu, card = _twin(lambda d: pt.nn.Transformer(
        64, 4, 2, 2, 128, dropout=0.0, device=d).eval(), "cuda")
    emb = torch.randn(50, 64, generator=gen, device="cuda")
    src = torch.randn(3, 10, 64, generator=gen, device="cuda")

    def decode(model, dev, cached):
        e, s = emb.to(dev), src.to(dev)
        with torch.no_grad():
            mem = model.encoder(s)
            caches = model.decoder.gen_cache(mem) if cached else None
            toks = torch.zeros(3, 1, dtype=torch.long, device=dev)
            for t in range(8):
                if cached:
                    h, caches = model.decoder(e[toks[:, -1:]], mem,
                                              cache=caches)
                else:
                    mask = model.generate_square_subsequent_mask(t + 1,
                                                                 device=dev)
                    h = model.decoder(e[toks], mem, tgt_mask=mask)
                toks = torch.cat([toks, (h[:, -1] @ e.T).argmax(
                    -1, keepdim=True)], 1)
        return toks.cpu()

    before = ops.KERNELS["flash_attention_fwd"].launches
    got = decode(card, "cuda", True)
    assert ops.KERNELS["flash_attention_fwd"].launches - before == \
        2 + 2 * 2 * 8
    assert torch.equal(got, decode(card, "cuda", False))
    assert torch.equal(got, decode(cpu, "cpu", True))


@pytest.mark.parametrize("cls", ["LSTM", "GRU", "SimpleRNN"])
def test_rnn_layers_on_the_card(gen, cls, monkeypatch):
    """The whole-sequence layers (cuDNN, TF32 off as in ``chip_smoke.py``)
    bidirectional over 2 layers with ``sequence_length``: outputs, final
    states and the input's gradient within f32's `_TOL` of the CPU twin's
    largest magnitude; the card's weights are views into one flat buffer
    (cuDNN reads them in place), built on the card or moved there; under
    O2 bf16 the LSTM runs in bf16 on the card."""
    import paddle_tpu_torch as pt
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cpu, card = _twin(lambda d: getattr(pt.nn, cls)(
        16, 32, 2, direction="bidirect", device=d), "cuda")
    x = torch.randn(5, 12, 16, generator=gen, device="cuda")
    lens = torch.tensor([12, 3, 7, 12, 1])
    res = []
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        xs = _leaf(x, dev)
        out, state = model(xs, sequence_length=lens.to(dev))
        out.square().sum().backward()
        states = state if isinstance(state, tuple) else (state,)
        res.append([out, *states, xs.grad])
    for a, b in zip(*res):
        _close_to_max(a, b)
    moved = copy.deepcopy(cpu).cuda()
    moved(x, sequence_length=lens.cuda())
    for model in (card, moved):
        assert len({p.untyped_storage().data_ptr()
                    for p in model.parameters()}) == 1
    if cls == "LSTM":
        with pt.amp.auto_cast(level="O2", dtype="bfloat16"):
            out, _ = card(x)
        assert out.dtype == torch.bfloat16


def test_common_functionals_on_the_card(gen):
    """Resizes, padding, grid sampling and fold on the card against the
    CPU in f32 (`_TOL` of the largest magnitude), forward and input
    gradient."""
    import paddle_tpu_torch as pt
    F = pt.nn.functional
    x = torch.randn(2, 3, 17, 19, generator=gen, device="cuda")
    grid = torch.rand(2, 5, 6, 2, generator=gen, device="cuda") * 2.4 - 1.2
    cases = [
        lambda t: F.interpolate(t, size=[7, 9], mode="bicubic"),
        lambda t: F.interpolate(t, size=[30, 40], mode="bilinear",
                                align_corners=True),
        lambda t: F.interpolate(t[:, :, None].expand(2, 3, 4, 17, 19),
                                size=[3, 9, 8], mode="trilinear",
                                data_format="NCDHW"),
        lambda t: F.pad(t, [1, 0, 0, 1, 2, 3, 1, 1], mode="reflect"),
        lambda t: F.grid_sample(t, grid.to(t.device),
                                padding_mode="reflection"),
        lambda t: F.fold(F.unfold(t, 3, paddings=1), [17, 19], 3,
                         paddings=1),
    ]
    for fn in cases:
        res = []
        for dev in ("cuda", "cpu"):
            xs = _leaf(x, dev)
            out = fn(xs)
            out.square().sum().backward()
            res.append((out, xs.grad))
        for a, b in zip(*res):
            _close_to_max(a, b)


def test_beam_search_on_the_card(gen):
    """``dynamic_decode`` over an ``LSTMCell``, beam 4: tokens and
    lengths equal to the CPU's."""
    import paddle_tpu_torch as pt
    res = []
    for dev in ("cpu", "cuda"):
        g = torch.Generator().manual_seed(1)
        emb = pt.nn.Embedding(40, 16, device="cpu", generator=g).to(dev)
        cell = pt.nn.LSTMCell(16, 16, device="cpu", generator=g).to(dev)
        proj = pt.nn.Linear(16, 40, device="cpu", generator=g).to(dev)
        dec = pt.nn.BeamSearchDecoder(cell, 0, 39, 4, embedding_fn=emb,
                                      output_fn=proj)
        h0 = torch.linspace(-1, 1, 3 * 16).reshape(3, 16).to(dev)
        with torch.no_grad():
            res.append([t.cpu() for t in pt.nn.dynamic_decode(
                dec, inits=(h0, h0 * 0.5), max_step_num=12)])
    assert torch.equal(res[0][0], res[1][0])
    assert torch.equal(res[0][1], res[1][1])
