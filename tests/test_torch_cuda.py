"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (sm_90a, the kernels are built for
Hopper) and ``nvcc``; without a CUDA device each one skips.  The file
imports torch and the port only, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

Small shapes with ragged edges; the main path's shapes are covered by
``chip_smoke.py``.  Tolerances: f32 1e-4 abs + rel (sums in another
order), bf16 2e-2 abs + rel (about two bf16 ulps at unit scale).  bf16
ragged attention is also held to the plain version run in f32, which
keeps the probabilities in f32 as the kernel does, within one bf16 ulp
(rtol 2^-7) plus 2^-8 of the output's RMS.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import ops

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
