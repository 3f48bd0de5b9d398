"""The port's kernel modules, held against the JAX package's Pallas kernels.

Each plain PyTorch version in ``paddle_tpu_torch.ops`` (what the kernel
wrappers run on CPU tensors) is compared with the reference's Pallas
entry point called directly, in interpret mode on the CPU, as
``tests/test_pallas_kernels.py`` calls it.  Inputs are made from a seed
with numpy and handed to both.

Tolerances: f32 2e-5 abs/rel for attention (the reference's own
kernel-vs-composite tolerance), 1e-5 for layer norm and 2e-4 for the
matmul epilogue (a K-long f32 sum taken in another order).  bf16 2e-2
(about two bf16 ulps at unit scale): for attention the port's plain
version rounds the probabilities to bf16 before the PV product, as the
reference's composite does, while the Pallas kernel keeps them in f32.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import pallas_fused as pf
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.ops import pallas_ragged as pr
from paddle_tpu_torch import ops as tops

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _both(a, dtype):
    """One f32 numpy array as (jax array, torch CPU tensor) of dtype."""
    return (jnp.asarray(a).astype(_JAX[dtype]),
            torch.from_numpy(a).to(_TORCH[dtype]))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ---------------------------------------------------------------------
# ragged paged attention
# ---------------------------------------------------------------------
#: the shapes of tests/test_pallas_kernels.py `_RAGGED_CASES` plus the
#: null-segment case: (query_lens, context_lens, pad q-blocks)
_RAGGED_CASES = {
    "pure_decode": ([1, 1, 1], [60, 17, 5], 0),
    "pure_prefill": ([20], [20], 0),
    "mixed": ([12, 1, 1], [30, 25, 9], 0),
    "chunk_boundary": ([16, 1], [48, 33], 0),
    # a ctx-0 sequence with no queries plus trailing null q-blocks
    "null_and_ctx0": ([1, 0], [25, 0], 2),
}


def _ragged_inputs(query_lens, context_lens, pad_blocks, dtype, seed=30,
                   H=4, D=32, bs=16, W=4):
    block_q = pr.ragged_q_block(_JAX[dtype])
    assert block_q == tops.ragged_q_block(_TORCH[dtype])
    S = len(query_lens)
    sid = tops.ragged_segments(query_lens, context_lens, block_q)[0]
    nqb = len(sid) + pad_blocks
    sid, qs, qv, _, _ = tops.ragged_segments(
        query_lens, context_lens, block_q, num_q_blocks=nqb, num_seqs=S)
    rng = np.random.default_rng(seed)
    nb = S * W + 1
    q = rng.standard_normal((nqb * block_q, H, D), np.float32)
    k = rng.standard_normal((nb, H, bs, D), np.float32)
    v = rng.standard_normal((nb, H, bs, D), np.float32)
    tables = np.zeros((S, W), np.int32)
    for s, ctx in enumerate(context_lens):
        for w in range(-(-int(ctx) // bs)):
            tables[s, w] = 1 + s * W + w
    ints = [tables, np.asarray(context_lens, np.int32), sid, qs, qv]
    return block_q, (q, k, v), ints


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_RAGGED_CASES))
def test_ragged_attention_plain_matches_pallas(case, dtype):
    qls, ctxs, pad = _RAGGED_CASES[case]
    block_q, floats, ints = _ragged_inputs(qls, ctxs, pad, dtype)
    jf, tf = zip(*(_both(a, dtype) for a in floats))
    scale = 1.0 / floats[0].shape[-1] ** 0.5
    ref = pr.ragged_paged_attention(*jf, *(jnp.asarray(a) for a in ints),
                                    block_q=block_q, scale=scale)
    got = tops.ragged_paged_attention(
        *tf, *(torch.from_numpy(a) for a in ints), block_q=block_q,
        scale=scale)
    assert got.dtype == _TORCH[dtype] and got.shape == tf[0].shape
    tol = _TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(ref), atol=tol, rtol=tol)
    if case == "null_and_ctx0":
        # everything past the one decode q-block is padding: exact zeros
        assert float(got[block_q:].abs().sum()) == 0.0


@pytest.mark.parametrize("args", [
    ([12, 1, 0, 1], [30, 25, 7, 9], 8, 6),
    ([1, 1, 1], [60, 17, 5], 16, None),
    ([256, 1, 1, 1], [768, 520, 529, 600], 16, 23),
    ([20], [20], 8, None),
])
def test_ragged_segments_identical(args):
    qls, ctxs, block_q, nqb = args
    ref = pr.ragged_segments(qls, ctxs, block_q, num_q_blocks=nqb)
    got = tops.ragged_segments(qls, ctxs, block_q, num_q_blocks=nqb)
    for a, b in zip(ref[:4], got[:4]):
        assert a.dtype == b.dtype and a.tolist() == b.tolist()
    assert ref[4] == got[4]
    with pytest.raises(ValueError):
        tops.ragged_segments([12], [30], 8, num_q_blocks=1)
    with pytest.raises(ValueError):
        tops.ragged_segments([31], [30], 8)       # query > context


# ---------------------------------------------------------------------
# layer norm
# ---------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_plain_matches_pallas(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((37, 96), np.float32) * 3 + 1
    gamma = rng.standard_normal(96, np.float32) + 1
    beta = rng.standard_normal(96, np.float32)
    (jx, tx), (jg, tg), (jb, tb) = (_both(a, dtype) for a in (x, gamma, beta))
    out_ref, (_, _, mu_ref, rstd_ref) = pk._fused_layer_norm_2d_fwd(
        jx, jg, jb, 1e-5)
    out, mu, rstd = tops.fused_layer_norm(tx, tg, tb, eps=1e-5)
    assert out.dtype == _TORCH[dtype] and mu.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else _TOL[dtype]
    np.testing.assert_allclose(_np(out), _np(out_ref), atol=tol, rtol=tol)
    # the Pallas kernel broadcasts each row's stat over 8 lanes
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_ref)[:37, 0],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rstd_ref)[:37, 0],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        _np(out), _np(pk.fused_layer_norm(jx, jg, jb, eps=1e-5)),
        atol=tol, rtol=tol)


# ---------------------------------------------------------------------
# matmul epilogue
# ---------------------------------------------------------------------
@pytest.mark.parametrize("act", tops.ACTIVATIONS)
def test_matmul_epilogue_plain_matches_pallas(act):
    assert tops.ACTIVATIONS == pf.ACTIVATIONS
    rng = np.random.default_rng(28)
    x = rng.standard_normal((40, 96), np.float32)
    w = rng.standard_normal((96, 64), np.float32) * 0.1
    b = rng.standard_normal(64, np.float32)
    ref = pf.fused_linear_act(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(b), act)
    got, z = tops.fused_linear_act(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b), act, return_z=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(z.numpy(), x @ w + b, atol=2e-4, rtol=2e-4)


def test_matmul_epilogue_bf16_multiblock_plain_matches_pallas():
    rng = np.random.default_rng(29)
    x = rng.standard_normal((300, 128), np.float32)
    w = rng.standard_normal((128, 640), np.float32) * 0.1
    b = rng.standard_normal(640, np.float32)
    (jx, tx), (jw, tw), (jb, tb) = (_both(a, "bfloat16") for a in (x, w, b))
    ref = pf.fused_linear_act(jx, jw, jb, "gelu_tanh")
    got = tops.fused_linear_act(tx, tw, tb, "gelu_tanh")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(ref), atol=2e-2, rtol=2e-2)


def test_matmul_epilogue_split_k_choice():
    """Split-K only where the 64x64 output tiles cannot fill the card
    (132 SMs, 6 tiles each): a serving step's out and fc2 GEMMs (192
    tiles) take 4 chunks, qkv and fc1 (576 and 768 tiles) and the
    training shape none; every chunk sums at least 4 slices of 32."""
    from paddle_tpu_torch.ops.matmul_epilogue import split_k
    cases = {(368, 2048, 6144): 1, (368, 2048, 2048): 4,
             (368, 2048, 8192): 1, (368, 8192, 2048): 4,
             (4096, 2048, 8192): 1, (4, 2048, 8192): 6, (70, 200, 130): 1,
             (5, 17, 9): 1, (88, 8192, 2048): 12, (1, 1 << 20, 64): 16}
    for (m, k, n), want in cases.items():
        got = split_k(m, k, n, 132)
        assert got == want, (m, k, n, got)
        assert got == 1 or -(-k // 32) // got >= 4


def test_wrappers_refuse_other_devices():
    x = torch.zeros(2, 4, device="meta")
    with pytest.raises(RuntimeError):
        tops.fused_layer_norm(x, torch.ones(4), torch.zeros(4))
    with pytest.raises(RuntimeError):
        tops.fused_linear_act(x, torch.ones(4, 4), torch.zeros(4))
    with pytest.raises(ValueError):
        tops.fused_linear_act(torch.zeros(2, 4), torch.ones(4, 4),
                              torch.zeros(4), act="tanh")
