"""The CUDA source of ragged paged attention (rows 1 and 10), run on the
CPU against its plain version.

``paddle_tpu_torch/csrc/ragged_attention.cu`` is compiled with g++
against the CPU stand-in for the CUDA device language (``tests/cuda_emu``:
one thread per CUDA thread, block and warp barriers, ``mma.cuh``'s PTX
replaced by functions following the PTX fragment layouts; see
``tests/test_torch_flash_emulated.py``) and called through the same C
entry points and signatures as the card's library.  The tensor-core
route's four instantiations (bf16 and int8 pools, heads of 64 and 128):
decode rows at contexts 1, 16, 17 and 70 (one tile, so 3 of the 4 warps
hold an empty state, for the first two), a prefill chunk that starts
mid-context and ends on a page edge (its second q-block has 8 valid
rows), pages of 32 slots (two 16-key tiles a page), null-segment padding
(exact zeros), a q-block whose context is 0 (exact zeros), block tables
scattered over the pool, int8 pools with a different scale in every
slot.  The CUDA-core routes (f32, and bf16 at D = 40) through the same
entry points; the route rule against the Python copy.  Tolerances as on
the card (``tests/test_torch_cuda.py``): bf16 2e-2 abs + rel against the
plain version, and 2^-8 of the output's RMS + 2^-7 relative against the
plain version run in f32 (which keeps the probabilities in f32, as the
kernel does); f32 1e-4.  Outputs start as NaN, so a missed element
shows; every case runs twice and the two runs are bit-identical.  Copies
of the source with one warp's partial state dropped from the merge, or
with masked entries giving p = exp(0) in a row the warp has seen nothing
of yet, fail these checks.  The stand-in copies synchronously: it checks
layouts, masks, the split walk and the merge, not speed; the card tests
and ``chip_smoke.py`` do that.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import cuda_lib
from paddle_tpu_torch.ops.ragged import mma_route
from cuda_emu_build import build_emulated

_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 5e-3}
_F32P_TOL = (2.0 ** -8, 2.0 ** -7)   # (x RMS, relative)


def _build(tmp_path_factory, source):
    """The stand-in library of ``source`` (the text of ragged_attention.cu)."""
    return build_emulated(tmp_path_factory, "ragged", {"ragged_attention.cu": source})


def _source():
    return (cuda_lib.SRC_DIR / "ragged_attention.cu").read_text()


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(tmp_path_factory, _source())


def _quantize(pool):
    """Per-slot int8 codes [nb, H, bs, D] and f32 scales [nb, bs, 1]: one
    abs-max over each slot's (H, D), as the quantizing KV scatter."""
    f = pool.float()
    amax = f.abs().amax(dim=(1, 3))
    sc = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.clamp(torch.round(f / sc[:, None, :, None]), -127, 127)
    return codes.to(torch.int8), sc[..., None].contiguous()


def _inputs(qlens, ctxs, pad, D, dtype, int8, bs=16, H=2, ctx0=False,
            seed=0):
    """A ragged step: ``ragged_segments`` of (qlens, ctxs) padded with
    ``pad`` null q-blocks, with ``ctx0`` one more q-block of a sequence
    whose context is 0; block tables scattered over the pool; int8 pools
    with a magnitude (so a scale) of their own in every slot."""
    block_q = ops.ragged_q_block(dtype)
    S = len(qlens) + ctx0
    sid, qs, qv, _, _ = ops.ragged_segments(qlens, ctxs, block_q,
                                            num_seqs=S)
    if ctx0:   # the descriptors of a query row at position 0, context 0
        sid, qs, qv = (np.append(a, x) for a, x in
                       ((sid, S - 1), (qs, 0), (qv, 1)))
    sid, qs, qv = (np.append(a, [x] * pad).astype(np.int32) for a, x in
                   ((sid, S), (qs, 0), (qv, 0)))
    ctx_all = list(ctxs) + [0] * ctx0
    W = max(1, max(-(-c // bs) for c in ctx_all))
    rng = np.random.default_rng(seed)
    nb = 1 + S * W
    perm = 1 + rng.permutation(nb - 1)
    tables = np.zeros((S, W), np.int32)
    for s, c in enumerate(ctx_all):
        n = -(-c // bs)
        tables[s, :n] = perm[s * W:s * W + n]
    g = torch.Generator().manual_seed(seed)
    nqb = len(sid)
    q = torch.randn(nqb * block_q, H, D, generator=g).to(dtype)
    kw = dict(block_q=block_q)
    pools = []
    for _ in range(2):
        f = torch.randn(nb, H, bs, D, generator=g)
        if int8:
            f = f * (0.1 + 3 * torch.rand(nb, 1, bs, 1, generator=g))
            codes, sc = _quantize(f)
            pools.append(codes)
            kw.setdefault("k_scales", sc)
            kw["v_scales"] = sc
        else:
            pools.append(f.to(dtype))
    if int8:
        assert kw["k_scales"].unique().numel() == nb * bs
    ints = [torch.from_numpy(a) for a in
            (tables, np.asarray(ctx_all, np.int32), sid, qs, qv)]
    return q, pools, ints, kw


def _fwd(lib, q, pools, ints, kw):
    """The entry point on CPU tensors, into a NaN-filled output."""
    T, H, D = q.shape
    k, v = pools
    tables = ints[0]
    out = torch.full_like(q, float("nan"))
    geo = (ints[2].shape[0], tables.shape[0], H, D, k.shape[2],
           tables.shape[1], kw["block_q"], D ** -0.5,
           cuda_lib.dtype_code(q.dtype), 0, None)
    ptrs = [t.data_ptr() for t in ints]
    if "k_scales" in kw:
        rc = lib.ptt_ragged_attention_int8_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kw["k_scales"].data_ptr(), kw["v_scales"].data_ptr(), *ptrs,
            out.data_ptr(), *geo)
    else:
        rc = lib.ptt_ragged_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs,
            out.data_ptr(), *geo)
    assert rc == 0
    return out


def _check(lib, q, pools, ints, kw):
    """One case against the plain version (and, in bf16, against it in
    f32), null and context-0 rows exact zeros, run twice and
    bit-identical."""
    out = _fwd(lib, q, pools, ints, kw)
    want = ops.ragged_attention_ref(q, *pools, *ints, **kw)
    dt = q.dtype
    torch.testing.assert_close(out.float(), want.float(), atol=_TOL[dt],
                               rtol=_TOL[dt])
    if dt == torch.bfloat16:
        pools32 = pools if "k_scales" in kw else [p.float() for p in pools]
        want32 = ops.ragged_attention_ref(q.float(), *pools32, *ints, **kw)
        rms = float(want32.pow(2).mean().sqrt())
        torch.testing.assert_close(out.float(), want32,
                                   atol=_F32P_TOL[0] * rms,
                                   rtol=_F32P_TOL[1])
    tables, ctxs, sid, _, qv = ints
    bq = kw["block_q"]
    for i in range(sid.shape[0]):
        s = int(sid[i])
        if s >= tables.shape[0] or int(ctxs[s]) == 0:
            assert float(out[i * bq:(i + 1) * bq].abs().max()) == 0.0
        elif int(qv[i]) < bq:   # rows past q_valids are zeros too
            assert float(out[i * bq + int(qv[i]):(i + 1) * bq]
                         .abs().max()) == 0.0
    again = _fwd(lib, q, pools, ints, kw)
    assert torch.equal(again, out)
    k, v = pools
    return mma_route(q, k, v, out, bq, kw.get("k_scales"),
                     kw.get("v_scales"))


#: (name, qlens, ctxs, pad, bs, ctx0)
_CASES = [
    # decode rows: contexts 1 and 16 are one tile (warps 1-3 empty), 17
    # two, 70 five (every warp, warp 0 twice); a null q-block; a q-block
    # of a sequence at context 0
    ("decode", [1, 1, 1, 1], [1, 16, 17, 70], 1, 16, True),
    # a 24-token prefill chunk at positions 24..47 (ends on the page edge
    # 48; its second q-block has 8 valid rows) beside a decode row
    ("prefill", [24, 1], [48, 33], 1, 16, False),
    # pages of 32 slots: two 16-key tiles a page
    ("pages32", [1, 20], [50, 40], 0, 32, False),
]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name,qlens,ctxs,pad,bs,ctx0", _CASES,
                         ids=[c[0] for c in _CASES])
def test_ragged_mma_emulated(lib, name, qlens, ctxs, pad, bs, ctx0, int8,
                             D):
    q, pools, ints, kw = _inputs(qlens, ctxs, pad, D, torch.bfloat16, int8,
                                 bs=bs, ctx0=ctx0, seed=D + 7 * int8)
    assert _check(lib, q, pools, ints, kw)


@pytest.mark.parametrize("dtype,D", [(torch.float32, 64),
                                     (torch.bfloat16, 40),
                                     (torch.float16, 64),
                                     (torch.float16, 40)])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_ragged_cuda_core_routes_emulated(lib, dtype, D, int8):
    """f32 and f16 queries, and bf16 at D = 40, take the CUDA-core kernel
    through the same entry points."""
    q, pools, ints, kw = _inputs([1, 12], [40, 30], 1, D, dtype, int8,
                                 ctx0=True, seed=3)
    assert not _check(lib, q, pools, ints, kw)


def test_ragged_route_rule_emulated(lib):
    """The wrapper's Python copy of the route rule (`mma_route`) answers
    as the library's ``ptt_ragged_attention_mma_route``: dtype, D, pages
    off 16 slots, block_q, a misaligned view, the int8 scale tables."""
    def both(D=128, dtype=torch.bfloat16, bs=16, block_q=16, shift=0,
             scales=False, scale_shift=0):
        q = torch.zeros(4 * block_q * D + 8, dtype=dtype)[
            shift:shift + 4 * block_q * D].view(4 * block_q, 1, D)
        pool = torch.zeros(3, 1, bs, D, dtype=dtype)
        out = torch.zeros(4 * block_q, 1, D, dtype=dtype)
        sc = torch.zeros(3 * bs + 4)[scale_shift:scale_shift + 3 * bs] \
            if scales else None
        ts = (q, pool, pool, sc, sc, out)
        lib_says = bool(lib.ptt_ragged_attention_mma_route(
            *(None if t is None else t.data_ptr() for t in ts), D, bs,
            block_q, cuda_lib.dtype_code(dtype)))
        assert mma_route(q, pool, pool, out, block_q, sc, sc) == lib_says
        return lib_says
    assert both() and both(D=64) and both(bs=32) and both(scales=True)
    assert not both(D=96) and not both(D=40) and not both(D=256)
    assert not both(bs=8) and not both(bs=24)
    assert not both(dtype=torch.float32, block_q=8)
    assert not both(dtype=torch.float16) and not both(dtype=torch.float16,
                                                      D=64)
    assert not both(block_q=32)
    assert not both(shift=1)
    assert not both(scales=True, scale_shift=1)


#: (what, text in the tensor-core kernel, its replacement): copies of the
#: source that these tests must reject
_MUTATIONS = [
    ("warp 0's partial state dropped from the merge",
     "  for (int w = 0; w < kMmaWarps; ++w) {\n      // an empty state",
     "  for (int w = 1; w < kMmaWarps; ++w) {\n      // an empty state"),
    ("masked entries give p = exp(0) where the warp has seen nothing",
     "s[jj][e] == -INFINITY ? 0.f : exp2f(s[jj][e] - m_new[e >> 1]);",
     "exp2f((s[jj][e] == -INFINITY ? kNegInf : s[jj][e]) - "
     "m_new[e >> 1]);"),
]


@pytest.mark.parametrize("what,old,new", _MUTATIONS,
                         ids=[m[0] for m in _MUTATIONS])
def test_ragged_mutations_fail_emulated(tmp_path_factory, what, old, new):
    """A copy of the source with ``what`` fails the checks above on the
    tensor-core cases at D = 64 (a wrong value, or a padding row that is
    not zero)."""
    src = _source()
    assert src.count(old) == 1, f"the kernel no longer has: {old!r}"
    broken = _build(tmp_path_factory, src.replace(old, new))
    failed = 0
    for _, qlens, ctxs, pad, bs, ctx0 in _CASES:
        for int8 in (False, True):
            try:
                _check(broken, *_inputs(qlens, ctxs, pad, 64,
                                        torch.bfloat16, int8, bs=bs,
                                        ctx0=ctx0))
            except AssertionError:
                failed += 1
    assert failed, f"{what}: every case passed"
