"""The CUDA source of paged decode attention (row 9), run on the CPU
against its plain version.

``paddle_tpu_torch/csrc/paged_attention.cu`` is compiled with g++
against the CPU stand-in for the CUDA device language
(``tests/cuda_emu``: one thread per CUDA thread, block and warp
barriers, blocks one after another in order or in a seeded random order;
see ``tests/test_torch_flash_emulated.py``) and called through the same
C entry points and signatures as the card's library.  The vector route at
heads of 40 (lanes of a row left idle), 64, 128 and 256 (two vectors a
lane in f32), f32 and bf16, pages of 16 and 32 slots: contexts 0 (exact
zeros), 1, 16 and 17 (one page and one key past it), and 161-300 (many
tiles, several splits of the key walk); block tables scattered over the
pool, their padding entries pointing at a page of NaNs that must never
show, rows staged whole and (4100 wide) by each block's run; the splits
the library picks for the stand-in's 132-SM device 0 (the wrapper's
cached count, `split_count`, equal to it for every case, asked once a
shape), and forced ones: 1 (no merge), 3 and 32 (splits with no visible
key, which weigh 0).  The
element-wise route (bf16 heads off 16 bytes, a misaligned view) through
the same entry point; the route rule against the Python copy.  Tolerances
as on the card (``tests/test_torch_cuda.py``): bf16 2e-2 abs + rel
against the plain version, and 2^-8 of the output's RMS + 2^-7 relative
against the plain version run in f32 (which keeps the probabilities in
f32, as the kernel does); f32 1e-4.  Outputs start as NaN, so a missed
element shows; every case runs twice, the second time with the blocks in
another order, and the two outputs are bit-identical; the merge's
counters are 0 again after every launch.  Copies of the source with one
split's state, or one warp's, dropped from the merge fail these checks.
The stand-in runs blocks one at a time and loads synchronously: it
checks indexing, masks, the split walk and the merges, not speed; the
card tests and ``chip_smoke.py`` do that.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import cuda_lib
from paddle_tpu_torch.ops import paged
from paddle_tpu_torch.ops.paged import split_count, vector_route
from cuda_emu_build import build_emulated

_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 5e-3}
_F32P_TOL = (2.0 ** -8, 2.0 ** -7)   # (x RMS, relative)
_H = 2


def _build(tmp_path_factory, source):
    """The stand-in library of ``source`` (the text of paged_attention.cu)."""
    return build_emulated(tmp_path_factory, "paged", {"paged_attention.cu": source})


def _source():
    return (cuda_lib.SRC_DIR / "paged_attention.cu").read_text()


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(tmp_path_factory, _source())


def _inputs(ctxs, bs, D, dtype, seed=0, extra_pages=2):
    """A decode step: block tables scattered over the pool, ``extra_pages``
    padding entries past the longest context; page 0 holds NaNs and every
    padding entry points at it.  Returns (q, k, v, tables, ctx) and the
    pools with page 0 zeroed (the plain version multiplies padding rows by
    a probability of 0, which a NaN would turn into NaN)."""
    B = len(ctxs)
    W = max(-(-c // bs) for c in ctxs) + extra_pages
    rng = np.random.default_rng(seed)
    nb = 1 + sum(-(-c // bs) for c in ctxs) + 2
    perm = 1 + rng.permutation(nb - 1)
    tables = np.zeros((B, W), np.int32)
    used = 0
    for i, c in enumerate(ctxs):
        n = -(-c // bs)
        tables[i, :n] = perm[used:used + n]
        used += n
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, 1, _H, D, generator=g).to(dtype)
    pools, clean = [], []
    for _ in range(2):
        f = torch.randn(nb, _H, bs, D, generator=g).to(dtype)
        f[0] = float("nan")
        pools.append(f)
        c = f.clone()
        c[0] = 0
        clean.append(c)
    ints = (torch.from_numpy(tables), torch.tensor(ctxs, dtype=torch.int32))
    return (q, *pools, *ints), (q, *clean, *ints)


def _fwd(lib, args, splits=None, order=0, device=0):
    """The entry point on CPU tensors, into a NaN-filled output; the
    library's splits for the stand-in's ``device`` unless given.  Returns
    (out, splits); the merge's counters must be 0 again."""
    q, k, v, tables, ctx = args
    B, _, H, D = q.shape
    bs, W = k.shape[2], tables.shape[1]
    code = cuda_lib.dtype_code(q.dtype)
    if splits is None:
        splits = lib.ptt_paged_attention_splits(B, H, D, bs, W, code,
                                                device)
        # the wrapper's cached count is the library's answer
        assert split_count(lib, B, H, D, bs, W, code, device) == splits
    out = torch.full_like(q, float("nan"))
    partial = torch.full((B * H * splits * (D + 2),), float("nan"))
    tickets = torch.zeros(B * H, dtype=torch.int32)
    lib.emu_set_block_order(order)
    try:
        rc = lib.ptt_paged_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), tables.data_ptr(),
            ctx.data_ptr(), out.data_ptr(), partial.data_ptr(),
            tickets.data_ptr(), B, H, D, bs, W, splits, D ** -0.5, code,
            device, None)
    finally:
        lib.emu_set_block_order(0)
    assert rc == 0
    assert not tickets.any(), "the merge's counters were not reset"
    return out, splits


def _check(lib, args, clean, splits=None, device=0):
    """One case against the plain version (and, in bf16, against it in
    f32), context-0 rows exact zeros, run twice (the blocks in another
    order the second time) and bit-identical.  Returns the splits."""
    out, splits = _fwd(lib, args, splits, device=device)
    q, k, v, tables, ctx = clean
    want = ops.paged_attention_ref(*clean)
    dt = q.dtype
    torch.testing.assert_close(out.float(), want.float(), atol=_TOL[dt],
                               rtol=_TOL[dt])
    if dt == torch.bfloat16:
        want32 = ops.paged_attention_ref(q.float(), k.float(), v.float(),
                                         tables, ctx)
        rms = float(want32.pow(2).mean().sqrt())
        torch.testing.assert_close(out.float(), want32,
                                   atol=_F32P_TOL[0] * rms,
                                   rtol=_F32P_TOL[1])
    for i, c in enumerate(ctx.tolist()):
        if c == 0:
            assert float(out[i].abs().max()) == 0.0
    again, _ = _fwd(lib, args, splits, order=12345, device=device)
    assert torch.equal(again, out)
    return splits


_CTXS = {"short": [0, 1, 16, 17], "long": [300, 5, 0, 161]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [40, 64, 128, 256])
@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("ctxs", list(_CTXS), ids=list(_CTXS))
def test_paged_vector_route_emulated(lib, ctxs, bs, D, dtype):
    args, clean = _inputs(_CTXS[ctxs], bs, D, dtype, seed=D + bs)
    q, k, v = args[:3]
    assert vector_route(q, k, v, torch.empty_like(q))
    splits = _check(lib, args, clean)
    if ctxs == "long":
        assert splits > 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("splits", [1, 3, 32])
def test_paged_forced_splits_emulated(lib, splits, dtype):
    """Splits given to the entry point: one (the block writes the output),
    and more than the short contexts have tiles (splits with no visible
    key: weight 0), pages of 8 slots."""
    args, clean = _inputs([1, 40, 0, 129], 8, 64, dtype, seed=splits)
    assert _check(lib, args, clean, splits=splits) == splits


@pytest.mark.parametrize("ctxs,D", [("short", 40), ("short", 128)])
def test_paged_vector_route_f16_emulated(lib, ctxs, D):
    """f16 on the vector route (80- and 256-byte rows): bf16's
    instantiations, f16 loads."""
    test_paged_vector_route_emulated(lib, ctxs, 16, D, torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_wide_table_emulated(lib, dtype):
    """Tables 4100 entries wide (past the 4096 staged whole): each block
    stages only its run's page ids, once the context length is in."""
    args, clean = _inputs([40, 0, 300], 16, 128, dtype, seed=9,
                          extra_pages=4100 - 19)
    assert args[3].shape[1] == 4100
    assert _check(lib, args, clean) > 1


def test_paged_splits_follow_the_card_emulated(lib):
    """The split rule: one block a pair on a one-SM device, more on the
    stand-in's 132 SMs, none past a tile a warp at the table's width, at
    most 32."""
    code = cuda_lib.dtype_code(torch.bfloat16)
    splits = lib.ptt_paged_attention_splits
    assert splits(4, 2, 128, 16, 13, code, 1) == 1
    assert splits(4, 2, 128, 16, 13, code, 132) == 13  # 52 tiles of 4 keys
    assert splits(4, 2, 128, 16, 1000, code, 0) == 16  # 132 SMs, 8 pairs
    assert splits(1, 1, 128, 16, 1000, code, 0) == 32
    assert splits(4, 2, 128, 16, 0, code, 0) == 1
    args, clean = _inputs([300, 5, 0, 161], 16, 128, torch.bfloat16)
    assert _check(lib, args, clean, device=1) == 1


def test_paged_split_cache_emulated(lib):
    """The wrapper asks the library for the splits once a (B, H, D, block
    size, table width, dtype, device): each shape's cached count is the
    library's answer, asking again adds no entry, and a cached entry is
    what the wrapper answers (the library is not asked again)."""
    f32, bf16 = (cuda_lib.dtype_code(t) for t in (torch.float32,
                                                  torch.bfloat16))
    shapes = [(4, 2, 128, 16, 13, bf16, 1), (4, 2, 128, 16, 13, bf16, 132),
              (4, 2, 128, 16, 1000, bf16, 0), (1, 1, 128, 16, 1000, f32, 0),
              (5, 16, 128, 16, 13, bf16, 0), (4, 32, 128, 16, 260, bf16, 0)]
    for shape in shapes:
        assert split_count(lib, *shape) == \
            lib.ptt_paged_attention_splits(*shape)
    size = len(paged._splits)
    for shape in shapes:
        split_count(lib, *shape)
    assert len(paged._splits) == size
    key = (lib, *shapes[0])
    kept = paged._splits[key]
    paged._splits[key] = 7
    try:
        assert split_count(lib, *shapes[0]) == 7
    finally:
        paged._splits[key] = kept


@pytest.mark.parametrize("dtype,D,shift", [(torch.bfloat16, 36, 0),
                                           (torch.float32, 64, 1),
                                           (torch.float16, 36, 0)],
                         ids=["bf16_d36", "misaligned", "f16_d36"])
def test_paged_elementwise_route_emulated(lib, dtype, D, shift):
    """bf16 heads of 36 (72-byte rows) and a q view one element off 16
    bytes take the element-wise route through the same entry point."""
    args, clean = _inputs([1, 40, 0, 129], 16, D, dtype, seed=5)
    q = args[0]
    buf = torch.empty(q.numel() + shift, dtype=dtype)
    qs = buf[shift:].view(q.shape)
    qs.copy_(q)
    args = (qs, *args[1:])
    assert not vector_route(qs, args[1], args[2], torch.empty_like(qs))
    _check(lib, args, clean)


def test_paged_route_rule_emulated(lib):
    """The wrapper's Python copy of the route rule (`vector_route`)
    answers as the library's ``ptt_paged_attention_vector_route``."""
    def both(D=128, dtype=torch.bfloat16, shift=0, pool_shift=0):
        q = torch.zeros(2 * D + 8, dtype=dtype)[shift:shift + 2 * D] \
            .view(2, 1, 1, D)
        pool = torch.zeros(3 * 16 * D + 8, dtype=dtype)[
            pool_shift:pool_shift + 3 * 16 * D].view(3, 1, 16, D)
        out = torch.zeros(2, 1, 1, D, dtype=dtype)
        lib_says = bool(lib.ptt_paged_attention_vector_route(
            q.data_ptr(), pool.data_ptr(), pool.data_ptr(), out.data_ptr(),
            D, cuda_lib.dtype_code(dtype)))
        assert vector_route(q, pool, pool, out) == lib_says
        return lib_says
    assert both() and both(D=64) and both(D=256) and both(D=8)
    assert both(D=4, dtype=torch.float32) and both(D=256, dtype=torch.float32)
    assert not both(D=36) and not both(D=2, dtype=torch.float32)
    assert not both(shift=1) and not both(pool_shift=2)
    assert both(dtype=torch.float16) and both(D=8, dtype=torch.float16)
    assert not both(D=36, dtype=torch.float16)


#: (what, text in the source, its replacement): copies of the source that
#: these tests must reject
_MUTATIONS = [
    ("split 0's state dropped from the merge",
     "    for (int i = 0; i < nsplit; ++i)\n      a += __ldcg(",
     "    for (int i = 1; i < nsplit; ++i)\n      a += __ldcg("),
    ("warp 0's state dropped from the merge",
     "f[w] = wl[w] > 0.f ? exp2f(wm[w] - M) : 0.f;",
     "f[w] = wl[w] > 0.f && w > 0 ? exp2f(wm[w] - M) : 0.f;"),
]


@pytest.mark.parametrize("what,old,new", _MUTATIONS,
                         ids=[m[0] for m in _MUTATIONS])
def test_paged_mutations_fail_emulated(tmp_path_factory, what, old, new):
    """A copy of the source with ``what`` fails the checks above on the
    long contexts, bf16 and f32, heads of 64 and 128."""
    src = _source()
    assert src.count(old) == 1, f"the kernel no longer has: {old!r}"
    broken = _build(tmp_path_factory, src.replace(old, new))
    failed = 0
    for dtype in (torch.float32, torch.bfloat16):
        for D in (64, 128):
            try:
                _check(broken, *_inputs(_CTXS["long"], 16, D, dtype))
            except AssertionError:
                failed += 1
    assert failed, f"{what}: every case passed"
