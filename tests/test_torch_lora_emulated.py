"""The CUDA source of the LoRA SGMV epilogue (row 15), run on the CPU
against its plain version.

``paddle_tpu_torch/csrc/lora_sgmv.cu`` is compiled with g++ against the
CPU stand-in for the CUDA device language (``tests/cuda_emu``: one thread
per CUDA thread, block and warp barriers, ``mma.cuh``'s PTX replaced by
functions following the PTX fragment layouts; see
``tests/test_torch_flash_emulated.py``) and called through the same C
entry points and signatures as the card's library.  Every route: bf16
with 16-byte rows on the tensor cores (ranks 8-64, padded to 16, 32 or 64
columns; block rows 16 and 32, the second taking two 16-row passes; K off
the stage depth), f32, and bf16 rows whose K or N is off 8 values (the
element-wise route).  Blocks mix unsorted adapters with null blocks and an
adapter that owns no block; every activation; every column span the
launch picks, reached through the stand-in's SM count per device (device
0 has 132 SMs, device d > 0 has d); out left unwritten when its pointer is
null.  Tolerances as on the card (``tests/test_torch_cuda.py``): bf16
2e-2 abs + rel, f32 1e-4.  Outputs start as NaN, so a missed element
shows; every case runs twice and the two runs are bit-identical; null
rows give s = z bit for bit.  Copies of the source with the barrier
before the K split's sum removed, or with one warp's partial dropped,
fail these checks.  The stand-in copies synchronously: it checks
layouts, masks, barriers and the fixed summation order, not speed; the
card tests and ``chip_smoke.py`` do that.
"""

import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import cuda_lib
from paddle_tpu_torch.ops.lora import _sgmv_ref, mma_route
from paddle_tpu_torch.ops.matmul_epilogue import act_f32
from cuda_emu_build import build_emulated

_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 5e-3}
_ACTS = ops.ACTIVATIONS
_L = 4   # adapter slots: id 4 is a null block


def _build(tmp_path_factory, source):
    """The stand-in library of ``source`` (the text of lora_sgmv.cu)."""
    return build_emulated(tmp_path_factory, "lora", {"lora_sgmv.cu": source})


def _source():
    return (cuda_lib.SRC_DIR / "lora_sgmv.cu").read_text()


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(tmp_path_factory, _source())


def _inputs(ids, bm, K, N, r, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    R = len(ids) * bm
    z = torch.randn(R, N, generator=g).to(dtype)
    x = torch.randn(R, K, generator=g).to(dtype)
    a = (torch.randn(_L, K, r, generator=g) / 5).to(dtype)
    b = (torch.randn(_L, r, N, generator=g) / 5).to(dtype)
    return z, x, a, b, torch.tensor(ids, dtype=torch.int32)


def _fwd(lib, z, x, a, b, gid, act, device=0, with_out=True):
    """The entry point on CPU tensors; NaN-filled outputs (out None where
    ``with_out`` is False: the kernel writes s alone)."""
    R, K = x.shape
    L, _, r = a.shape
    N = b.shape[2]
    s = torch.full((R, N), float("nan"), dtype=x.dtype)
    out = torch.full_like(s, float("nan")) if with_out else None
    rc = lib.ptt_lora_sgmv_fwd(
        z.data_ptr(), x.data_ptr(), a.data_ptr(), b.data_ptr(),
        gid.data_ptr(), None if out is None else out.data_ptr(),
        s.data_ptr(), R, K, N, r, L, R // gid.shape[0], _ACTS.index(act),
        cuda_lib.dtype_code(x.dtype), device, None)
    assert rc == 0
    return out, s


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), atol=_TOL[dtype],
                               rtol=_TOL[dtype])


def _check(lib, ids, bm, K, N, r, dtype, act, device=0, seed=0,
           with_out=True):
    """One case against the plain version, null rows exact, run twice and
    bit-identical; returns whether it took the tensor-core route."""
    z, x, a, b, gid = _inputs(ids, bm, K, N, r, dtype, seed)
    out, s = _fwd(lib, z, x, a, b, gid, act, device, with_out)
    want, s_want = _sgmv_ref(z, x, a, b, gid, act)
    _close(s, s_want, dtype)
    if with_out:
        _close(out, want, dtype)
    null = (gid >= _L).repeat_interleave(bm)
    assert torch.equal(s[null], z[null])
    if with_out:
        _close(out[null], act_f32(z[null].float(), act).to(dtype), dtype)
    again = _fwd(lib, z, x, a, b, gid, act, device, with_out)
    assert torch.equal(again[1], s)
    if with_out:
        assert torch.equal(again[0], out)
    return mma_route(K, N, r, z, x, a, b, out, s)


_MIXED = [2, 0, 4, 1, 0, 2, 4]   # unsorted, two null, adapter 3 owns none

#: (ids, bm, K, N, r, dtype, tensor-core route)
_CASES = [
    # the tensor-core route: ranks 16, 32, 64 and 48 (padded to 64), K off
    # the stage depth (512 at r = 16, 128 at 32, 64 above; K 1040: three
    # stages through the double buffer), N off the B tile
    (_MIXED, 16, 200, 136, 16, torch.bfloat16, True),
    (_MIXED, 16, 1040, 72, 16, torch.bfloat16, True),
    (_MIXED, 16, 72, 264, 32, torch.bfloat16, True),
    (_MIXED, 16, 136, 72, 64, torch.bfloat16, True),
    (_MIXED, 16, 64, 136, 48, torch.bfloat16, True),
    (_MIXED, 16, 40, 16, 8, torch.bfloat16, True),
    # block rows 32: two 16-row passes a block
    ([1, 4, 3, 1], 32, 264, 520, 16, torch.bfloat16, True),
    ([0, 4], 32, 64, 64, 64, torch.bfloat16, True),
    # one adapter owning every block (fine-tuning's layout)
    ([0] * 6, 16, 256, 512, 16, torch.bfloat16, True),
    # the element-wise route: K or N off 8 values
    (_MIXED, 16, 70, 136, 16, torch.bfloat16, False),
    (_MIXED, 16, 72, 130, 16, torch.bfloat16, False),
    # f32 (the CUDA cores)
    (_MIXED, 8, 70, 130, 8, torch.float32, False),
    (_MIXED, 8, 64, 72, 32, torch.float32, False),
    # f16 (f32's CUDA-core kernel on f16 rows): 16-byte rows, and rows off
    (_MIXED, 16, 64, 72, 16, torch.float16, False),
    (_MIXED, 16, 70, 130, 8, torch.float16, False),
]


@pytest.mark.parametrize("ids,bm,K,N,r,dtype,mma", _CASES)
def test_lora_sgmv_emulated(lib, ids, bm, K, N, r, dtype, mma):
    assert _check(lib, ids, bm, K, N, r, dtype, "gelu_tanh",
                  seed=K * 7 + N + r) == mma


@pytest.mark.parametrize("act", _ACTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_lora_sgmv_activations_emulated(lib, act, dtype):
    bm = 16 if dtype == torch.bfloat16 else 8
    assert _check(lib, _MIXED, bm, 72, 136, 16, dtype, act, seed=3) == (
        dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype,K,N", [(torch.bfloat16, 72, 136),
                                       (torch.bfloat16, 70, 130),
                                       (torch.float32, 72, 136)])
def test_lora_sgmv_without_out_emulated(lib, dtype, K, N):
    """act "none" with out's pointer null: s alone, on every route."""
    bm = 16 if dtype == torch.bfloat16 else 8
    _check(lib, _MIXED, bm, K, N, 16, dtype, "none", seed=4, with_out=False)


def _spans_of(nb, N, device):
    """`span_chunks`' rule: N whole where nb fills the SMs, else N's
    chunks of 8 columns over ceil(SMs / nb) spans, rounded down to a
    multiple of 64 chunks, at least 64."""
    sms = device if device > 0 else 132
    chunks, spans = N // 8, -(-sms // nb)
    span = chunks if spans == 1 else max(64, chunks // spans // 64 * 64)
    return -(-chunks // span)


def test_lora_sgmv_spans_rule_emulated(lib):
    """The spans of the library's launch follow the rule, on the card's
    132 SMs: the drives' serving step (23 blocks of 16) splits N, the
    fine-tuning drive's 512 blocks keep it whole."""
    rule = lib.ptt_lora_sgmv_spans
    assert rule(23, 3072, 0) == 6 and rule(23, 1024, 0) == 2
    assert rule(23, 4096, 0) == 8
    assert rule(512, 3072, 0) == 1 and rule(512, 1024, 0) == 1
    assert rule(3, 16, 0) == 1 and rule(3, 130, 0) == 0
    for nb in (1, 3, 7, 23, 512):
        for N in (16, 256, 1024, 1280, 3072, 4096):
            for device in (0, 1, 2, 3, 5, 7, 12, 30):
                assert rule(nb, N, device) == _spans_of(nb, N, device)


@pytest.mark.parametrize("N", [2048, 1280])
def test_lora_sgmv_every_span_emulated(lib, N):
    """Each span count the launch can pick for 3 blocks of N columns (N
    2048: 1, 2 or 4 spans; 1280: 1 or 3, the last partly empty),
    each on the stand-in device whose SM count makes the launch pick
    it."""
    ids, seen = [3, 4, 1], {}
    for device in range(1, 16):
        seen.setdefault(lib.ptt_lora_sgmv_spans(len(ids), N, device), device)
    assert sorted(seen) == ([1, 2, 4] if N == 2048 else [1, 3])
    for spans, device in seen.items():
        assert _check(lib, ids, 16, 72, N, 16, torch.bfloat16, "silu",
                      device=device, seed=spans)


def test_lora_sgmv_route_rule_emulated(lib):
    """The wrapper's Python copy of the route rule (`mma_route`) answers as
    the library's ``ptt_lora_sgmv_mma_route``: dtype, K, N and r off 8,
    r past 128, a misaligned view, a null out."""
    def both(K, N, r, dtype, shift=0, with_out=True):
        z = torch.zeros(4 * N + 8, dtype=dtype)[shift:shift + 4 * N]
        x = torch.zeros(4, K, dtype=dtype)
        a = torch.zeros(1, K, r, dtype=dtype)
        b = torch.zeros(1, r, N, dtype=dtype)
        s = torch.zeros(4, N, dtype=dtype)
        out = torch.zeros_like(s) if with_out else None
        ts = (z, x, a, b, out, s)
        lib_says = bool(lib.ptt_lora_sgmv_mma_route(
            *(None if t is None else t.data_ptr() for t in ts), K, N, r,
            cuda_lib.dtype_code(dtype)))
        assert mma_route(K, N, r, *ts) == lib_says
        return lib_says
    assert both(64, 64, 16, torch.bfloat16)
    assert both(64, 64, 16, torch.bfloat16, with_out=False)
    assert both(64, 64, 128, torch.bfloat16)
    assert not both(64, 64, 136, torch.bfloat16)
    assert not both(64, 64, 12, torch.bfloat16)
    assert not both(60, 64, 16, torch.bfloat16)
    assert not both(64, 60, 16, torch.bfloat16)
    assert not both(64, 64, 16, torch.bfloat16, shift=1)
    assert not both(64, 64, 16, torch.float32)
    assert not both(64, 64, 16, torch.float16)


def test_lora_sgmv_refuses_bad_layouts_emulated(lib):
    """The tensor-core route refuses block rows off 16 and more than 2048
    entries of t; the f32 kernel the latter."""
    for dtype, bm, r in ((torch.bfloat16, 8, 16), (torch.bfloat16, 16, 136),
                         (torch.bfloat16, 32, 128), (torch.float32, 8, 512)):
        z, x, a, b, gid = _inputs([0, 1], bm, 64, 64, r, dtype, 0)
        s = torch.empty_like(z)
        assert lib.ptt_lora_sgmv_fwd(
            z.data_ptr(), x.data_ptr(), a.data_ptr(), b.data_ptr(),
            gid.data_ptr(), None, s.data_ptr(), 2 * bm, 64, 64, r, _L, bm,
            0, cuda_lib.dtype_code(dtype), 0, None) != 0


#: (what, text in the tensor-core kernel, its replacement): copies of the
#: source that these tests must reject
_MUTATIONS = [
    ("the barrier before the K split's sum removed",
     "    __syncthreads();\n    for (int e = tid; e < 16 * r;",
     "    for (int e = tid; e < 16 * r;"),
    ("warp 0's partial dropped from the K split's sum",
     "for (int w = 0; w < kWarps; ++w) v += part",
     "for (int w = 1; w < kWarps; ++w) v += part"),
]


@pytest.mark.parametrize("what,old,new", _MUTATIONS,
                         ids=[m[0] for m in _MUTATIONS])
def test_lora_sgmv_mutations_fail_emulated(tmp_path_factory, what, old, new):
    """A copy of the source with ``what`` fails the checks above on the
    tensor-core cases (a wrong value, or two runs that differ)."""
    src = _source()
    assert src.count(old) == 1, f"the kernel no longer has: {old!r}"
    broken = _build(tmp_path_factory, src.replace(old, new))
    failed = 0
    for ids, bm, K, N, r, dtype, mma in _CASES[:6]:
        try:
            _check(broken, ids, bm, K, N, r, dtype, "none", seed=K + N)
        except AssertionError:
            failed += 1
    assert failed, f"{what}: every case passed"
