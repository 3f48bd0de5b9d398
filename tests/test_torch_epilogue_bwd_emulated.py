"""The CUDA source of the matmul epilogue's backward (row 7), run on the
CPU against its plain version.

``paddle_tpu_torch/csrc/matmul_epilogue.cu`` is compiled with g++
against the CPU stand-in for the CUDA device language
(``tests/cuda_emu``, built as
``tests/test_torch_matmul_epilogue_emulated.py`` builds it) and the
backward is called through the same C entry points and signatures as the
card's library.  The vector route at every activation, f32 and bf16, at
row counts off the block's 16 warps and off its slice: N of 8 (one vector
a row) and 768 (BERT's width: three column spans, the last one partly
idle in f32), and 8192 (GPT's fc1) with tanh-GELU; stand-in devices of 8
and 24 SMs (one and three row slices of 8 column spans); the
element-wise route (N = 130, and a view off 16 bytes) through the same
entry point; the route rule and the partial rows against the Python
copy.  Tolerances as on the card (``tests/test_torch_cuda.py``): dz f32
1e-4, bf16 2e-2 abs + rel; db, a column sum taken in another order, f32
1e-4 * sqrt(rows) abs and bf16 2e-2.  Outputs and scratch start as NaN,
so a missed element shows; every case runs twice, the second time with
the blocks in another order, and the two runs are bit-identical, and the
counters of the last block's sum are 0 again after each.  Copies of the
source with a row slice of each group left out of db, or one warp's rows
left out of a block's partial row, fail these checks.
"""

import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import cuda_lib
from paddle_tpu_torch.ops.matmul_epilogue import bwd_vector_route
from cuda_emu_build import build_emulated

_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 5e-3}


def _source():
    return (cuda_lib.SRC_DIR / "matmul_epilogue.cu").read_text()


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_emulated(tmp_path_factory, "epilogue_bwd",
                          {"matmul_epilogue.cu": _source()})


def _inputs(M, N, dtype, seed=0, shift=0):
    g = torch.Generator().manual_seed(seed)
    z = (2 * torch.randn(M * N + shift, generator=g)).to(dtype)
    gr = torch.randn(M * N + shift, generator=g).to(dtype)
    return z[shift:].view(M, N), gr[shift:].view(M, N)


def _bwd(lib, z, g, act, order=0, device=0, shift=0):
    """The entry point on CPU tensors into NaN-filled dz, db and scratch;
    returns (dz, db, partial rows)."""
    M, N = z.shape
    code = cuda_lib.dtype_code(z.dtype)
    dz = torch.full((M * N + shift,), float("nan"), dtype=z.dtype)[
        shift:].view(M, N)
    db = torch.full((N,), float("nan"), dtype=z.dtype)
    ptrs = (z.data_ptr(), g.data_ptr(), dz.data_ptr())
    nparts = lib.ptt_matmul_epilogue_bwd_parts(*ptrs, M, N, code, device)
    partial = torch.full((nparts, N), float("nan"))
    tickets = torch.zeros(-(-N // 128), dtype=torch.int32)
    lib.emu_set_block_order(order)
    try:
        rc = lib.ptt_matmul_epilogue_bwd(
            *ptrs, db.data_ptr(), partial.data_ptr(), tickets.data_ptr(), M,
            N, nparts, ops.ACTIVATIONS.index(act), code, device, None)
    finally:
        lib.emu_set_block_order(0)
    assert rc == 0
    assert not tickets.any(), "the counters were not reset"
    return dz, db, nparts


def _ref(z, g, act):
    """The plain version on one CPU thread: PyTorch's multi-threaded CPU
    tanh gave tanh-GELU values up to 2.4e-3 off (f32) on its first call in
    some processes that had loaded a stand-in library, and never on one
    thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return ops.linear_act_bwd_ref(z, g, act)
    finally:
        torch.set_num_threads(threads)


def _check(lib, z, g, act, device=0, shift=0):
    """dz and db against the plain version; a second run, blocks in
    another order, bit-identical.  Returns the partial rows used."""
    dz, db, nparts = _bwd(lib, z, g, act, device=device, shift=shift)
    dz_r, db_r = _ref(z, g, act)
    dt = z.dtype
    torch.testing.assert_close(dz.float(), dz_r.float(), atol=_TOL[dt],
                               rtol=_TOL[dt])
    sum_tol = 1e-4 * z.shape[0] ** 0.5 if dt == torch.float32 \
        else _TOL[dt]
    torch.testing.assert_close(db.float(), db_r.float(), atol=sum_tol,
                               rtol=_TOL[dt])
    dz2, db2, _ = _bwd(lib, z, g, act, order=777, device=device, shift=shift)
    assert torch.equal(dz2, dz) and torch.equal(db2, db)
    return nparts


#: (M, N, act): every activation at N = 768 and 8; GPT's fc1 width (512
#: blocks of the second pass, ~17 s a case on the stand-in) at its own
#: activation
_VEC_CASES = ([(131, 768, a) for a in ops.ACTIVATIONS]
              + [(70, 8, a) for a in ops.ACTIVATIONS]
              + [(7, 8192, "gelu_tanh")])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("M,N,act", _VEC_CASES)
def test_epilogue_bwd_vector_route_emulated(lib, M, N, act, dtype):
    z, g = _inputs(M, N, dtype, seed=M + N)
    assert bwd_vector_route(z, g, torch.empty_like(z))
    nparts = _check(lib, z, g, act)
    if M > 64:
        assert nparts > 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("slices", [1, 3])
def test_epilogue_bwd_persistent_grid_emulated(lib, slices, dtype):
    """On stand-in devices of 8 and 24 SMs (one block an SM) the grid
    holds 1 and 3 row slices of the 8 column spans at N = 1024 in f32,
    2048 in bf16, each block walking 100 or more rows."""
    N = 1024 if dtype == torch.float32 else 2048
    z, g = _inputs(300, N, dtype, seed=slices)
    assert _check(lib, z, g, "gelu_tanh", device=8 * slices) == slices


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("N,shift", [(130, 0), (256, 1)],
                         ids=["n130", "misaligned"])
def test_epilogue_bwd_elementwise_route_emulated(lib, N, shift, dtype):
    """Rows off 16 bytes (bf16 N = 130; f32 takes it too at 130 = 4 * 32
    + 2) and views one element off take the element-wise route through
    the same entry point: 64 row chunks."""
    z, g = _inputs(100, N, dtype, seed=N, shift=shift)
    dz = torch.empty(100 * N + shift, dtype=dtype)[shift:].view(100, N)
    assert not bwd_vector_route(z, g, dz)
    assert _check(lib, z, g, "silu", shift=shift) == 64


@pytest.mark.parametrize("M,N,act,route", [(131, 768, "gelu_tanh", True),
                                           (100, 130, "silu", False)],
                         ids=["vector", "elementwise"])
def test_epilogue_bwd_f16_emulated(lib, M, N, act, route):
    """f16 on both routes: bf16's instantiations with f16 loads and
    stores."""
    z, g = _inputs(M, N, torch.float16, seed=M + N)
    assert bwd_vector_route(z, g, torch.empty_like(z)) == route
    nparts = _check(lib, z, g, act)
    assert nparts > 1 if route else nparts == 64


def test_epilogue_bwd_route_rule_emulated(lib):
    """The wrapper's Python copy of the route rule (`bwd_vector_route`)
    answers as ``ptt_matmul_epilogue_bwd_vector_route``."""
    def both(N, dtype=torch.bfloat16, zs=0, gs=0, ds=0):
        def view(shift):
            return torch.zeros(2 * N + 8, dtype=dtype)[shift:shift + 2 * N] \
                .view(2, N)
        z, g, dz = view(zs), view(gs), view(ds)
        lib_says = bool(lib.ptt_matmul_epilogue_bwd_vector_route(
            z.data_ptr(), g.data_ptr(), dz.data_ptr(), N,
            cuda_lib.dtype_code(dtype)))
        assert bwd_vector_route(z, g, dz) == lib_says
        return lib_says
    assert both(8) and both(768) and both(8192) and both(4, torch.float32)
    assert not both(130) and not both(4) and not both(6, torch.float32)
    assert not both(64, zs=1) and not both(64, gs=2) and not both(64, ds=4)
    assert both(64, torch.float32, zs=4, gs=4, ds=4)
    assert both(8, torch.float16) and not both(130, torch.float16)


#: (what, text in the source, its replacement): copies of the source that
#: these tests must reject
_MUTATIONS = [
    ("a row slice of each group left out of db",
     "for (int k = part * per; k < s1; ++k)",
     "for (int k = part * per + 1; k < s1; ++k)"),
    ("warp 0's rows left out of the block's partial row",
     "for (int w = 0; w < kBwdWarps; ++w) s += red[w][c];",
     "for (int w = 1; w < kBwdWarps; ++w) s += red[w][c];"),
]


@pytest.mark.parametrize("what,old,new", _MUTATIONS,
                         ids=[m[0] for m in _MUTATIONS])
def test_epilogue_bwd_mutations_fail_emulated(tmp_path_factory, what, old,
                                              new):
    """A copy of the source with ``what`` fails the checks above at
    [131, 768] gelu_tanh, f32 and bf16."""
    src = _source()
    assert src.count(old) == 1, f"the kernel no longer has: {old!r}"
    broken = build_emulated(tmp_path_factory, "epilogue_bwd",
                            {"matmul_epilogue.cu": src.replace(old, new)})
    failed = 0
    for dtype in (torch.float32, torch.bfloat16):
        try:
            _check(broken, *_inputs(131, 768, dtype), "gelu_tanh")
        except AssertionError:
            failed += 1
    assert failed == 2, f"{what}: a case passed"
