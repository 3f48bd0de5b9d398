"""The CUDA source of the RMS norm's forward and backward (row 12), run on
the CPU against the plain versions.

``paddle_tpu_torch/csrc/rms_norm.cu`` is compiled with g++ against the
CPU stand-in for the CUDA device language (``tests/cuda_emu``: one thread
per CUDA thread, block and warp barriers; see
``tests/test_torch_flash_emulated.py``) and called through the same C
entry points and signatures as the card's library.  Both routes of both
kernels at tiny ragged shapes: widths off 16 bytes (7, bf16 300 and 4100)
and a misaligned x (the forward's one-value loads, the backward's scalar
route); 300, 1024 and 4096 with few rows, and f32 4100, whose last
vectors a lane holds are ragged (the forward's 16-byte loads, the
backward's vector route, one to sixteen warps a row); a width past the
backward's register route (8200, the scalar route on 16-byte loads); more
rows than the backward's persistent grid holds on a stand-in device of
one to three SMs (device d > 0 has d SMs), so blocks walk several rows
and the last row group is partly empty.  Tolerances as on the card
(``tests/test_torch_cuda.py``): f32 1e-4 abs + rel, bf16 2e-2; dgamma as
a column sum (``_sum_tol``).  Outputs and the scratch start as NaN, so a
missed element shows, and a row of the scratch past the blocks the
wrapper sizes it for must stay NaN; every case runs twice, the second
time with the blocks in another order, and the two runs are
bit-identical.  The wrapper's Python copies of the route rule and of the
first pass's block count answer as the library's.  The stand-in runs a
block's threads concurrently and its blocks one after another: it checks
indexing, masks, barriers and the fixed summation order, not speed; the
card tests and ``chip_smoke.py`` do that.
"""

import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import cuda_lib
from paddle_tpu_torch.ops.rms_norm import (_BWD_SM_THREADS, _BWD_THREADS,
                                           bwd_blocks, vector_route)
from test_torch_cuda import _TOL, _sum_tol
from cuda_emu_build import build_emulated

_DTYPES = [torch.float32, torch.bfloat16]
_EPS = 1e-6


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_emulated(tmp_path_factory, "rms_norm", {
        "rms_norm.cu": (cuda_lib.SRC_DIR / "rms_norm.cu").read_text()})


def _sms(device):
    """The stand-in's SMs on ``device``: 132 on device 0, d on d > 0."""
    return device if device > 0 else 132


def _inputs(rows, n, dtype, misaligned, seed):
    g = torch.Generator().manual_seed(seed)
    x = (2 * torch.randn(rows * n + 1, generator=g) + 1).to(dtype)
    # misaligned: a view one element past the buffer's 16-byte boundary
    x = (x[1:] if misaligned else x[:-1]).view(rows, n)
    gamma = (1 + 0.1 * torch.randn(n, generator=g)).to(dtype)
    dout = torch.randn(rows, n, generator=g).to(dtype)
    return x, gamma, dout


def _fwd(lib, x, gamma, device):
    rows, n = x.shape
    out = torch.full_like(x, float("nan"))
    rstd = torch.full((rows,), float("nan"))
    assert lib.ptt_rms_norm_fwd(
        x.data_ptr(), gamma.data_ptr(), out.data_ptr(), rstd.data_ptr(),
        rows, n, _EPS, cuda_lib.dtype_code(x.dtype), device, None) == 0
    return out, rstd


def _bwd(lib, x, gamma, rstd, dout, device, order=0):
    """The backward into NaN-filled outputs, its scratch sized by the
    wrapper's rule (plus one NaN row that must stay untouched); the
    blocks in order, or in a seeded random order."""
    rows, n = x.shape
    dx = torch.full_like(x, float("nan"))
    dg = torch.full((n,), float("nan"), dtype=gamma.dtype)
    vec = vector_route(n, x, gamma, dout, dx)
    nblk = bwd_blocks(rows, n, x.element_size(), vec, _sms(device))
    assert nblk == lib.ptt_rms_norm_bwd_blocks(rows, n, x.element_size(),
                                               int(vec), device)
    partial = torch.full((nblk + 1, n), float("nan"))
    lib.emu_set_block_order(order)
    try:
        rc = lib.ptt_rms_norm_bwd(
            x.data_ptr(), gamma.data_ptr(), rstd.data_ptr(), dout.data_ptr(),
            dx.data_ptr(), dg.data_ptr(), partial.data_ptr(), rows, n, nblk,
            cuda_lib.dtype_code(x.dtype), device, None)
    finally:
        lib.emu_set_block_order(0)
    assert rc == 0
    assert torch.isnan(partial[nblk]).all(), "a block wrote past the scratch"
    return dx, dg, vec


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), atol=_TOL[dtype],
                               rtol=_TOL[dtype])


#: (rows, n, device, misaligned, backward vector route in f32, in bf16)
_CASES = [
    (5, 7, 0, False, False, False),         # off 16 bytes in both
    (6, 300, 0, False, True, False),        # bf16 300: 600 bytes
    (3, 1024, 0, False, True, True),        # the LLaMA drive's width
    (2, 4096, 0, False, True, True),        # LLaMA-2 7B's width
    (37, 1024, 1, False, True, True),       # one SM: blocks walk rows
    (99, 1024, 3, False, True, True),       # a partly empty last group
    (21, 4096, 2, False, True, True),       # wide rows walked
    (3, 4100, 0, False, True, False),       # f32: ragged last vectors
    (2, 8200, 0, False, False, False),      # past the register route
    (4, 1024, 0, True, False, False),       # x misaligned
]


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("rows,n,device,misaligned,v32,v16", _CASES)
def test_rms_norm_fwd_emulated(lib, dtype, rows, n, device, misaligned,
                               v32, v16):
    x, gamma, _ = _inputs(rows, n, dtype, misaligned, rows * 29 + n)
    out, rstd = _fwd(lib, x, gamma, device)
    want, rstd_ref = ops.rms_norm_ref(x, gamma, _EPS)
    _close(out, want, dtype)
    _close(rstd, rstd_ref, torch.float32)
    again = _fwd(lib, x, gamma, device)
    assert torch.equal(again[0], out) and torch.equal(again[1], rstd)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("rows,n,device,misaligned,v32,v16", _CASES)
def test_rms_norm_bwd_emulated(lib, dtype, rows, n, device, misaligned,
                               v32, v16):
    x, gamma, dout = _inputs(rows, n, dtype, misaligned, rows * 13 + n)
    _, rstd = ops.rms_norm_ref(x, gamma, _EPS)
    dx, dg, vec = _bwd(lib, x, gamma, rstd, dout, device)
    assert vec == (v32 if dtype == torch.float32 else v16)
    assert bool(lib.ptt_rms_norm_vector_route(
        x.data_ptr(), gamma.data_ptr(), dout.data_ptr(), dx.data_ptr(), n,
        x.element_size())) == vec
    dx_ref, dg_ref = ops.rms_norm_bwd_ref(x, gamma, rstd, dout)
    _close(dx, dx_ref, dtype)
    assert dg.dtype == dtype
    torch.testing.assert_close(dg.float(), dg_ref.float(),
                               atol=_sum_tol(dtype, rows), rtol=_TOL[dtype])
    again = _bwd(lib, x, gamma, rstd, dout, device, order=rows + n)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dg)


@pytest.mark.parametrize("rows,n,device,misaligned,v32,v16",
                         [_CASES[0], _CASES[2]], ids=["n7", "n1024"])
def test_rms_norm_f16_emulated(lib, rows, n, device, misaligned, v32, v16):
    """f16 forward and backward, a width off 16 bytes (the scalar routes)
    and the LLaMA drive's (the vector route): bf16's instantiations with
    f16 loads and stores."""
    test_rms_norm_fwd_emulated(lib, torch.float16, rows, n, device,
                               misaligned, v32, v16)
    test_rms_norm_bwd_emulated(lib, torch.float16, rows, n, device,
                               misaligned, v32, v16)


def test_rms_norm_bwd_blocks_rule(lib):
    """The first pass's blocks, Python against the library, over the
    widths each route takes, rows around a row group and devices of one
    to 132 SMs: the vector route's grid never passes one block a row group
    nor its blocks an SM, the scalar route's 512 nor the rows."""
    for n in (8, 300, 1024, 2048, 4096, 8192, 8200):
        for isz in (2, 4):
            for rows in (1, 3, 4, 5, 37, 4096, 8192, 100000):
                for device in (0, 1, 3):
                    for vec in (True, False):
                        got = bwd_blocks(rows, n, isz, vec, _sms(device))
                        assert got == lib.ptt_rms_norm_bwd_blocks(
                            rows, n, isz, int(vec), device), \
                            (n, isz, rows, device, vec)
                        cap = (_BWD_SM_THREADS // _BWD_THREADS
                               * _sms(device)) if vec else 512
                        assert 1 <= got <= min(rows, cap)


def test_rms_norm_bwd_refuses_bad_arguments(lib):
    """The backward refuses nblk outside [1, rows] and rows wider than the
    scalar route's shared memory holds (n floats over 227 KB)."""
    x, gamma, dout = _inputs(4, 64, torch.float32, False, 0)
    rstd = torch.ones(4)
    dx, dg = torch.empty_like(x), torch.empty(64)
    partial = torch.empty(8, 64)
    args = [t.data_ptr() for t in (x, gamma, rstd, dout, dx, dg, partial)]
    f32 = cuda_lib.dtype_code(torch.float32)
    for rows, n, nblk in ((4, 64, 0), (4, 64, 5), (4, 58200, 1)):
        assert lib.ptt_rms_norm_bwd(*args, rows, n, nblk, f32, 0,
                                    None) != 0
