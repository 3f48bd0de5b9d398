"""The CUDA source of the layer norm's forward and backward (rows 2 and 6),
run on the CPU against the plain versions.

``paddle_tpu_torch/csrc/layer_norm.cu`` is compiled with g++ against the
CPU stand-in for the CUDA device language (``tests/cuda_emu``: one thread
per CUDA thread, block and warp barriers; see
``tests/test_torch_flash_emulated.py``) and called through the same C
entry points and signatures as the card's library.  Both routes of both
kernels at tiny ragged shapes: widths off 16 bytes (7, bf16 300 and 4100)
and a misaligned x (the scalar routes); 300, 768 and 2048 with few rows,
and f32 4100, whose last vectors a lane holds are ragged (the vector
routes, one to 32 warps a row); a width past the register route
(8200); rows fewer than the persistent grid, and more rows than it holds
on a stand-in device of one to three SMs (device d > 0 has d SMs; the
stand-in holds one block an SM), so blocks walk several rows and the last
row group is partly empty.  Tolerances as on the card
(``tests/test_torch_cuda.py``): f32 1e-4 abs + rel, bf16 2e-2; dgamma and
dbeta as column sums (``_sum_tol``).  Outputs start as NaN, so a missed
element shows; every case runs twice and the two runs are bit-identical.
The wrapper's Python copy of the route rule answers as the library's.
The stand-in runs a block's threads concurrently and its blocks one after
another: it checks indexing, masks, barriers and the fixed summation
order, not speed; the card tests and ``chip_smoke.py`` do that.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import cuda_lib
from paddle_tpu_torch.ops.layer_norm import _BWD_BLOCKS_PER_SM, vector_route
from test_torch_cuda import _TOL, _sum_tol
from test_torch_flash_emulated import _emulated_source

_EMU = Path(__file__).resolve().parent / "cuda_emu"
_DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels for the CPU stand-in")
    out = tmp_path_factory.mktemp("cuda_emu_layer_norm")
    shutil.copy(cuda_lib.SRC_DIR / "common.cuh", out / "common.cuh")
    cpp = out / "layer_norm.cpp"
    cpp.write_text(_emulated_source(
        (cuda_lib.SRC_DIR / "layer_norm.cu").read_text()))
    so = out / "libemu_layer_norm.so"
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         "-Wno-unknown-pragmas", "-I", str(_EMU), "-I", str(out), str(cpp),
         str(_EMU / "emu.cpp"), "-o", str(so)],
        capture_output=True, text=True, timeout=600)
    assert build.returncode == 0, build.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in cuda_lib._SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = list(argtypes), restype
    return lib


def _sms(device):
    """The stand-in's SMs on ``device``: 132 on device 0, d on d > 0."""
    return device if device > 0 else 132


def _inputs(rows, n, dtype, misaligned, seed):
    g = torch.Generator().manual_seed(seed)
    x = (2 * torch.randn(rows * n + 1, generator=g) + 1).to(dtype)
    # misaligned: a view one element past the buffer's 16-byte boundary
    x = (x[1:] if misaligned else x[:-1]).view(rows, n)
    gamma = (1 + 0.1 * torch.randn(n, generator=g)).to(dtype)
    beta = torch.randn(n, generator=g).to(dtype)
    dout = torch.randn(rows, n, generator=g).to(dtype)
    return x, gamma, beta, dout


def _lib_route(lib, n, *tensors):
    return bool(lib.ptt_layer_norm_vector_route(
        *(t.data_ptr() for t in tensors), n, tensors[0].element_size()))


def _fwd(lib, x, gamma, beta, device):
    rows, n = x.shape
    out = torch.full_like(x, float("nan"))
    mu = torch.full((rows,), float("nan"))
    rstd = torch.full((rows,), float("nan"))
    assert lib.ptt_layer_norm_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        mu.data_ptr(), rstd.data_ptr(), rows, n, 1e-5,
        cuda_lib.dtype_code(x.dtype), device, None) == 0
    return out, mu, rstd


def _bwd(lib, x, gamma, mu, rstd, dout, device):
    rows, n = x.shape
    nblk = min(rows, _BWD_BLOCKS_PER_SM * _sms(device))
    dx = torch.full_like(x, float("nan"))
    dg = torch.full((n,), float("nan"), dtype=gamma.dtype)
    db = torch.full((n,), float("nan"), dtype=gamma.dtype)
    partial = torch.full((2, nblk, n), float("nan"))
    assert lib.ptt_layer_norm_bwd(
        x.data_ptr(), gamma.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
        dout.data_ptr(), dx.data_ptr(), dg.data_ptr(), db.data_ptr(),
        partial.data_ptr(), rows, n, nblk, cuda_lib.dtype_code(x.dtype),
        device, None) == 0
    return dx, dg, db, partial


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), atol=_TOL[dtype],
                               rtol=_TOL[dtype])


#: (rows, n, device, misaligned, vector route in f32, in bf16)
_CASES = [
    (5, 7, 0, False, False, False),         # off 16 bytes in both
    (6, 300, 0, False, True, False),        # bf16 300: 600 bytes
    (3, 768, 0, False, True, True),         # BERT's width, few rows
    (5, 2048, 0, False, True, True),        # GPT's width, few rows
    (37, 768, 1, False, True, True),        # one SM: blocks walk rows
    (37, 2048, 3, False, True, True),       # a partly empty last group
    (3, 4100, 0, False, True, False),       # f32: ragged last vectors
    (2, 8200, 0, False, False, False),      # past the register route
    (4, 2048, 0, True, False, False),       # x misaligned
]


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("rows,n,device,misaligned,v32,v16", _CASES)
def test_layer_norm_fwd_emulated(lib, dtype, rows, n, device, misaligned,
                                 v32, v16):
    x, gamma, beta, _ = _inputs(rows, n, dtype, misaligned, rows * 31 + n)
    out, mu, rstd = _fwd(lib, x, gamma, beta, device)
    route = vector_route(n, x, gamma, beta, out)
    assert route == (v32 if dtype == torch.float32 else v16)
    assert _lib_route(lib, n, x, gamma, beta, out) == route
    want, mu_ref, rstd_ref = ops.layer_norm_ref(x, gamma, beta)
    _close(out, want, dtype)
    _close(mu, mu_ref, torch.float32)
    _close(rstd, rstd_ref, torch.float32)
    again = _fwd(lib, x, gamma, beta, device)
    assert all(torch.equal(a, b) for a, b in zip(again, (out, mu, rstd)))


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("rows,n,device,misaligned,v32,v16", _CASES)
def test_layer_norm_bwd_emulated(lib, dtype, rows, n, device, misaligned,
                                 v32, v16):
    x, gamma, beta, dout = _inputs(rows, n, dtype, misaligned,
                                   rows * 17 + n)
    _, mu, rstd = ops.layer_norm_ref(x, gamma, beta)
    dx, dg, db, _ = _bwd(lib, x, gamma, mu, rstd, dout, device)
    route = vector_route(n, x, gamma, dout, dx)
    assert route == (v32 if dtype == torch.float32 else v16)
    assert _lib_route(lib, n, x, gamma, dout, dx) == route
    want = ops.layer_norm_bwd_ref(x, gamma, mu, rstd, dout)
    _close(dx, want[0], dtype)
    for got, ref in ((dg, want[1]), (db, want[2])):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), ref.float(),
                                   atol=_sum_tol(dtype, rows),
                                   rtol=_TOL[dtype])
    again = _bwd(lib, x, gamma, mu, rstd, dout, device)
    assert all(torch.equal(a, b) for a, b in zip(again[:3], (dx, dg, db)))


def test_layer_norm_bwd_refuses_bad_arguments(lib):
    """The backward refuses nblk outside [1, rows] and rows wider than its
    shared memory holds (2n floats over 227 KB)."""
    x, gamma, _, dout = _inputs(4, 64, torch.float32, False, 0)
    mu = rstd = torch.ones(4)
    dx, dg, db = torch.empty_like(x), torch.empty(64), torch.empty(64)
    partial = torch.empty(2, 8, 64)
    args = [t.data_ptr() for t in (x, gamma, mu, rstd, dout, dx, dg, db,
                                   partial)]
    f32 = cuda_lib.dtype_code(torch.float32)
    for rows, n, nblk in ((4, 64, 0), (4, 64, 5), (4, 29100, 1)):
        assert lib.ptt_layer_norm_bwd(*args, rows, n, nblk, f32, 0,
                                      None) != 0
