"""The CUDA source of the grouped-expert matmul, run on the CPU against its
plain versions.

``paddle_tpu_torch/csrc/grouped_matmul.cu`` is compiled with g++ against
the CPU stand-in for the CUDA device language (``tests/cuda_emu``: one
thread per CUDA thread, block and warp barriers, ``mma.cuh``'s PTX
replaced by functions following the PTX fragment layouts; see
``tests/test_torch_flash_emulated.py``) and called through the same C
entry points and signatures as the card's library.  Both designs: the
bf16 tensor-core kernels (forward at every tile shape the launch picks,
dw at each of its three tiles) and the f32 CUDA-core
kernels, at tiny ragged shapes: null blocks, unsorted ids, row tiles
spanning blocks of 16 and blocks of 48 that straddle tiles, N and K of
16, 70 and 130 (the element-wise staging) and of 64 and 128 (16-byte
copies), weights read transposed, an expert that owns no block, and the
dw's rows split into S > 1 slices summed by a second launch.  Tolerances
as on the card (``tests/test_torch_cuda.py``): bf16 2e-2 abs + rel, f32
1e-4; dw as a column sum.  The f32 forward at the layout of the card
test that failed intermittently (``test_grouped_linear_act_gradients_on_
the_card[float32]``) is repeated, every run bit-identical to the first:
the stand-in's threads of a block run concurrently, so a missing barrier
would show as a run that differs.  The stand-in copies synchronously: it
checks layouts, masks, passes and sums, not the asynchronous schedule or
speed; the card tests and ``chip_smoke.py`` do that.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import cuda_lib
from test_torch_flash_emulated import _emulated_header, _emulated_source

_EMU = Path(__file__).resolve().parent / "cuda_emu"
_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
_ACTS = ops.ACTIVATIONS


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels for the CPU stand-in")
    out = tmp_path_factory.mktemp("cuda_emu_grouped")
    for header in cuda_lib.SRC_DIR.glob("*.cuh"):
        text = header.read_text()
        if header.name == "mma.cuh":
            text = _emulated_header(text)
        (out / header.name).write_text(text)
    cpp = out / "grouped_matmul.cpp"
    cpp.write_text(_emulated_source(
        (cuda_lib.SRC_DIR / "grouped_matmul.cu").read_text()))
    so = out / "libemu_grouped.so"
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


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _device_for(tile, R, N):
    """The stand-in's device index whose SM count makes the bf16 launch
    pick ``tile`` for R rows of N columns: device 0 has 132 SMs, device
    d > 0 has d.  "mid" (128 x 64) is a grid under one 128 x 128 tile an
    SM, "wide" one to two tiles an SM, "wide2" two or more."""
    tiles = -(-R // 128) * -(-N // 128)
    if tile == "mid":
        assert tiles < 132
        return 0
    assert tiles >= 2 and tiles < 64
    return tiles if tile == "wide" else 1


def _fwd(lib, x, w, b, gid, act, trans, tile="mid", want_z=True):
    """The forward entry point on CPU tensors, on the stand-in device that
    makes the launch pick the bf16 ``tile`` (`_device_for`); NaN-filled
    outputs, so a missed element shows."""
    E = w.shape[0]
    R = x.shape[0]
    N = w.shape[1] if trans else w.shape[2]
    out = torch.full((R, N), float("nan"), dtype=x.dtype)
    z = torch.full_like(out, float("nan")) if want_z else None
    rc = lib.ptt_grouped_matmul_fwd(
        _ptr(x), _ptr(w), _ptr(b), _ptr(gid), _ptr(out), _ptr(z), R,
        x.shape[1], N, E, R // gid.shape[0], int(trans), _ACTS.index(act),
        cuda_lib.dtype_code(x.dtype), _device_for(tile, R, N), None)
    assert rc == 0
    return out, z


def _dw(lib, x, dz, gid, E, S):
    R, K = x.shape
    N = dz.shape[1]
    dw = torch.full((E, K, N), float("nan"), dtype=x.dtype)
    part = torch.full((S, E, K, N), float("nan")) if S > 1 else None
    rc = lib.ptt_grouped_matmul_dw(
        _ptr(x), _ptr(dz), _ptr(gid), _ptr(dw), _ptr(part), R, K, N, E,
        R // gid.shape[0], S, cuda_lib.dtype_code(x.dtype), 0, None)
    assert rc == 0
    return dw


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _inputs(ids, bm, K, N, E, dtype, trans, seed, bias=True, null_rows=True):
    g = torch.Generator().manual_seed(seed)
    gid = torch.tensor(ids, dtype=torch.int32)
    x = torch.randn(len(ids) * bm, K, generator=g)
    if null_rows:   # padding rows are zero, as the router leaves them
        x[(gid >= E).repeat_interleave(bm)] = 0
    shape = (E, N, K) if trans else (E, K, N)
    w = torch.randn(*shape, generator=g) / K ** 0.5
    b = torch.randn(E, N, generator=g) if bias else None
    return (x.to(dtype), w.to(dtype), None if b is None else b.to(dtype),
            gid)


#: (ids, bm, K, N, trans, act, tile): E = 4, so id 4 is a null block;
#: ``tile`` the bf16 tile the launch picks (`_device_for`; the narrow
#: tiles go by K or N alone)
_FWD_CASES = [
    # a 128-row tile over 8 blocks of 16, one expert; the 128 x 64 tile
    ([1] * 8, 16, 130, 70, False, "gelu_tanh", "mid"),
    # unsorted ids, null blocks inside spanned tiles, expert 3 owns none
    ([2, 0, 4, 1, 0, 2, 4, 4, 1, 1], 16, 70, 130, True, "silu", "mid"),
    ([2, 0, 4, 1, 0, 2, 4, 4, 1, 1], 16, 70, 130, False, "none", "wide"),
    ([2, 0, 4, 1, 0, 2, 4, 4, 1, 1], 16, 70, 130, True, "gelu", "wide2"),
    # K = 16 (LoRA's dx) and N = 16 (u, t): the narrow tiles
    ([3, 3, 0, 4, 0, 1, 1, 3, 2], 16, 16, 130, True, "none", "mid"),
    ([3, 3, 0, 4, 0, 1, 1, 3, 2], 16, 16, 70, False, "relu", "mid"),
    ([0, 2, 4, 2, 0, 0, 1, 3, 3, 2], 16, 130, 16, True, "none", "mid"),
    ([0, 2, 4, 2, 0, 0, 1, 3, 3, 2], 16, 70, 16, False, "gelu", "mid"),
    # 16-byte copies and stores: K, N multiples of 8
    ([0, 0, 1, 2, 2, 4], 32, 64, 64, False, "gelu_tanh", "mid"),
    ([0, 0, 1, 2, 2, 4], 32, 128, 136, True, "none", "wide"),
    # blocks of 48 rows straddle the 128-row tiles (sorted, as MoE's)
    ([0, 0, 1, 2, 2, 2, 4], 48, 64, 130, False, "gelu_tanh", "wide"),
    ([0, 0, 1, 2, 2, 2, 4], 48, 64, 130, False, "silu", "wide2"),
    ([0, 1, 3, 4, 4], 48, 16, 16, True, "none", "mid"),
    # nothing but null blocks
    ([4, 4, 4], 16, 70, 130, False, "gelu_tanh", "mid"),
]


@pytest.mark.parametrize("ids,bm,K,N,trans,act,tile", _FWD_CASES)
def test_grouped_forward_bf16_emulated(lib, ids, bm, K, N, trans, act,
                                       tile):
    dtype, E = torch.bfloat16, 4
    x, w, b, gid = _inputs(ids, bm, K, N, E, dtype, trans,
                           seed=K * 1000 + N + len(ids), bias=not trans)
    out, z = _fwd(lib, x, w, b, gid, act, trans, tile)
    wk = w.transpose(1, 2) if trans else w
    want = ops.grouped_linear_act_ref(x, wk, b, block_group=gid, act=act)
    want_z = ops.grouped_linear_act_ref(x, wk, b, block_group=gid)
    _close(out, want, _TOL[dtype])
    _close(z, want_z, _TOL[dtype])
    null = (gid >= E).repeat_interleave(bm)
    assert not out[null].any() and not z[null].any()


@pytest.mark.parametrize("trans", [False, True])
def test_grouped_forward_f32_emulated(lib, trans):
    """The f32 kernel with unsorted ids and null blocks, N and K off the
    64-column tile."""
    ids, bm, K, N, E = [2, 0, 4, 1, 0, 2, 4], 8, 70, 130, 4
    x, w, b, gid = _inputs(ids, bm, K, N, E, torch.float32, trans, seed=5)
    out, z = _fwd(lib, x, w, b, gid, "gelu_tanh", trans)
    wk = w.transpose(1, 2) if trans else w
    _close(out, ops.grouped_linear_act_ref(x, wk, b, block_group=gid,
                                           act="gelu_tanh"), 1e-4)
    _close(z, ops.grouped_linear_act_ref(x, wk, b, block_group=gid), 1e-4)


def test_grouped_f32_forward_repeats_emulated(lib):
    """The card test's f32 layout (counts [37, 0, 80, 11], blocks of 32, K
    96, N 160, gelu_tanh) 8 times: every run equal to the first bit for
    bit and to the plain version within 1e-4."""
    counts, bm, K, N, E = [37, 0, 80, 11], 32, 96, 160, 4
    nb = ops.num_group_blocks(sum(counts), E, bm)
    gid, offsets = ops.group_segments(torch.tensor(counts), bm, nb)
    g = torch.Generator().manual_seed(0)
    x = torch.zeros(nb * bm, K)
    for e, c in enumerate(counts):
        x[int(offsets[e]):int(offsets[e]) + c] = torch.randn(c, K,
                                                             generator=g)
    w = torch.randn(E, K, N, generator=g) / 10
    b = torch.randn(E, N, generator=g)
    want = ops.grouped_linear_act_ref(x, w, b, block_group=gid,
                                      act="gelu_tanh")
    first = None
    for _ in range(8):
        out, z = _fwd(lib, x, w, b, gid, "gelu_tanh", False)
        if first is None:
            first = (out, z)
            _close(out, want, 1e-4)
        assert torch.equal(out, first[0]) and torch.equal(z, first[1])


#: (counts, bm, K, N, S): sorted blocks; expert 1 owns one block, expert
#: 3 none
_DW_CASES = [
    ([40, 16, 30, 0], 16, 70, 130, 1),
    ([40, 16, 30, 0], 16, 70, 130, 3),
    ([70, 5, 33, 0], 16, 130, 16, 4),     # N = 16: LoRA's dA tile
    ([70, 5, 33, 0], 16, 16, 70, 2),      # K = 16: LoRA's dB tile
    ([64, 16, 50, 0], 16, 64, 64, 5),     # 16-byte copies; empty slices
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("counts,bm,K,N,S", _DW_CASES)
def test_grouped_dw_emulated(lib, dtype, counts, bm, K, N, S):
    E = len(counts)
    nb = ops.num_group_blocks(sum(counts), E, bm)
    gid, offsets = ops.group_segments(torch.tensor(counts), bm, nb)
    g = torch.Generator().manual_seed(K + N + S)
    x = torch.zeros(nb * bm, K)
    dz = torch.zeros(nb * bm, N)
    for e, c in enumerate(counts):
        o = int(offsets[e])
        x[o:o + c] = torch.randn(c, K, generator=g)
        dz[o:o + c] = torch.randn(c, N, generator=g)
    x, dz = x.to(dtype), dz.to(dtype)
    dw = _dw(lib, x, dz, gid, E, S)
    want = ops.grouped_dw_ref(x, dz, gid, E)
    tol = 1e-4 * max(counts) ** 0.5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(dw.float(), want.float(), atol=tol,
                               rtol=_TOL[dtype])
    for e, c in enumerate(counts):
        if c == 0:
            assert not dw[e].any()
    if S > 1:   # the slices' sum in a fixed order: a second run is equal
        assert torch.equal(_dw(lib, x, dz, gid, E, S), dw)


def test_grouped_dw_slices_rule(lib):
    """Slices: two blocks an SM (132 SMs) where the tiles alone would not
    fill the card, at least 256 of an expert's mean rows a slice, at most
    64; MoE training's tiles fill the card (1 slice)."""
    bf, f32 = (cuda_lib.dtype_code(t) for t in (torch.bfloat16,
                                                torch.float32))
    rule = lib.ptt_grouped_matmul_dw_slices
    assert rule(8192, 1024, 16, 1, bf, 0) == 17     # LoRA dA: 16 tiles
    assert rule(8192, 16, 3072, 1, bf, 0) == 6      # LoRA dB: 48 tiles
    assert rule(16896, 768, 3072, 4, bf, 0) == 1    # MoE training
    assert rule(16896, 768, 3072, 4, f32, 0) == 1
    assert rule(512, 1024, 16, 1, bf, 0) == 2       # capped by rows
    assert rule(200, 64, 64, 4, bf, 0) == 1
    assert rule(1 << 20, 16, 16, 1, bf, 0) == 64    # at most 64


def test_grouped_entries_refuse_bad_layouts(lib):
    """bf16 blocks must be 16-row multiples; S > 1 needs the scratch."""
    x = torch.zeros(64, 32, dtype=torch.bfloat16)
    w = torch.zeros(1, 32, 16, dtype=torch.bfloat16)
    gid = torch.zeros(8, dtype=torch.int32)       # blocks of 8
    out = torch.empty(64, 16, dtype=torch.bfloat16)
    code = cuda_lib.dtype_code(torch.bfloat16)
    assert lib.ptt_grouped_matmul_fwd(
        _ptr(x), _ptr(w), None, _ptr(gid), _ptr(out), None, 64, 32, 16, 1,
        8, 0, 0, code, 0, None) != 0
    dw = torch.empty(1, 32, 16, dtype=torch.bfloat16)
    assert lib.ptt_grouped_matmul_dw(
        _ptr(x), _ptr(out), _ptr(gid[:4]), _ptr(dw), None, 64, 32, 16, 1,
        16, 3, code, 0, None) != 0
