"""The CUDA source of the matmul epilogue's forward (rows 3 and 11) and of
``csrc/wgmma.cuh``, run on the CPU against the plain versions.

``paddle_tpu_torch/csrc/matmul_epilogue.cu`` and ``wgmma_check.cu`` are
compiled with g++ against the CPU stand-in for the CUDA device language
(``tests/cuda_emu``; see ``tests/test_torch_flash_emulated.py``), with
each inline PTX statement of ``wgmma.cuh`` replaced by its stand-in
(``tests/cuda_emu/wgmma_emu.h``): mbarriers with arrival and transaction
counts and phases, TMA 2-D tile loads with zero fill outside the tensor
and the 128-byte swizzle, and ``wgmma`` m64nNk16 reading A (K-major) and
B (MN-major, the transpose-B form) through their decoded descriptors and
writing the PTX accumulator layout.  The kernels are then called through
the same C entry points and signatures as the card's library.

Tiny ragged shapes: M off the 128-row tile, N = 130, 70 and 9 and K = 17
and 200 (the element-wise staging route), N of 136-512 and K up to 1000
(TMA, the last K slice and column tile ragged, the 4-stage ring wrapped;
on a one-SM stand-in device one persistent block through every tile and
K chunk),
split-K with its fixed-order second pass, every activation, z written,
int8 codes widened in shared memory with the bias in bf16 and in f32.
Tolerance as on the card (``tests/test_torch_cuda.py``): bf16 2e-2 abs +
2e-2 rel; every case run twice, bit-identical.  tanh-GELU's negative
tail (z in [-6, -1], where 1 + tanh cancels and that gate would let an
approximate tanh pass) within two bf16 ulps, on exact products.  The
wrappers' Python copy of the staging-route rule answers as the
library's.  ``ptt_wgmma_check``'s integer products equal ``torch.mm``
exactly.  The stand-in acts
synchronously and reads the descriptors as the kernels write them: it
checks layouts, masks, barrier counts and phases, passes and sums, not
the asynchronous schedule, nor which descriptor offset the hardware
reads for which step (the card's ``wgmma_check`` does that).
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import cuda_lib
from paddle_tpu_torch.ops.matmul_epilogue import act_f32
from test_torch_flash_emulated import _emulated_header, _emulated_source

_EMU = Path(__file__).resolve().parent / "cuda_emu"
_SOURCES = ("matmul_epilogue.cu", "wgmma_check.cu")
_TOL = 2e-2
_ACTS = ops.ACTIVATIONS
_BF16 = cuda_lib.dtype_code(torch.bfloat16)

#: wgmma.cuh's inline PTX statements (first match) and their stand-ins
_STANDINS = (
    ("fence.mbarrier_init", ";"),
    ("mbarrier.init", "emu_mbar_init(bar, count);"),
    ("mbarrier.arrive.expect_tx", "emu_mbar_arrive(bar, bytes);"),
    ("mbarrier.arrive", "emu_mbar_arrive(bar, 0);"),
    ("mbarrier.try_wait", "ok = emu_mbar_wait(bar, parity);"),
    ("tensor.2d.shared::cluster", "emu_tma_load_2d(dst, map, bar, c0, c1);"),
    ("tensor.2d.global.shared", "emu_tma_store_2d(map, src, c0, c1);"),
    ("cp.async.bulk.commit_group", ";"),
    ("cp.async.bulk.wait_group", ";"),
    ("fence.proxy.async", ";"),
    ("wgmma.mma_async", None),
    ("wgmma.fence", ";"),
    ("wgmma.commit_group", ";"),
    ("wgmma.wait_group", ";"),
    ('asm volatile("" :', ";"),
    ("bar.sync", "emu_named_barrier(id, count);"),
)


def _emulated_wgmma_header(text):
    """wgmma.cuh with each inline PTX statement replaced by its stand-in."""
    def sub(m):
        asm = m.group(0)
        for key, standin in _STANDINS:
            if key in asm:
                if standin is None:
                    n = re.search(r"\.m64n(\d+)k16\.", asm).group(1)
                    standin = f"emu_wgmma<{n}>(d, desc_a, desc_b, scale_d);"
                return standin + "\n"
        raise AssertionError(f"no stand-in for {asm[:80]!r}")
    out, n = re.subn(r"asm volatile\(.*?\);\n", sub, text, flags=re.S)
    assert n == 17, f"wgmma.cuh has {n} asm statements, the stand-in knows 17"
    return out.replace("#include <cstdint>\n",
                       '#include <cstdint>\n\n#include "wgmma_emu.h"\n', 1)


def build_emulated(out, sources):
    """Compile ``sources`` ({file name: text}, .cu files of csrc, edited or
    not) with the headers for the stand-in into ``out`` and load the
    library with the entry points' signatures."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels for the CPU stand-in")
    for header in cuda_lib.SRC_DIR.glob("*.cuh"):
        text = header.read_text()
        if header.name == "mma.cuh":
            text = _emulated_header(text)
        elif header.name == "wgmma.cuh":
            text = _emulated_wgmma_header(text)
        (out / header.name).write_text(text)
    cpps = []
    for name, text in sources.items():
        cpp = out / (Path(name).stem + ".cpp")
        cpp.write_text(_emulated_source(text))
        cpps.append(str(cpp))
    so = out / "libemu_epilogue.so"
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         "-Wno-unknown-pragmas", "-I", str(_EMU), "-I", str(out), *cpps,
         str(_EMU / "emu.cpp"), "-o", str(so)],
        capture_output=True, text=True, timeout=600)
    assert build.returncode == 0, build.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in cuda_lib._SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = list(argtypes), restype
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_emulated(
        tmp_path_factory.mktemp("cuda_emu_epilogue"),
        {name: (cuda_lib.SRC_DIR / name).read_text() for name in _SOURCES})


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _route(lib, x, w):
    K, N = w.shape
    return "tma" if lib.ptt_matmul_epilogue_tma_route(
        _ptr(x), _ptr(w), K, N, w.element_size()) else "elementwise"


def _fwd(lib, x, w, b, act, splits, want_z=True, device=0):
    """The bf16 forward entry point on CPU tensors, NaN-filled outputs
    (a missed element shows), `splits` K chunks; on the stand-in's
    ``device`` (0: 132 SMs, d > 0: d SMs: the persistent grid's size)."""
    M, K = x.shape
    N = w.shape[1]
    out = torch.full((M, N), float("nan"), dtype=x.dtype)
    z = torch.full_like(out, float("nan")) if want_z else None
    part = torch.full((splits, M, N), float("nan")) if splits > 1 else None
    rc = lib.ptt_matmul_epilogue_fwd(
        _ptr(x), _ptr(w), _ptr(b), _ptr(out), _ptr(z), _ptr(part), M, K, N,
        splits, _ACTS.index(act), _BF16, device, None)
    assert rc == 0
    return out, z


def _fwd_int8(lib, x, w_q, scale, b, act, splits, device=0):
    M, K = x.shape
    N = w_q.shape[1]
    out = torch.full((M, N), float("nan"), dtype=x.dtype)
    part = torch.full((splits, M, N), float("nan")) if splits > 1 else None
    rc = lib.ptt_matmul_epilogue_int8_fwd(
        _ptr(x), _ptr(w_q), _ptr(scale), _ptr(b), _ptr(out), _ptr(part), M,
        K, N, splits, _ACTS.index(act), _BF16, cuda_lib.dtype_code(b.dtype),
        device, None)
    assert rc == 0
    return out


def _close(got, want):
    torch.testing.assert_close(got.float(), want.float(), atol=_TOL,
                               rtol=_TOL)


def _inputs(M, K, N, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=g).to(torch.bfloat16)
    w = (torch.randn(K, N, generator=g) / K ** 0.5).to(torch.bfloat16)
    b = torch.randn(N, generator=g).to(torch.bfloat16)
    return x, w, b


#: (M, K, N, act, splits, route): M off the 128-row tile; K = 640 wraps
#: the 4-stage ring; N = 136 and 192 end in a partial column tile
_BF16_CASES = [
    (200, 640, 192, "gelu_tanh", 1, "tma"),
    (70, 1000, 136, "silu", 4, "tma"),
    (4, 512, 256, "gelu_tanh", 2, "tma"),
    (130, 128, 64, "none", 1, "tma"),
    (70, 200, 130, "gelu", 1, "elementwise"),
    (5, 17, 9, "relu", 1, "elementwise"),
    (33, 1000, 70, "none", 3, "elementwise"),
]


@pytest.mark.parametrize("M,K,N,act,splits,route", _BF16_CASES)
def test_matmul_epilogue_bf16_emulated(lib, M, K, N, act, splits, route):
    x, w, b = _inputs(M, K, N, seed=M * 7 + K + N)
    assert _route(lib, x, w) == route
    out, z = _fwd(lib, x, w, b, act, splits)
    want, want_z = ops.linear_act_ref(x, w, b, act, return_z=True)
    _close(out, want)
    _close(z, want_z)
    again, z2 = _fwd(lib, x, w, b, act, splits)
    assert torch.equal(again, out) and torch.equal(z2, z)


#: (weights, M, K, N, act, splits): on the stand-in device with one SM,
#: one persistent block takes every work item in turn, its stage ring
#: running on across tiles (and K chunks), its bias buffers alternating
_ONE_BLOCK_CASES = [("bf16", 100, 640, 520, "gelu", 1),
                    ("bf16", 70, 1000, 136, "silu", 4),
                    ("bf16", 500, 128, 256, "gelu_tanh", 1),
                    ("bf16", 37, 72, 130, "relu", 2),
                    ("int8", 70, 256, 400, "gelu_tanh", 1),
                    ("int8", 37, 200, 130, "none", 1)]


@pytest.mark.parametrize("weights,M,K,N,act,splits", _ONE_BLOCK_CASES)
def test_matmul_epilogue_one_block_emulated(lib, weights, M, K, N, act,
                                            splits):
    if weights == "bf16":
        x, w, b = _inputs(M, K, N, seed=M + K + N + 1)
        out, z = _fwd(lib, x, w, b, act, splits, device=1)
        want, want_z = ops.linear_act_ref(x, w, b, act, return_z=True)
        _close(out, want)
        _close(z, want_z)
        assert torch.equal(_fwd(lib, x, w, b, act, splits, device=1)[0],
                           out)
    else:
        from paddle_tpu_torch.quantization import quantize_weight_int8
        g = torch.Generator().manual_seed(M + K + N)
        x = torch.randn(M, K, generator=g).to(torch.bfloat16)
        w_q, scale = quantize_weight_int8(
            torch.randn(K, N, generator=g) / K ** 0.5, axis=1)
        b = torch.randn(N, generator=g)
        out = _fwd_int8(lib, x, w_q, scale, b, act, splits, device=1)
        _close(out, ops.linear_act_int8_ref(x, w_q, scale, b, act))
        assert torch.equal(
            _fwd_int8(lib, x, w_q, scale, b, act, splits, device=1), out)


@pytest.mark.parametrize("act", _ACTS)
@pytest.mark.parametrize("route", ["tma", "elementwise"])
def test_matmul_epilogue_activations_emulated(lib, act, route):
    """Every activation through both routes; serving's form (no z)."""
    M, K, N = (96, 128, 128) if route == "tma" else (37, 72, 130)
    x, w, b = _inputs(M, K, N, seed=len(act))
    assert _route(lib, x, w) == route
    out, z = _fwd(lib, x, w, b, act, 1, want_z=False)
    assert z is None
    _close(out, ops.linear_act_ref(x, w, b, act))


def test_matmul_epilogue_misaligned_view_emulated(lib):
    """x a view one element off 16 bytes: TMA cannot describe it, so the
    element-wise route runs at K and N that TMA would take."""
    x, w, b = _inputs(40, 128, 128, seed=3)
    buf = torch.zeros(40 * 128 + 1, dtype=torch.bfloat16)
    buf[1:] = x.reshape(-1)
    xv = buf[1:].view(40, 128)
    assert xv.data_ptr() % 16 and _route(lib, xv, w) == "elementwise"
    out, z = _fwd(lib, xv, w, b, "gelu_tanh", 1)
    want, want_z = ops.linear_act_ref(x, w, b, "gelu_tanh", return_z=True)
    _close(out, want)
    _close(z, want_z)


#: (M, K, N, act, splits, route): int8 codes need N % 16 for TMA
_INT8_CASES = [
    (70, 256, 128, "gelu_tanh", 1, "tma"),
    (200, 640, 272, "silu", 1, "tma"),
    (33, 1000, 144, "none", 4, "tma"),
    (64, 256, 136, "gelu", 1, "elementwise"),
    (70, 200, 130, "relu", 1, "elementwise"),
    (5, 17, 9, "gelu_tanh", 2, "elementwise"),
]


@pytest.mark.parametrize("bias", ["bfloat16", "float32"])
@pytest.mark.parametrize("M,K,N,act,splits,route", _INT8_CASES)
def test_matmul_epilogue_int8_emulated(lib, M, K, N, act, splits, route,
                                       bias):
    """Per-channel codes and f32 scales, an all-zero channel (scale 1,
    output act(b)); the bias in x's type or f32."""
    from paddle_tpu_torch.quantization import quantize_weight_int8
    g = torch.Generator().manual_seed(M + K + N)
    x = torch.randn(M, K, generator=g).to(torch.bfloat16)
    wf = torch.randn(K, N, generator=g) / K ** 0.5
    wf[:, 0] = 0.0
    w_q, scale = quantize_weight_int8(wf, axis=1)
    b = torch.randn(N, generator=g).to(getattr(torch, bias))
    assert _route(lib, x, w_q) == route
    out = _fwd_int8(lib, x, w_q, scale, b, act, splits)
    _close(out, ops.linear_act_int8_ref(x, w_q, scale, b, act))
    _close(out[:, 0], act_f32(b[0].float().expand(M), act))
    assert torch.equal(_fwd_int8(lib, x, w_q, scale, b, act, splits), out)


def test_tma_route_rule_emulated(lib):
    """TMA where both operands' bases and row strides are 16-byte
    aligned: K and N multiples of 8 for bf16, N of 16 for int8 codes."""
    x = torch.zeros(8, 64, dtype=torch.bfloat16)
    rule = lib.ptt_matmul_epilogue_tma_route
    assert rule(_ptr(x), _ptr(x), 64, 64, 2) == 1
    assert rule(_ptr(x), _ptr(x), 64, 130, 2) == 0
    assert rule(_ptr(x), _ptr(x), 17, 64, 2) == 0
    assert rule(_ptr(x), _ptr(x), 64, 136, 1) == 0
    assert rule(_ptr(x), _ptr(x), 64, 144, 1) == 1
    assert rule(_ptr(x) + 2, _ptr(x), 64, 64, 2) == 0
    assert rule(_ptr(x), _ptr(x) + 8, 64, 64, 2) == 0


#: (x's offset in elements, K, w's dtype, w's offset, N, TMA?)
ROUTE_CASES = [(0, 64, torch.bfloat16, 0, 64, True),
               (0, 64, torch.bfloat16, 0, 130, False),
               (0, 17, torch.bfloat16, 0, 64, False),
               (1, 64, torch.bfloat16, 0, 64, False),
               (0, 64, torch.bfloat16, 4, 64, False),
               (8, 64, torch.bfloat16, 8, 64, True),
               (0, 64, torch.int8, 0, 136, False),
               (0, 64, torch.int8, 0, 144, True),
               (0, 64, torch.int8, 8, 144, False),
               (0, 64, torch.int8, 16, 144, True)]


def route_operands(x_off, K, w_dtype, w_off, N, device="cpu"):
    """x [4, K] bf16 and w [K, N] as views ``x_off`` and ``w_off``
    elements into 16-byte aligned buffers."""
    xb = torch.zeros(4 * K + 16, dtype=torch.bfloat16, device=device)
    wb = torch.zeros(K * N + 16, dtype=w_dtype, device=device)
    return (xb[x_off:x_off + 4 * K].view(4, K),
            wb[w_off:w_off + K * N].view(K, N))


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_tma_route_python_rule_emulated(lib, case):
    """The wrappers count each launch's route by `tma_route`, a Python
    copy of the kernel's rule: both give the same answer."""
    from paddle_tpu_torch.ops.matmul_epilogue import tma_route
    x, w = route_operands(*case[:-1])
    K, N = w.shape
    assert tma_route(x, w, K, N) == case[-1]
    assert lib.ptt_matmul_epilogue_tma_route(
        _ptr(x), _ptr(w), K, N, w.element_size()) == case[-1]


def gelu_tail_inputs(M, K, N, int8, gen, device="cpu"):
    """Operands whose products and sums are exact in f32 whatever their
    order (x and the codes in {-1, 0, 1}, w or the scale 2^-10), so the
    kernel's z and the plain version's are the same floats, with the
    bias spreading z over about [-6, -1], tanh-GELU's negative tail,
    where 1 + tanh cancels.  Returns (x, w or (w_q, scale), b, z)."""
    x = torch.randint(-1, 2, (M, K), generator=gen, device=device)
    w = torch.randint(-1, 2, (K, N), generator=gen, device=device)
    b = torch.linspace(-6.0, -1.0, N, device=device).to(torch.bfloat16)
    x = x.to(torch.bfloat16)
    z = x.float() @ w.float() * 2.0 ** -10 + b.float()
    if int8:
        scale = torch.full((N,), 2.0 ** -10, device=device)
        return x, (w.to(torch.int8), scale), b, z
    return x, (w.float() * 2.0 ** -10).to(torch.bfloat16), b, z


def assert_gelu_tail(got, want, z):
    """``got`` within two bf16 ulps of the plain value ``want`` plus
    2^-22·|z| (a few f32 ulps of tanh near -1, times z / 2: where tanh
    rounds to -1 one side may give 0)."""
    want = want.float()
    _, e = torch.frexp(want)
    ulp = torch.where(want == 0, torch.zeros_like(want),
                      torch.ldexp(torch.ones_like(want), e - 8))
    err = (got.float() - want).abs()
    tol = 2 * ulp + 2.0 ** -22 * z.abs()
    bad = err > tol
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.numel()} values off; worst at z = "
        f"{float(z[bad][0])}: {float(got.float()[bad][0])} vs "
        f"{float(want[bad][0])}")


#: (weights, M, K, N, splits): TMA, split-K, the element-wise route
_TAIL_CASES = [("bf16", 70, 256, 192, 1), ("bf16", 4, 512, 256, 2),
               ("bf16", 5, 17, 130, 1), ("int8", 70, 256, 144, 1),
               ("int8", 4, 512, 144, 2)]


@pytest.mark.parametrize("weights,M,K,N,splits", _TAIL_CASES)
def test_gelu_tanh_tail_emulated(lib, weights, M, K, N, splits):
    """tanh-GELU for z in [-6, -1] within two bf16 ulps of the plain
    version, through every staging route and split-K's second pass."""
    g = torch.Generator().manual_seed(M + K + N)
    x, w, b, z = gelu_tail_inputs(M, K, N, weights == "int8", g)
    if weights == "int8":
        out = _fwd_int8(lib, x, *w, b, "gelu_tanh", splits)
        want = ops.linear_act_int8_ref(x, *w, b, "gelu_tanh")
    else:
        out, _ = _fwd(lib, x, w, b, "gelu_tanh", splits, want_z=False)
        want = ops.linear_act_ref(x, w, b, "gelu_tanh")
    assert_gelu_tail(out, want, z)


def test_wgmma_check_emulated(lib):
    """`ptt_wgmma_check` (``csrc/wgmma_check.cu``) on integer tiles: the
    TMA-loaded and the thread-staged products equal torch.mm bit for
    bit."""
    g = torch.Generator().manual_seed(2)
    a = torch.randint(-3, 4, (64, 64), generator=g).to(torch.bfloat16)
    b = torch.randint(-3, 4, (64, 128), generator=g).to(torch.bfloat16)
    c = torch.full((2, 64, 128), float("nan"))
    assert lib.ptt_wgmma_check(a.data_ptr(), b.data_ptr(), c.data_ptr(), 0,
                               None) == 0
    want = torch.mm(a.float(), b.float())
    assert torch.equal(c[0], want) and torch.equal(c[1], want)
