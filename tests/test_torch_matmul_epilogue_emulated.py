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

import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import cuda_lib
from paddle_tpu_torch.ops.matmul_epilogue import act_f32
from cuda_emu_build import build_emulated

_SOURCES = ("matmul_epilogue.cu", "wgmma_check.cu")
_TOL = 2e-2
_ACTS = ops.ACTIVATIONS

@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_emulated(
        tmp_path_factory, "epilogue",
        {name: (cuda_lib.SRC_DIR / name).read_text() for name in _SOURCES})


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _route(lib, x, w):
    K, N = w.shape
    return "tma" if lib.ptt_matmul_epilogue_tma_route(
        _ptr(x), _ptr(w), K, N, w.element_size()) else "elementwise"


def _fwd(lib, x, w, b, act, splits, want_z=True, device=0):
    """The forward entry point on CPU tensors, NaN-filled outputs
    (a missed element shows), `splits` K chunks; on the stand-in's
    ``device`` (0: 132 SMs, d > 0: d SMs: the persistent grid's size)."""
    M, K = x.shape
    N = w.shape[1]
    out = torch.full((M, N), float("nan"), dtype=x.dtype)
    z = torch.full_like(out, float("nan")) if want_z else None
    part = torch.full((splits, M, N), float("nan")) if splits > 1 else None
    rc = lib.ptt_matmul_epilogue_fwd(
        _ptr(x), _ptr(w), _ptr(b), _ptr(out), _ptr(z), _ptr(part), M, K, N,
        splits, _ACTS.index(act), cuda_lib.dtype_code(x.dtype), device, None)
    assert rc == 0
    return out, z


def _fwd_int8(lib, x, w_q, scale, b, act, splits, device=0):
    M, K = x.shape
    N = w_q.shape[1]
    out = torch.full((M, N), float("nan"), dtype=x.dtype)
    part = torch.full((splits, M, N), float("nan")) if splits > 1 else None
    rc = lib.ptt_matmul_epilogue_int8_fwd(
        _ptr(x), _ptr(w_q), _ptr(scale), _ptr(b), _ptr(out), _ptr(part), M,
        K, N, splits, _ACTS.index(act), cuda_lib.dtype_code(x.dtype),
        cuda_lib.dtype_code(b.dtype), device, None)
    assert rc == 0
    return out


def _close(got, want, tol=_TOL):
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


#: f16 against its plain version: about five f16 ulps at unit scale
_F16_TOL = 5e-3


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


@pytest.mark.parametrize("M,K,N,splits", [(64, 128, 64, 1),
                                           (70, 200, 130, 3)],
                         ids=["aligned", "ragged"])
def test_matmul_epilogue_f16_emulated(lib, M, K, N, splits):
    """f16 takes the f32 CUDA-core tiles (f16 loads and stores, f32
    sums), with and without split-K; int8 codes with an f16 and an f32
    bias."""
    from paddle_tpu_torch.quantization import quantize_weight_int8
    g = torch.Generator().manual_seed(M + K)
    x = torch.randn(M, K, generator=g).to(torch.float16)
    wf = torch.randn(K, N, generator=g) / K ** 0.5
    b = torch.randn(N, generator=g).to(torch.float16)
    out, z = _fwd(lib, x, wf.to(torch.float16), b, "gelu_tanh", splits)
    want, want_z = ops.linear_act_ref(x, wf.to(torch.float16), b,
                                      "gelu_tanh", return_z=True)
    _close(out, want, _F16_TOL)
    _close(z, want_z, _F16_TOL)
    w_q, scale = quantize_weight_int8(wf, axis=1)
    for bias in (b, b.float()):
        got = _fwd_int8(lib, x, w_q, scale, bias, "silu", splits)
        _close(got, ops.linear_act_int8_ref(x, w_q, scale, bias, "silu"),
               _F16_TOL)


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
