"""The CUDA source of the flash attention kernels and of ``csrc/mma.cuh``,
run on the CPU against the plain versions.

``paddle_tpu_torch/csrc/flash_attention.cu`` and ``mma_check.cu`` are
compiled with g++ against a CPU stand-in for the CUDA device language
(``tests/cuda_emu``: one thread per CUDA thread, block and warp barriers,
and the PTX of ``mma.cuh`` -- ``ldmatrix``, ``mma.sync`` m16n8k16,
``cp.async`` -- replaced by functions that follow the PTX fragment
layouts), then called through the same C entry points and signatures as
the card's library.  Tiny shapes with ragged edges: the bf16 tensor-core
kernels at heads of 40-256, on separate tensors and on the views
``qkv.unbind(2)`` gives (129: the element-wise staging), several key
tiles, Sq = 1, Sq > Sk (rows that see no key: exact zeros) and Sq < Sk;
the f32 CUDA-core kernels at two shapes; the ``mma.cuh`` fragments
exactly equal to ``torch.mm`` on integer tiles.  Tolerances as on the
card (``tests/test_torch_cuda.py``): bf16 2e-2 abs + rel, f32 1e-4, lse
1e-4 abs + 1e-5 rel.  The stand-in copies synchronously, so it checks
layouts, masks and arithmetic, not the asynchronous schedule or speed;
the card tests and ``chip_smoke.py`` do that.
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

_EMU = Path(__file__).resolve().parent / "cuda_emu"
_SOURCES = ("flash_attention.cu", "mma_check.cu")
_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _emulated_header(text):
    """mma.cuh with each inline PTX statement replaced by its stand-in."""
    def sub(m):
        asm = m.group(0)
        if "ldmatrix" in asm:
            return f"emu_ldmatrix(r, p, {str('.trans' in asm).lower()});\n"
        if "mma.sync" in asm:
            return "emu_mma(d, a, b0, b1);\n"
        if "cp.async.cg" in asm:
            return "emu_cp_async(dst, src, src_bytes, 16);\n"
        if "cp.async.ca" in asm:
            return "emu_cp_async(dst, src, src_bytes, 4);\n"
        return ";\n"   # commit / wait: the stand-in copies synchronously
    out, n = re.subn(r"asm volatile\(.*?\);\n", sub, text, flags=re.S)
    assert n == 7, f"mma.cuh has {n} asm statements, the stand-in knows 7"
    return out


def _emulated_source(text):
    """A .cu file with dynamic shared memory on the stand-in's buffer,
    static shared memory static, and launches through `emu_launch`."""
    text = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(emu.dyn);", text)
    text = text.replace("__shared__", "static")
    return re.sub(r"([\w:]+(?:<[^;<>]*>)?)<<<(.*?)>>>\((.*?)\);",
                  r"emu_launch(\2, [&] { \1(\3); });", text, flags=re.S)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels for the CPU stand-in")
    out = tmp_path_factory.mktemp("cuda_emu")
    for header in cuda_lib.SRC_DIR.glob("*.cuh"):
        text = header.read_text()
        if header.name == "mma.cuh":
            text = _emulated_header(text)
        (out / header.name).write_text(text)
    cpps = []
    for name in _SOURCES:
        cpp = out / (Path(name).stem + ".cpp")
        cpp.write_text(_emulated_source((cuda_lib.SRC_DIR / name).read_text()))
        cpps.append(str(cpp))
    so = out / "libemu.so"
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


def _strides(*tensors):
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


#: (B, Sq, Sk, H, D, causal, view)
_CASES = [(1, 100, 100, 2, 64, True, False), (1, 100, 100, 1, 64, False, False),
          (1, 3, 130, 1, 64, True, False), (1, 70, 30, 1, 64, True, False),
          (1, 33, 150, 1, 128, False, False), (1, 1, 70, 2, 128, True, False),
          (1, 40, 40, 1, 40, True, False), (1, 50, 50, 1, 96, False, False),
          (1, 70, 70, 1, 256, True, False), (1, 40, 40, 1, 160, False, False),
          (1, 70, 70, 2, 129, True, True), (1, 130, 130, 2, 64, True, True),
          (1, 20, 60, 1, 128, False, False)]
_F32_CASES = [(1, 100, 100, 1, 64, True, False),
              (1, 40, 60, 1, 160, False, False)]


@pytest.mark.parametrize(
    "dtype,B,Sq,Sk,H,D,causal,view",
    [(torch.bfloat16, *c) for c in _CASES]
    + [(torch.float32, *c) for c in _F32_CASES])
def test_flash_kernels_emulated(lib, dtype, B, Sq, Sk, H, D, causal, view):
    g = torch.Generator().manual_seed(Sq * 1000 + D)
    if view:
        q, k, v = torch.randn(B, Sq, 3, H, D, generator=g).to(dtype).unbind(2)
    else:
        q, k, v = (torch.randn(B, s, H, D, generator=g).to(dtype)
                   for s in (Sq, Sk, Sk))
    do = torch.randn(B, Sq, H, D, generator=g).to(dtype)
    scale, code = D ** -0.5, cuda_lib.dtype_code(dtype)
    out = torch.full((B, Sq, H, D), float("nan"), dtype=dtype)
    lse = torch.full((B, H, Sq), float("nan"))
    assert lib.ptt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, Sq, Sk, D, _strides(q, k, v), scale,
        int(causal), code, 0, None) == 0
    out_r, lse_r = ops.flash_attention_ref(q, k, v, causal, scale)
    _close(out, out_r, _TOL[dtype])
    torch.testing.assert_close(lse, lse_r, atol=1e-4, rtol=1e-5)

    lse_s, delta = ops.flash_bwd_stats(out_r, do, lse_r)
    dq = torch.full((B, Sq, H, D), float("nan"), dtype=dtype)
    dk = torch.full((B, Sk, H, D), float("nan"), dtype=dtype)
    dv = torch.full_like(dk, float("nan"))
    st = _strides(q, k, v, do)
    stats = (lse_s.data_ptr(), delta.data_ptr())
    assert lib.ptt_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), *stats,
        dq.data_ptr(), B, H, Sq, Sk, D, st, scale, int(causal), code, 0,
        None) == 0
    assert lib.ptt_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), *stats,
        dk.data_ptr(), dv.data_ptr(), B, H, Sq, Sk, D, st, scale,
        int(causal), code, 0, None) == 0
    for got, want in zip((dq, dk, dv), ops.flash_attention_bwd_ref(
            q, k, v, do, lse_s, delta, causal, scale)):
        _close(got, want, _TOL[dtype])
    if causal and Sq > Sk:   # rows that see no key: exact zeros
        empty = Sq - Sk
        assert float(out[:, :empty].abs().max()) == 0.0
        assert float(dq[:, :empty].abs().max()) == 0.0
        assert bool((lse[..., :empty] == -1e30).all())


def test_mma_fragments_emulated(lib):
    """`ptt_mma_check` (see ``csrc/mma_check.cu``) on integer tiles: the
    transposed and plain ldmatrix paths and the accumulator fed back as an
    A fragment each equal torch.mm bit for bit."""
    g = torch.Generator().manual_seed(1)
    a = torch.randint(-2, 3, (16, 16), generator=g).to(torch.bfloat16)
    b = torch.randint(-2, 3, (16, 16), generator=g).to(torch.bfloat16)
    c = torch.full((3, 16, 16), float("nan"))
    assert lib.ptt_mma_check(a.data_ptr(), b.data_ptr(), c.data_ptr(), 0,
                             None) == 0
    ab = torch.mm(a.float(), b.float())
    for got, want in zip(c, (ab, ab, torch.mm(ab, b.float()))):
        assert torch.equal(got, want)
