"""The port's CUDA sources compiled with g++ for the CPU stand-in of the
device language (``tests/cuda_emu``), once a test run.

`build_emulated` rewrites ``paddle_tpu_torch/csrc``'s headers (the
inline PTX of ``mma.cuh`` and ``wgmma.cuh`` replaced by their stand-ins)
and the given ``.cu`` sources (dynamic shared memory on the stand-in's
buffer, launches through ``emu_launch``), and builds them into one
library with the stand-in's ``emu.cpp``.  The library is keyed by a hash
of the compiler, its flags, every file it is built from and the
stand-in's own files, and built under a file lock in a directory that
the xdist workers of one run share (the parent of each worker's base
temporary directory; the base itself without xdist): the first worker to
ask builds it, the others load the same file.  An edited source, a
broken copy or a changed stand-in gets its own key.
"""
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import pytest

from paddle_tpu_torch.ops import cuda_lib

EMU = Path(__file__).resolve().parent / "cuda_emu"
_FLAGS = ("-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
          "-Wno-unknown-pragmas")


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


def _cache_dir(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    root = base / "cuda_emu_cache"
    root.mkdir(exist_ok=True)
    return root


def build_emulated(tmp_path_factory, name, sources):
    """The stand-in library of ``sources`` ({file name: text}, .cu files of
    csrc, edited or not), built once a run (see the module note), loaded
    with the entry points' signatures."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels for the CPU stand-in")
    files = {}
    for header in sorted(cuda_lib.SRC_DIR.glob("*.cuh")):
        text = header.read_text()
        if header.name == "mma.cuh":
            text = _emulated_header(text)
        elif header.name == "wgmma.cuh":
            text = _emulated_wgmma_header(text)
        files[header.name] = text
    cpps = [Path(n).stem + ".cpp" for n in sources]
    for cpp, text in zip(cpps, sources.values()):
        files[cpp] = _emulated_source(text)
    h = hashlib.sha256(" ".join((gxx,) + _FLAGS).encode())
    for fname in sorted(files):
        h.update(fname.encode() + b"\0" + files[fname].encode() + b"\0")
    for f in sorted(EMU.iterdir()):
        if f.is_file():
            h.update(f.name.encode() + b"\0" + f.read_bytes())
    key = f"{name}-{h.hexdigest()[:16]}"
    root = _cache_dir(tmp_path_factory)
    out = root / key
    so = out / f"lib{name}.so"
    with open(root / f"{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            out.mkdir(exist_ok=True)
            for fname, text in files.items():
                (out / fname).write_text(text)
            tmp = out / f"lib{name}.{os.getpid()}.tmp"
            build = subprocess.run(
                [gxx, *_FLAGS, "-I", str(EMU), "-I", str(out),
                 *(str(out / c) for c in cpps), str(EMU / "emu.cpp"),
                 "-o", str(tmp)],
                capture_output=True, text=True, timeout=600)
            assert build.returncode == 0, build.stderr[-4000:]
            os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for fn_name, (argtypes, restype) in cuda_lib._SIGNATURES.items():
        fn = getattr(lib, fn_name, None)
        if fn is not None:
            fn.argtypes, fn.restype = list(argtypes), restype
    lib.emu_set_block_order.argtypes = [ctypes.c_uint]
    return lib
