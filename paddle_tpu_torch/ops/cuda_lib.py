"""Build and bind the port's hand-written CUDA kernels.

Every ``paddle_tpu_torch/csrc/*.cu`` source is compiled by ``nvcc`` for
Hopper (``sm_90a``) into ONE shared library with a plain C interface,
``build/paddle_tpu_torch/libpaddle_tpu_torch_<digest>.so`` at the root of
the checkout, and loaded with ``ctypes``.  The build happens at first
use, never at import: the sources compile in parallel (one ``nvcc -c``
each, all started together) and one ``nvcc -shared`` links them.  The
file name carries a digest of the sources and flags, so an edited source
rebuilds and an unchanged one is reused.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; `check` raises when that is not 0, so a refused
launch (too many threads, too much shared memory) never passes silently.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["ARCH_FLAGS", "build", "library", "check", "dtype_code",
           "stream_handle", "sm_count", "tickets"]

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "paddle_tpu_torch"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
_CFLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.POINTER(ctypes.c_longlong)
#: C signature of every entry point: (argtypes, restype).  Each kernel
#: entry ends with (dtype code, device index, stream).
_SIGNATURES = {
    "ptt_layer_norm_fwd": ((_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I,
                            _P), _I),
    "ptt_layer_norm_bwd": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _P), _I),
    "ptt_layer_norm_residual_fwd": ((_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _F, _I, _I, _P), _I),
    "ptt_rms_norm_fwd": ((_P, _P, _P, _P, _I, _I, _F, _I, _I, _P), _I),
    "ptt_rms_norm_bwd": ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _P), _I),
    "ptt_matmul_epilogue_fwd": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _P), _I),
    "ptt_matmul_epilogue_bwd": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _P), _I),
    "ptt_matmul_epilogue_bwd_parts": ((_P, _P, _P, _I, _I, _I, _I), _I),
    "ptt_matmul_epilogue_bwd_vector_route": ((_P, _P, _P, _I, _I), _I),
    "ptt_matmul_epilogue_int8_fwd": ((_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _I, _I, _I, _I, _I, _P), _I),
    "ptt_softmax_xent_fwd": ((_P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
    "ptt_softmax_xent_bwd": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
    "ptt_ragged_attention_fwd": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                  _I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
                                 _I),
    "ptt_ragged_attention_int8_fwd": ((_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                       _F, _I, _I, _P), _I),
    "ptt_ragged_attention_mma_route": ((_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                        _I), _I),
    "ptt_flash_attention_fwd": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _LL, _F, _I, _I, _I, _P), _I),
    "ptt_flash_attention_bwd_dq": ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _LL, _F, _I, _I, _I, _P), _I),
    "ptt_flash_attention_bwd_dkv": ((_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _I, _I, _I, _LL, _F, _I, _I, _I, _P),
                                    _I),
    "ptt_grouped_matmul_fwd": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _I, _I, _P), _I),
    "ptt_grouped_matmul_dw_slices": ((_I, _I, _I, _I, _I, _I), _I),
    "ptt_grouped_matmul_dw": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _P), _I),
    "ptt_lora_sgmv_fwd": ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _P), _I),
    "ptt_lora_sgmv_mma_route": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I),
                                _I),
    "ptt_lora_sgmv_spans": ((_I, _I, _I), _I),
    "ptt_paged_attention_fwd": ((_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _I, _F, _I, _I, _P), _I),
    "ptt_paged_attention_vector_route": ((_P, _P, _P, _P, _I, _I), _I),
    "ptt_paged_attention_splits": ((_I, _I, _I, _I, _I, _I, _I), _I),
    "ptt_matmul_epilogue_tma_route": ((_P, _P, _I, _I, _I), _I),
    "ptt_layer_norm_vector_route": ((_P, _P, _P, _P, _I, _I), _I),
    "ptt_mma_check": ((_P, _P, _P, _I, _P), _I),
    "ptt_wgmma_check": ((_P, _P, _P, _I, _P), _I),
    "ptt_error_string": ((_I,), ctypes.c_char_p),
}

_lock = threading.Lock()
_lib = None


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
        "built from paddle_tpu_torch/csrc at first use")


def _sources():
    srcs = sorted(SRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    return srcs, sorted(SRC_DIR.glob("*.cuh"))


def _digest(files, flags):
    h = hashlib.sha256(" ".join(flags).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build():
    """Compile the kernels, unless this exact build is there already, and
    return the library's path."""
    srcs, headers = _sources()
    lib_path = (BUILD_DIR / "libpaddle_tpu_torch_"
                f"{_digest(srcs + headers, _CFLAGS)}.so")
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    obj_dir = BUILD_DIR / f"obj_{lib_path.stem}_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in srcs:
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *_CFLAGS, "-I", str(SRC_DIR), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                           + "\n".join(log))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    shutil.rmtree(obj_dir, ignore_errors=True)
    return lib_path


def library():
    """The loaded kernel library (built at first use), with every entry
    point's ``argtypes``/``restype`` declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            _lib = lib
        return _lib


def check(code, kernel):
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().ptt_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA error {code} ({msg})")


def dtype_code(dtype):
    """The C entry points' dtype code: 0 float32, 1 bfloat16."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]


def stream_handle(device):
    """PyTorch's current stream on ``device`` as a C pointer value."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


#: int32 counters of the kernels whose last block to finish does a merge
#: (paged attention, the epilogue backward), by (device, stream): each
#: launch leaves the ones it used 0, so they are zeroed once, when made
_tickets = {}


def tickets(device, n):
    """At least ``n`` zeroed int32 counters on ``device`` for launches on
    its current stream (one buffer a stream: launches on one stream run
    one after another)."""
    import torch
    key = (device.index, stream_handle(device))
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


@functools.lru_cache(maxsize=None)
def sm_count(index):
    """The SMs of CUDA device ``index``."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count
