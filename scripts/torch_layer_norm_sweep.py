#!/usr/bin/env python3
"""Sweep the layer-norm kernels' register budget (rows 2 and 6) on one
CUDA card.

    python3 scripts/torch_layer_norm_sweep.py

It builds ``paddle_tpu_torch/csrc/layer_norm.cu`` alone several times,
with its budget's constants (16-byte vectors of a row a lane holds,
hence the warps a row takes, and threads a block) set to other values,
prints each build's registers, and times each at the serving, training
and BERT shapes (CUDA events, L2 flushed: ``chip_smoke.time_ms``), every
output checked against the plain version.  Needs one CUDA device and
``nvcc``; writes its JSON to ``build/ln_sweep/ln_sweep.json`` and prints
it as its last line.
"""
from __future__ import annotations

import importlib.util
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "ln_sweep"

#: sweep variants: (forward 16-byte vectors a lane, forward threads,
#: backward vectors a lane, backward threads); the first is the source's
#: default
VARIANTS = [(2, 128, 4, 128), (1, 128, 2, 128), (4, 128, 8, 128),
            (2, 256, 4, 256)]
#: (rows, width) timed: the serving step's token budget (bf16 368, f32
#: 312), the training drive's 4096 and the flash drive's 8192 rows of
#: 2048, the BERT drive's 8192 of 768
FWD_SHAPES = {"serve": (None, 2048), "train": (4096, 2048),
              "train8192": (8192, 2048), "bert": (8192, 768)}
BWD_SHAPES = {k: v for k, v in FWD_SHAPES.items() if k != "serve"}
SERVE_ROWS = {"bfloat16": 256 + 7 * 16, "float32": 256 + 7 * 8}


def load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def dtypes():
    import torch
    return (("bfloat16", torch.bfloat16), ("float32", torch.float32))


def write(name, data):
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / name).write_text(json.dumps(data, indent=1))
    print(json.dumps(data), flush=True)


#: the budget's constants in ``csrc/layer_norm.cu``, in VARIANTS' order
CONSTANTS = ("kFwdLaneVectors", "kFwdThreads", "kBwdLaneVectors",
             "kBwdThreads")


def build_variant(cuda_lib, variant):
    """``layer_norm.cu`` with the budget's constants set to ``variant``,
    built alone into a shared library under ``build/ln_sweep``."""
    d = ROOT / "build" / "ln_sweep" / "_".join(map(str, variant))
    d.mkdir(parents=True, exist_ok=True)
    shutil.copy(cuda_lib.SRC_DIR / "common.cuh", d)
    src = (cuda_lib.SRC_DIR / "layer_norm.cu").read_text()
    for name, value in zip(CONSTANTS, variant):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"layer_norm.cu defines {name} {n} times")
    (d / "layer_norm.cu").write_text(src)
    out = d / "ln.so"
    cmd = [cuda_lib._nvcc(), *cuda_lib._CFLAGS, "-shared", "-I", str(d),
           str(d / "layer_norm.cu"), "-o", str(out)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {variant}: {res.stdout}{res.stderr}")
    return out


def bind(cuda_lib, path):
    import ctypes
    lib = ctypes.CDLL(str(path))
    for name in ("ptt_layer_norm_fwd", "ptt_layer_norm_bwd"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = cuda_lib._SIGNATURES[name]
    return lib


def sweep():
    import torch
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import cuda_lib
    from paddle_tpu_torch.ops.layer_norm import _BWD_BLOCKS_PER_SM
    cs = load_module("chip_smoke", ROOT / "chip_smoke.py")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        paths = list(pool.map(lambda v: build_variant(cuda_lib, v),
                              VARIANTS))
    print(f"built {len(paths)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for v, p in zip(VARIANTS, paths):
        print(f"variant {v}:", flush=True)
        cs.kernel_resources(cuda_lib, p, cs.LN_KERNEL_NAMES)
    libs = [bind(cuda_lib, p) for p in paths]
    sms = cuda_lib.sm_count(0)
    stream = cuda_lib.stream_handle(torch.device("cuda", 0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows_out = []
    for dname, dtype in dtypes():
        code = cuda_lib.dtype_code(dtype)
        for case, (rows, n) in FWD_SHAPES.items():
            rows = rows or SERVE_ROWS[dname]
            x = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
            g = (1 + 0.1 * torch.randn(n, device="cuda",
                                       generator=gen)).to(dtype)
            b = (0.1 * torch.randn(n, device="cuda",
                                   generator=gen)).to(dtype)
            out = torch.empty_like(x)
            mu = torch.empty(rows, device="cuda")
            rstd = torch.empty(rows, device="cuda")
            ref = ops.layer_norm_ref(x, g, b)[0]
            for v, lib in zip(VARIANTS, libs):
                def fwd(lib=lib):
                    return lib.ptt_layer_norm_fwd(
                        x.data_ptr(), g.data_ptr(), b.data_ptr(),
                        out.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
                        rows, n, 1e-5, code, 0, stream)
                assert fwd() == 0
                err = cs.compare(out, ref, dname)
                rows_out.append(dict(
                    kernel="fwd", dtype=dname, case=case, shape=[rows, n],
                    variant=v, ms=cs.time_ms(fwd), ok=err[2],
                    max_abs_err=err[0]))
            if case in BWD_SHAPES:
                do = torch.randn(rows, n, device="cuda",
                                 generator=gen).to(dtype)
                _, mu_r, rstd_r = ops.layer_norm_ref(x, g, b)
                want = ops.layer_norm_bwd_ref(x, g, mu_r, rstd_r, do)
                dx = torch.empty_like(x)
                dg, db = torch.empty_like(g), torch.empty_like(g)
                nblk = min(rows, _BWD_BLOCKS_PER_SM * sms)
                part = torch.empty(2, nblk, n, device="cuda")
                for v, lib in zip(VARIANTS, libs):
                    def bwd(lib=lib):
                        return lib.ptt_layer_norm_bwd(
                            x.data_ptr(), g.data_ptr(), mu_r.data_ptr(),
                            rstd_r.data_ptr(), do.data_ptr(), dx.data_ptr(),
                            dg.data_ptr(), db.data_ptr(), part.data_ptr(),
                            rows, n, nblk, code, 0, stream)
                    assert bwd() == 0
                    err = cs.compare(dx, want[0], dname)
                    rows_out.append(dict(
                        kernel="bwd", dtype=dname, case=case,
                        shape=[rows, n], variant=v, ms=cs.time_ms(bwd),
                        ok=err[2], max_abs_err=err[0]))
            torch.cuda.empty_cache()
    for r in rows_out:
        print(f"{r['kernel']} {r['dtype']:8s} {r['case']:9s} "
              f"{r['variant']} {r['ms']:.4f} ms ok={r['ok']}", flush=True)
    write("ln_sweep.json", dict(card=card_line(), variants=VARIANTS,
                                results=rows_out))


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_layer_norm_sweep: needs a CUDA device")
        sys.exit(1)
    sweep()


if __name__ == "__main__":
    main()
