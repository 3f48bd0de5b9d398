#!/usr/bin/env python3
"""Sweep the register budgets of the RMS norm backward's vector route (row
12) and of the residual layer norm's (row 13) on one CUDA card.

    python3 scripts/torch_norm_sweep.py

It builds ``paddle_tpu_torch/csrc/rms_norm.cu`` and ``layer_norm.cu``
alone several times each, with their budget's constants set to other
values (row 12: values of a row a lane holds, threads a block,
threads an SM of the persistent grid; row 13: vectors a lane, threads a
block), all in parallel, prints each build's registers and stack bytes,
and times each at the shapes the drives give it (row 12 at
``chip_smoke.RMS_SHAPES``, row 13 at the BERT drive's [8192, 768]), in
bf16 and f32 (CUDA events, L2 flushed: ``chip_smoke.time_ms``), every
output checked against the plain version.  The first variant of each is
the source's default; a variant may also name an edit of the source
(`EDITS`: row 12 loading two rows ahead).  Needs one CUDA device and ``nvcc``; writes its
JSON to ``build/norm_sweep/norm_sweep.json`` and prints it as its last
line.
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
OUT = ROOT / "build" / "norm_sweep"

#: per kernel: its source, the budget's constants and the variants (the
#: source's values first; a trailing name applies that edit of `EDITS`)
SWEEPS = {
    "rms_bwd": ("rms_norm.cu",
                ("kBwdLaneValues", "kBwdThreads", "kBwdSmThreads"),
                [(16, 256, 512), (16, 128, 512), (16, 128, 384),
                 (16, 512, 512), (8, 128, 768), (8, 128, 1024),
                 (8, 256, 1024), (16, 256, 512, "ahead2"),
                 (16, 128, 512, "ahead2")]),
    "ln_res": ("layer_norm.cu", ("kResLaneVectors", "kResThreads"),
               [(3, 128), (1, 128), (2, 128), (4, 128), (6, 128),
                (3, 256)]),
}


#: edits of a source for a variant, as (text, replacement) pairs; each
#: text must occur once.  "ahead2": the RMS norm backward loads its row
#: two rows ahead (x, dy and rstd of row + 2 steps) instead of one.
EDITS = {"ahead2": [
    ("""  V a[kC], d[kC];
  load_row<W>(a, xv, row, rows, nv, t);
  load_row<W>(d, dv, row, rows, nv, t);
  float r = row < static_cast<size_t>(rows) ? rstd[row] : 0.f;
""", """  V a[kC], d[kC], pa[kC], pd[kC];
  load_row<W>(a, xv, row, rows, nv, t);
  load_row<W>(d, dv, row, rows, nv, t);
  float r = row < static_cast<size_t>(rows) ? rstd[row] : 0.f;
  load_row<W>(pa, xv, row + step, rows, nv, t);
  load_row<W>(pd, dv, row + step, rows, nv, t);
  float pr = row + step < static_cast<size_t>(rows) ? rstd[row + step] : 0.f;
"""),
    ("    const size_t nrow = row + step;\n",
     "    const size_t nrow = row + 2 * step;\n"),
    ("""      a[c] = na[c];
      d[c] = nd[c];
    }
    r = nr;
""", """      a[c] = pa[c];
      d[c] = pd[c];
      pa[c] = na[c];
      pd[c] = nd[c];
    }
    r = pr;
    pr = nr;
""")]}


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


def build_variant(cuda_lib, kernel, variant):
    """The kernel's source with its budget's constants set to ``variant``,
    built alone into a shared library under ``build/norm_sweep``."""
    source, names, _ = SWEEPS[kernel]
    d = OUT / f"{kernel}_{'_'.join(map(str, variant))}"
    d.mkdir(parents=True, exist_ok=True)
    shutil.copy(cuda_lib.SRC_DIR / "common.cuh", d)
    src = (cuda_lib.SRC_DIR / source).read_text()
    for name, value in zip(names, variant):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"{source} defines {name} {n} times")
    edit = variant[len(names)] if len(variant) > len(names) else None
    for text, replacement in EDITS.get(edit, []):
        if src.count(text) != 1:
            raise RuntimeError(f"{source} no longer has: {text!r}")
        src = src.replace(text, replacement)
    (d / source).write_text(src)
    out = d / "lib.so"
    cmd = [cuda_lib._nvcc(), *cuda_lib._CFLAGS, "-shared", "-I", str(d),
           str(d / source), "-o", str(out)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {kernel} {variant}: {res.stdout}"
                           f"{res.stderr}")
    return out


def bind(cuda_lib, path):
    import ctypes
    lib = ctypes.CDLL(str(path))
    for name, sig in cuda_lib._SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = sig
    return lib


def time_rms_bwd(cs, ops, cuda_lib, libs, gen):
    """Row 12's backward through each variant's library at every
    `RMS_SHAPES` shape, bf16 and f32."""
    import torch
    stream = cuda_lib.stream_handle(torch.device("cuda", 0))
    rows_out = []
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        code = cuda_lib.dtype_code(dtype)
        for case, (rows, n) in cs.RMS_SHAPES.items():
            x = (torch.randn(rows, n, device="cuda", generator=gen)
                 + 0.5).to(dtype)
            g = (1 + 0.1 * torch.randn(n, device="cuda",
                                       generator=gen)).to(dtype)
            do = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
            _, rstd = ops.rms_norm_ref(x, g, cs.RMS_EPS)
            dx_r, dg_r = ops.rms_norm_bwd_ref(x, g, rstd, do)
            abs_sum = (do.float() * x.float() * rstd[:, None]).abs().sum(0)
            dx, dg = torch.empty_like(x), torch.empty_like(g)
            for v, lib in libs:
                nblk = lib.ptt_rms_norm_bwd_blocks(rows, n, x.element_size(),
                                                   1, 0)
                part = torch.empty(nblk, n, device="cuda")

                def bwd(lib=lib, nblk=nblk, part=part):
                    return lib.ptt_rms_norm_bwd(
                        x.data_ptr(), g.data_ptr(), rstd.data_ptr(),
                        do.data_ptr(), dx.data_ptr(), dg.data_ptr(),
                        part.data_ptr(), rows, n, nblk, code, 0, stream)
                assert bwd() == 0
                err = cs.compare(dx, dx_r, dname)
                dg_ok = cs.compare_sum(dg, dg_r, abs_sum, dname)[1]
                rows_out.append(dict(
                    kernel="rms_bwd", dtype=dname, case=case,
                    shape=[rows, n], variant=v, blocks=nblk,
                    ms=cs.time_ms(bwd), ok=err[2] and dg_ok,
                    max_abs_err=err[0]))
            torch.cuda.empty_cache()
    return rows_out


def time_ln_res(cs, ops, cuda_lib, libs, gen):
    """Row 13 through each variant's library at the BERT drive's [8192,
    768], bf16 and f32."""
    import torch
    stream = cuda_lib.stream_handle(torch.device("cuda", 0))
    rows, n = cs.BERT_ROWS, cs.BERT_HIDDEN
    rows_out = []
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        code = cuda_lib.dtype_code(dtype)
        x = (2 * torch.randn(rows, n, device="cuda", generator=gen)
             + 0.5).to(dtype)
        r = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
        g = (1 + 0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
        b = (0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
        ref = ops.layer_norm_residual_ref(x, r, g, b, 1e-12)
        out, s = torch.empty_like(x), torch.empty_like(x)
        mu = torch.empty(rows, device="cuda")
        rstd = torch.empty(rows, device="cuda")
        for v, lib in libs:
            def fwd(lib=lib):
                return lib.ptt_layer_norm_residual_fwd(
                    x.data_ptr(), r.data_ptr(), g.data_ptr(), b.data_ptr(),
                    out.data_ptr(), s.data_ptr(), mu.data_ptr(),
                    rstd.data_ptr(), rows, n, 1e-12, code, 0, stream)
            assert fwd() == 0
            err = cs.compare(out, ref[0], dname)
            ok = err[2] and torch.equal(s, ref[1])
            rows_out.append(dict(
                kernel="ln_res", dtype=dname, case="bert", shape=[rows, n],
                variant=v, ms=cs.time_ms(fwd), ok=ok, max_abs_err=err[0]))
    return rows_out


def sweep():
    import torch
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import cuda_lib
    cs = load_module("chip_smoke", ROOT / "chip_smoke.py")
    jobs = [(k, v) for k, (_, _, vs) in SWEEPS.items() for v in vs]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = list(pool.map(lambda j: build_variant(cuda_lib, *j), jobs))
    print(f"built {len(paths)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    resources = {}
    for (k, v), p in zip(jobs, paths):
        print(f"{k} variant {v}:", flush=True)
        names = ("rms_bwd_vec_kernel",) if k == "rms_bwd" \
            else ("ln_res_fwd_vec_kernel",)
        res = cs.kernel_resources(cuda_lib, p, names) or {}
        resources[f"{k} {v}"] = res
    libs = {k: [(v, bind(cuda_lib, p)) for (kk, v), p in zip(jobs, paths)
                if kk == k] for k in SWEEPS}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows_out = time_rms_bwd(cs, ops, cuda_lib, libs["rms_bwd"], gen)
    rows_out += time_ln_res(cs, ops, cuda_lib, libs["ln_res"], gen)
    for r in rows_out:
        print(f"{r['kernel']} {r['dtype']:8s} {r['case']:8s} "
              f"{r['variant']} {r['ms']:.4f} ms ok={r['ok']}"
              + (f" blocks={r['blocks']}" if "blocks" in r else ""),
              flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    data = dict(card=card_line(),
                variants={k: v[2] for k, v in SWEEPS.items()},
                resources=resources, results=rows_out)
    (OUT / "norm_sweep.json").write_text(json.dumps(data, indent=1))
    print(json.dumps(data), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_norm_sweep: needs a CUDA device")
        sys.exit(1)
    sweep()


if __name__ == "__main__":
    main()
