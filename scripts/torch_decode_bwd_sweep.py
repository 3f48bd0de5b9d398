#!/usr/bin/env python3
"""Time variants of paged decode attention (row 9) and of the matmul
epilogue's backward (row 7) on one CUDA card.

    python3 scripts/torch_decode_bwd_sweep.py

Each variant is a copy of ``csrc/paged_attention.cu`` or
``csrc/matmul_epilogue.cu`` with a few lines replaced (`PAGED_VARIANTS`,
`BWD_VARIANTS`: constants, the split rule, a pass skipped to see what it
costs), built alone with ``nvcc`` (all in parallel) and swapped in for
the package's library while ``chip_smoke.check_paged`` and
``chip_smoke.check_matmul_epilogue_bwd`` time it (CUDA events, L2
flushed) at the drives' shapes; each run says whether the output still
matched the plain version (variants that skip work do not).  It also
times an empty call and one tiny PyTorch kernel the same way: the floor
of that timing.  Needs one CUDA device and ``nvcc``; writes its JSON to
``build/decode_bwd_sweep/sweep.json`` and prints it as its last line.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "decode_bwd_sweep"

#: (name, [(text, replacement), ...]) of paged_attention.cu; the first is
#: the source as it is, and it runs again last (the call's spread)
PAGED_VARIANTS = [
    ("default", []),
    ("lane_elems_32", [("constexpr int kLaneElems = 16;",
                        "constexpr int kLaneElems = 32;")]),
    ("one_split", [("  return static_cast<int>(std::max<long long>(s, 1));",
                    "  return 1;")]),
    ("no_kv_loads", [("          kr[r][v] = kp[sub + v * G];\n"
                      "          vr[r][v] = vp[sub + v * G];",
                      "          kr[r][v] = V{};\n"
                      "          vr[r][v] = V{};")]),
    ("next_tile_zeroed", [("    V nk[kRows][VPL], nvv[kRows][VPL];\n",
                           "    V nk[kRows][VPL] = {}, nvv[kRows][VPL] = {};\n")]),
    ("one_block_an_sm_min", [(
        "__global__ void __launch_bounds__(kVecThreads, 4)\n"
        "    paged_attn_vec_kernel",
        "__global__ void __launch_bounds__(kVecThreads)\n"
        "    paged_attn_vec_kernel")]),
    ("default_again", []),
]

#: the same for matmul_epilogue.cu's backward
BWD_VARIANTS = [
    ("default", []),
    ("warps8", [("constexpr int kBwdWarps = 16;",
                 "constexpr int kBwdWarps = 8;")]),
    ("warps32", [("constexpr int kBwdWarps = 16;",
                  "constexpr int kBwdWarps = 32;")]),
    ("default_again", []),
]
PAGED_CASES = ("decode", "long")
BWD_CASES = ("train", "flash", "bert_head")


def load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variant(cuda_lib, source, name, patches):
    """``source`` with ``patches`` applied, built alone under OUT/name."""
    d = OUT / f"{Path(source).stem}_{name}"
    d.mkdir(parents=True, exist_ok=True)
    for h in cuda_lib.SRC_DIR.glob("*.cuh"):
        shutil.copy(h, d)
    src = (cuda_lib.SRC_DIR / source).read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"{source} {name}: {old!r} is not there once")
        src = src.replace(old, new)
    (d / source).write_text(src)
    out = d / "variant.so"
    res = subprocess.run([cuda_lib._nvcc(), *cuda_lib._CFLAGS, "-shared",
                          "-I", str(d), str(d / source), "-o", str(out)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {source} {name}:\n{res.stdout}"
                           f"{res.stderr}")
    return out


class Swapped:
    """The package's library with the entry points ``variant`` has taken
    from ``variant``."""

    def __init__(self, base, variant):
        self._base, self._variant = base, variant

    def __getattr__(self, name):
        fn = getattr(self._variant, name, None)
        return fn if fn is not None else getattr(self._base, name)


def bind(cuda_lib, path):
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in cuda_lib._SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = list(argtypes), restype
    return lib


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_decode_bwd_sweep: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import cuda_lib
    cs = load_module("chip_smoke", ROOT / "chip_smoke.py")
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    jobs = [("paged_attention.cu", n, p) for n, p in PAGED_VARIANTS]
    jobs += [("matmul_epilogue.cu", n, p) for n, p in BWD_VARIANTS]
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        base = pool.submit(cuda_lib.library)
        paths = list(pool.map(lambda j: build_variant(cuda_lib, *j), jobs))
        base = base.result()
    print(f"built {len(paths)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for (src, name, _), path in zip(jobs, paths):
        print(f"{src} {name}:", flush=True)
        cs.kernel_resources(cuda_lib, path, cs.VEC_KERNEL_NAMES)
    cs.warm_up(ops)
    x = torch.zeros(16, device="cuda")
    floor = dict(empty_ms=cs.time_ms(lambda: None),
                 tiny_kernel_ms=cs.time_ms(lambda: x.add_(1.0)))
    print(f"floor: {floor}", flush=True)
    rows = []
    for (src, name, _), path in zip(jobs, paths):
        cuda_lib._lib = Swapped(base, bind(cuda_lib, path))
        try:
            for dtype, dname in ((torch.bfloat16, "bfloat16"),
                                 (torch.float32, "float32")):
                gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
                if src == "paged_attention.cu":
                    for case in PAGED_CASES:
                        r = cs.check_paged(ops, dtype, dname, gen, case)
                        rows.append(dict(kernel="paged_attention",
                                         variant=name, dtype=dname,
                                         case=case, ms=r["ms"], ok=r["ok"],
                                         bound_ms=r["bound_ms"]))
                else:
                    for case in BWD_CASES:
                        n_rows, n = cs.ME_BWD_CASES.get(
                            case, (cs.TRAIN_ROWS, cs.FFN))
                        r = cs.check_matmul_epilogue_bwd(
                            ops, n_rows, dtype, dname, gen, n=n)
                        rows.append(dict(kernel="matmul_epilogue_bwd",
                                         variant=name, dtype=dname,
                                         case=case, ms=r["ms"], ok=r["ok"],
                                         bound_ms=r["bound_ms"],
                                         library_ms=r["library_ms"]))
                        torch.cuda.empty_cache()
                for r in rows[-3 if src != "paged_attention.cu" else -2:]:
                    print(f"{r['kernel']} {r['variant']:15s} {r['dtype']:8s} "
                          f"{r['case']:9s} {r['ms']:.4f} ms (bound "
                          f"{r['bound_ms']:.4f}) ok={r['ok']}", flush=True)
        finally:
            cuda_lib._lib = base
    OUT.mkdir(parents=True, exist_ok=True)
    text = json.dumps(dict(card=card, floor=floor, results=rows))
    (OUT / "sweep.json").write_text(text)
    print(text)


if __name__ == "__main__":
    main()
