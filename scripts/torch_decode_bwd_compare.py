#!/usr/bin/env python3
"""Compare paged decode attention (row 9), the matmul epilogue's backward
(row 7) and the drives that run them in this checkout with another
checkout's, on one CUDA card.

    python3 scripts/torch_decode_bwd_compare.py PARENT_DIR

PARENT_DIR holds another commit of the repository, unpacked (``git
archive <commit> | tar -x -C build/parent``).  Both checkouts' kernels
are built first, in parallel; then four processes run one after another,
parent, this tree, this tree, parent, each with its own checkout's
package first on ``sys.path``:

* row 9 at ``chip_smoke.PAGED_CASES`` (phase 25's decode step, a long
  decode of 4 x 4096 keys) and row 7 at the training drive's [4096, 8192]
  and ``chip_smoke.ME_BWD_CASES`` (the fc1 shapes of phases 8, 24 and
  15), bf16 and f32, through this tree's ``chip_smoke.check_paged`` and
  ``check_matmul_epilogue_bwd`` on either package, so both sides see the
  same inputs and bounds (CUDA events, L2 flushed);
* phases 8 (flash training), 15 (BERT training), 24 (LoRA fine-tuning)
  and 9 + 25 (dense and paged decoding) through the process's own
  checkout's ``chip_smoke.py``, profiles included, and the greedy tokens
  of phase 25's bf16 paged decode.

It prints each process's kernel times, ms/step, the row-7 and row-9
device ms a step of each drive and the greedy match ratio of each
process's paged tokens against the first parent's; the JSON goes to
``build/decode_bwd_compare/compare.json`` and is printed as the last
line.  Needs one CUDA device and ``nvcc``; the card's ``nvidia-smi``
line is printed first.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "decode_bwd_compare"
ORDER = ("parent", "change", "change", "parent")
#: the drives compared, with the summary key of their ms a step
DRIVES = {"phase8": "step_ms", "phase15": "step_ms", "phase24": "step_ms",
          "phase25": "decode_ms_per_step"}
#: profile buckets read from each drive
BUCKETS = ("matmul_epilogue_bwd", "paged_attention", "column_sum")


def load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def buckets(summary):
    """The row-7, row-9 and column-sum device ms a step of a drive's
    profile, or None where the profiler saw no device time."""
    prof = summary.get("profile")
    if not prof:
        return None
    per = prof["device_ms_per_step"]
    return {b: per.get(b, 0.0) for b in BUCKETS}


def worker(root, label, out_path):
    """One process: the kernel times, then the drives."""
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = load_module("chip_smoke", root / "chip_smoke.py")
    here = load_module("chip_smoke_here", ROOT / "chip_smoke.py")
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import cuda_lib
    cuda_lib.library()
    for fn in (ops.paged_attention, ops.fused_linear_act_bwd):
        for name in ("vector_launches", "elementwise_launches"):
            if not hasattr(fn, name):    # a checkout without the counters
                setattr(fn, name, 0)
    cs.warm_up(ops)
    res = {"label": label, "root": str(root), "kernels": {}}
    gen = torch.Generator(device="cuda").manual_seed(here.SEED)
    rows = [("paged_attention", case) for case in here.PAGED_CASES]
    rows += [("matmul_epilogue_bwd", "train")]
    rows += [("matmul_epilogue_bwd", case) for case in here.ME_BWD_CASES]
    for dtype, dtype_name in ((torch.bfloat16, "bfloat16"),
                              (torch.float32, "float32")):
        for name, case in rows:
            if name == "paged_attention":
                r = here.check_paged(ops, dtype, dtype_name, gen, case)
            else:
                rows_n = here.ME_BWD_CASES.get(case, (here.TRAIN_ROWS,
                                                      here.FFN))
                r = here.check_matmul_epilogue_bwd(
                    ops, rows_n[0], dtype, dtype_name, gen, n=rows_n[1])
            key = f"{name}/{case}/{dtype_name}"
            res["kernels"][key] = {k: r[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "err", "route",
                "shape")}
            print(f"{label} {key}: {r['ms']:.4f} ms (bound "
                  f"{r['bound_ms']:.4f}, plain {r['plain_ms']:.4f}, library "
                  f"{r['library_ms']}), max abs err {r['err']:.3e}, route "
                  f"{r['route']}", flush=True)
            torch.cuda.empty_cache()
    cs.reset_routes(ops)
    _, res["phase8"] = cs.phase_training(pt, ops, flash=True)
    cs.free_device_memory()
    _, res["phase15"] = cs.phase_bert_training(pt, ops)
    cs.free_device_memory()
    _, res["phase24"] = cs.phase_lora_training(pt, ops)
    cs.free_device_memory()
    keep = {}
    _, generate = cs.phase_generate(pt, ops, keep=keep)
    cs.free_device_memory()
    _, res["phase25"] = cs.phase_paged(pt, ops, keep, generate)
    cs.free_device_memory()
    model = pt.GPTForCausalLM(pt.GPTConfig(**pt.GPT_1P3B),
                              dtype=torch.bfloat16, seed=cs.SEED).eval()
    toks = cs.paged_generate(pt, ops, model, keep["prompts"].numpy(),
                             cs.GEN_NEW, "cuda")[0]
    res["phase25_tokens"] = toks.tolist()
    Path(out_path).write_text(json.dumps(res, default=str))


def summary_line(res):
    return "; ".join(
        f"{d} {res[d][key]:.2f} ms/step, buckets {buckets(res[d])}"
        for d, key in DRIVES.items())


def main():
    if len(sys.argv) == 5 and sys.argv[1] == "--worker":
        worker(*sys.argv[2:])
        return
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    parent = Path(sys.argv[1]).resolve()
    if not (parent / "chip_smoke.py").exists():
        sys.exit(f"{parent}: no chip_smoke.py, not a checkout")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from paddle_tpu_torch.ops import cuda_lib; "
         "cuda_lib.library()"], cwd=str(d)) for d in (parent, ROOT)]
    if any(b.wait() for b in builds):
        sys.exit("a build failed")
    runs = []
    for i, label in enumerate(ORDER):
        path = OUT / f"{i}_{label}.json"
        root = parent if label == "parent" else ROOT
        rc = subprocess.run([sys.executable, __file__, "--worker",
                             str(root), label, str(path)]).returncode
        if rc:
            sys.exit(f"the {label} process failed ({rc})")
        runs.append(json.loads(path.read_text()))
        print(f"{label}: {summary_line(runs[-1])}", flush=True)
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch.quantization import greedy_match_ratio
    first = runs[0]
    out = {"card": card, "order": list(ORDER), "kernels": {}, "drives": {}}
    for key in first["kernels"]:
        out["kernels"][key] = {
            "ms": [r["kernels"][key]["ms"] for r in runs],
            "bound_ms": first["kernels"][key]["bound_ms"],
            "library_ms": [r["kernels"][key]["library_ms"] for r in runs],
            "plain_ms": [r["kernels"][key]["plain_ms"] for r in runs],
            "max_abs_err": [r["kernels"][key]["err"] for r in runs],
            "route": [r["kernels"][key]["route"] for r in runs]}
    for d, key in DRIVES.items():
        out["drives"][d] = {
            "ms_per_step": [r[d][key] for r in runs],
            "buckets_ms_per_step": [buckets(r[d]) for r in runs],
            "device_idle_share": [
                (r[d].get("profile") or {}).get("device_idle_share")
                for r in runs]}
    out["drives"]["phase8"]["losses"] = [r["phase8"]["losses"] for r in runs]
    out["drives"]["phase25"]["greedy_match_vs_first_parent"] = [
        greedy_match_ratio(first["phase25_tokens"], r["phase25_tokens"])
        for r in runs]
    for key, v in out["kernels"].items():
        print(f"  {key}: ms {v['ms']} (bound {v['bound_ms']:.4f}, library "
              f"{v['library_ms']})")
    for d, v in out["drives"].items():
        print(f"  {d}: ms/step {v['ms_per_step']}, buckets "
              f"{v['buckets_ms_per_step']}")
    print(f"  phase25 greedy match vs the first parent: "
          f"{out['drives']['phase25']['greedy_match_vs_first_parent']}")
    text = json.dumps(out)
    (OUT / "compare.json").write_text(text)
    print(text)


if __name__ == "__main__":
    main()
