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

import json
import sys
from pathlib import Path

import compare_common as cc

OUT = cc.ROOT / "build" / "decode_bwd_compare"
#: the drives compared, with the summary key of their ms a step
DRIVES = {"phase8": "step_ms", "phase15": "step_ms", "phase24": "step_ms",
          "phase25": "decode_ms_per_step"}
#: profile buckets read from each drive
BUCKETS = ("matmul_epilogue_bwd", "paged_attention", "column_sum")


def buckets(summary):
    """The row-7, row-9 and column-sum device ms a step of a drive's
    profile, or None where the profiler saw no device time."""
    return cc.buckets(summary, BUCKETS)


def worker(root, label, out_path):
    """One process: the kernel times, then the drives."""
    torch, cs, pt, ops, _ = cc.start_worker(root)
    here = cc.this_tree()
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
                n_rows, n, act = here.ME_BWD_CASES.get(
                    case, (here.TRAIN_ROWS, here.FFN, "gelu_tanh"))
                r = here.check_matmul_epilogue_bwd(
                    ops, n_rows, dtype, dtype_name, gen, n=n, act=act)
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
    trees = {"parent": Path(sys.argv[1]).resolve(), "change": cc.ROOT}
    card, runs = cc.run_order(
        __file__, trees, cc.ORDER, OUT,
        after=lambda label, r: print(f"{label}: {summary_line(r)}",
                                     flush=True))
    sys.path.insert(0, str(cc.ROOT))
    from paddle_tpu_torch.quantization import greedy_match_ratio
    first = runs[0]
    out = {"card": card, "order": list(cc.ORDER), "kernels": {},
           "drives": {}}
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
    cc.write_out(OUT, out)


if __name__ == "__main__":
    main()
