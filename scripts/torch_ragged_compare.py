#!/usr/bin/env python3
"""Compare ragged paged attention (rows 1 and 10) and the serving drives
of this checkout with another checkout's, on one CUDA card.

    python3 scripts/torch_ragged_compare.py PARENT_DIR

PARENT_DIR holds another commit of the repository, unpacked (``git
archive <commit> | tar -x -C build/parent``).  Both checkouts' kernels
are built first, in parallel; then four processes run one after another,
parent, this tree, this tree, parent, each with its own checkout's
package first on ``sys.path``:

* rows 1 and 10 with bf16 queries at ``chip_smoke.RAGGED_CASES`` (the
  mixed step, the decode-only step, the mixed step at heads of 64),
  through this tree's ``chip_smoke.check_ragged`` on either package, so
  both sides see the same inputs and bounds (CUDA events, L2 flushed);
* phases 4, 13, 18 and 22 (bf16 serving, int8 serving, MoE serving,
  multi-LoRA serving) through the process's own checkout's
  ``chip_smoke.py``, profiles included.

It prints each process's kernel times, ms/step, tokens/s and
ragged-attention device ms a step, and the greedy match ratio of this
tree's tokens against the parent's in each drive; the JSON goes to
``build/ragged_compare/compare.json`` and is printed as the last line.
Needs one CUDA device and ``nvcc``; the card's ``nvidia-smi`` line is
printed first.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import compare_common as cc

OUT = cc.ROOT / "build" / "ragged_compare"
#: the drives compared: (phase, summary key of its profile's buckets)
DRIVES = ("phase4", "phase13", "phase18", "phase22")
ROUTES = ("mma_launches", "f32_launches", "elementwise_launches")


def ragged_ms(summary):
    """Ragged attention's device ms a step (float + int8 buckets) of a
    drive's profile, or None where the profiler saw no device time."""
    prof = summary.get("profile")
    if not prof:
        return None
    per = prof["device_ms_per_step"]
    return per.get("ragged_attention", 0.0) + per.get(
        "ragged_attention_int8", 0.0)


def worker(root, label, out_path):
    """One process: the kernel times, then the four drives."""
    torch, cs, pt, ops, _ = cc.start_worker(root)
    here = cc.this_tree()
    for fn in (ops.ragged_paged_attention, ops.ragged_paged_attention_int8):
        for name in ROUTES:     # a checkout without route counters
            if not hasattr(fn, name):
                setattr(fn, name, 0)
    cs.warm_up(ops)
    res = {"label": label, "root": str(root), "kernels": {}}
    gen = torch.Generator(device="cuda").manual_seed(here.SEED)
    for case in here.RAGGED_CASES:
        for int8 in (False, True):
            r = here.check_ragged(ops, 16, torch.bfloat16, "bfloat16", gen,
                                  int8=int8, case=case)
            key = f"{case}/{'int8' if int8 else 'bf16'}"
            res["kernels"][key] = {k: r[k] for k in (
                "ms", "plain_ms", "bound_ms", "err", "route", "note")}
            print(f"{label} {key}: {r['ms']:.4f} ms (bound "
                  f"{r['bound_ms']:.4f}, plain {r['plain_ms']:.4f}), max "
                  f"abs err {r['err']:.3e}, route {r['route']}", flush=True)
    torch.cuda.empty_cache()
    cs.reset_routes(ops)
    _, serving, tokens = cs.phase_serving(pt, ops)
    res["phase4"], res["phase4_tokens"] = serving, tokens
    cs.free_device_memory()
    _, res["phase13"], res["phase13_tokens"] = cs.phase_serving(
        pt, ops, int8=True, base=dict(serving, generated=tokens))
    cs.free_device_memory()
    _, res["phase18"], res["phase18_tokens"] = cs.phase_serving(
        pt, ops, moe=True, base=serving)
    cs.free_device_memory()
    _, lora, generated = cs.phase_multilora_serving(pt, ops)
    res["phase22"], res["phase22_tokens"] = lora["lora"], generated["lora"]
    Path(out_path).write_text(json.dumps(res, default=str))


def summary_line(res):
    parts = []
    for d in DRIVES:
        s = res[d]
        parts.append(f"{d} {s['ms_per_step']:.2f} ms/step, "
                     f"{s['tokens_per_s']:.1f} tokens/s, ragged "
                     f"{ragged_ms(s)} ms a step")
    return "; ".join(parts)


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
            "plain_ms": [r["kernels"][key]["plain_ms"] for r in runs],
            "max_abs_err": [r["kernels"][key]["err"] for r in runs]}
    for d in DRIVES:
        out["drives"][d] = {
            "ms_per_step": [r[d]["ms_per_step"] for r in runs],
            "tokens_per_s": [r[d]["tokens_per_s"] for r in runs],
            "ragged_ms_per_step": [ragged_ms(r[d]) for r in runs],
            "device_idle_share": [
                (r[d].get("profile") or {}).get("device_idle_share")
                for r in runs],
            "greedy_match_vs_first_parent": [
                greedy_match_ratio(first[f"{d}_tokens"], r[f"{d}_tokens"])
                for r in runs]}
    for key, v in out["kernels"].items():
        print(f"  {key}: ms {v['ms']} (bound {v['bound_ms']:.4f})")
    for d, v in out["drives"].items():
        print(f"  {d}: ms/step {v['ms_per_step']}, ragged ms a step "
              f"{v['ragged_ms_per_step']}, greedy match "
              f"{v['greedy_match_vs_first_parent']}")
    cc.write_out(OUT, out)


if __name__ == "__main__":
    main()
