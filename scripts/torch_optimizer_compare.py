#!/usr/bin/env python3
"""Compare the optimizer step and the training drives that run it in this
checkout with another checkout's, on one CUDA card; or sweep the update's
chunk size in this checkout.

    python3 scripts/torch_optimizer_compare.py PARENT_DIR
    python3 scripts/torch_optimizer_compare.py --sweep

PARENT_DIR holds another commit of the repository, unpacked (``git
archive <commit> | tar -x -C build/parent``).  Both checkouts' kernels
are built first, in parallel; then one process a run, one after
another, parent, this tree, this tree, parent (`compare_common`):

* the optimizer step alone: GPT_1P3B's 1.3 B f32 parameters with seeded
  random gradients, ``AdamW(1e-4, weight_decay=0.01)`` with
  ``ClipGradByGlobalNorm(1.0)`` (phases 6 and 8's), ``step()`` timed by
  CUDA events (the median of 5 after 2 untimed), the clip alone the same
  way, and the memory the step adds to the peak;
* phases 6 (composite, B=4) and 8 (flash + recompute, B=8) through the
  process's own checkout's ``chip_smoke.py``: ms/step, tokens/s, peak
  memory and one profiled step, whose "other" group holds AdamW, the
  clip and the O1 casts.

``--sweep`` runs one process on this tree: the same step at each chunk
size of `SWEEP` (``optimizer.CHUNK_ELEMENTS``, the most elements one
multi-tensor chunk covers), over the f32 parameters and over bf16 ones
(O2's, whose chunks also hold f32 copies of the parameters and
gradients).

It prints each process's numbers; the JSON goes to
``build/optimizer_compare/compare.json`` (``sweep.json``) and is printed
as the last line.  Needs one CUDA device and ``nvcc``; the card's
``nvidia-smi`` line is printed first.
"""
from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

import compare_common as cc

OUT = cc.ROOT / "build" / "optimizer_compare"
#: profile groups read from each drive
BUCKETS = ("other", "cublas_gemm", "matmul_epilogue", "layer_norm",
           "layer_norm_bwd")
#: chunk sizes of the sweep, in elements
SWEEP = tuple(1 << k for k in range(24, 29))


def event_ms(torch, fn, warmup=2, iters=5):
    """The median CUDA-event ms of ``fn`` over ``iters`` calls after
    ``warmup`` untimed ones."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def gpt_params(torch, pt, seed, dtype):
    """GPT_1P3B's parameters in ``dtype`` with seeded random gradients."""
    model = pt.GPTForCausalLM(pt.GPTConfig(**pt.GPT_1P3B), dtype=dtype,
                              seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = list(model.parameters())
    for p in params:
        p.grad = (1e-3 * torch.randn(p.shape, device="cuda",
                                     generator=gen)).to(dtype)
    return params


def optimizer_step(torch, pt, params):
    """The AdamW step and the clip alone over ``params``."""
    clip = pt.nn.ClipGradByGlobalNorm(1.0)
    opt = pt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                             parameters=params, grad_clip=clip)
    opt.step()                            # the moments exist from here
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms = event_ms(torch, opt.step)
    extra_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    clip_ms = event_ms(torch, lambda: clip(params))
    del opt
    torch.cuda.empty_cache()
    return dict(params=sum(p.numel() for p in params), tensors=len(params),
                step_ms=step_ms, clip_ms=clip_ms,
                step_extra_peak_gib=extra_gib)


def worker(root, label, out_path):
    torch, cs, pt, ops, _ = cc.start_worker(root)
    cs.warm_up(ops)
    cs.reset_routes(ops)
    res = {"label": label, "root": str(root),
           "chunk_elements": getattr(pt.optimizer.optimizer,
                                     "CHUNK_ELEMENTS", None)}
    params = gpt_params(torch, pt, cs.SEED, torch.float32)
    res["optimizer"] = optimizer_step(torch, pt, params)
    del params
    torch.cuda.empty_cache()
    print(f"{label} optimizer step: {res['optimizer']}", flush=True)
    for key, flash in (("phase6", False), ("phase8", True)):
        _, res[key] = cs.phase_training(pt, ops, flash=flash)
        cs.free_device_memory()
    Path(out_path).write_text(json.dumps(res, default=str))


def sweep():
    """`optimizer_step` at each chunk size of `SWEEP`, f32 and bf16."""
    torch, cs, pt, _, _ = cc.start_worker(cc.ROOT)
    mod = pt.optimizer.optimizer
    default = mod.CHUNK_ELEMENTS
    card = cc.card_line()
    print(card, flush=True)
    out = {"card": card, "default_chunk_elements": default, "runs": []}
    for dtype in (torch.float32, torch.bfloat16):
        params = gpt_params(torch, pt, cs.SEED, dtype)
        for chunk in SWEEP:
            mod.CHUNK_ELEMENTS = chunk
            row = dict(optimizer_step(torch, pt, params),
                       dtype=str(dtype).split(".")[-1],
                       chunk_elements=chunk)
            print(f"sweep {row}", flush=True)
            out["runs"].append(row)
        mod.CHUNK_ELEMENTS = default
        del params
        torch.cuda.empty_cache()
    OUT.mkdir(parents=True, exist_ok=True)
    text = json.dumps(out)
    (OUT / "sweep.json").write_text(text)
    print(text)


def main():
    if len(sys.argv) == 5 and sys.argv[1] == "--worker":
        worker(*sys.argv[2:])
        return
    if sys.argv[1:] == ["--sweep"]:
        sweep()
        return
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    trees = {"parent": Path(sys.argv[1]).resolve(), "change": cc.ROOT}
    card, runs = cc.run_order(__file__, trees, cc.ORDER, OUT)
    out = {"card": card, "order": list(cc.ORDER),
           "chunk_elements": [r.get("chunk_elements") for r in runs],
           "optimizer": [r["optimizer"] for r in runs], "drives": {}}
    for d in ("phase6", "phase8"):
        out["drives"][d] = {
            "ms_per_step": [r[d]["step_ms"] for r in runs],
            "tokens_per_s": [r[d]["tokens_per_s"] for r in runs],
            "peak_memory_gib": [r[d]["peak_memory_gib"] for r in runs],
            "buckets_ms_per_step": [cc.buckets(r[d], BUCKETS)
                                    for r in runs],
            "device_busy_ms": [(r[d].get("profile") or {}).get(
                "device_busy_ms") for r in runs],
            "device_idle_share": [(r[d].get("profile") or {}).get(
                "device_idle_share") for r in runs]}
    for r in runs:
        print(f"  {r['label']}: optimizer {r['optimizer']}")
    for d, v in out["drives"].items():
        print(f"  {d} ({list(cc.ORDER)}): ms/step {v['ms_per_step']}, peak "
              f"{v['peak_memory_gib']} GiB, busy {v['device_busy_ms']}, "
              f"buckets {v['buckets_ms_per_step']}")
    cc.write_out(OUT, out)


if __name__ == "__main__":
    main()
