#!/usr/bin/env python3
"""Compare the RMS norm backward (row 12), the residual layer norm (row
13), the paged-decode wrapper's host time and the drives that run them in
this checkout with another checkout's, on one CUDA card.

    python3 scripts/torch_norm_compare.py PARENT_DIR [OLDER_DIR]

PARENT_DIR holds another commit of the repository, unpacked (``git
archive <commit> | tar -x -C build/parent``); OLDER_DIR, if given, a
third one.  Every checkout's kernels are built first, in parallel; then
one process a run, one after another, parent, this tree, this tree,
parent (OLDER_DIR's runs first and last), each with its own checkout's
package first on ``sys.path``:

* row 12's backward at ``chip_smoke.RMS_SHAPES`` and row 13 at the BERT
  drive's [8192, 768], bf16 and f32, through this tree's
  ``chip_smoke.check_rms_norm_bwd`` and ``check_layer_norm_residual`` on
  either package, so both sides see the same inputs and bounds (CUDA
  events, L2 flushed), with the route each launch took (a checkout
  without the counters reports none);
* the host time a call of the paged-decode wrapper (``ops.paged_attention``
  at phase 25b's decode step: 4 sequences, 16 heads of 128, pages of 16,
  13 pages a table, bf16) and of its parts (the library's split query,
  the merge's scratch, the counters, the stream handle, where a checkout
  has them), the median over repeats of back-to-back calls with no
  synchronisation in between, and the layer norm's wrapper at the same
  step's [4, 2048] beside it;
* phases 11 (LLaMA training), 15 (BERT training) and 16 (ERNIE) through
  the process's own checkout's ``chip_smoke.py``, profiles included, and
  phases 9 + 25 (dense and paged decoding) with the greedy tokens of
  phase 25's bf16 paged decode (OLDER_DIR's runs: the host times and
  phases 9 + 25 only).

Host time moves between processes of one call by tens of percent, so a
last process then imports every checkout's package into itself (under
other names: the packages import themselves relatively) and takes turns
through them in the same order, four times: the wrapper host times
above and phase 25b's drive (GPT_1P3B bf16, 4 prompts of 128 tokens, 32
paged decode steps; ms a step and greedy tokens) beside phase 9's dense
decode of the same model and prompts in the same turn, the control whose
ratio to it cancels the host's speed of the moment.  Alone:

    python3 scripts/torch_norm_compare.py --one-process OUT.json \
        parent=build/parent change=. change=. parent=build/parent

It prints each process's numbers, ms a step, the row-12, row-13 and
column-sum device ms a step of each drive, and the greedy match ratio of
each process's paged tokens against the first parent's; the JSON goes
to ``build/norm_compare/compare.json`` and is printed as the last line.
Needs one CUDA device and ``nvcc``; the card's ``nvidia-smi`` line is
printed first.
"""
from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import compare_common as cc

ROOT = cc.ROOT
OUT = ROOT / "build" / "norm_compare"
#: the drives compared, with the summary key of their ms a step
DRIVES = {"phase11": "step_ms", "phase15": "step_ms",
          "phase16": "ms_per_forward", "phase25": "decode_ms_per_step"}
#: profile buckets read from each drive
BUCKETS = ("rms_norm_bwd", "layer_norm_residual", "column_sum", "rms_norm",
           "layer_norm_bwd", "paged_attention")
#: the norm wrappers that count launches by route in this tree
ROUTED = ("fused_rms_norm_bwd", "fused_layer_norm_residual")
#: the one-process run: turns through every checkout, and decode steps a
#: turn
ROUNDS, DECODE_STEPS = 4, 32


def buckets(summary):
    """The device ms a step of `BUCKETS` in a drive's profile, or None
    where the profiler saw no device time."""
    return cc.buckets(summary, BUCKETS)


def per_call_us(torch, fn, calls=200, repeats=9):
    """Host microseconds a call of ``fn``: ``calls`` calls back to back
    with no synchronisation, the median over ``repeats``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def host_times(torch, ops, cuda_lib):
    """Host µs a call of the paged-decode wrapper and its parts at phase
    25b's decode step, and of the layer-norm wrapper at its rows."""
    B, H, D, bs, W = 4, 16, 128, 16, 13
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    nb = B * W + 1
    q = torch.randn(B, 1, H, D, device="cuda", generator=gen).bfloat16()
    k = torch.randn(nb, H, bs, D, device="cuda", generator=gen).bfloat16()
    v = torch.randn(nb, H, bs, D, device="cuda", generator=gen).bfloat16()
    tables = (1 + torch.arange(B * W, device="cuda", dtype=torch.int32)
              ).view(B, W)
    ctx = torch.full((B,), 192, device="cuda", dtype=torch.int32)
    x = torch.randn(B, 2048, device="cuda", generator=gen).bfloat16()
    g = torch.ones(2048, device="cuda").bfloat16()
    b = torch.zeros(2048, device="cuda").bfloat16()
    lib = cuda_lib.library()
    code = cuda_lib.dtype_code(torch.bfloat16)
    out = {"paged_attention": per_call_us(
        torch, lambda: ops.paged_attention(q, k, v, tables, ctx)),
        "layer_norm": per_call_us(
            torch, lambda: ops.fused_layer_norm(x, g, b)),
        "stream_handle": per_call_us(
            torch, lambda: cuda_lib.stream_handle(dev))}
    if hasattr(lib, "ptt_paged_attention_splits"):
        splits = lib.ptt_paged_attention_splits(B, H, D, bs, W, code, 0)
        out["splits"] = splits
        out["library_splits_query"] = per_call_us(
            torch, lambda: lib.ptt_paged_attention_splits(B, H, D, bs, W,
                                                          code, 0))
        out["empty_partial"] = per_call_us(
            torch, lambda: torch.empty(B * H * splits * (D + 2),
                                       dtype=torch.float32, device=dev))
    if hasattr(cuda_lib, "tickets"):
        out["tickets"] = per_call_us(
            torch, lambda: cuda_lib.tickets(dev, B * H))
    split_count = getattr(ops.paged, "split_count", None)
    if split_count is not None:
        out["cached_split_count"] = per_call_us(
            torch, lambda: split_count(lib, B, H, D, bs, W, code, 0))
    return out


def kernel_rows(torch, here, ops, label, gen):
    """Rows 12 (backward) and 13 through this tree's check functions."""
    rows = {}
    for dtype, dtype_name in ((torch.bfloat16, "bfloat16"),
                              (torch.float32, "float32")):
        cases = [("rms_norm_bwd", c) for c in here.RMS_SHAPES]
        cases.append(("layer_norm_residual", "bert"))
        for name, case in cases:
            if name == "rms_norm_bwd":
                r = here.check_rms_norm_bwd(ops, case, dtype, dtype_name, gen)
            else:
                r = here.check_layer_norm_residual(ops, here.BERT_ROWS, dtype,
                                                   dtype_name, gen)
            key = f"{name}/{case}/{dtype_name}"
            rows[key] = {k: r[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "err", "ok",
                "route", "shape")}
            print(f"{label} {key}: {r['ms']:.4f} ms (bound "
                  f"{r['bound_ms']:.4f}, plain {r['plain_ms']:.4f}, library "
                  f"{r['library_ms']}), max abs err {r['err']:.3e}, route "
                  f"{r['route']}", flush=True)
            torch.cuda.empty_cache()
    return rows


def worker(root, label, out_path, full):
    """One process: the host times, the kernel rows, then the drives."""
    torch, cs, pt, ops, cuda_lib = cc.start_worker(root)
    here = cc.this_tree()
    for name in ROUTED:
        fn = getattr(ops, name)
        for attr in ("vector_launches", "scalar_launches"):
            if not hasattr(fn, attr):    # a checkout without the counters
                setattr(fn, attr, 0)
    cs.warm_up(ops)
    res = {"label": label, "root": str(root)}
    res["host_us"] = host_times(torch, ops, cuda_lib)
    print(f"{label} host us a call: {res['host_us']}", flush=True)
    if full == "1":
        gen = torch.Generator(device="cuda").manual_seed(here.SEED)
        res["kernels"] = kernel_rows(torch, here, ops, label, gen)
        cs.reset_routes(ops)
        _, res["phase11"] = cs.phase_llama_training(pt, ops)
        cs.free_device_memory()
        _, res["phase15"] = cs.phase_bert_training(pt, ops)
        cs.free_device_memory()
        _, res["phase16"] = cs.phase_ernie(pt, ops)
        cs.free_device_memory()
    else:
        cs.reset_routes(ops)
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


def load_package(alias, root):
    """The ``paddle_tpu_torch`` package of checkout ``root`` imported as
    ``alias`` (its imports are relative, so several checkouts' packages
    live in one process, each with its own kernel library)."""
    pkg = Path(root) / "paddle_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def dense_ms(torch, model, prompts):
    """Phase 9's measure on the same model and prompts, the paged drive's
    control in the same turn: ms a decode step of greedy `generate()`
    with the dense KV cache, (time of 1 + `DECODE_STEPS` new tokens -
    time of 1) / `DECODE_STEPS`."""
    ids = torch.as_tensor(prompts)

    def run(new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(ids, max_new_tokens=new)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    first = run(1)
    return (run(DECODE_STEPS + 1) - first) / DECODE_STEPS * 1e3


def one_process(out_path, *specs):
    """Every checkout's package in this one process (``specs``: label=dir
    pairs), measured in turns in the order given, `ROUNDS` times: the
    host µs a call of the paged-decode and layer-norm wrappers
    (`host_times`), and phase 25b's drive (GPT_1P3B in bf16, 4 prompts of
    128 tokens, `DECODE_STEPS` paged decode steps: ms a step and the
    greedy tokens) beside its control in the same turn, the dense-cache
    decode of phase 9 (`dense_ms`): the host's speed moves between turns,
    so the ratio of the two is the reading that compares checkouts."""
    import numpy as np
    import torch
    here = cc.this_tree()
    trees = [spec.split("=", 1) for spec in specs]
    pkgs = {}
    for label, root in trees:
        if label not in pkgs:
            pt = load_package(f"ptt_{label}", root)
            pt.ops.cuda_lib.library()
            model = pt.GPTForCausalLM(pt.GPTConfig(**pt.GPT_1P3B),
                                      dtype=torch.bfloat16,
                                      seed=here.SEED).eval()
            pkgs[label] = (pt, model)
    prompts = np.random.default_rng(here.SEED).integers(
        1, pkgs[trees[0][0]][0].GPT_1P3B["vocab_size"], (4, 128))
    res = {"order": [label for label, _ in trees], "rounds": []}
    for _ in range(ROUNDS):
        for label, _ in trees:
            pt, model = pkgs[label]
            row = {"label": label,
                   "host_us": host_times(torch, pt.ops, pt.ops.cuda_lib)}
            row["dense_ms_per_step"] = dense_ms(torch, model, prompts)
            toks, _, decode_s, _, _ = here.paged_generate(
                pt, pt.ops, model, prompts, DECODE_STEPS, "cuda")
            row["decode_ms_per_step"] = decode_s / DECODE_STEPS * 1e3
            row["paged_over_dense"] = (row["decode_ms_per_step"]
                                       / row["dense_ms_per_step"])
            row["tokens"] = toks.tolist()
            print(f"one process {label}: decode "
                  f"{row['decode_ms_per_step']:.2f} ms/step, dense "
                  f"{row['dense_ms_per_step']:.2f}, host us "
                  f"{row['host_us']}", flush=True)
            res["rounds"].append(row)
    Path(out_path).write_text(json.dumps(res))


def summary_line(res):
    return "; ".join(
        f"{d} {res[d][key]:.2f} ms/step, buckets {buckets(res[d])}"
        for d, key in DRIVES.items() if d in res)


def main():
    if len(sys.argv) == 6 and sys.argv[1] == "--worker":
        worker(*sys.argv[2:])
        return
    if len(sys.argv) > 3 and sys.argv[1] == "--one-process":
        one_process(*sys.argv[2:])
        return
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    trees = {"parent": Path(sys.argv[1]).resolve(), "change": ROOT}
    order = list(cc.ORDER)
    if len(sys.argv) == 3:
        trees["older"] = Path(sys.argv[2]).resolve()
        order = ["older", *order, "older"]
    card, runs = cc.run_order(
        __file__, trees, order, OUT,
        args=lambda label: ("0" if label == "older" else "1",),
        after=lambda label, r: print(f"{label}: {summary_line(r)}",
                                     flush=True))
    path = OUT / "one_process.json"
    rc = subprocess.run([sys.executable, __file__, "--one-process",
                         str(path), *(f"{label}={trees[label]}"
                                      for label in order)]).returncode
    if rc:
        sys.exit(f"the one-process run failed ({rc})")
    together = json.loads(path.read_text())
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch.quantization import greedy_match_ratio
    first = next(r for r in runs if r["label"] == "parent")
    full = [r for r in runs if "kernels" in r]
    out = {"card": card, "order": order, "kernels": {}, "drives": {},
           "host_us": [r["host_us"] for r in runs]}
    for key in first["kernels"]:
        out["kernels"][key] = {
            f: [r["kernels"][key][f] for r in full]
            for f in ("ms", "plain_ms", "library_ms", "err", "ok", "route")}
        out["kernels"][key]["bound_ms"] = first["kernels"][key]["bound_ms"]
    for d, key in DRIVES.items():
        have = [r for r in runs if d in r]
        out["drives"][d] = {
            "labels": [r["label"] for r in have],
            "ms_per_step": [r[d][key] for r in have],
            "buckets_ms_per_step": [buckets(r[d]) for r in have],
            "device_idle_share": [
                (r[d].get("profile") or {}).get("device_idle_share")
                for r in have]}
    out["drives"]["phase25"]["greedy_match_vs_first_parent"] = [
        greedy_match_ratio(first["phase25_tokens"], r["phase25_tokens"])
        for r in runs]
    ref = next(r for r in together["rounds"] if r["label"] == "parent")
    out["one_process"] = [
        dict(label=r["label"], decode_ms_per_step=r["decode_ms_per_step"],
             dense_ms_per_step=r["dense_ms_per_step"],
             paged_over_dense=r["paged_over_dense"], host_us=r["host_us"],
             greedy_match_vs_parent=greedy_match_ratio(ref["tokens"],
                                                       r["tokens"]))
        for r in together["rounds"]]
    for r in runs:
        print(f"  {r['label']} host us: {r['host_us']}")
    for key, v in out["kernels"].items():
        print(f"  {key}: ms {v['ms']} (bound {v['bound_ms']:.4f}, library "
              f"{v['library_ms']}, routes {v['route']})")
    for d, v in out["drives"].items():
        print(f"  {d} ({v['labels']}): ms/step {v['ms_per_step']}, buckets "
              f"{v['buckets_ms_per_step']}")
    print(f"  phase25 greedy match vs the first parent: "
          f"{out['drives']['phase25']['greedy_match_vs_first_parent']}")
    for r in out["one_process"]:
        print(f"  one process {r['label']}: decode "
              f"{r['decode_ms_per_step']:.2f} ms/step (dense "
              f"{r['dense_ms_per_step']:.2f}, ratio "
              f"{r['paged_over_dense']:.3f}), paged wrapper "
              f"{r['host_us']['paged_attention']:.1f} us, layer norm "
              f"{r['host_us']['layer_norm']:.1f} us, greedy match "
              f"{r['greedy_match_vs_parent']}")
    cc.write_out(OUT, out)


if __name__ == "__main__":
    main()
