#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of paddle-tpu on one NVIDIA H100.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA device, imports nothing
of JAX and nothing of the JAX package, and exits non-zero as soon as a
phase fails.  Phases:

0. the card's name and power limit (``nvidia-smi``);
1. build: every kernel of ``paddle_tpu_torch/csrc`` compiled by ``nvcc``
   for sm_90a into one library (timed);
2. kernels: each kernel of the serving path against its plain PyTorch
   version on the card, at the main path's shapes, in bf16 and in f32,
   with errors against stated tolerances and CUDA-event times of the
   kernel, the plain version and (where one PyTorch call computes the
   same function) the library call, beside the least time the card
   could take (``bound_ms``);
3. parity: GPT at full width (hidden 2048, 16 heads, vocab 50304) cut to
   2 layers, f32, weights from a numpy seed, served by the engine on the
   card and on the CPU (plain versions): 4 requests sharing a prefix,
   16 greedy tokens each, must give identical tokens, and every kernel's
   launch count must advance on the card;
4. serving: GPT_1P3B (24 layers) in bf16 with random weights from a
   seed, ``max_batch=8``, chunk 256: 16 requests sharing a 512-token
   prefix plus a 4-64 token tail, 64 greedy tokens each (the
   ``gpt_decode`` trace of bench.py at the 1.3B width).  Every kernel's
   launch count is set to 0 just before and read just after; each must
   equal its launches per step times the steps.  A second, profiled
   burst (8 of the prompts, 16 tokens) then splits device time by
   kernel and gives the device's idle share (``torch.profiler``).

The last two lines are one JSON object of kernel results and the card's
``nvidia-smi`` line; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

#: published peaks of one H100 SXM (NVIDIA data sheet, dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

#: max |kernel - plain| allowed, as atol + rtol * |plain|.  bf16: about
#: two bf16 ulps at unit scale (the plain attention also rounds its
#: probabilities to bf16, the kernel keeps f32).  f32: sums taken in
#: another order.
TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-4, 1e-4)}

#: ragged attention in bf16 is also held to the plain version run in f32
#: on the same values, which keeps the probabilities in f32 as the kernel
#: does: max |kernel - plain| <= 2^-8 * RMS(plain) + 2^-7 * |plain|, one
#: bf16 ulp of the output's rounding.  A dropped KV block moves the output
#: by several percent of its RMS, far past this limit.
RAGGED_BF16_F32P_TOL = (2.0 ** -8, 2.0 ** -7)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------
def time_ms(fn, iters=20, warmup=3):
    """Median CUDA-event time of ``fn`` in ms, with the 50 MB L2 flushed
    before every timed call (the serving path meets cold weights)."""
    import torch
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def bound(nbytes, ops, dtype_name):
    """Least time (ms) for ``nbytes`` of traffic and ``ops`` operations,
    and which of the two bounds it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def compare(got, want, dtype_name, atol=None, rtol=None):
    import torch
    if atol is None:
        atol, rtol = TOL[dtype_name]
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf"), float("inf"), False
    diff = (g - w).abs()
    ok = bool((diff <= atol + rtol * w.abs()).all())
    rel = float((diff / w.abs().clamp_min(1e-6)).max())
    return float(diff.max()), rel, ok


# ---------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------
def check_layer_norm(ops, rows, dtype, dtype_name, gen):
    import torch
    n = 2048
    x = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
    g = (1 + 0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    b = (0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    out, mu, rstd = ops.fused_layer_norm(x, g, b)
    ref, mu_ref, rstd_ref = ops.layer_norm_ref(x, g, b)
    torch.cuda.synchronize()
    err, rel, ok = compare(out, ref, dtype_name)
    ok = ok and compare(mu, mu_ref, "float32")[2] \
        and compare(rstd, rstd_ref, "float32")[2]
    isz = x.element_size()
    nbytes = 2 * rows * n * isz + 2 * n * isz + 2 * rows * 4
    bms, by = bound(nbytes, 8 * rows * n, dtype_name)
    return dict(
        err=err, rel=rel, ok=ok, shape=f"x[{rows},{n}]",
        ms=time_ms(lambda: ops.fused_layer_norm(x, g, b)),
        plain_ms=time_ms(lambda: ops.layer_norm_ref(x, g, b)),
        library_ms=time_ms(lambda: torch.nn.functional.layer_norm(
            x, (n,), g, b, 1e-5)),
        bound_ms=bms, bound_by=by)


def check_matmul_epilogue(ops, rows, dtype, dtype_name, gen):
    import torch
    K, N = 2048, 8192
    x = torch.randn(rows, K, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(K, N, device="cuda", generator=gen)
         / K ** 0.5).to(dtype)
    b = (0.1 * torch.randn(N, device="cuda", generator=gen)).to(dtype)
    out = ops.fused_linear_act(x, w, b, "gelu_tanh")
    ref = ops.linear_act_ref(x, w, b, "gelu_tanh")
    torch.cuda.synchronize()
    err, rel, ok = compare(out, ref, dtype_name)
    # the library call: one cuBLASLt GEMM with a bias + tanh-GELU epilogue
    # (its CUDA fallback also applies gelu(approximate="tanh")); timed and
    # compared here only, the port never calls it
    def library():
        return torch._addmm_activation(b, x, w, use_gelu=True)
    lib_err = compare(library(), ref, dtype_name)[0]
    isz = x.element_size()
    nbytes = (rows * K + K * N + N + rows * N) * isz
    bms, by = bound(nbytes, 2 * rows * K * N + 12 * rows * N, dtype_name)
    return dict(
        err=err, rel=rel, ok=ok, shape=f"x[{rows},{K}] w[{K},{N}]",
        note=f"library vs plain max abs err {lib_err:.3e}",
        ms=time_ms(lambda: ops.fused_linear_act(x, w, b, "gelu_tanh")),
        plain_ms=time_ms(lambda: ops.linear_act_ref(x, w, b, "gelu_tanh")),
        library_ms=time_ms(library), bound_ms=bms, bound_by=by)


def check_ragged(ops, block_q, dtype, dtype_name, gen):
    """A mixed step of the serving drive: one 256-token prefill chunk
    (positions 256..511) plus seven decode rows at contexts 520-622."""
    import numpy as np
    import torch
    H, D, bs, W, S = 16, 128, 16, 128, 8
    qlens = [1] * 7 + [256]
    ctxs = [520 + 17 * i for i in range(7)] + [512]
    nqb = 7 + 256 // block_q
    sid, qs, qv, _, _ = ops.ragged_segments(qlens, ctxs, block_q,
                                            num_q_blocks=nqb, num_seqs=S)
    rng = np.random.default_rng(SEED)
    per_seq = -(-max(ctxs) // bs)
    nb = 1 + S * per_seq
    perm = 1 + rng.permutation(nb - 1)           # scattered like a pool
    tables = np.zeros((S, W), np.int32)
    for s, c in enumerate(ctxs):
        nblk = -(-c // bs)
        tables[s, :nblk] = perm[s * per_seq:s * per_seq + nblk]
    q = torch.randn(nqb * block_q, H, D, device="cuda",
                    generator=gen).to(dtype)
    kp = torch.randn(nb, H, bs, D, device="cuda", generator=gen).to(dtype)
    vp = torch.randn(nb, H, bs, D, device="cuda", generator=gen).to(dtype)
    ints = [torch.from_numpy(a).cuda() for a in
            (tables, np.asarray(ctxs, np.int32), sid, qs, qv)]
    args = (q, kp, vp, *ints)
    out = ops.ragged_paged_attention(*args, block_q=block_q)
    ref = ops.ragged_attention_ref(*args, block_q=block_q)
    torch.cuda.synchronize()
    err, rel, ok = compare(out, ref, dtype_name)
    note = ""
    if dtype == torch.bfloat16:
        ref32 = ops.ragged_attention_ref(q.float(), kp.float(), vp.float(),
                                         *ints, block_q=block_q)
        k_rms, k_rel = RAGGED_BF16_F32P_TOL
        rms = float(ref32.pow(2).mean().sqrt())
        err32, _, ok32 = compare(out, ref32, dtype_name, k_rms * rms, k_rel)
        ok = ok and ok32
        note = (f"vs plain with f32 probabilities max abs err {err32:.3e} "
                f"(tolerance {k_rms * rms:.3e} + {k_rel:g}*|plain|, "
                f"RMS {rms:.3e})")
        del ref32
    # work this data needs: visible (row, key) pairs, KV blocks touched
    pairs, touched = 0, set()
    for i in range(nqb):
        s = int(sid[i])
        if s >= S or qv[i] == 0:
            continue
        c, q0 = ctxs[s], int(qs[i])
        pairs += sum(min(c, q0 + r + 1) for r in range(int(qv[i])))
        touched.update(tables[s, :-(-min(c, q0 + int(qv[i])) // bs)].tolist())
    isz = q.element_size()
    nbytes = (2 * q.numel() * isz + 2 * len(touched) * H * bs * D * isz
              + 4 * (tables.size + len(ctxs) + 3 * nqb))
    bms, by = bound(nbytes, 4 * D * H * pairs, dtype_name)
    return dict(
        err=err, rel=rel, ok=ok, note=note,
        shape=f"q[{q.shape[0]},{H},{D}] pool[{nb},{H},{bs},{D}] W={W}",
        ms=time_ms(lambda: ops.ragged_paged_attention(*args,
                                                      block_q=block_q)),
        plain_ms=time_ms(lambda: ops.ragged_attention_ref(
            *args, block_q=block_q), iters=5),
        library_ms=None, bound_ms=bms, bound_by=by)


KERNEL_INFO = {
    "ragged_attention": dict(
        source="paddle_tpu_torch/csrc/ragged_attention.cu",
        replaces="paddle_tpu/ops/pallas_ragged.py:115",
        per_layer=1),
    "layer_norm": dict(
        source="paddle_tpu_torch/csrc/layer_norm.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:522",
        per_layer=2, per_step_extra=1),
    "matmul_epilogue": dict(
        source="paddle_tpu_torch/csrc/matmul_epilogue.cu",
        replaces="paddle_tpu/ops/pallas_fused.py:266",
        per_layer=1),
}


def phase_kernels(ops, budgets):
    import torch
    checks = {"ragged_attention": check_ragged,
              "layer_norm": check_layer_norm,
              "matmul_epilogue": check_matmul_epilogue}
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for dtype, dtype_name in ((torch.bfloat16, "bfloat16"),
                              (torch.float32, "float32")):
        block_q = ops.ragged_q_block(dtype)
        for name, check in checks.items():
            arg = block_q if name == "ragged_attention" \
                else budgets[dtype_name]
            r = check(ops, arg, dtype, dtype_name, gen)
            atol, rtol = TOL[dtype_name]
            say(f"  {name:16s} {dtype_name:8s} {r['shape']}: max abs err "
                f"{r['err']:.3e} (max rel {r['rel']:.3e}; tolerance "
                f"{atol:g} + {rtol:g}*|plain|) kernel {r['ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms, library "
                f"{'n/a' if r['library_ms'] is None else '%.4f ms' % r['library_ms']}"
                f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                + (f"; {r['note']}" if r.get("note") else ""))
            if not r["ok"]:
                fail(f"{name} {dtype_name}: kernel disagrees with its "
                     f"plain version (max abs err {r['err']:.3e})")
            results[(name, dtype_name)] = r
    return results


# ---------------------------------------------------------------------
# phase 3: CUDA vs CPU parity at full width, 2 layers, f32
# ---------------------------------------------------------------------
def numpy_weights(model, seed):
    """Weights for every parameter, drawn with numpy: the reference's
    initialisers (Xavier-normal Linear weights, N(0, 1) embeddings) and
    small random biases and layer-norm affines."""
    import numpy as np
    rng = np.random.default_rng(seed)
    params = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name.endswith(("wte.weight", "wpe.weight")):
            a = rng.standard_normal(shape, np.float32)
        elif "ln_" in name and name.endswith("weight"):
            a = 1 + 0.1 * rng.standard_normal(shape, np.float32)
        elif len(shape) == 2:
            std = (2.0 / (shape[0] + shape[1])) ** 0.5
            a = std * rng.standard_normal(shape, np.float32)
        else:
            a = 0.02 * rng.standard_normal(shape, np.float32)
        params[name] = a
    return params


def reset_launches(ops):
    for fn in ops.KERNELS.values():
        fn.launches = 0


def launches(ops):
    return {name: fn.launches for name, fn in ops.KERNELS.items()}


def phase_parity(pt, ops):
    import numpy as np
    import torch
    cfg = pt.GPTConfig(**dict(pt.GPT_1P3B, num_hidden_layers=2))
    rng = np.random.default_rng(SEED + 1)
    shared = list(rng.integers(1, cfg.vocab_size, size=48))
    prompts = [shared + list(rng.integers(1, cfg.vocab_size, size=n))
               for n in (5, 9, 12, 7)]
    kw = dict(max_batch=4, prefill_chunk=64, max_model_len=256,
              num_blocks=128)
    outs = {}
    params = None
    for device in ("cuda", "cpu"):
        model = pt.GPTForCausalLM(cfg, device=device, dtype=torch.float32)
        if params is None:
            params = numpy_weights(model, SEED + 2)
        pt.load_reference_state(model, params)
        eng = pt.GenerationEngine(model, device=device, **kw)
        reset_launches(ops)
        t0 = time.perf_counter()
        outs[device] = eng.generate(prompts, max_new_tokens=16)
        if device == "cuda":
            torch.cuda.synchronize()
            counts = launches(ops)
        say(f"  {device}: {eng.stats()['steps']} steps in "
            f"{time.perf_counter() - t0:.2f} s, prefix hit rate "
            f"{eng.stats()['prefix_hit_rate']:.3f}")
        del eng, model
        torch.cuda.empty_cache()
    if outs["cuda"] != outs["cpu"]:
        fail(f"parity: CUDA tokens {outs['cuda']} != CPU tokens "
             f"{outs['cpu']}")
    if not all(len(o) == len(p) + 16 for o, p in zip(outs["cuda"], prompts)):
        fail("parity: a request did not return 16 tokens")
    say(f"  greedy tokens identical on CUDA and CPU for {len(prompts)} "
        f"requests x 16 tokens; CUDA launches {counts}")
    if not all(counts.values()):
        fail(f"parity: a kernel was not launched on the card: {counts}")


# ---------------------------------------------------------------------
# phase 4: the serving drive
# ---------------------------------------------------------------------
def phase_serving(pt, ops):
    import numpy as np
    import torch
    cfg = pt.GPTConfig(**pt.GPT_1P3B)
    model = pt.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=SEED)
    eng = pt.GenerationEngine(model, max_batch=8, prefill_chunk=256,
                              max_model_len=cfg.max_position_embeddings)
    rng = np.random.default_rng(SEED)
    shared = list(rng.integers(1, cfg.vocab_size, size=512))
    prompts = [shared + list(rng.integers(
        1, cfg.vocab_size, size=int(rng.integers(4, 64))))
        for _ in range(16)]
    warm = [list(rng.integers(1, cfg.vocab_size, size=40))
            for _ in range(2)]
    eng.generate(warm, max_new_tokens=4)        # first-use costs
    torch.cuda.synchronize()
    hit0, look0 = eng.cache._hit_tokens, eng.cache._lookup_tokens
    steps0, toks0 = eng.stats()["steps"], eng.stats()["tokens_generated"]

    reset_launches(ops)
    t0 = time.perf_counter()
    ids = [eng.add_request(p, max_new_tokens=64) for p in prompts]
    while eng.has_unfinished():
        eng.step()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = launches(ops)

    reqs = [eng._results[i] for i in ids]
    if not all(len(r.generated) == 64 for r in reqs):
        fail(f"serving: generated lengths "
             f"{[len(r.generated) for r in reqs]}, expected 64 each")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated):
        fail("serving: a token outside the vocabulary")
    steps = eng.stats()["steps"] - steps0
    tokens = eng.stats()["tokens_generated"] - toks0
    ttft = sorted((r.t_first_token - r.t_submit) * 1e3 for r in reqs)
    hit = (eng.cache._hit_tokens - hit0) / max(
        1, eng.cache._lookup_tokens - look0)
    per_step = {name: info["per_layer"] * cfg.num_hidden_layers
                + info.get("per_step_extra", 0)
                for name, info in KERNEL_INFO.items()}
    say(f"  {len(prompts)} requests, {tokens} tokens in {elapsed:.3f} s: "
        f"{tokens / elapsed:.1f} tokens/s, median TTFT "
        f"{ttft[len(ttft) // 2]:.1f} ms, prefix hit rate {hit:.3f}, "
        f"{steps} steps ({elapsed / steps * 1e3:.2f} ms/step), "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say(f"  launches {counts}; per step {per_step}")
    for name, n in counts.items():
        if n == 0:
            fail(f"serving: kernel {name} was never launched")
        if n != per_step[name] * steps:
            fail(f"serving: {name} launched {n} times in {steps} steps, "
                 f"expected {per_step[name]} per step")
    summary = dict(tokens_per_s=tokens / elapsed,
                   median_ttft_ms=ttft[len(ttft) // 2],
                   prefix_hit_rate=hit, steps=steps, elapsed_s=elapsed)
    summary["profile"] = profile_burst(eng, prompts[:8])
    return counts, summary


#: device-time groups of the profile, by kernel-name substring
_PROFILE_GROUPS = (("ragged_attention", "ragged_attn_kernel"),
                   ("layer_norm", "layer_norm_fwd_kernel"),
                   ("matmul_epilogue", "me_fwd_"),
                   ("cublas_gemm", ("gemm", "xmma", "nvjet", "cutlass",
                                    "cublas")))


def profile_burst(eng, prompts):
    """Device time by kernel group and the device's idle share over a
    profiled burst (8 of the drive's prompts, 16 tokens each, their
    prefixes cached).  The profiler's own overhead inflates the wall
    time, so the idle share is an upper bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    steps0 = eng.stats()["steps"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=16)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = eng.stats()["steps"] - steps0
    groups = {name: 0.0 for name, _ in _PROFILE_GROUPS}
    groups["other"] = 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        name = evt.key
        for group, keys in _PROFILE_GROUPS:
            if any(k in name for k in ((keys,) if isinstance(keys, str)
                                       else keys)):
                groups[group] += us / 1e3
                break
        else:
            groups["other"] += us / 1e3
    busy_ms = sum(groups.values())
    if busy_ms == 0:
        say("  profile: the profiler saw no device time (not measured)")
        return None
    out = dict(steps=steps, wall_ms=wall_ms, device_busy_ms=busy_ms,
               device_idle_share=max(0.0, 1 - busy_ms / wall_ms),
               device_ms_per_step={k: v / steps for k, v in groups.items()})
    say(f"  profile over {steps} steps: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms (idle share {out['device_idle_share']:.3f}); "
        f"device ms/step " + ", ".join(
            f"{k} {v / steps:.3f}" for k, v in groups.items()))
    return out


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script drives the "
             "port on a CUDA device")
    if not (ROOT / "paddle_tpu_torch" / "csrc").is_dir():
        fail(f"no paddle_tpu_torch/csrc beside {Path(__file__).name}: run "
             f"it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    say(f"[0] card: {card}")

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    path = cuda_lib.build()
    cuda_lib.library()
    say(f"[1] build: {time.perf_counter() - t0:.2f} s -> "
        f"{path.relative_to(ROOT)}")

    say("[2] kernels vs plain versions at the main path's shapes")
    # the serving drive's token budget: chunk 256 + 7 rows of block_q
    budgets = {"bfloat16": 256 + 7 * 16, "float32": 256 + 7 * 8}
    results = phase_kernels(ops, budgets)

    say("[3] parity: full width, 2 layers, f32, CUDA vs CPU")
    phase_parity(pt, ops)

    say("[4] serving: GPT_1P3B bf16, 16 requests x 64 tokens")
    counts, serving = phase_serving(pt, ops)

    kernels = []
    for name, info in KERNEL_INFO.items():
        r = results[(name, "bfloat16")]
        f = results[(name, "float32")]
        kernels.append(dict(
            name=name, route="cuda", source=info["source"],
            replaces=info["replaces"], launches=counts[name],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], dtype="bfloat16", shape=r["shape"],
            note=r.get("note", ""),
            f32=dict(max_abs_err=f["err"], ms=f["ms"],
                     plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
                     bound_by=f["bound_by"], library_ms=f["library_ms"],
                     shape=f["shape"])))
    say(json.dumps({"kernels": kernels, "serving": serving}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
