#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of paddle-tpu on one NVIDIA H100.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA device, imports nothing
of JAX and nothing of the JAX package, and exits non-zero as soon as a
phase fails.  Phases:

0. the card's name and power limit (``nvidia-smi``);
1. build: every kernel of ``paddle_tpu_torch/csrc`` compiled by ``nvcc``
   for sm_90a into one library (timed);
2. kernels: one untimed launch of every kernel first, then each kernel
   against its plain PyTorch version on the card, at the shapes the
   serving and the training drives give it (flash attention: the flash
   drive's B=8, S=1024, 16 heads of 128, causal; a decode step's one
   query against 640 keys; heads of 64 at the 0.35B width; BERT-base's
   B=64, S=128, 12 heads of 64, not causal; and heads of 256, causal and
   not; RMS norm: the LLaMA training drive's 8192 rows of 1024, LLaMA-2
   7B's prefill of 512 rows and decode step of 4 rows of 4096; the fused
   residual layer norm at the BERT drive's 8192 rows of 768, forward and,
   through the layer-norm backward kernel, backward), in bf16 and in f32,
   with
   errors against stated tolerances and CUDA-event times of the kernel,
   the plain version and (where one PyTorch call computes the same
   function) the library call, beside the least time the card could take
   (``bound_ms``); the int8 serving kernels at the serving drive's shapes
   too (the int8 matmul epilogue at fc1's 368 x 2048 @ 2048 x 8192 with
   gelu_tanh, int8 ragged attention at the mixed step with int8 pools);
   and the grouped-expert matmul's forward and dw kernels at the MoE
   drives' shapes with skewed expert counts (one expert empty, one
   holding almost everything): the serving step's 736 assignments (368
   packed rows x top 2) over 4 experts at block rows 128 through w1
   (2048 -> 8192, gelu_tanh) and w2 (8192 -> 2048), and the training
   drive's 16384 assignments through w1 (768 -> 3072, z saved), its dx
   (w1 read transposed) and its dw; the library yardstick is
   ``torch._grouped_mm`` (bf16, where this torch has it) or a per-expert
   loop of ``torch._addmm_activation`` / ``addmm`` / ``mm``, named in
   each row's note; the LoRA SGMV epilogue at the multi-LoRA serving
   step's qkv, out, fc1 (gelu_tanh) and fc2 (the token budget's rows, 4
   adapters of 16 slots mixed with null blocks, rank 16; no library
   call), the grouped kernels at LoRA's backward shapes (8192 rows, one
   adapter: u and dx through the transposed read with N or K = 16, dA and
   dB; yardstick ``torch.mm``), and paged decode attention at phase 25's
   decode shape (4 sequences at contexts 129-192 and one at 0, 16 heads
   of 128, pages of 16; no library call);
3. parity: GPT at full width (hidden 2048, 16 heads, vocab 50304) cut to
   2 layers, f32, weights from a numpy seed, served by the engine on the
   card and on the CPU (plain versions): 4 requests sharing a prefix,
   16 greedy tokens each, must give identical tokens, and each serving
   kernel must launch its launches per step times the steps on the card
   (the backward kernels none); then the same with
   ``weight_dtype="int8", kv_cache_dtype="int8"``, where only the int8
   epilogue and the int8 attention may launch (besides layer norm);
4. serving: GPT_1P3B (24 layers) in bf16 with random weights from a
   seed, ``max_batch=8``, chunk 256: 16 requests sharing a 512-token
   prefix plus a 4-64 token tail, 64 greedy tokens each (the
   ``gpt_decode`` trace of bench.py at the 1.3B width).  Every kernel's
   launch count is set to 0 just before and read just after; each must
   equal its launches per step times the steps.  A second, profiled
   burst (8 of the prompts, 16 tokens) then splits device time by
   kernel and gives the device's idle share (``torch.profiler``);
5. training parity: GPT at full width cut to 2 layers, f32, no AMP,
   ``use_flash_attention=False``, weights from a numpy seed, B=2, S=128:
   3 AdamW steps on the card (kernels) and on the CPU (plain versions)
   on the same ids; the losses, every gradient of step 1 and every
   parameter after step 3 must agree within stated tolerances, and
   every kernel of the training path must launch on the card;
6. training: GPT_1P3B (24 layers) with f32 master weights under
   ``amp.auto_cast(bf16, O1)``, ``use_flash_attention=False``, AdamW(1e-4,
   weight decay 0.01, global-norm clip 1.0), B=4, S=1024, one fixed
   batch from a numpy seed (bench.py's ``bench_gpt`` recipe): 2 warm-up
   steps, then 5 timed steps whose losses must be finite and fall; step
   ms, tokens/s, MFU (bench.py's 6N + 12LSH flops per token against the
   989 TFLOP/s bf16 peak) and peak memory; launches counted from 0 must
   equal launches per step times the steps; one profiled step splits
   device time by kernel group and gives the idle share;
7. flash training parity: phase 5 with ``use_flash_attention=True,
   use_recompute=True``; every flash kernel must launch on the card;
8. flash training: phase 6 with ``use_flash_attention=True,
   use_recompute=True`` at B=8 (bench.py's first size), launches counted
   per step with every block's forward run twice (recompute);
9. generate: ``model.generate`` with the dense KV cache, greedy.  Full
   width cut to 2 layers, f32: 4 prompts of 37-120 tokens left-padded to
   one batch, 16 new tokens, identical on the card and the CPU; then
   GPT_1P3B in bf16, 4 prompts x 128 tokens, 64 new tokens: ms per
   decode step;
10. LLaMA training parity: bench.py's ``bench_llama`` width (hidden 1024,
    16 heads, 8 kv heads, ffn 2816, vocab 32000) cut to 2 layers, f32,
    ``use_recompute=True``, weights from a numpy seed, B=2, S=128: 3
    AdamW steps on the card and on the CPU, held as in phases 5 and 7;
    every kernel of the path (RMS norm forward and backward, the three
    flash kernels, cross-entropy forward and backward) must launch;
11. LLaMA training: ``bench_llama``'s recipe (bench.py:1071-1138) at 16
    layers, f32 master weights under ``amp.auto_cast(bf16, O1)``,
    ``AdamW(1e-4)``, the shifted cross-entropy, B=8, S=1024, one batch
    from a numpy seed fed as ids and labels: 2 warm-up steps, then 5
    timed steps (ms/step, tokens/s, MFU, peak memory, launches per step,
    one profiled step);
12. LLaMA generate: LLaMA-2 7B's width cut to 2 layers, f32, 4
    left-padded prompts of 37-120 tokens, 16 greedy tokens identical on
    the card and the CPU; then ``LLAMA_7B`` (32 layers) in bf16 with
    random weights from a seed, 4 prompts x 128 tokens, 64 greedy
    tokens: prefill ms, ms per decode step, tokens/s, peak memory;
13. int8 serving: phase 4's drive, unchanged but for the dtypes:
    GPT_1P3B in bf16 with the same random weights, served by
    ``GenerationEngine(..., weight_dtype="int8", kv_cache_dtype="int8")``
    (the reference bench's int8 phase at the 1.3B width).  Gates: one
    full-width prefill's logits with int8 weights against bf16 weights
    (``logits_cosine`` >= 0.99), the int8 pool's bytes per block at most
    1/1.8 of the bf16 pool's, launches counted as in phase 4.  Reports
    tokens/s, ms/step, TTFT, weight memory and KV blocks against phase
    4's, the greedy match ratio against phase 4's tokens, and one
    profiled burst;
14. BERT training parity: BERT-base's width (hidden 768, 12 heads, ffn
    3072, vocab 30522) cut to 2 layers, f32, both dropouts 0, weights
    from a numpy seed, B=2, S=128, labels the ids with about 15% at -100:
    3 AdamW steps on the card and on the CPU, held as in phases 5, 7 and
    10, but for the parameter elements whose gradient lay within the
    gradient gate of 0 at some step (AdamW steps them by ~lr of a sign
    the gate does not fix; the key slices of the qkv biases have a
    gradient of 0 in exact arithmetic): those are held to 2 * 3 * lr;
    every kernel of the path must launch, the three flash kernels (not
    causal) included;
15. BERT training: bench.py's ``bench_bert`` recipe (bench.py:314-380)
    run eagerly: ``BertConfig()`` (12 layers, dropout 0.1 on the hidden
    states and the attention probabilities, so attention takes the
    composite and no flash kernel runs), f32 master weights under
    ``amp.auto_cast(bf16, O1)``, ``AdamW(1e-4)``, B=64, S=128, ids from
    ``np.random.default_rng(0)`` fed as ids and labels: 2 warm-up steps,
    then 5 timed steps (ms/step, tokens/s, MFU, peak memory, launches per
    step, one profiled step);
16. ERNIE: ``ErnieConfig()``'s width cut to 2 layers, f32, eval, numpy
    weights: the MLM logits, the pooled output and the sequence
    classification logits on the card against the CPU; then
    ``ErnieForSequenceClassification`` at 12 layers in bf16, random
    weights from a seed, eval, B=64, S=128: ms per forward, sequences/s,
    launches per forward (the flash forward, not causal), one profiled
    forward;
17. MoE serving parity: MoE-GPT at GPT_1P3B's width (4 experts, top 2)
    cut to 2 layers, f32, numpy weights, served on the card and on the
    CPU with phase 3's 4 requests, 16 greedy tokens each: identical
    tokens, identical expert choices of every row at the first step
    (else each differing row's top-k margin is printed), and the grouped
    forward kernel launched exactly 2 x layers a step;
18. MoE serving: MoE-GPT at GPT_1P3B's width (24 layers, ~3.7 B
    parameters) in bf16, random weights from a seed, on phase 4's trace
    unchanged (the dense twin): tokens/s, ms/step, TTFT, peak memory,
    launches per step, each step's per-expert counts and their imbalance
    (mean and max), one profiled burst with the grouped kernel in its own
    group, beside phase 4's numbers;
19. MoE training parity: ``MoEGPTConfig()``'s width (hidden 768, 12
    heads, vocab 50304, experts of 3072) cut to 2 layers, f32, composite
    attention, numpy weights, B=2, S=128: 3 AdamW steps with the aux loss
    on the card and on the CPU, held as phase 14; the grouped forward
    kernel launches 4 x layers a step (forward and dx), the dw kernel 2 x
    layers;
20. MoE training: bench.py's ``moe_gpt`` recipe (bench.py:1518-1545:
    ``MoEGPTPretrainingCriterion`` with the aux loss, ``AdamW(1e-4)``,
    random ids as labels, f32, no ``auto_cast``, composite attention) at
    ``MoEGPTConfig()``'s own 12 layers on one card, B=8, S=1024: ms/step,
    tokens/s, MFU over the active parameters, peak memory, launches per
    step, the loss falling on the repeated batch, one profiled step;
21. LoRA serving parity: bench_gpt_multilora's width (hidden 1024, 16
    heads, vocab 50304, 1024 positions) cut to 2 layers, f32, numpy
    weights, served with LoRA on (rank 16) on the card and on the CPU: 4
    adapters and 2 base-model rows among 6 requests, 16 greedy tokens
    each: identical tokens; the SGMV epilogue 4 x layers a step, fc1's
    matmul epilogue none;
22. multi-LoRA serving: bench.py:959-1068's ``bench_gpt_multilora``
    recipe (TPU branch) at 24 layers in bf16 with random weights from a
    seed (the reference builds f32 weights): 64 adapters of rank 16
    (``make_adapter``, seed 1000 + i), ``enable_lora(rank=16,
    num_slots=16)``, ``max_batch=8``, ``bursty_trace(7, 64 requests,
    adapter_pool=64)`` after a warm-up of 2 requests x 2 tokens:
    tokens/s, p99 TTFT, ms/step, the adapter hit rate and spills, peak
    memory, launches per step, one profiled burst; then the same trace
    without adapters on a LoRA-free engine (the base twin), and the
    base-model rows' greedy match ratio against it (reported);
23. LoRA fine-tuning parity: phase 21's width, 2 layers, f32, the base
    frozen and ``convert_to_lora(rank=16)``: 3 AdamW steps on the card and
    on the CPU held as phase 19; the base parameters end bit-unchanged;
    the SGMV epilogue, the grouped forward kernel (u, t, dx) and the
    grouped dw kernel launch;
24. LoRA fine-tuning: the multilora width at 24 layers, rank 16, on
    ``bench_gpt``'s recipe (f32 master weights under ``auto_cast(bf16,
    O1)``, ``AdamW(1e-4, weight_decay=0.01)`` over the LoRA factors, clip
    1.0), B=8, S=1024: ms/step, tokens/s, peak memory, launches per step,
    one profiled step (no MFU), the loss falling;
25. the paged decode view: GPT_1P3B's width cut to 2 layers, f32: 4
    prompts of 64 tokens prefilled through ``PagedCacheView("prefill")``
    and 16 greedy steps through ``PagedCacheView("decode")`` give the
    same tokens on the card and the CPU; then GPT_1P3B in bf16 on phase
    9's prompts (4 x 128) and weights, 64 decode steps: ms per decode step
    beside phase 9's dense cache and the token match against phase 9.

Before the last line come one JSON object (every kernel's results, the
serving, training-parity, training, flash training-parity, flash
training, generate, the three LLaMA, the int8 serving, the two BERT, the
ERNIE, the four MoE, the four LoRA and the paged decode summaries) and
the card's
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

#: column sums (dgamma, dbeta, db) over thousands of rows, taken in
#: another order: atol = SUM_TOL * the largest column's sum of |terms|
#: (f32: 1e-5 of it, ~80 f32 ulps, the rounding a few-thousand-term sum
#: may gather; bf16: 2^-8 of it, one bf16 rounding), rtol as in TOL.
SUM_TOL = {"bfloat16": 2.0 ** -8, "float32": 1e-5}

#: the training drive's shapes (B=4, S=1024, GPT_1P3B): 4096 token rows,
#: hidden 2048, fc1 width 8192, 4092 = 4 x 1023 logit rows after the
#: criterion's shift, vocab 50304
TRAIN_ROWS, HIDDEN, FFN, XENT_ROWS, VOCAB = 4096, 2048, 8192, 4092, 50304

#: ragged attention in bf16 is also held to the plain version run in f32
#: on the same values, which keeps the probabilities in f32 as the kernel
#: does: max |kernel - plain| <= 2^-8 * RMS(plain) + 2^-7 * |plain|, one
#: bf16 ulp of the output's rounding.  A dropped KV block moves the output
#: by several percent of its RMS, far past this limit.
RAGGED_BF16_F32P_TOL = (2.0 ** -8, 2.0 ** -7)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def bursty_trace(seed, n_requests=8, vocab=97, prefix_pool=4,
                 prefix_len=16, tail_max=5, zipf_a=1.5, pareto_a=1.3,
                 max_new_tokens=6, horizon=24, adapter_pool=0,
                 adapter_zipf=1.3, adapter_none_frac=0.25):
    """The reference's synthetic serving trace
    (``paddle_tpu/distributed/fault_tolerance/chaos.py:60``, its burst
    mode), copied so that this script needs no JAX: heavy-tailed arrival
    gaps, prompts that share Zipf-popular prefixes, and with
    ``adapter_pool`` a Zipf-popular adapter id per request (``"t0"``...,
    ``adapter_none_frac`` of them None: base-model rows) from a stream of
    its own.  Returns ``[{"arrival_step", "prompt", "max_new_tokens"[,
    "adapter"]}, ...]``, equal to the reference's for the same
    arguments."""
    import numpy as np
    rng = np.random.RandomState(seed)
    prefixes = [[int(t) for t in rng.randint(1, vocab, size=prefix_len)]
                for _ in range(prefix_pool)]
    ranks = np.arange(1, prefix_pool + 1, dtype=np.float64) ** -zipf_a
    probs = ranks / ranks.sum()
    if adapter_pool:
        a_rng = np.random.RandomState([int(seed), 0xADA])
        a_ranks = np.arange(1, int(adapter_pool) + 1,
                            dtype=np.float64) ** -float(adapter_zipf)
        a_probs = a_ranks / a_ranks.sum()
    t = 0.0
    out = []
    for i in range(int(n_requests)):
        if i:
            t += float(rng.pareto(pareto_a))
        p = int(rng.choice(prefix_pool, p=probs))
        tail = [int(x) for x in
                rng.randint(1, vocab, size=1 + int(rng.randint(tail_max)))]
        req = {"arrival_step": min(int(t), horizon - 1),
               "prompt": prefixes[p] + tail,
               "max_new_tokens": int(max_new_tokens)}
        if adapter_pool:
            base = a_rng.random_sample() < float(adapter_none_frac)
            aid = int(a_rng.choice(int(adapter_pool), p=a_probs))
            req["adapter"] = None if base else f"t{aid}"
        out.append(req)
    return out


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
#: GPU cycles (~0.5 ms) the stream sleeps before each timed call: longer
#: than any wrapper's host time, so the host has enqueued the call before
#: the stream reaches the start event, and the events time the kernels,
#: not the host (a slow host otherwise shows in the short kernels' times)
SLEEP_CYCLES = 1_000_000


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
        torch.cuda._sleep(SLEEP_CYCLES)
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
    n = HIDDEN
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
    K, N = HIDDEN, FFN
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


def check_matmul_epilogue_int8(ops, rows, dtype, dtype_name, gen):
    """The int8-weight epilogue at fc1's serving shape: x [rows, 2048] in
    ``dtype``, per-channel int8 codes [2048, 8192] with f32 scales, a bias
    in x's type, gelu_tanh."""
    import torch
    from paddle_tpu_torch.quantization import quantize_weight_int8
    K, N = HIDDEN, FFN
    x = torch.randn(rows, K, device="cuda", generator=gen).to(dtype)
    w_q, scale = quantize_weight_int8(
        torch.randn(K, N, device="cuda", generator=gen) / K ** 0.5, axis=1)
    b = (0.1 * torch.randn(N, device="cuda", generator=gen)).to(dtype)
    args = (x, w_q, scale, b, "gelu_tanh")
    out = ops.fused_linear_act_int8(*args)
    ref = ops.linear_act_int8_ref(*args)
    torch.cuda.synchronize()
    err, rel, ok = compare(out, ref, dtype_name)
    # the library call: torch._weight_int8pack_mm computes x @ (w_q * s)^T
    # from [N, K] codes, without the bias and the activation; timed here
    # only, the port never calls it
    w_nk, s_x = w_q.t().contiguous(), scale.to(dtype)

    def library():
        return torch._weight_int8pack_mm(x, w_nk, s_x)
    try:
        lib_err = compare(library(), torch.matmul(
            x.float(), w_q.float() * scale), dtype_name)[0]
        library_ms = time_ms(library)
        note = (f"library: x @ (w_q*s)^T only, no bias or activation; its "
                f"max abs err vs plain {lib_err:.3e}")
    except (RuntimeError, NotImplementedError) as exc:
        library_ms = None
        note = (f"library: none, torch._weight_int8pack_mm refused these "
                f"inputs ({str(exc).splitlines()[0][:120]})")
    isz = x.element_size()
    nbytes = rows * K * isz + K * N + 4 * N + N * isz + rows * N * isz
    bms, by = bound(nbytes, 2 * rows * K * N + 12 * rows * N, dtype_name)
    return dict(
        err=err, rel=rel, ok=ok, note=note,
        shape=f"x[{rows},{K}] w_q[{K},{N}] int8",
        ms=time_ms(lambda: ops.fused_linear_act_int8(*args)),
        plain_ms=time_ms(lambda: ops.linear_act_int8_ref(*args)),
        library_ms=library_ms, bound_ms=bms, bound_by=by)


def quantize_pool(pool):
    """Per-slot int8 codes of a float pool [nb, H, bs, D] and their f32
    scales [nb, bs, 1]: one abs-max over each slot's (H, D), as the
    quantizing KV scatter makes them."""
    import torch
    f = pool.float()
    amax = f.abs().amax(dim=(1, 3))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.clamp(torch.round(f / scale[:, None, :, None]), -127, 127)
    return codes.to(torch.int8), scale[..., None].contiguous()


def check_ragged_int8(ops, block_q, dtype, dtype_name, gen):
    """`check_ragged` over int8 pools with per-slot scales."""
    return check_ragged(ops, block_q, dtype, dtype_name, gen, int8=True)


def check_ragged(ops, block_q, dtype, dtype_name, gen, int8=False):
    """A mixed step of the serving drive: one 256-token prefill chunk
    (positions 256..511) plus seven decode rows at contexts 520-622.
    With ``int8`` the pools hold per-slot int8 codes and scales."""
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
    kw = dict(block_q=block_q)
    if int8:
        (kp, ks), (vp, vs) = quantize_pool(kp), quantize_pool(vp)
        kw.update(k_scales=ks, v_scales=vs)
    ints = [torch.from_numpy(a).cuda() for a in
            (tables, np.asarray(ctxs, np.int32), sid, qs, qv)]
    args = (q, kp, vp, *ints)
    out = ops.ragged_paged_attention(*args, **kw)
    ref = ops.ragged_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    err, rel, ok = compare(out, ref, dtype_name)
    note = ""
    if dtype == torch.bfloat16:
        pools32 = (kp, vp) if int8 else (kp.float(), vp.float())
        ref32 = ops.ragged_attention_ref(q.float(), *pools32, *ints, **kw)
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
    # K/V at the pool's element size, plus one f32 scale per touched slot
    # and side for int8 pools
    nbytes = (2 * q.numel() * isz
              + 2 * len(touched) * H * bs * D * kp.element_size()
              + (2 * len(touched) * bs * 4 if int8 else 0)
              + 4 * (tables.size + len(ctxs) + 3 * nqb))
    bms, by = bound(nbytes, 4 * D * H * pairs, dtype_name)
    return dict(
        err=err, rel=rel, ok=ok, note=note,
        shape=(f"q[{q.shape[0]},{H},{D}] pool[{nb},{H},{bs},{D}] "
               f"{dtype_name if not int8 else 'int8'} W={W}"),
        ms=time_ms(lambda: ops.ragged_paged_attention(*args, **kw)),
        plain_ms=time_ms(lambda: ops.ragged_attention_ref(*args, **kw),
                         iters=5),
        library_ms=None, bound_ms=bms, bound_by=by)


def compare_sum(got, want, abs_sum, dtype_name):
    """A column sum against its plain version: atol scaled to the sum of
    |terms| of the largest column (`SUM_TOL`), rtol as in `TOL`."""
    atol = SUM_TOL[dtype_name] * float(abs_sum.max())
    err, _, ok = compare(got, want, dtype_name, atol, TOL[dtype_name][1])
    return err, ok, atol


def check_layer_norm_bwd(ops, rows, dtype, dtype_name, gen):
    """The training drive's layer-norm backward: x, do [4096, 2048]."""
    import torch
    n = HIDDEN
    x = (torch.randn(rows, n, device="cuda", generator=gen)
         + 0.5).to(dtype)
    g = (1 + 0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    b = (0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    do = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
    _, mu, rstd = ops.layer_norm_ref(x, g, b)
    args = (x, g, mu, rstd, do)
    dx, dg, db = ops.fused_layer_norm_bwd(*args)
    dx_r, dg_r, db_r = ops.layer_norm_bwd_ref(*args)
    torch.cuda.synchronize()
    err, rel, ok = compare(dx, dx_r, dtype_name)
    xhat = (x.float() - mu[:, None]) * rstd[:, None]
    dg_err, dg_ok, dg_tol = compare_sum(
        dg, dg_r, (do.float() * xhat).abs().sum(0), dtype_name)
    db_err, db_ok, db_tol = compare_sum(db, db_r, do.float().abs().sum(0),
                                        dtype_name)
    del xhat
    isz = x.element_size()
    nbytes = 3 * rows * n * isz + 3 * n * isz + 2 * rows * 4
    bms, by = bound(nbytes, 13 * rows * n, dtype_name)
    mean, rs = mu[:, None].contiguous(), rstd[:, None].contiguous()

    def library():
        return torch.ops.aten.native_layer_norm_backward(
            do, x, [n], mean, rs, g, b, [True, True, True])
    return dict(
        err=max(err, dg_err, db_err), rel=rel, ok=ok and dg_ok and db_ok,
        shape=f"x[{rows},{n}]",
        note=(f"dx max abs err {err:.3e}; dgamma {dg_err:.3e} (atol "
              f"{dg_tol:.3e}), dbeta {db_err:.3e} (atol {db_tol:.3e})"),
        ms=time_ms(lambda: ops.fused_layer_norm_bwd(*args)),
        plain_ms=time_ms(lambda: ops.layer_norm_bwd_ref(*args)),
        library_ms=time_ms(library), bound_ms=bms, bound_by=by)


#: the BERT training drive's residual stream (B=64, S=128, hidden 768):
#: 8192 token rows, f32 under O1 (fused_residual_layer_norm is black-listed)
BERT_ROWS, BERT_HIDDEN = 8192, 768


def check_layer_norm_residual(ops, rows, dtype, dtype_name, gen):
    """The fused residual add + layer norm forward at the BERT drive's
    [8192, 768], and its backward, the layer-norm backward kernel on the
    saved sum (held and timed in the note)."""
    import torch
    n = BERT_HIDDEN
    x = (2 * torch.randn(rows, n, device="cuda", generator=gen)
         + 0.5).to(dtype)
    r = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
    g = (1 + 0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    b = (0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    out, s, mu, rstd = ops.fused_layer_norm_residual(x, r, g, b, 1e-12)
    ref, s_r, mu_r, rstd_r = ops.layer_norm_residual_ref(x, r, g, b, 1e-12)
    do = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
    bargs = (s_r, g, mu_r, rstd_r, do)
    dx, dg, db = ops.fused_layer_norm_bwd(*bargs)
    dx_r, dg_r, db_r = ops.layer_norm_bwd_ref(*bargs)
    torch.cuda.synchronize()
    err, rel, ok = compare(out, ref, dtype_name)
    s_err, _, s_ok = compare(s, s_r, dtype_name)
    stat_ok = compare(mu, mu_r, "float32")[2] \
        and compare(rstd, rstd_r, "float32")[2]
    dx_err, _, dx_ok = compare(dx, dx_r, dtype_name)
    xhat = (s_r.float() - mu_r[:, None]) * rstd_r[:, None]
    dg_err, dg_ok, _ = compare_sum(dg, dg_r, (do.float() * xhat).abs().sum(0),
                                   dtype_name)
    db_err, db_ok, _ = compare_sum(db, db_r, do.float().abs().sum(0),
                                   dtype_name)
    del xhat
    isz = x.element_size()
    # four [rows, n] streams (x, r read; out, s written), gamma and beta,
    # the f32 mu and rstd
    nbytes = 4 * rows * n * isz + 2 * n * isz + 2 * rows * 4
    bms, by = bound(nbytes, 10 * rows * n, dtype_name)
    bwd_ms = time_ms(lambda: ops.fused_layer_norm_bwd(*bargs))

    def library():      # two calls: no single PyTorch call computes it
        return torch.nn.functional.layer_norm(x + r, (n,), g, b, 1e-12)
    return dict(      # err: the forward kernel's (out, s); the rest in note
        err=max(err, s_err), rel=rel,
        ok=ok and s_ok and stat_ok and dx_ok and dg_ok and db_ok,
        shape=f"x, r[{rows},{n}]",
        note=(f"out {err:.3e}, s {s_err:.3e}; backward (layer_norm_bwd on "
              f"the saved s) dx {dx_err:.3e}, dgamma {dg_err:.3e}, dbeta "
              f"{db_err:.3e}, {bwd_ms:.4f} ms; library: F.layer_norm(x + r), "
              f"two calls"),
        ms=time_ms(lambda: ops.fused_layer_norm_residual(x, r, g, b, 1e-12)),
        plain_ms=time_ms(lambda: ops.layer_norm_residual_ref(x, r, g, b,
                                                             1e-12)),
        library_ms=time_ms(library), bound_ms=bms, bound_by=by)


def check_matmul_epilogue_bwd(ops, rows, dtype, dtype_name, gen):
    """The training drive's fc1 epilogue backward: z, g [4096, 8192],
    gelu_tanh."""
    import torch
    N = FFN
    z = torch.randn(rows, N, device="cuda", generator=gen).to(dtype)
    g = (0.1 * torch.randn(rows, N, device="cuda", generator=gen)).to(dtype)
    dz, db = ops.fused_linear_act_bwd(z, g, "gelu_tanh")
    dz_r, db_r = ops.linear_act_bwd_ref(z, g, "gelu_tanh")
    torch.cuda.synchronize()
    err, rel, ok = compare(dz, dz_r, dtype_name)
    db_err, db_ok, db_tol = compare_sum(db, db_r, dz_r.float().abs().sum(0),
                                        dtype_name)
    isz = z.element_size()
    nbytes = 3 * rows * N * isz + N * isz
    bms, by = bound(nbytes, 20 * rows * N, dtype_name)
    return dict(
        err=max(err, db_err), rel=rel, ok=ok and db_ok,
        shape=f"z[{rows},{N}] gelu_tanh",
        note=(f"dz max abs err {err:.3e}; db {db_err:.3e} (atol "
              f"{db_tol:.3e}); the library call computes dz only"),
        ms=time_ms(lambda: ops.fused_linear_act_bwd(z, g, "gelu_tanh")),
        plain_ms=time_ms(lambda: ops.linear_act_bwd_ref(z, g, "gelu_tanh")),
        library_ms=time_ms(lambda: torch.ops.aten.gelu_backward(
            g, z, approximate="tanh")),
        bound_ms=bms, bound_by=by)


def _xent_inputs(rows, dtype, gen):
    import torch
    x = (2 * torch.randn(rows, VOCAB, device="cuda",
                         generator=gen)).to(dtype)
    labels = torch.randint(0, VOCAB, (rows,), device="cuda", generator=gen)
    labels[::97] = -1                     # a few ignored rows
    return x, labels


def check_softmax_xent_fwd(ops, rows, dtype, dtype_name, gen):
    """The training drive's loss: logits [4092, 50304]."""
    import torch
    x, labels = _xent_inputs(rows, dtype, gen)
    loss, lse = ops.softmax_xent_fwd(x, labels)
    loss_r, lse_r = ops.softmax_xent_fwd_ref(x, labels)
    torch.cuda.synchronize()
    # loss and lse are f32 whatever the logits' type: f32 tolerance
    err, rel, ok = compare(loss, loss_r, "float32")
    lse_err, _, lse_ok = compare(lse, lse_r, "float32")
    isz = x.element_size()
    nbytes = rows * VOCAB * isz + rows * 8 + 2 * rows * 4
    bms, by = bound(nbytes, 4 * rows * VOCAB, dtype_name)
    return dict(
        err=max(err, lse_err), rel=rel, ok=ok and lse_ok,
        shape=f"logits[{rows},{VOCAB}]",
        note=f"loss max abs err {err:.3e}, lse {lse_err:.3e}",
        ms=time_ms(lambda: ops.softmax_xent_fwd(x, labels)),
        plain_ms=time_ms(lambda: ops.softmax_xent_fwd_ref(x, labels)),
        library_ms=time_ms(lambda: torch.nn.functional.cross_entropy(
            x, labels, reduction="none", ignore_index=-1)),
        bound_ms=bms, bound_by=by)


def check_softmax_xent_bwd(ops, rows, dtype, dtype_name, gen):
    """The training drive's loss gradient: logits [4092, 50304], g the
    mean's 1/valid-count per row."""
    import torch
    x, labels = _xent_inputs(rows, dtype, gen)
    _, lse = ops.softmax_xent_fwd_ref(x, labels)
    g = torch.full((rows,), 1.0 / rows, device="cuda")
    dx = ops.softmax_xent_bwd(x, labels, lse, g)
    dx_r = ops.softmax_xent_bwd_ref(x, labels, lse, g)
    torch.cuda.synchronize()
    # dx is ~1/rows in size: hold it to TOL scaled by the gradient's 1/rows
    atol, rtol = TOL[dtype_name]
    err, rel, ok = compare(dx, dx_r, dtype_name, atol / rows, rtol)
    isz = x.element_size()
    nbytes = 2 * rows * VOCAB * isz + rows * (8 + 4 + 4)
    bms, by = bound(nbytes, 4 * rows * VOCAB, dtype_name)
    return dict(
        err=err, rel=rel, ok=ok, shape=f"logits[{rows},{VOCAB}]",
        note=(f"tolerance {atol / rows:.3e} + {rtol:g}*|plain|; no single "
              f"PyTorch call computes this backward alone"),
        ms=time_ms(lambda: ops.softmax_xent_bwd(x, labels, lse, g)),
        plain_ms=time_ms(lambda: ops.softmax_xent_bwd_ref(x, labels, lse,
                                                          g)),
        library_ms=None, bound_ms=bms, bound_by=by)


#: RMS norm shapes (rows, hidden).  train: the LLaMA training drive's 8 x
#: 1024 token rows of hidden 1024 (f32 there: O1 black-lists rms_norm);
#: prefill: LLaMA-2 7B's 4 prompts x 128 tokens of hidden 4096; decode:
#: one decode step of those 4 rows
RMS_SHAPES = {"train": (8192, 1024), "prefill": (512, 4096),
              "decode": (4, 4096)}
RMS_EPS = 1e-6


def check_rms_norm(ops, shape_key, dtype, dtype_name, gen):
    import torch
    rows, n = RMS_SHAPES[shape_key]
    x = (torch.randn(rows, n, device="cuda", generator=gen) + 0.5).to(dtype)
    g = (1 + 0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    out, rstd = ops.fused_rms_norm(x, g, RMS_EPS)
    ref, rstd_ref = ops.rms_norm_ref(x, g, RMS_EPS)
    torch.cuda.synchronize()
    err, rel, ok = compare(out, ref, dtype_name)
    rstd_err, _, rstd_ok = compare(rstd, rstd_ref, "float32")
    isz = x.element_size()
    nbytes = 2 * rows * n * isz + n * isz + rows * 4
    bms, by = bound(nbytes, 4 * rows * n, dtype_name)
    try:   # timing only: the port never calls it
        lib = torch.nn.functional.rms_norm
        lib(x, (n,), g, RMS_EPS)
        library_ms = time_ms(lambda: lib(x, (n,), g, RMS_EPS))
        lib_note = "library F.rms_norm"
    except (AttributeError, RuntimeError) as exc:
        library_ms = None
        lib_note = f"library call failed: {str(exc).splitlines()[0][:160]}"
    return dict(
        err=max(err, rstd_err), rel=rel, ok=ok and rstd_ok,
        shape=f"x[{rows},{n}]",
        note=f"out {err:.3e}, rstd {rstd_err:.3e}; {lib_note}",
        ms=time_ms(lambda: ops.fused_rms_norm(x, g, RMS_EPS)),
        plain_ms=time_ms(lambda: ops.rms_norm_ref(x, g, RMS_EPS)),
        library_ms=library_ms, bound_ms=bms, bound_by=by)


def check_rms_norm_bwd(ops, shape_key, dtype, dtype_name, gen):
    """dx and dgamma from the plain forward's rstd; dgamma held by the
    column-sum rule (`compare_sum`)."""
    import torch
    rows, n = RMS_SHAPES[shape_key]
    x = (torch.randn(rows, n, device="cuda", generator=gen) + 0.5).to(dtype)
    g = (1 + 0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    do = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
    _, rstd = ops.rms_norm_ref(x, g, RMS_EPS)
    args = (x, g, rstd, do)
    dx, dg = ops.fused_rms_norm_bwd(*args)
    dx_r, dg_r = ops.rms_norm_bwd_ref(*args)
    torch.cuda.synchronize()
    err, rel, ok = compare(dx, dx_r, dtype_name)
    dg_err, dg_ok, dg_tol = compare_sum(
        dg, dg_r, (do.float() * x.float() * rstd[:, None]).abs().sum(0),
        dtype_name)
    isz = x.element_size()
    nbytes = 3 * rows * n * isz + 2 * n * isz + rows * 4
    bms, by = bound(nbytes, 8 * rows * n, dtype_name)
    try:   # timing only: ATen's fused backward, from its own forward's rstd
        aten = torch.ops.aten
        _, lib_rstd = aten._fused_rms_norm(x, [n], g, RMS_EPS)

        def library():
            return aten._fused_rms_norm_backward(do, x, [n], lib_rstd, g,
                                                 [True, True])
        lib_err = compare(library()[0], dx_r, dtype_name)[0]
        library_ms = time_ms(library)
        lib_note = (f"library aten._fused_rms_norm_backward, dx vs plain "
                    f"{lib_err:.3e}")
    except (AttributeError, RuntimeError, TypeError) as exc:
        library_ms = None
        lib_note = f"library call failed: {str(exc).splitlines()[0][:160]}"
    return dict(
        err=max(err, dg_err), rel=rel, ok=ok and dg_ok,
        shape=f"x[{rows},{n}]",
        note=(f"dx max abs err {err:.3e}; dgamma {dg_err:.3e} (atol "
              f"{dg_tol:.3e}); {lib_note}"),
        ms=time_ms(lambda: ops.fused_rms_norm_bwd(*args)),
        plain_ms=time_ms(lambda: ops.rms_norm_bwd_ref(*args)),
        library_ms=library_ms, bound_ms=bms, bound_by=by)


#: flash attention shapes: (B, Sq, Sk, H, D, causal).  train: the flash
#: drive's (B=8, S=1024, GPT_1P3B's 16 heads of 128); decode: one
#: generate step of the 1.3B drive (4 rows, one query against 640 keys);
#: train_d64: bench.py's 0.35B width (hidden 1024, 16 heads of 64); bert:
#: BERT-base's attention in the ERNIE eval drive and at dropout 0 (B=64,
#: S=128, 12 heads of 64, not causal); d256: the widest head the
#: reference routes to its kernel, causal and not (no model of the repo
#: has it; 8 heads of 256 at S=1024)
FLASH_SHAPES = {"train": (8, 1024, 1024, 16, 128, True),
                "decode": (4, 1, 640, 16, 128, True),
                "train_d64": (8, 1024, 1024, 16, 64, True),
                "bert": (64, 128, 128, 12, 64, False),
                "d256_causal": (2, 1024, 1024, 8, 256, True),
                "d256_full": (2, 1024, 1024, 8, 256, False)}


#: the flash kernels' names (the bf16 tensor-core kernels add "_mma")
FLASH_KERNEL_NAMES = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                      "flash_bwd_dkv_kernel")


def kernel_resources(cuda_lib, lib_path, names):
    """Registers a thread and stack/local bytes (where spills go) of every
    instantiation of the kernels whose names contain one of ``names``, from
    ``cuobjdump --dump-resource-usage`` on the built library; printed, and
    returned as {demangled name: {"registers", "stack", "local"}}.  None
    (with the reason printed) where the toolkit has no cuobjdump."""
    import re
    bin_dir = Path(cuda_lib._nvcc()).parent
    tool = bin_dir / "cuobjdump"
    if not tool.exists():
        say(f"  resource usage: no cuobjdump beside nvcc in {bin_dir}")
        return None
    dump = subprocess.run([str(tool), "--dump-resource-usage", str(lib_path)],
                          capture_output=True, text=True, timeout=120)
    found = re.findall(r"Function (\S+):\s+REG:(\d+) STACK:(\d+) "
                       r"SHARED:\d+ LOCAL:(\d+)", dump.stdout)
    found = [f for f in found if any(n in f[0] for n in names)]
    plain = [f[0] for f in found]
    filt = bin_dir / "cu++filt"
    if filt.exists() and plain:
        out = subprocess.run([str(filt), *plain], capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
        if len(out) == len(plain):
            # "void <unnamed>::tc::k<(int)128, (bool)1>(...)" -> k<128, 1>
            plain = [re.sub(r"\((?:int|bool)\)|<unnamed>::|"
                            r"\(anonymous namespace\)::|^void ", "", o)
                     .split("(")[0] for o in out]
    res = {}
    for name, (_, reg, stack, local) in zip(plain, found):
        res[name] = dict(registers=int(reg), stack=int(stack),
                         local=int(local))
        say(f"  {name}: {reg} registers a thread, stack {stack} B, local "
            f"{local} B")
    return res


def visible_pairs(sq, sk, causal):
    """(row, key) pairs one (batch, head) attends: bottom-right causal."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(sk, max(0, r + off + 1)) for r in range(sq))


def _flash_library(q, k, v, g, causal, dtype):
    """PyTorch's own fused attention on the same inputs ([B, H, S, D]
    views), forward and backward: the flash kernel in bf16, the
    memory-efficient one in f32 (flash takes no f32).  Timed here only;
    the port never calls them.  Returns (fwd fn, bwd fn, out)."""
    import torch
    qt, kt, vt, gt = (t.transpose(1, 2) for t in (q, k, v, g))
    scale = 1.0 / q.shape[-1] ** 0.5
    # torch aligns a causal mask top-left: for Sq < Sk only Sq = 1 (which
    # sees every key) is the same function, and runs without the mask
    lib_causal = causal and q.shape[1] == k.shape[1]
    aten = torch.ops.aten
    if dtype == torch.bfloat16:
        def fwd():
            return aten._scaled_dot_product_flash_attention(
                qt, kt, vt, 0.0, lib_causal, False, scale=scale)
        res = fwd()

        def bwd():
            return aten._scaled_dot_product_flash_attention_backward(
                gt, qt, kt, vt, res[0], res[1], res[2], res[3], res[4],
                res[5], 0.0, lib_causal, res[6], res[7], scale=scale)
    else:
        def fwd():
            return aten._scaled_dot_product_efficient_attention(
                qt, kt, vt, None, True, 0.0, lib_causal, scale=scale)
        res = fwd()

        def bwd():
            return aten._scaled_dot_product_efficient_attention_backward(
                gt, qt, kt, vt, None, res[0], res[1], res[2], res[3], 0.0,
                [True, True, True, False], lib_causal, scale=scale)
    return fwd, bwd, res[0].transpose(1, 2)


def check_flash(ops, shape_key, dtype, dtype_name, gen):
    """The three flash kernels at one shape: q, k, v as the views
    ``qkv.unbind(2)`` gives (the model's layout; S and Sk equal) or as
    separate tensors.  dq and dk/dv take lse and delta from the plain
    forward, as both versions must see the same inputs."""
    import torch
    B, Sq, Sk, H, D, causal = FLASH_SHAPES[shape_key]
    if Sq == Sk:
        qkv = torch.randn(B, Sq, 3, H, D, device="cuda",
                          generator=gen).to(dtype)
        q, k, v = qkv.unbind(2)
    else:
        q, k, v = (torch.randn(B, s, H, D, device="cuda",
                               generator=gen).to(dtype)
                   for s in (Sq, Sk, Sk))
    g = torch.randn(B, Sq, H, D, device="cuda", generator=gen).to(dtype)
    out, lse = ops.fused_flash_attention_fwd(q, k, v, causal)
    out_r, lse_r = ops.flash_attention_ref(q, k, v, causal)
    lse_s, delta = ops.flash_bwd_stats(out_r, g, lse_r)
    bargs = (q, k, v, g, lse_s, delta, causal)
    dq = ops.fused_flash_attention_bwd_dq(*bargs)
    dk, dv = ops.fused_flash_attention_bwd_dkv(*bargs)
    dq_r, dk_r, dv_r = ops.flash_attention_bwd_ref(*bargs)
    # the backward sums in a fixed order, no atomics: a second run is
    # bit-identical
    again = (ops.fused_flash_attention_bwd_dq(*bargs),
             *ops.fused_flash_attention_bwd_dkv(*bargs))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
        fail(f"flash backward {dtype_name} {shape_key}: two runs on the "
             f"same inputs differ")
    err, rel, ok = compare(out, out_r, dtype_name)
    lse_err, _, lse_ok = compare(lse, lse_r, "float32")
    dq_err, dq_rel, dq_ok = compare(dq, dq_r, dtype_name)
    errs = [compare(a, b, dtype_name) for a, b in ((dk, dk_r), (dv, dv_r))]
    pairs = B * H * visible_pairs(Sq, Sk, causal)
    isz = q.element_size()
    qb, kb = B * Sq * H * D * isz, B * Sk * H * D * isz
    stats = 4 * B * H * Sq
    shape = (f"B={B} Sq={Sq} Sk={Sk} H={H} D={D} "
             f"{'causal' if causal else 'full'}")
    try:
        lib_fwd, lib_bwd, lib_out = _flash_library(q, k, v, g, causal, dtype)
        lib_note = (f"library vs plain max abs err "
                    f"{compare(lib_out, out_r, dtype_name)[0]:.3e}")
        lib_fwd_ms, lib_bwd_ms = time_ms(lib_fwd), time_ms(lib_bwd)
    except (RuntimeError, TypeError) as exc:   # timing only: report why
        lib_note = f"library call failed: {str(exc).splitlines()[0][:160]}"
        lib_fwd_ms = lib_bwd_ms = None
    bwd_note = "; the library call computes dq, dk and dv in one call"
    # one plain backward computes dq, dk and dv: timed once for both
    plain_bwd_ms = time_ms(lambda: ops.flash_attention_bwd_ref(*bargs),
                           iters=5)
    fwd_b = bound(2 * qb + 2 * kb + stats, 4 * D * pairs, dtype_name)
    dq_b = bound(3 * qb + 2 * kb + 2 * stats, 6 * D * pairs, dtype_name)
    dkv_b = bound(2 * qb + 4 * kb + 2 * stats, 8 * D * pairs, dtype_name)
    return {
        "flash_attention_fwd": dict(
            err=max(err, lse_err), rel=rel, ok=ok and lse_ok, shape=shape,
            note=f"out {err:.3e}, lse {lse_err:.3e}; {lib_note}",
            ms=time_ms(lambda: ops.fused_flash_attention_fwd(q, k, v,
                                                             causal)),
            plain_ms=time_ms(lambda: ops.flash_attention_ref(q, k, v, causal),
                             iters=5),
            library_ms=lib_fwd_ms, bound_ms=fwd_b[0], bound_by=fwd_b[1]),
        "flash_attention_bwd_dq": dict(
            err=dq_err, rel=dq_rel, ok=dq_ok, shape=shape,
            note=lib_note + bwd_note,
            ms=time_ms(lambda: ops.fused_flash_attention_bwd_dq(*bargs)),
            plain_ms=plain_bwd_ms,
            library_ms=lib_bwd_ms, bound_ms=dq_b[0], bound_by=dq_b[1]),
        "flash_attention_bwd_dkv": dict(
            err=max(e[0] for e in errs), rel=max(e[1] for e in errs),
            ok=all(e[2] for e in errs), shape=shape,
            note=(f"dk {errs[0][0]:.3e}, dv {errs[1][0]:.3e}; "
                  + lib_note + bwd_note),
            ms=time_ms(lambda: ops.fused_flash_attention_bwd_dkv(*bargs)),
            plain_ms=plain_bwd_ms,
            library_ms=lib_bwd_ms, bound_ms=dkv_b[0], bound_by=dkv_b[1]),
    }


#: the grouped-expert matmul's cases: (assignments per expert, K, N, act,
#: transposed weights, z saved).  serve/w2: the MoE serving drive's mixed
#: step (368 packed rows x top 2 = 736 assignments over E = 4 at bm 128,
#: 10 blocks) through w1 (2048 -> 8192, gelu_tanh) and w2 (8192 -> 2048);
#: train/train_dx: the MoE training drive's 16384 assignments (B=8,
#: S=1024, top 2) through w1 (768 -> 3072, z saved) and the backward's dx
#: (3072 -> 768 against w1 read transposed).  Counts are skewed: one
#: expert empty, one holding almost everything.
GROUPED_CASES = {"serve": ([0, 700, 20, 16], 2048, 8192, "gelu_tanh",
                           False, False),
                 "w2": ([0, 700, 20, 16], 8192, 2048, "none", False, False),
                 "train": ([0, 15000, 1000, 384], 768, 3072, "gelu_tanh",
                           False, True),
                 "train_dx": ([0, 15000, 1000, 384], 3072, 768, "none",
                              True, False)}


def grouped_inputs(ops, counts, K, dtype, gen):
    """x [R, K] with each expert's rows in its blocks (padding rows zero),
    the block ids, and each expert's (first row, rows) for the library
    yardstick."""
    import torch
    E = len(counts)
    bm, nb, R = ops.grouped_layout(sum(counts), E, dtype)
    gid, offsets = ops.group_segments(torch.tensor(counts), bm, nb)
    x = torch.zeros(R, K, device="cuda", dtype=dtype)
    segs = []
    for e, c in enumerate(counts):
        o = int(offsets[e])
        x[o:o + c] = torch.randn(c, K, device="cuda", generator=gen).to(dtype)
        segs.append((o, -(-c // bm) * bm))
    return x, gid.cuda(), segs, bm


def _grouped_mm_offsets(segs):
    """torch._grouped_mm's ``offs``: each expert's last row + 1, its rows
    taken as its whole run of blocks (padding rows are zero)."""
    import torch
    return torch.tensor([o + n for o, n in segs], dtype=torch.int32,
                        device="cuda")


def check_grouped(ops, case, dtype, dtype_name, gen):
    """The grouped forward kernel at one of `GROUPED_CASES` against its
    plain version.  Library yardstick: ``torch._grouped_mm`` on the same
    rows plus the bias and the activation as separate calls (bf16, where
    this torch has it), else a per-expert loop of
    ``torch._addmm_activation`` (``addmm`` without activation; for the
    transposed case the weights' transposed views)."""
    import torch
    counts, K, N, act, trans, save_z = GROUPED_CASES[case]
    E = len(counts)
    x, gid, segs, bm = grouped_inputs(ops, counts, K, dtype, gen)
    shape_w = (E, N, K) if trans else (E, K, N)
    w = (torch.randn(*shape_w, device="cuda", generator=gen)
         / K ** 0.5).to(dtype)
    b = None if trans else (0.1 * torch.randn(
        E, N, device="cuda", generator=gen)).to(dtype)

    def kernel():
        return ops.fused_grouped_linear_act(x, w, b, gid, act,
                                            return_z=save_z,
                                            transpose_w=trans)
    wp = w.transpose(1, 2) if trans else w        # [E, K, N] views

    def plain():
        return ops.grouped_linear_act_ref(x, wp, b, block_group=gid,
                                          act=act)
    got = kernel()
    got = got[0] if save_z else got
    want = plain()
    torch.cuda.synchronize()
    err, rel, ok = compare(got, want, dtype_name)
    real = [(e, o, n) for e, (o, n) in enumerate(segs) if n]
    lib_fn = None
    if dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
        offs = _grouped_mm_offsets(segs)
        row_e = torch.repeat_interleave(
            torch.arange(E, device="cuda"),
            torch.tensor([n for _, n in segs], device="cuda"))
        rows = int(offs[-1])
        xr = x[:rows]

        def lib_fn():
            y = torch._grouped_mm(xr, wp, offs=offs)
            if b is not None:
                y = y + b[row_e]
            if act == "gelu_tanh":
                y = torch.nn.functional.gelu(y, approximate="tanh")
            return y
        lib_name = "torch._grouped_mm" + ("" if b is None else " + bias") \
            + (" + gelu" if act == "gelu_tanh" else "")
        try:
            lib_out = lib_fn()
            lib_err = compare(lib_out, want[:rows], dtype_name)[0]
        except (RuntimeError, TypeError) as exc:
            lib_fn, lib_name = None, (
                f"torch._grouped_mm failed ({str(exc).splitlines()[0][:100]})"
                f"; ")
    if lib_fn is None:
        prefix = "" if dtype != torch.bfloat16 else lib_name
        zero_b = torch.zeros(N, device="cuda", dtype=dtype)

        def lib_fn():
            if act == "gelu_tanh":
                return [torch._addmm_activation(
                    zero_b if b is None else b[e], x[o:o + n], wp[e],
                    use_gelu=True) for e, o, n in real]
            return [torch.addmm(zero_b if b is None else b[e], x[o:o + n],
                                wp[e]) for e, o, n in real]
        lib_name = prefix + ("a per-expert loop of torch._addmm_activation"
                             if act == "gelu_tanh" else
                             "a per-expert loop of torch.addmm")
        lib_out = torch.cat([y for y in lib_fn()])
        lib_err = compare(lib_out, torch.cat(
            [want[o:o + n] for _, o, n in real]), dtype_name)[0]
    T = sum(counts)
    isz = x.element_size()
    used = sum(1 for c in counts if c)
    nbytes = (used * (K * N + (0 if b is None else N)) + x.shape[0] * K
              + x.shape[0] * N * (2 if save_z else 1)) * isz
    bms, by = bound(nbytes, 2 * T * K * N, dtype_name)
    return dict(
        err=err, rel=rel, ok=ok,
        shape=(f"{case}: x[{x.shape[0]},{K}] (bm {bm}, counts {counts}) "
               f"w[{E},{K},{N}]{' read transposed' if trans else ''} "
               f"{act}{', z saved' if save_z else ''}"),
        note=f"library: {lib_name}, vs plain max abs err {lib_err:.3e}",
        ms=time_ms(kernel), plain_ms=time_ms(plain, iters=5),
        library_ms=time_ms(lib_fn), bound_ms=bms, bound_by=by)


def check_grouped_dw(ops, case, dtype, dtype_name, gen):
    """The grouped dw kernel at the training case's shapes (x [R, K], dz
    [R, N] of w1) against its plain version, as a column sum (`SUM_TOL`
    of the largest sum of |terms|).  Library yardstick: ``torch._grouped_mm``
    of x^T and dz over the experts' row ranges (bf16, where this torch
    has it), else a per-expert loop of ``torch.mm``."""
    import torch
    counts, K, N = GROUPED_CASES[case][:3]
    E = len(counts)
    x, gid, segs, bm = grouped_inputs(ops, counts, K, dtype, gen)
    dz = torch.zeros(x.shape[0], N, device="cuda", dtype=dtype)
    for o, n in segs:
        dz[o:o + n] = torch.randn(n, N, device="cuda", generator=gen).to(
            dtype)

    def kernel():
        return ops.fused_grouped_dw(x, dz, gid, E)

    def plain():
        return ops.grouped_dw_ref(x, dz, gid, E)
    got, want = kernel(), plain()
    abs_sum = ops.grouped_dw_ref(x.abs(), dz.abs(), gid, E).float()
    torch.cuda.synchronize()
    err, ok, _ = compare_sum(got, want, abs_sum, dtype_name)
    rel = compare(got, want, dtype_name)[1]
    ok = ok and all(not bool(got[e].any()) for e, c in enumerate(counts)
                    if not c)
    lib_fn = None
    if dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
        offs = _grouped_mm_offsets(segs)
        rows = int(offs[-1])
        xt, dzr = x[:rows].t(), dz[:rows]

        def lib_fn():
            return torch._grouped_mm(xt, dzr, offs=offs)
        lib_name = "torch._grouped_mm"
        try:
            lib_err = compare(lib_fn(), want, dtype_name)[0]
        except (RuntimeError, TypeError) as exc:
            lib_fn, lib_name = None, (
                f"torch._grouped_mm failed ({str(exc).splitlines()[0][:100]})"
                f"; ")
    if lib_fn is None:
        prefix = "" if dtype != torch.bfloat16 else lib_name

        def lib_fn():
            return [torch.mm(x[o:o + n].t(), dz[o:o + n])
                    for o, n in segs if n]
        lib_name = prefix + "a per-expert loop of torch.mm"
        lib_err = compare(torch.stack(lib_fn()), torch.stack(
            [want[e] for e, (_, n) in enumerate(segs) if n]),
            dtype_name)[0]
    isz = x.element_size()
    nbytes = (x.numel() + dz.numel() + E * K * N) * isz
    bms, by = bound(nbytes, 2 * sum(counts) * K * N, dtype_name)
    return dict(
        err=err, rel=rel, ok=ok,
        shape=(f"{case}: x[{x.shape[0]},{K}] dz[{x.shape[0]},{N}] (bm {bm}, "
               f"counts {counts}) -> dw[{E},{K},{N}]"),
        note=f"library: {lib_name}, vs plain max abs err {lib_err:.3e}",
        ms=time_ms(kernel), plain_ms=time_ms(plain, iters=5),
        library_ms=time_ms(lib_fn), bound_ms=bms, bound_by=by)


#: the SGMV epilogue at the multi-LoRA serving step (phase 22's model:
#: hidden 1024, ffn 4096; rank 16 over 16 slots): (K, N, act) of each
#: projection.  The step's rows are its token budget (bf16: 256 + 7 x 16 =
#: 368, 23 blocks of 16; f32: 312, 39 blocks of 8).
LORA_CASES = {"qkv": (1024, 3072, "none"), "out": (1024, 1024, "none"),
              "fc1": (1024, 4096, "gelu_tanh"), "fc2": (4096, 1024, "none")}
LORA_RANK, LORA_SLOTS = 16, 16
#: the SGMV epilogue at the LoRA fine-tuning drive's shapes (phase 24:
#: B x S = `LORA_BWD_ROWS` rows, one adapter that owns every block; GPT's
#: MLP runs fc1 through the matmul epilogue there): (K, N, act)
LORA_TRAIN_CASES = {"train_qkv": (1024, 3072, "none"),
                    "train_out": (1024, 1024, "none"),
                    "train_fc2": (4096, 1024, "none")}


def lora_block_ids(nb, slots):
    """Per-block adapter slots of a mixed serving step: adapters 0, 3, 6
    and 9 in turn, a null block (``slots``) every third block; the other
    slots own no block."""
    return [slots if i % 3 == 2 else (0, 3, 6, 9)[i % 4] for i in range(nb)]


def check_lora(ops, case, dtype, dtype_name, gen, rows):
    """The SGMV epilogue at one of `LORA_CASES` (the serving step's mixed
    blocks over `LORA_SLOTS` slots) or `LORA_TRAIN_CASES` (one adapter
    owning every block, as fine-tuning's single-adapter path runs it)
    against its plain version (out; the saved sum against the plain
    version without activation, and equal to z on null rows).  No single
    PyTorch call computes it.  Bound: z read and out and s written for
    every row, x read for the adapter blocks' rows, the factors of the
    adapters in use."""
    import torch
    train = case in LORA_TRAIN_CASES
    K, N, act = (LORA_TRAIN_CASES if train else LORA_CASES)[case]
    bm = ops.ragged_q_block(dtype)
    nb = rows // bm
    r = ops.lora_rank_pad(LORA_RANK, dtype)
    slots = 1 if train else LORA_SLOTS
    aid = [0] * nb if train else lora_block_ids(nb, slots)
    gid = torch.tensor(aid, dtype=torch.int32, device="cuda")
    z = torch.randn(rows, N, device="cuda", generator=gen).to(dtype)
    x = torch.randn(rows, K, device="cuda", generator=gen).to(dtype)
    a = (0.05 * torch.randn(slots, K, r, device="cuda",
                            generator=gen)).to(dtype)
    b = (0.05 * torch.randn(slots, r, N, device="cuda",
                            generator=gen)).to(dtype)

    def kernel():
        return ops.fused_lora_segment_epilogue(z, x, a, b, gid, act)

    def plain(act=act):
        return ops.lora_segment_epilogue_ref(z, x, a, b, block_adapter=gid,
                                             act=act)
    (out, s), want, s_want = kernel(), plain(), plain("none")
    torch.cuda.synchronize()
    err, rel, ok = compare(out, want, dtype_name)
    s_err, _, s_ok = compare(s, s_want, dtype_name)
    null = (gid == slots).repeat_interleave(bm)
    ok = ok and s_ok and bool(torch.equal(s[null], z[null]))
    used = sorted(set(aid) - {slots})
    real_rows = (nb - aid.count(slots)) * bm
    isz = x.element_size()
    nbytes = (3 * rows * N + real_rows * K + len(used) * r * (K + N)) * isz
    bms, by = bound(nbytes, 2 * real_rows * r * (K + N), dtype_name)
    return dict(
        err=err, rel=rel, ok=ok,
        shape=(f"{case}: z[{rows},{N}] x[{rows},{K}] (bm {bm}, "
               f"{aid.count(slots)} of {nb} blocks null, adapters "
               f"{used} of {slots} slots) r {r} {act}"),
        note=(f"s vs plain max abs err {s_err:.3e}, null rows' s == z; "
              f"library: none, no single PyTorch call applies each row "
              f"block's own adapter"),
        ms=time_ms(kernel), plain_ms=time_ms(plain, iters=5),
        library_ms=None, bound_ms=bms, bound_by=by)


#: LoRA's backward at the fine-tuning drive's qkv (phase 24: B = 8,
#: S = 1024 rows, one adapter, hidden 1024 -> 3072, rank 16): the grouped
#: kernels over the adapter stacks, blocks of min_rows rows.  14a, as
#: (K, N, transposed): u = ds @ B^T ([8192, 3072] against B [1, 16, 3072]
#: read transposed: N = 16, under the 64-column tile), dx = u @ A^T
#: (K = 16) and the recomputed t = x @ A (A [1, 1024, 16] as stored:
#: N = 16); 14b: dA = x^T u ([1, 1024, 16]) and dB = t^T ds ([1, 16,
#: 3072]).
LORA_BWD_ROWS = 8192
LORA_BWD_CASES = {"lora_u": (3072, 16, True), "lora_dx": (16, 1024, True),
                  "lora_t": (1024, 16, False)}
LORA_DW_CASES = {"lora_dA": (1024, 16), "lora_dB": (16, 3072)}


def check_lora_grouped(ops, case, dtype, dtype_name, gen):
    """Row 14a at one of `LORA_BWD_CASES` (x [8192, K], w [1, N, K] read
    transposed, or w [1, K, N] as stored) against its plain version.
    Library yardstick: ``torch.mm`` of x and the one adapter's factor."""
    import torch
    K, N, trans = LORA_BWD_CASES[case]
    R = LORA_BWD_ROWS
    bm = ops.ragged_q_block(dtype)
    gid = torch.zeros(R // bm, dtype=torch.int32, device="cuda")
    x = torch.randn(R, K, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(1, *((N, K) if trans else (K, N)), device="cuda",
                     generator=gen) / K ** 0.5).to(dtype)

    def kernel():
        return ops.fused_grouped_linear_act(x, w, None, gid, "none",
                                            transpose_w=trans)
    wk = w.transpose(1, 2) if trans else w      # [1, K, N]

    def plain():
        return ops.grouped_linear_act_ref(x, wk, None, block_group=gid)

    def lib_fn():
        return torch.mm(x, wk[0])
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err, rel, ok = compare(got, want, dtype_name)
    lib_err = compare(lib_fn(), want, dtype_name)[0]
    isz = x.element_size()
    bms, by = bound((R * K + N * K + R * N) * isz, 2 * R * K * N,
                    dtype_name)
    return dict(
        err=err, rel=rel, ok=ok,
        shape=(f"{case}: x[{R},{K}] (bm {bm}, one adapter) "
               f"w[1,{w.shape[1]},{w.shape[2]}]"
               + (" read transposed" if trans else "")),
        note=f"library: torch.mm, vs plain max abs err {lib_err:.3e}",
        ms=time_ms(kernel), plain_ms=time_ms(plain, iters=5),
        library_ms=time_ms(lib_fn), bound_ms=bms, bound_by=by)


def check_lora_dw(ops, case, dtype, dtype_name, gen):
    """Row 14b at one of `LORA_DW_CASES` (x [8192, K], dz [8192, N], one
    adapter) against its plain version, as a column sum (`SUM_TOL`).
    Library yardstick: ``torch.mm(x^T, dz)``."""
    import torch
    K, N = LORA_DW_CASES[case]
    R = LORA_BWD_ROWS
    bm = ops.ragged_q_block(dtype)
    gid = torch.zeros(R // bm, dtype=torch.int32, device="cuda")
    x = torch.randn(R, K, device="cuda", generator=gen).to(dtype)
    dz = torch.randn(R, N, device="cuda", generator=gen).to(dtype)

    def kernel():
        return ops.fused_grouped_dw(x, dz, gid, 1)

    def plain():
        return ops.grouped_dw_ref(x, dz, gid, 1)

    def lib_fn():
        return torch.mm(x.t(), dz)
    got, want = kernel(), plain()
    abs_sum = ops.grouped_dw_ref(x.abs(), dz.abs(), gid, 1).float()
    torch.cuda.synchronize()
    err, ok, _ = compare_sum(got, want, abs_sum, dtype_name)
    rel = compare(got, want, dtype_name)[1]
    lib_err = compare(lib_fn(), want[0], dtype_name)[0]
    isz = x.element_size()
    bms, by = bound((R * K + R * N + K * N) * isz, 2 * R * K * N,
                    dtype_name)
    return dict(
        err=err, rel=rel, ok=ok,
        shape=(f"{case}: x[{R},{K}] dz[{R},{N}] (bm {bm}, one adapter) -> "
               f"dw[1,{K},{N}]"),
        note=f"library: torch.mm, vs plain max abs err {lib_err:.3e}",
        ms=time_ms(kernel), plain_ms=time_ms(plain, iters=5),
        library_ms=time_ms(lib_fn), bound_ms=bms, bound_by=by)


#: paged decode attention at phase 25's decode step (GPT_1P3B: 16 heads of
#: 128, block 16): 4 sequences at contexts 129-192 plus one at context 0,
#: tables 16 wide (padding entries point at block 0)
PAGED_CTX, PAGED_H, PAGED_D, PAGED_BS, PAGED_W = (129, 150, 171, 192, 0), \
    16, 128, 16, 16


def check_paged(ops, dtype, dtype_name, gen):
    """Paged decode attention against its plain version; bf16 also against
    the plain version run in f32 (`RAGGED_BF16_F32P_TOL`: the kernel keeps
    the probabilities in f32).  No single PyTorch call gathers the pages
    and attends.  Bound: q and the visible keys' rows of K and V read
    (not the rest of their last pages: the kernel reads only the rows
    below the context length), the output written; 4 operations per
    visible key element."""
    import torch
    B, H, D, bs, W = len(PAGED_CTX), PAGED_H, PAGED_D, PAGED_BS, PAGED_W
    pages = [-(-c // bs) for c in PAGED_CTX]
    nb = sum(pages) + 1
    q = torch.randn(B, 1, H, D, device="cuda", generator=gen).to(dtype)
    k = torch.randn(nb, H, bs, D, device="cuda", generator=gen).to(dtype)
    v = torch.randn(nb, H, bs, D, device="cuda", generator=gen).to(dtype)
    perm = torch.randperm(nb - 1, device="cuda", generator=gen) + 1
    tables = torch.zeros(B, W, dtype=torch.int32, device="cuda")
    used = 0
    for i, n in enumerate(pages):
        tables[i, :n] = perm[used:used + n]
        used += n
    ctx = torch.tensor(PAGED_CTX, dtype=torch.int32, device="cuda")

    def kernel():
        return ops.paged_attention(q, k, v, tables, ctx)

    def plain():
        return ops.paged_attention_ref(q, k, v, tables, ctx)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err, rel, ok = compare(got, want, dtype_name)
    ok = ok and not bool(got[PAGED_CTX.index(0)].any())
    note = ""
    if dtype == torch.bfloat16:
        w32 = ops.paged_attention_ref(q.float(), k.float(), v.float(),
                                      tables, ctx)
        a, r_ = RAGGED_BF16_F32P_TOL
        rms = float(w32.pow(2).mean().sqrt())
        e32 = float((got.float() - w32).abs().max())
        ok = ok and bool(((got.float() - w32).abs()
                          <= a * rms + r_ * w32.abs()).all())
        note = f"vs plain in f32 max abs err {e32:.3e}; "
    isz = q.element_size()
    nbytes = (2 * B * H * D + 2 * sum(PAGED_CTX) * H * D) * isz
    bms, by = bound(nbytes, 4 * sum(PAGED_CTX) * H * D, dtype_name)
    return dict(
        err=err, rel=rel, ok=ok,
        shape=(f"q[{B},1,{H},{D}] pools[{nb},{H},{bs},{D}] contexts "
               f"{list(PAGED_CTX)} tables [{B},{W}]"),
        note=note + "library: none, no single PyTorch call gathers the "
                    "pages and attends",
        ms=time_ms(kernel), plain_ms=time_ms(plain, iters=5),
        library_ms=None, bound_ms=bms, bound_by=by)


#: every kernel: its source, the TPU kernel it replaces, and its launches
#: per step of each drive as (per layer, per step once); a kernel a drive
#: does not run launches 0 times there.  serve_int8: the serving drive
#: with int8 weights (qkv, out, fc1 with gelu_tanh, fc2: four int8
#: epilogues a layer) and an int8 pool.  ``main`` names the drive whose
#: launches the kernels line reports, where it is not the serving drive
#: or the composite training drive.  The LLaMA drives: llama_train (two
#: RMS norms and one attention a layer, every layer's forward run twice
#: by recompute, the final norm and the loss once) and llama_gen (one
#: forward of generate()).  The BERT drives: bert_train (dropout on:
#: attention takes the composite, no flash kernel; per layer two fused
#: residual layer norms, fc1's epilogue; once the embeddings' and the MLM
#: head's layer norms, the MLM transform's epilogue and the loss),
#: bert_parity (the same at dropout 0: the flash kernels, not causal) and
#: ernie_eval (one forward of ErnieForSequenceClassification in eval: no
#: MLM head, the pooler and classifier are cuBLAS GEMMs).  The MoE drives:
#: serve_moe (per layer two layer norms, one attention and the two grouped
#: expert GEMMs; no fc1 epilogue) and moe_train (the composite attention;
#: per layer the two grouped GEMMs forward and their two dx through the
#: same forward kernel, and the two dw).  The LoRA drives: serve_lora (per
#: layer four SGMV epilogues, qkv, out, fc1 with its gelu and fc2; fc1's
#: GEMM is cuBLAS, so no matmul epilogue) and lora_train (convert_to_lora
#: with the base frozen, flash attention: GPT's MLP runs fc1 through the
#: matmul epilogue, so the SGMV epilogue runs 3 a layer; the backward of
#: each runs the grouped forward kernel for u, t and dx, but layer 0's qkv
#: needs no dx (its input is frozen), and the grouped dw for dA and dB;
#: layer 0's first layer norm needs no backward for the same reason).
#: paged_decode: one decode step of the paged view (per layer two layer
#: norms, fc1's epilogue and one paged attention)
KERNEL_INFO = {
    "ragged_attention": dict(
        source="paddle_tpu_torch/csrc/ragged_attention.cu",
        replaces="paddle_tpu/ops/pallas_ragged.py:115",
        serve=(1, 0), serve_moe=(1, 0), serve_lora=(1, 0)),
    "layer_norm": dict(
        source="paddle_tpu_torch/csrc/layer_norm.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:522",
        serve=(2, 1), train=(2, 1), train_flash=(4, 1), generate=(2, 1),
        serve_int8=(2, 1), bert_train=(0, 2), bert_parity=(0, 2),
        ernie_eval=(0, 1), serve_moe=(2, 1), moe_train=(2, 1),
        serve_lora=(2, 1), lora_train=(2, 1), paged_decode=(2, 1)),
    "matmul_epilogue": dict(
        source="paddle_tpu_torch/csrc/matmul_epilogue.cu",
        replaces="paddle_tpu/ops/pallas_fused.py:266",
        serve=(1, 0), train=(1, 0), train_flash=(2, 0), generate=(1, 0),
        bert_train=(1, 1), bert_parity=(1, 1), ernie_eval=(1, 0),
        lora_train=(1, 0), paged_decode=(1, 0)),
    "layer_norm_bwd": dict(
        source="paddle_tpu_torch/csrc/layer_norm.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:536",
        train=(2, 1), train_flash=(2, 1), bert_train=(2, 2),
        bert_parity=(2, 2), moe_train=(2, 1), lora_train=(2, 0)),
    "matmul_epilogue_bwd": dict(
        source="paddle_tpu_torch/csrc/matmul_epilogue.cu",
        replaces="paddle_tpu/ops/pallas_fused.py:278",
        train=(1, 0), train_flash=(1, 0), bert_train=(1, 1),
        bert_parity=(1, 1), lora_train=(1, 0)),
    "softmax_xent_fwd": dict(
        source="paddle_tpu_torch/csrc/softmax_xent.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:759",
        train=(0, 1), train_flash=(0, 1), llama_train=(0, 1),
        bert_train=(0, 1), bert_parity=(0, 1), moe_train=(0, 1),
        lora_train=(0, 1)),
    "softmax_xent_bwd": dict(
        source="paddle_tpu_torch/csrc/softmax_xent.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:802",
        train=(0, 1), train_flash=(0, 1), llama_train=(0, 1),
        bert_train=(0, 1), bert_parity=(0, 1), moe_train=(0, 1),
        lora_train=(0, 1)),
    # train_flash recomputes every block's forward inside the backward,
    # so each forward kernel of a block launches twice per step
    "flash_attention_fwd": dict(
        source="paddle_tpu_torch/csrc/flash_attention.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:78",
        main="train_flash", train_flash=(2, 0), generate=(1, 0),
        llama_train=(2, 0), llama_gen=(1, 0), bert_parity=(1, 0),
        ernie_eval=(1, 0), lora_train=(1, 0)),
    "flash_attention_bwd_dq": dict(
        source="paddle_tpu_torch/csrc/flash_attention.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:128",
        main="train_flash", train_flash=(1, 0), llama_train=(1, 0),
        bert_parity=(1, 0), lora_train=(1, 0)),
    "flash_attention_bwd_dkv": dict(
        source="paddle_tpu_torch/csrc/flash_attention.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:170",
        main="train_flash", train_flash=(1, 0), llama_train=(1, 0),
        bert_parity=(1, 0), lora_train=(1, 0)),
    "rms_norm": dict(
        source="paddle_tpu_torch/csrc/rms_norm.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:648",
        main="llama_train", llama_train=(4, 1), llama_gen=(2, 1)),
    "rms_norm_bwd": dict(
        source="paddle_tpu_torch/csrc/rms_norm.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:658",
        main="llama_train", llama_train=(2, 1)),
    "ragged_attention_int8": dict(
        source="paddle_tpu_torch/csrc/ragged_attention.cu",
        replaces="paddle_tpu/ops/pallas_ragged.py:197",
        main="serve_int8", serve_int8=(1, 0)),
    "matmul_epilogue_int8": dict(
        source="paddle_tpu_torch/csrc/matmul_epilogue.cu",
        replaces="paddle_tpu/ops/pallas_fused.py:406",
        main="serve_int8", serve_int8=(4, 0)),
    "layer_norm_residual": dict(
        source="paddle_tpu_torch/csrc/layer_norm.cu",
        replaces="paddle_tpu/ops/pallas_fused.py:101",
        main="bert_train", bert_train=(2, 0), bert_parity=(2, 0),
        ernie_eval=(2, 0)),
    "grouped_matmul": dict(
        source="paddle_tpu_torch/csrc/grouped_matmul.cu",
        replaces="paddle_tpu/ops/pallas_grouped.py:85",
        main="serve_moe", serve_moe=(2, 0), moe_train=(4, 0),
        lora_train=(9, -1)),
    "grouped_matmul_dw": dict(
        source="paddle_tpu_torch/csrc/grouped_matmul.cu",
        replaces="paddle_tpu/ops/pallas_grouped.py:133",
        main="moe_train", moe_train=(2, 0), lora_train=(6, 0)),
    "lora_sgmv": dict(
        source="paddle_tpu_torch/csrc/lora_sgmv.cu",
        replaces="paddle_tpu/ops/pallas_grouped.py:355",
        main="serve_lora", serve_lora=(4, 0), lora_train=(3, 0)),
    "paged_attention": dict(
        source="paddle_tpu_torch/csrc/paged_attention.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:898",
        main="paged_decode", paged_decode=(1, 0)),
}


def per_step(drive, layers):
    """Launches per step of every kernel in one drive ("serve",
    "serve_int8", "serve_moe", "serve_lora", "train", "train_flash",
    "llama_train", "bert_train", "bert_parity", "moe_train", "lora_train",
    "paged_decode", or "generate", "llama_gen" and "ernie_eval", whose step
    is one forward)."""
    return {name: info[drive][0] * layers + info[drive][1]
            if drive in info else 0 for name, info in KERNEL_INFO.items()}


def check_counts(phase, counts, steps, layers, drive):
    want = per_step(drive, layers)
    say(f"  launches {counts}; per step {want}")
    for name, n in counts.items():
        if want[name] and n == 0:
            fail(f"{phase}: kernel {name} was never launched")
        if n != want[name] * steps:
            fail(f"{phase}: {name} launched {n} times in {steps} steps, "
                 f"expected {want[name]} per step")


def report(name, dtype_name, r):
    atol, rtol = TOL[dtype_name]
    lib = "n/a" if r["library_ms"] is None else "%.4f ms" % r["library_ms"]
    say(f"  {name:19s} {dtype_name:8s} {r['shape']}: max abs err "
        f"{r['err']:.3e} (max rel {r['rel']:.3e}; tolerance {atol:g} + "
        f"{rtol:g}*|plain|) kernel {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, library {lib}, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']})"
        + (f"; {r['note']}" if r.get("note") else ""))
    if not r["ok"]:
        fail(f"{name} {dtype_name}: kernel disagrees with its plain "
             f"version (max abs err {r['err']:.3e})")


def warm_up(ops):
    """One untimed launch of every kernel at a small shape, before the
    first timing, so that no timed kernel pays for the card's first use
    (the first kernel timed in one run read 2.7x slow).  Fails if a
    kernel did not launch."""
    import numpy as np
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    reset_launches(ops)
    x, g, b = rand(64, 256), rand(256), rand(256)
    _, mu, rstd = ops.fused_layer_norm(x, g, b)
    ops.fused_layer_norm_bwd(x, g, mu, rstd, x)
    ops.fused_layer_norm_residual(x, x, g, b)
    ops.fused_linear_act(x, rand(256, 128), rand(128), "gelu_tanh")
    ops.fused_linear_act_bwd(x, x, "gelu_tanh")
    labels = torch.arange(64, device="cuda")
    _, lse = ops.softmax_xent_fwd(x, labels)
    ops.softmax_xent_bwd(x, labels, lse, torch.ones(64, device="cuda"))
    _, rstd = ops.fused_rms_norm(x, g)
    ops.fused_rms_norm_bwd(x, g, rstd, x)
    q = rand(1, 64, 2, 64)
    _, lse = ops.fused_flash_attention_fwd(q, q, q, True)
    lse_s, delta = ops.flash_bwd_stats(q, q, lse)
    ops.fused_flash_attention_bwd_dq(q, q, q, q, lse_s, delta, True)
    ops.fused_flash_attention_bwd_dkv(q, q, q, q, lse_s, delta, True)
    block_q = ops.ragged_q_block(torch.float32)
    sid, qs, qv, _, _ = ops.ragged_segments([block_q], [block_q], block_q)
    ints = [torch.from_numpy(a).cuda() for a in
            (np.ones((1, 1), np.int32), np.asarray([block_q], np.int32),
             sid, qs, qv)]
    pool = rand(2, 2, 16, 64)
    ops.ragged_paged_attention(rand(block_q, 2, 64), pool, pool, *ints,
                               block_q=block_q)
    pool8, scales = quantize_pool(pool)
    ops.ragged_paged_attention(rand(block_q, 2, 64), pool8, pool8, *ints,
                               block_q=block_q, k_scales=scales,
                               v_scales=scales)
    ops.fused_linear_act_int8(x, torch.ones(256, 128, dtype=torch.int8,
                                            device="cuda"),
                              torch.ones(128, device="cuda"), rand(128),
                              "gelu_tanh")
    gid = torch.tensor([0, 1, 1, 2], dtype=torch.int32, device="cuda")
    ops.fused_grouped_linear_act(x, rand(2, 256, 128), rand(2, 128), gid,
                                 "gelu_tanh")
    ops.fused_grouped_dw(x, rand(64, 128), gid, 2)
    ops.fused_lora_segment_epilogue(rand(64, 128), x, rand(2, 256, 8),
                                    rand(2, 8, 128), gid, "gelu_tanh")
    ops.paged_attention(rand(1, 1, 2, 64), pool, pool, *ints[:2])
    torch.cuda.synchronize()
    idle = [name for name, n in launches(ops).items() if n != 1]
    if idle:
        fail(f"warm-up: kernels {idle} did not launch exactly once")
    reset_launches(ops)


def phase_kernels(ops, budgets):
    """Every kernel at the serving drive's shapes (keys (name, dtype); the
    int8 serving kernels too, from a generator of their own so that the
    other rows' inputs stay as they were), at the training drive's (keys
    (name, dtype, "train"); the fused residual layer norm at the BERT
    training drive's) and, for flash attention and RMS norm, at each of
    `FLASH_SHAPES` and `RMS_SHAPES` (keys (name, dtype, shape)); the
    grouped-expert kernels at each of `GROUPED_CASES` (keys
    ("grouped_matmul", dtype) for the serving case, else (name, dtype,
    case)), from a generator of their own; the LoRA SGMV epilogue at each
    of `LORA_CASES` and `LORA_TRAIN_CASES` (keys ("lora_sgmv", dtype) for
    qkv, else ("lora_sgmv", dtype, case)), the grouped kernels at LoRA's backward shapes (keys
    (name, dtype, case) of `LORA_BWD_CASES` and `LORA_DW_CASES`) and
    paged decode attention (key ("paged_attention", dtype)), from a
    generator of their own."""
    import torch
    warm_up(ops)
    serve = {"ragged_attention": check_ragged,
             "layer_norm": check_layer_norm,
             "matmul_epilogue": check_matmul_epilogue}
    train = {"layer_norm": (check_layer_norm, TRAIN_ROWS),
             "matmul_epilogue": (check_matmul_epilogue, TRAIN_ROWS),
             "layer_norm_bwd": (check_layer_norm_bwd, TRAIN_ROWS),
             "matmul_epilogue_bwd": (check_matmul_epilogue_bwd, TRAIN_ROWS),
             "softmax_xent_fwd": (check_softmax_xent_fwd, XENT_ROWS),
             "softmax_xent_bwd": (check_softmax_xent_bwd, XENT_ROWS),
             "layer_norm_residual": (check_layer_norm_residual, BERT_ROWS)}
    serve_int8 = {"ragged_attention_int8": check_ragged_int8,
                  "matmul_epilogue_int8": check_matmul_epilogue_int8}
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    gen8 = torch.Generator(device="cuda").manual_seed(SEED + 8)
    gen_moe = torch.Generator(device="cuda").manual_seed(SEED + 17)
    gen_lora = torch.Generator(device="cuda").manual_seed(SEED + 21)
    for dtype, dtype_name in ((torch.bfloat16, "bfloat16"),
                              (torch.float32, "float32")):
        block_q = ops.ragged_q_block(dtype)
        for name, check in serve.items():
            arg = block_q if name == "ragged_attention" \
                else budgets[dtype_name]
            r = check(ops, arg, dtype, dtype_name, gen)
            report(name, dtype_name, r)
            results[(name, dtype_name)] = r
        for name, (check, rows) in train.items():
            r = check(ops, rows, dtype, dtype_name, gen)
            report(name, dtype_name, r)
            results[(name, dtype_name, "train")] = r
            torch.cuda.empty_cache()
        for shape_key in FLASH_SHAPES:
            for name, r in check_flash(ops, shape_key, dtype, dtype_name,
                                       gen).items():
                report(name, dtype_name, r)
                results[(name, dtype_name, shape_key)] = r
            torch.cuda.empty_cache()
        for shape_key in RMS_SHAPES:
            for name, check in (("rms_norm", check_rms_norm),
                                ("rms_norm_bwd", check_rms_norm_bwd)):
                r = check(ops, shape_key, dtype, dtype_name, gen)
                report(name, dtype_name, r)
                results[(name, dtype_name, shape_key)] = r
            torch.cuda.empty_cache()
        for name, check in serve_int8.items():
            arg = block_q if name == "ragged_attention_int8" \
                else budgets[dtype_name]
            r = check(ops, arg, dtype, dtype_name, gen8)
            twin = results[(name.removesuffix("_int8"), dtype_name)]
            r["note"] = "; ".join(filter(None, (
                r["note"], f"the float kernel at this shape "
                           f"{twin['ms']:.4f} ms")))
            report(name, dtype_name, r)
            results[(name, dtype_name)] = r
        torch.cuda.empty_cache()
        for case in GROUPED_CASES:
            r = check_grouped(ops, case, dtype, dtype_name, gen_moe)
            report("grouped_matmul", dtype_name, r)
            key = () if case == "serve" else (case,)
            results[("grouped_matmul", dtype_name) + key] = r
            torch.cuda.empty_cache()
        r = check_grouped_dw(ops, "train", dtype, dtype_name, gen_moe)
        report("grouped_matmul_dw", dtype_name, r)
        results[("grouped_matmul_dw", dtype_name, "train")] = r
        torch.cuda.empty_cache()
        for case in (*LORA_CASES, *LORA_TRAIN_CASES):
            rows = LORA_BWD_ROWS if case in LORA_TRAIN_CASES \
                else budgets[dtype_name]
            r = check_lora(ops, case, dtype, dtype_name, gen_lora, rows)
            report("lora_sgmv", dtype_name, r)
            key = () if case == "qkv" else (case,)
            results[("lora_sgmv", dtype_name) + key] = r
        for case in LORA_BWD_CASES:
            r = check_lora_grouped(ops, case, dtype, dtype_name, gen_lora)
            report("grouped_matmul", dtype_name, r)
            results[("grouped_matmul", dtype_name, case)] = r
        for case in LORA_DW_CASES:
            r = check_lora_dw(ops, case, dtype, dtype_name, gen_lora)
            report("grouped_matmul_dw", dtype_name, r)
            results[("grouped_matmul_dw", dtype_name, case)] = r
        r = check_paged(ops, dtype, dtype_name, gen_lora)
        report("paged_attention", dtype_name, r)
        results[("paged_attention", dtype_name)] = r
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------
# phase 3: CUDA vs CPU parity at full width, 2 layers, f32
# ---------------------------------------------------------------------
def numpy_weights(model, seed):
    """Weights for every parameter, drawn with numpy: the reference's
    initialisers (Xavier-normal Linear weights, N(0, 1) embeddings) and
    small random biases and norm weights (1 + 0.1 N); the model's own
    persistent buffers (LLaMA's rope tables) as they are."""
    import numpy as np
    rng = np.random.default_rng(seed)
    params = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name.endswith(("wte.weight", "wpe.weight", "embed_tokens.weight",
                          "embeddings.weight")):
            a = rng.standard_normal(shape, np.float32)
        elif ("ln_" in name and name.endswith("weight")) \
                or name.endswith(("norm.weight", ".ln.weight", ".ln1.weight",
                                  ".ln2.weight")):
            a = 1 + 0.1 * rng.standard_normal(shape, np.float32)
        elif len(shape) == 2:
            std = (2.0 / (shape[0] + shape[1])) ** 0.5
            a = std * rng.standard_normal(shape, np.float32)
        else:
            a = 0.02 * rng.standard_normal(shape, np.float32)
        params[name] = a
    for name, t in model.state_dict().items():
        if name not in params:
            params[name] = t.float().cpu().numpy()
    return params


def reset_launches(ops):
    for fn in ops.KERNELS.values():
        fn.launches = 0


def launches(ops):
    return {name: fn.launches for name, fn in ops.KERNELS.items()}


def phase_parity(pt, ops, int8=False):
    """The engine on the card and on the CPU, same weights and prompts:
    identical greedy tokens.  With ``int8``: int8 weights and an int8 KV
    pool on both sides; a token that differs is reported with the number
    of KV codes that differ between the two pools (a code can flip on a
    rounding boundary when f32 sums are taken in another order)."""
    import numpy as np
    import torch
    phase = "int8 parity" if int8 else "parity"
    cfg = pt.GPTConfig(**dict(pt.GPT_1P3B, num_hidden_layers=2))
    rng = np.random.default_rng(SEED + 1)
    shared = list(rng.integers(1, cfg.vocab_size, size=48))
    prompts = [shared + list(rng.integers(1, cfg.vocab_size, size=n))
               for n in (5, 9, 12, 7)]
    kw = dict(max_batch=4, prefill_chunk=64, max_model_len=256,
              num_blocks=128)
    if int8:
        kw.update(weight_dtype="int8", kv_cache_dtype="int8")
    outs, pools = {}, {}
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
            counts, steps = launches(ops), eng.stats()["steps"]
        say(f"  {device}: {eng.stats()['steps']} steps in "
            f"{time.perf_counter() - t0:.2f} s, prefix hit rate "
            f"{eng.stats()['prefix_hit_rate']:.3f}")
        if int8:
            pools[device] = [t.cpu() for layer in range(
                cfg.num_hidden_layers) for t in eng.cache.layer_pools(layer)]
        del eng, model
        torch.cuda.empty_cache()
    if int8:
        flips = sum(int((a != b).sum()) for a, b in zip(pools["cuda"],
                                                      pools["cpu"]))
        say(f"  KV codes that differ between card and CPU: {flips} of "
            f"{sum(a.numel() for a in pools['cuda'])}")
    if outs["cuda"] != outs["cpu"]:
        fail(f"{phase}: CUDA tokens {outs['cuda']} != CPU tokens "
             f"{outs['cpu']}")
    if not all(len(o) == len(p) + 16 for o, p in zip(outs["cuda"], prompts)):
        fail(f"{phase}: a request did not return 16 tokens")
    say(f"  greedy tokens identical on CUDA and CPU for {len(prompts)} "
        f"requests x 16 tokens")
    check_counts(phase, counts, steps, cfg.num_hidden_layers,
                 "serve_int8" if int8 else "serve")


# ---------------------------------------------------------------------
# phase 4: the serving drive
# ---------------------------------------------------------------------
def state_gib(model):
    """GiB of the model's parameters and persistent buffers."""
    return sum(t.numel() * t.element_size()
               for t in model.state_dict().values()) / 2 ** 30


INT8_COSINE_MIN = 0.99      # the reference's weight-only gate
INT8_BLOCK_RATIO_MIN = 1.8  # bytes per block, bf16 pool over int8 pool


def int8_prefill_gate(pt, model, prompt):
    """Convert ``model`` to int8 weights in place and gate the logits of
    one full-width prefill of ``prompt`` against the bf16 weights':
    ``logits_cosine`` >= `INT8_COSINE_MIN`."""
    import torch
    ids = torch.tensor([prompt], device="cuda")
    with torch.no_grad():
        want = model(ids).float()
        report = pt.quantization.convert_to_int8(model)
        free_device_memory()
        got = model(ids).float()
    cos = pt.quantization.logits_cosine(got, want)
    say(f"  int8 weights: {len(report)} degenerate-channel findings; "
        f"logits_cosine of a {len(prompt)}-token prefill vs bf16 weights "
        f"{cos:.6f} (gate >= {INT8_COSINE_MIN})")
    if not cos >= INT8_COSINE_MIN:
        fail(f"int8 serving: logits_cosine {cos:.6f} < {INT8_COSINE_MIN}")
    return cos


def time_int8_gemms(ops, model, rows):
    """The int8 epilogue at each of a serving step's four GEMMs (layer 0's
    converted qkv, out, fc1 with gelu_tanh, fc2; x [rows, K] bf16) beside
    what phase 4 runs there: the float epilogue kernel for fc1, a cuBLAS
    GEMM plus the bias for the other three (weights dequantized to
    bf16).  Times in ms, L2 flushed."""
    import torch
    blk = model.gpt.h[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    out = {}
    for name, lin, act in (("qkv", blk.attn.qkv_proj, "none"),
                           ("out", blk.attn.out_proj, "none"),
                           ("fc1", blk.mlp.fc1, "gelu_tanh"),
                           ("fc2", blk.mlp.fc2, "none")):
        K, N = lin.weight_q.shape
        x = torch.randn(rows, K, device="cuda", generator=gen).to(
            torch.bfloat16)
        w = (lin.weight_q.float() * lin.weight_scale).to(torch.bfloat16)
        args = (x, lin.weight_q, lin.weight_scale, lin.bias, act)
        t8 = time_ms(lambda: ops.fused_linear_act_int8(*args))
        if name == "fc1":
            tf = time_ms(lambda: ops.fused_linear_act(x, w, lin.bias, act))
        else:
            tf = time_ms(lambda: torch.matmul(x, w) + lin.bias)
        out[name] = dict(shape=f"{rows}x{K}x{N}", int8_ms=t8,
                         phase4_ms=tf)
    say("  int8 epilogue per GEMM of a step (ms, L2 flushed) against what "
        "phase 4 runs there (fc1: the float epilogue; qkv, out, fc2: cuBLAS "
        "+ bias): " + "; ".join(f"{k} {v['shape']} {v['int8_ms']:.4f} vs "
                                f"{v['phase4_ms']:.4f}"
                                for k, v in out.items()))
    return out


def phase_serving(pt, ops, int8=False, base=None, moe=False):
    """GPT_1P3B in bf16 served by the engine (phase 4).  With ``int8``
    (phase 13) the same weights and trace with int8 weights and an int8
    KV pool, held against ``base``, phase 4's summary.  With ``moe``
    (phase 18) MoE-GPT at GPT_1P3B's width (E = 4, top 2) on the same
    trace, with each step's per-expert counts and their imbalance, beside
    ``base``.  Returns (launch counts, summary, the generated tokens of
    each request)."""
    import numpy as np
    import torch
    phase = "moe serving" if moe else "int8 serving" if int8 else "serving"
    drive = "serve_moe" if moe else "serve_int8" if int8 else "serve"
    torch.cuda.reset_peak_memory_stats()
    if moe:
        cfg = moe_serve_cfg(pt)
        model = pt.MoEGPTForCausalLM(cfg, dtype=torch.bfloat16, seed=SEED)
    else:
        cfg = pt.GPTConfig(**pt.GPT_1P3B)
        model = pt.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=SEED)
    rng = np.random.default_rng(SEED)
    shared = list(rng.integers(1, cfg.vocab_size, size=512))
    prompts = [shared + list(rng.integers(
        1, cfg.vocab_size, size=int(rng.integers(4, 64))))
        for _ in range(16)]
    warm = [list(rng.integers(1, cfg.vocab_size, size=40))
            for _ in range(2)]
    summary = dict(weight_gib_bf16=state_gib(model))
    kw = {}
    if int8:
        summary["logits_cosine"] = int8_prefill_gate(pt, model, prompts[0])
        kw = dict(weight_dtype="int8", kv_cache_dtype="int8")
    eng = pt.GenerationEngine(model, max_batch=8, prefill_chunk=256,
                              max_model_len=cfg.max_position_embeddings,
                              **kw)
    summary.update(weight_gib=state_gib(model),
                   kv_blocks=eng.cache.num_blocks - 1,
                   bytes_per_block=eng.cache.bytes_per_block,
                   kv_dtype=eng.stats()["kv_dtype"])
    eng.generate(warm, max_new_tokens=4)        # first-use costs
    torch.cuda.synchronize()
    hit0, look0 = eng.cache._hit_tokens, eng.cache._lookup_tokens
    steps0, toks0 = eng.stats()["steps"], eng.stats()["tokens_generated"]

    routed = []         # each MoE layer's per-expert counts, per forward
    hooks = [blk.mlp.register_forward_hook(
        lambda mod, inp, out: routed.append(mod.counts))
        for blk in model.gpt.h] if moe else []
    reset_launches(ops)
    t0 = time.perf_counter()
    ids = [eng.add_request(p, max_new_tokens=64) for p in prompts]
    while eng.has_unfinished():
        eng.step()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = launches(ops)
    for h in hooks:
        h.remove()

    reqs = [eng._results[i] for i in ids]
    if not all(len(r.generated) == 64 for r in reqs):
        fail(f"{phase}: generated lengths "
             f"{[len(r.generated) for r in reqs]}, expected 64 each")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated):
        fail(f"{phase}: a token outside the vocabulary")
    steps = eng.stats()["steps"] - steps0
    tokens = eng.stats()["tokens_generated"] - toks0
    ttft = sorted((r.t_first_token - r.t_submit) * 1e3 for r in reqs)
    hit = (eng.cache._hit_tokens - hit0) / max(
        1, eng.cache._lookup_tokens - look0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"  {len(prompts)} requests, {tokens} tokens in {elapsed:.3f} s: "
        f"{tokens / elapsed:.1f} tokens/s, median TTFT "
        f"{ttft[len(ttft) // 2]:.1f} ms, prefix hit rate {hit:.3f}, "
        f"{steps} steps ({elapsed / steps * 1e3:.2f} ms/step), "
        f"peak memory {peak:.2f} GiB")
    say(f"  weights {summary['weight_gib']:.3f} GiB (bf16: "
        f"{summary['weight_gib_bf16']:.3f}); {summary['kv_dtype']} KV pool "
        f"of {summary['kv_blocks']} blocks x {summary['bytes_per_block']} "
        f"bytes at hbm_fraction 0.3")
    check_counts(phase, counts, steps, cfg.num_hidden_layers, drive)
    generated = [list(r.generated) for r in reqs]
    summary.update(tokens_per_s=tokens / elapsed,
                   median_ttft_ms=ttft[len(ttft) // 2],
                   prefix_hit_rate=hit, steps=steps, elapsed_s=elapsed,
                   ms_per_step=elapsed / steps * 1e3, peak_memory_gib=peak)
    if int8:
        ratio = base["bytes_per_block"] / summary["bytes_per_block"]
        match = pt.quantization.greedy_match_ratio(base["generated"],
                                                   generated)
        summary.update(bytes_per_block_ratio=ratio,
                       kv_blocks_ratio=summary["kv_blocks"]
                       / base["kv_blocks"],
                       greedy_match_ratio=match)
        say(f"  against phase 4 (bf16): bytes per block {ratio:.4f}x "
            f"fewer (gate >= {INT8_BLOCK_RATIO_MIN}), KV blocks "
            f"{summary['kv_blocks']} vs {base['kv_blocks']} "
            f"({summary['kv_blocks_ratio']:.3f}x), weights "
            f"{summary['weight_gib']:.3f} vs {base['weight_gib']:.3f} GiB, "
            f"tokens/s {summary['tokens_per_s']:.1f} vs "
            f"{base['tokens_per_s']:.1f}, greedy match ratio {match:.4f} "
            f"(reported, not gated)")
        if not ratio >= INT8_BLOCK_RATIO_MIN:
            fail(f"{phase}: bytes per block only {ratio:.4f}x fewer than "
                 f"the bf16 pool's")
    if moe:
        summary["routing"] = routing_summary(
            ops, routed, cfg.num_hidden_layers, steps)
        say(f"  against phase 4 (dense GPT_1P3B, bf16, same trace): "
            f"tokens/s {summary['tokens_per_s']:.1f} vs "
            f"{base['tokens_per_s']:.1f}, ms/step "
            f"{summary['ms_per_step']:.2f} vs {base['ms_per_step']:.2f}, "
            f"median TTFT {summary['median_ttft_ms']:.1f} vs "
            f"{base['median_ttft_ms']:.1f} ms, peak memory "
            f"{summary['peak_memory_gib']:.2f} vs "
            f"{base['peak_memory_gib']:.2f} GiB, weights "
            f"{summary['weight_gib']:.3f} vs {base['weight_gib']:.3f} GiB")
    steps0 = eng.stats()["steps"]
    prof = profile_device(lambda: eng.generate(prompts[:8],
                                               max_new_tokens=16))
    summary["profile"] = split_profile(prof, eng.stats()["steps"] - steps0,
                                       "burst")
    if int8:
        with torch.no_grad():
            summary["gemms"] = time_int8_gemms(ops, model, eng.token_budget)
    return counts, summary, generated


def routing_summary(ops, routed, layers, steps):
    """Per-step expert counts of a serving drive (``routed``: each MoE
    layer's counts per forward, in order) and their ``expert_imbalance``
    (max / mean over the experts) per layer and step: mean and max, and
    layer 0's counts at the first and the last step."""
    import torch
    from paddle_tpu_torch.distributed.auto_parallel import moe_dispatch
    c = torch.stack(routed).cpu().reshape(-1, layers, routed[0].shape[0])
    if c.shape[0] != steps:
        fail(f"moe serving: {c.shape[0]} routed forwards in {steps} steps")
    imb = torch.stack([moe_dispatch.expert_imbalance(row)
                       for row in c.reshape(-1, c.shape[-1])])
    out = dict(imbalance_mean=float(imb.mean()),
               imbalance_max=float(imb.max()),
               layer0_first_step=c[0, 0].tolist(),
               layer0_last_step=c[-1, 0].tolist(),
               assignments_per_step=int(c[0, 0].sum()))
    say(f"  routing: {c.shape[0]} steps x {layers} layers, expert "
        f"imbalance (max / mean count) mean {out['imbalance_mean']:.3f}, "
        f"max {out['imbalance_max']:.3f}; layer 0 counts at the first step "
        f"{out['layer0_first_step']}, at the last {out['layer0_last_step']} "
        f"({out['assignments_per_step']} assignments a step, padding rows "
        f"included)")
    return out


#: device-time groups of the profile, by kernel-name substring (first
#: match wins: the int8 kernels' instantiations, whose pool or weight type
#: is int8_t, "signed char", come before their float twins); column_sum
#: is the second pass of both backward kernels' column sums, and
#: splitk_epilogue the second pass of a split-K matmul epilogue (int8 or
#: float: its instantiations do not say which)
_PROFILE_GROUPS = (("lora_sgmv", "lora_sgmv_kernel"),
                   ("paged_attention", "paged_attn_kernel"),
                   ("grouped_matmul", "gmm_fwd_"),
                   ("grouped_matmul_dw", "gmm_dw_"),
                   ("ragged_attention_int8",
                    ("ragged_attn_kernel<float, signed char>",
                     "ragged_attn_kernel<__nv_bfloat16, signed char>")),
                   ("matmul_epilogue_int8",
                    ("me_fwd_wmma_bf16<signed char",
                     "me_fwd_fma<float, signed char",
                     "me_fwd_fma<__nv_bfloat16, signed char")),
                   ("ragged_attention", "ragged_attn_kernel"),
                   ("layer_norm_residual", "layer_norm_residual_fwd_kernel"),
                   ("layer_norm", "layer_norm_fwd_kernel"),
                   ("layer_norm_bwd", "layer_norm_bwd_kernel"),
                   ("matmul_epilogue", "me_fwd_"),
                   ("matmul_epilogue_bwd", "me_bwd_kernel"),
                   ("column_sum", "column_sum_kernel"),
                   ("splitk_epilogue", "splitk_epilogue_kernel"),
                   ("softmax_xent_fwd", "xent_fwd_kernel"),
                   ("softmax_xent_bwd", "xent_bwd_kernel"),
                   ("flash_attention_fwd", "flash_fwd_kernel"),
                   ("flash_attention_bwd_dq", "flash_bwd_dq_kernel"),
                   ("flash_attention_bwd_dkv", "flash_bwd_dkv_kernel"),
                   ("rms_norm", "rms_norm_fwd_kernel"),
                   ("rms_norm_bwd", "rms_norm_bwd_kernel"),
                   ("cublas_gemm", ("gemm", "xmma", "nvjet", "cutlass",
                                    "cublas")),
                   ("softmax", ("softmax", "SoftMax")))


def profile_device(fn):
    """Run ``fn`` under ``torch.profiler`` (CPU + CUDA) and synchronise;
    returns ``(profile, wall ms)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def split_profile(prof_wall, steps, what):
    """Device time by kernel group and the device's idle share over a
    profiled window of ``steps`` steps.  The profiler's own overhead
    inflates the wall time, so the idle share is an upper bound."""
    from torch.autograd import DeviceType
    prof, wall_ms = prof_wall
    groups = {name: 0.0 for name, _ in _PROFILE_GROUPS}
    groups["other"] = 0.0
    others = []
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
            others.append((us / 1e3, name))
    busy_ms = sum(groups.values())
    if busy_ms == 0:
        say("  profile: the profiler saw no device time (not measured)")
        return None
    out = dict(steps=steps, wall_ms=wall_ms, device_busy_ms=busy_ms,
               device_idle_share=max(0.0, 1 - busy_ms / wall_ms),
               device_ms_per_step={k: v / steps for k, v in groups.items()},
               top_other_ms_per_step=[
                   (name[:80], ms / steps) for ms, name in
                   sorted(others, reverse=True)[:8]])
    say(f"  profiled {what}, {steps} steps: wall {wall_ms:.1f} ms, device "
        f"busy {busy_ms:.1f} ms (idle share "
        f"{out['device_idle_share']:.3f}); "
        f"device ms/step " + ", ".join(
            f"{k} {v / steps:.3f}" for k, v in groups.items()))
    say("  largest kernels in other (ms/step): " + "; ".join(
        f"{name} {ms:.3f}" for name, ms in out["top_other_ms_per_step"]))
    return out


# ---------------------------------------------------------------------
# phase 5: training parity, CUDA vs CPU at full width, 2 layers, f32
# ---------------------------------------------------------------------
#: CUDA (kernels, cuBLAS) vs CPU (plain versions, CPU GEMMs), both f32
#: with TF32 off, sums taken in other orders.  loss: relative.  grads:
#: each gradient's max |CUDA - CPU| against its largest |value| (a GEMM's
#: rounding is relative to its sum of |terms|, not to a small result).
#: params after 3 AdamW steps: atol + rtol * |p|, ROADMAP's f32 gate.
PARITY_LR = 1e-4
PARITY_TOL = dict(loss=1e-5, grad=1e-4, param=(1e-4, 1e-4))


def train_parity_run(pt, ops, make_model, loss_of, params, ids, labels,
                     device, clip=True, steps=3, track_small=False):
    """Losses, step-1 gradients and final parameters of ``steps`` AdamW
    steps (global-norm clip 1.0 with ``clip``) of ``make_model(device)``
    on ``device``, with ``loss_of(model, ids, labels)`` as the loss, the
    launch counts of the run, and (with ``track_small``) for each
    parameter the elements whose gradient was, at some step, within the
    gradient gate of 0 (at most ``PARITY_TOL["grad"]`` of that gradient's
    largest magnitude)."""
    import torch
    model = make_model(device)
    pt.load_reference_state(model, params)
    opt = pt.optimizer.AdamW(
        learning_rate=PARITY_LR, weight_decay=0.01,
        parameters=model.parameters(),
        grad_clip=pt.nn.ClipGradByGlobalNorm(1.0) if clip else None)
    x, y = (torch.from_numpy(a).to(device) for a in (ids, labels))
    reset_launches(ops)
    t0 = time.perf_counter()
    losses, grads, small = [], None, {}
    for step in range(steps):
        loss = loss_of(model, x, y)
        loss.backward()
        losses.append(float(loss.detach()))
        if step == 0:
            grads = {n: p.grad.detach().cpu().clone()
                     for n, p in model.named_parameters()
                     if p.grad is not None}
        for n, p in model.named_parameters() if track_small else ():
            if p.grad is None:
                continue
            g = p.grad.detach().abs()
            m = (g <= PARITY_TOL["grad"] * g.max()).cpu()
            small[n] = small[n] | m if n in small else m
        opt.step()
        opt.clear_grad()
    if device == "cuda":
        torch.cuda.synchronize()
    counts = launches(ops)
    say(f"  {device}: {steps} steps in {time.perf_counter() - t0:.2f} s, "
        f"losses {losses}")
    final = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    return losses, grads, final, counts, small


def phase_train_parity(pt, ops, flash=False):
    """Phase 5 (the composite) or, with ``flash``, phase 7: the same run
    with ``use_flash_attention=True, use_recompute=True``."""
    cfg = pt.GPTConfig(**dict(pt.GPT_1P3B, num_hidden_layers=2,
                              use_flash_attention=flash,
                              use_recompute=flash))
    crit = pt.GPTPretrainingCriterion()
    return train_parity(
        pt, ops, "training parity",
        lambda device: pt.GPTForCausalLM(cfg, device=device),
        lambda model, x, y: crit(model(x), y), cfg.vocab_size,
        cfg.num_hidden_layers, "train_flash" if flash else "train")


def train_parity(pt, ops, phase, make_model, loss_of, vocab, layers, drive,
                 clip=True, ignore_share=0.0, sign_free=False, frozen=None):
    """3 AdamW steps of ``make_model`` on the card and on the CPU from the
    same numpy weights and batch (B=2, S=128, a few labels at the ignore
    index, and about ``ignore_share`` of the rest): losses, step-1
    gradients and final parameters held to `PARITY_TOL`, and each kernel's
    launches to ``drive``'s per step.  The same parameters must get a
    gradient on both sides.  With ``sign_free`` the parameter elements
    whose gradient at some step lay within the gradient gate of 0 are held
    by `hold_sign_free` instead.  ``frozen`` (a predicate on parameter
    names) names parameters that must end bit-unchanged on both sides."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 3)
    ids = rng.integers(0, vocab, (2, 128))
    labels = ids.copy()
    labels[0, :3] = -100                       # the loss's ignore index
    if ignore_share:
        labels[rng.random(labels.shape) < ignore_share] = -100
    params = numpy_weights(make_model("cpu"), SEED + 2)
    runs = {}
    for device in ("cuda", "cpu"):
        runs[device] = train_parity_run(
            pt, ops, make_model, loss_of, params, ids, labels, device, clip,
            track_small=sign_free and device == "cpu")
        torch.cuda.empty_cache()
    (l_gpu, g_gpu, p_gpu, counts, _), (l_cpu, g_cpu, p_cpu, _, small) = \
        runs["cuda"], runs["cpu"]
    if set(g_gpu) != set(g_cpu):
        fail(f"{phase}: gradients of {sorted(set(g_gpu) ^ set(g_cpu))} on "
             f"one side only")
    if frozen is not None:
        names = [n for n in p_cpu if frozen(n)]
        changed = [n for n in names for side in (p_gpu, p_cpu)
                   if not torch.equal(side[n], torch.from_numpy(
                       params[n]).to(side[n].dtype))]
        if not names or changed:
            fail(f"{phase}: frozen parameters changed: {changed[:8]}")
        say(f"  {len(names)} frozen parameters bit-unchanged on both sides; "
            f"{len(g_cpu)} got a gradient")
    key_note = ""
    if sign_free:
        key_note = hold_sign_free(phase, small, p_gpu, p_cpu)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    grad_err, grad_at = max(
        (float((g_gpu[n] - g_cpu[n]).abs().max())
         / max(float(g_cpu[n].abs().max()), 1e-30), n) for n in g_cpu)
    atol, rtol = PARITY_TOL["param"]
    worst, worst_at = 0.0, ""
    for n in p_cpu:
        d = (p_gpu[n] - p_cpu[n]).abs()
        excess = float((d - rtol * p_cpu[n].abs()).max())
        if excess > worst:
            worst, worst_at = excess, n
    say(f"  loss max rel err {loss_err:.3e} (tolerance "
        f"{PARITY_TOL['loss']:g}); step-1 grads max err / max |grad| "
        f"{grad_err:.3e} at {grad_at} (tolerance {PARITY_TOL['grad']:g}); "
        f"params after 3 steps max (|err| - {rtol:g}*|p|) {worst:.3e} at "
        f"{worst_at or '-'} (tolerance {atol:g}){key_note}")
    if loss_err > PARITY_TOL["loss"]:
        fail(f"{phase}: losses {l_gpu} on CUDA vs {l_cpu} on CPU")
    if grad_err > PARITY_TOL["grad"]:
        fail(f"{phase}: gradient of {grad_at} differs by "
             f"{grad_err:.3e} of its largest value")
    if worst > atol:
        fail(f"{phase}: parameter {worst_at} differs after 3 "
             f"steps by {worst:.3e} past {rtol:g}*|p|")
    check_counts(phase, counts, 3, layers, drive)
    return dict(loss_max_rel_err=loss_err, grad_max_rel_err=grad_err,
                param_max_excess=worst, losses_cuda=l_gpu,
                losses_cpu=l_cpu)


def hold_sign_free(phase, small, p_gpu, p_cpu, steps=3):
    """AdamW moves each element by about lr times the sign of its
    gradient's running mean, whatever the gradient's size.  Where a
    gradient lies within the gradient gate of 0 (``small``: at most
    ``PARITY_TOL["grad"]`` of its tensor's largest, at some step on the
    CPU), its sign is not fixed by the gate, and the two devices may step
    such an element by up to lr in opposite directions: those elements
    are held to 2 * steps * lr, the most two such walks can differ, and
    taken out of the `PARITY_TOL` check (``p_gpu`` gets the CPU's values
    there).  Among them are the key slices of the qkv biases, whose
    gradient is 0 in exact arithmetic (softmax is invariant to a per-row
    constant)."""
    import torch
    bound = 2 * steps * PARITY_LR
    worst, count = 0.0, 0
    for n, m in small.items():
        if not bool(m.any()):
            continue
        d = float((p_gpu[n] - p_cpu[n]).abs()[m].max())
        if d > bound:
            fail(f"{phase}: {n} differs by {d:.3e} after {steps} steps where "
                 f"its gradient was ~0, past 2 * {steps} * lr")
        worst, count = max(worst, d), count + int(m.sum())
        p_gpu[n] = torch.where(m, p_cpu[n], p_gpu[n])
    return (f"; {count} elements whose gradient lay within the gate of 0 at "
            f"some step: max |err| {worst:.3e} (bound {bound:g})")


# ---------------------------------------------------------------------
# phase 6: the training drive
# ---------------------------------------------------------------------
TRAIN_S, TRAIN_WARMUP, TRAIN_STEPS = 1024, 2, 5
#: batch of the composite drive (phase 6) and of the flash + recompute
#: drive (phase 8, bench.py:655's first size)
TRAIN_B = {False: 4, True: 8}
PEAK_BF16 = PEAK_OPS_PER_S["bfloat16"]


def phase_training(pt, ops, flash=False):
    """Phase 6 (the composite, B=4) or, with ``flash``, phase 8
    (``use_flash_attention=True, use_recompute=True``, B=8)."""
    import numpy as np
    import torch
    B = TRAIN_B[flash]
    cfg = pt.GPTConfig(**dict(pt.GPT_1P3B, use_flash_attention=flash,
                              use_recompute=flash))
    L, H = cfg.num_hidden_layers, cfg.hidden_size
    model = pt.GPTForCausalLM(cfg, dtype=torch.float32, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    opt = pt.optimizer.AdamW(
        learning_rate=1e-4, weight_decay=0.01, parameters=model.parameters(),
        grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    crit = pt.GPTPretrainingCriterion()
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (B, TRAIN_S))).cuda()

    def step():
        with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
            loss = crit(model(ids), ids)       # bench_gpt feeds ids as labels
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    return drive_training(ops, step, n_params, B, L, H, "training",
                          "train_flash" if flash else "train")


def drive_training(ops, step, n_params, B, L, H, phase, drive, S=TRAIN_S):
    """`TRAIN_WARMUP` untimed calls of ``step`` (one training step that
    returns its loss), then `TRAIN_STEPS` timed ones at batch ``B`` of
    ``S`` tokens: ms/step, tokens/s, MFU (6N + 12LSH flops per token
    against the bf16 peak; none when ``n_params`` is None), peak memory;
    the losses must be finite and fall, each kernel's launches must equal
    ``drive``'s per step; one profiled step.  Returns (launch counts,
    summary)."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    losses = [step() for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches(ops)
    t0 = time.perf_counter()
    losses += [step() for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = launches(ops)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses]
    step_ms = elapsed / TRAIN_STEPS * 1e3
    tokens_per_s = B * S * TRAIN_STEPS / elapsed
    if n_params is None:
        mfu, mfu_note = None, "no MFU"
    else:
        flops_per_token = 6 * n_params + 12 * L * S * H
        mfu = flops_per_token * tokens_per_s / PEAK_BF16
        mfu_note = (f"{n_params / 1e6:.1f}M params, MFU {mfu:.4f} (6N + "
                    f"12LSH = {flops_per_token:.4e} flop/token vs "
                    f"{PEAK_BF16:.3g} flop/s)")
    say(f"  B={B} S={S}: warm-up {TRAIN_WARMUP} steps {warm_s:.2f} s; "
        f"{TRAIN_STEPS} steps in {elapsed:.3f} s: {step_ms:.2f} ms/step, "
        f"{tokens_per_s:.1f} tokens/s, {mfu_note}, peak memory "
        f"{peak_gib:.2f} GiB; losses {losses}")
    if not all(np.isfinite(losses)):
        fail(f"{phase}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{phase}: the loss did not fall on a repeated batch: "
             f"{losses}")
    check_counts(phase, counts, TRAIN_STEPS, L, drive)
    summary = dict(n_params=n_params, batch=B, seq=S,
                   steps=TRAIN_STEPS, step_ms=step_ms,
                   tokens_per_s=tokens_per_s, mfu=mfu,
                   peak_memory_gib=peak_gib, losses=losses)
    summary["profile"] = split_profile(profile_device(step), 1,
                                       "training step")
    return counts, summary


# ---------------------------------------------------------------------
# phase 9: dense-cache generate()
# ---------------------------------------------------------------------
GEN_PARITY_LENS = (37, 64, 95, 120)
GEN_PARITY_NEW = 16
GEN_B, GEN_PROMPT, GEN_NEW = 4, 128, 64


def phase_generate(pt, ops, keep=None):
    """``model.generate`` with the dense KV cache: a prefill forward, then
    one-token forwards whose attention is the flash kernel with one query
    row against the whole prefix.  (a) Full width, 2 layers, f32, prompts
    of uneven length left-padded (id 0) to one batch, 16 greedy tokens:
    the card's tokens must equal the CPU's, and each kernel must launch
    its launches per forward times the forwards.  (b) GPT_1P3B in bf16,
    4 prompts x 128 tokens, 64 greedy tokens: ms per decode step."""
    import torch
    cfg = pt.GPTConfig(**dict(pt.GPT_1P3B, num_hidden_layers=2))
    rng = generate_parity(
        pt, ops, "generate parity",
        lambda device: pt.GPTForCausalLM(cfg, device=device),
        cfg.vocab_size, cfg.num_hidden_layers, "generate")
    cfg = pt.GPTConfig(**pt.GPT_1P3B)
    model = pt.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=SEED).eval()
    return generate_drive(ops, model, rng, "GPT_1P3B", "generate",
                          "generate", keep)


def generate_parity(pt, ops, phase, make_model, vocab, layers, drive):
    """Greedy `generate()` of ``make_model(device)`` (eval mode, numpy
    weights) on the card and on the CPU: `GEN_PARITY_LENS` prompts
    left-padded (id 0) to one batch, `GEN_PARITY_NEW` new tokens, which
    must be identical; each kernel must launch ``drive``'s launches per
    forward times the forwards.  Returns the numpy generator the prompts
    came from, for the drive's prompts."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 4)
    width = max(GEN_PARITY_LENS)
    ids = np.zeros((len(GEN_PARITY_LENS), width), np.int64)
    for row, n in enumerate(GEN_PARITY_LENS):
        ids[row, width - n:] = rng.integers(1, vocab, size=n)
    params = numpy_weights(make_model("cpu"), SEED + 2)
    outs = {}
    for device in ("cuda", "cpu"):
        model = make_model(device).eval()
        pt.load_reference_state(model, params)
        reset_launches(ops)
        t0 = time.perf_counter()
        outs[device] = model.generate(torch.from_numpy(ids),
                                      max_new_tokens=GEN_PARITY_NEW).cpu()
        if device == "cuda":
            torch.cuda.synchronize()
            counts = launches(ops)
        say(f"  {device}: {GEN_PARITY_NEW} tokens in "
            f"{time.perf_counter() - t0:.2f} s")
        del model
        torch.cuda.empty_cache()
    if outs["cuda"].shape != (len(GEN_PARITY_LENS), width + GEN_PARITY_NEW):
        fail(f"{phase}: shape {tuple(outs['cuda'].shape)}")
    if not torch.equal(outs["cuda"], outs["cpu"]):
        fail(f"{phase}: CUDA tokens "
             f"{outs['cuda'][:, width:].tolist()} != CPU tokens "
             f"{outs['cpu'][:, width:].tolist()}")
    say(f"  greedy tokens identical on CUDA and CPU for "
        f"{len(GEN_PARITY_LENS)} prompts of {list(GEN_PARITY_LENS)} "
        f"tokens x {GEN_PARITY_NEW}")
    check_counts(phase, counts, GEN_PARITY_NEW, layers, drive)
    return rng


def generate_drive(ops, model, rng, what, phase, drive, keep=None):
    """Greedy `generate()` of ``model`` on the card, `GEN_B` prompts of
    `GEN_PROMPT` tokens drawn from ``rng``, `GEN_NEW` new tokens: prefill
    ms, ms per decode step, tokens/s and peak memory; each kernel must
    launch ``drive``'s launches per forward times the forwards.  The
    prompts and new tokens go into ``keep`` (a dict) when given.  Returns
    (launch counts, summary)."""
    import torch
    cfg = model.config
    prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                            (GEN_B, GEN_PROMPT)))

    def run(new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    run(2)                                  # first-use costs
    _, prefill_s = run(1)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(ops)
    out, total_s = run(GEN_NEW)
    counts = launches(ops)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    new = out[:, GEN_PROMPT:]
    if new.shape != (GEN_B, GEN_NEW) or not bool(
            ((new >= 0) & (new < cfg.vocab_size)).all()):
        fail(f"{phase}: new tokens of shape {tuple(new.shape)} or outside "
             f"the vocabulary")
    decode_ms = (total_s - prefill_s) / (GEN_NEW - 1) * 1e3
    if keep is not None:
        keep.update(prompts=prompts, tokens=new.cpu())
    say(f"  {what} bf16, {GEN_B} prompts x {GEN_PROMPT} tokens, "
        f"{GEN_NEW} greedy tokens in {total_s:.3f} s: prefill "
        f"{prefill_s * 1e3:.1f} ms, {decode_ms:.2f} ms per decode step, "
        f"{GEN_B * GEN_NEW / total_s:.1f} tokens/s, peak memory "
        f"{peak_gib:.2f} GiB")
    check_counts(phase, counts, GEN_NEW, cfg.num_hidden_layers, drive)
    return counts, dict(batch=GEN_B, prompt=GEN_PROMPT, new_tokens=GEN_NEW,
                        total_s=total_s, prefill_ms=prefill_s * 1e3,
                        decode_ms_per_step=decode_ms,
                        tokens_per_s=GEN_B * GEN_NEW / total_s,
                        peak_memory_gib=peak_gib)


# ---------------------------------------------------------------------
# phases 10-12: LLaMA
# ---------------------------------------------------------------------
#: bench.py:1081-1086's single-chip LLaMA (bench_llama): GQA 16 heads over
#: 8 kv heads of 64, SwiGLU width 2816, LLaMA-2's vocab
LLAMA_TRAIN_CFG = dict(vocab_size=32000, hidden_size=1024,
                       num_hidden_layers=16, num_attention_heads=16,
                       num_key_value_heads=8, intermediate_size=2816,
                       max_position_embeddings=1024, use_recompute=True)
LLAMA_TRAIN_B = 8


def phase_llama_train_parity(pt, ops):
    """Phase 10: `LLAMA_TRAIN_CFG` cut to 2 layers, f32, recompute, 3
    AdamW(1e-4) steps without a clip (the recipe has none), card vs CPU."""
    cfg = pt.LlamaConfig(**dict(LLAMA_TRAIN_CFG, num_hidden_layers=2))
    return train_parity(
        pt, ops, "llama training parity",
        lambda device: pt.LlamaForCausalLM(cfg, device=device),
        lambda model, x, y: model(x, y)[0], cfg.vocab_size,
        cfg.num_hidden_layers, "llama_train", clip=False)


def phase_llama_training(pt, ops):
    """Phase 11: bench_llama's recipe on the card, eager: 16 layers, f32
    master weights under auto_cast(bf16, O1), AdamW(1e-4), the model's own
    shifted cross-entropy, B=8, S=1024, one batch fed as ids and labels."""
    import numpy as np
    import torch
    cfg = pt.LlamaConfig(**LLAMA_TRAIN_CFG)
    model = pt.LlamaForCausalLM(cfg, dtype=torch.float32, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.parameters())
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (LLAMA_TRAIN_B, TRAIN_S))).cuda()

    def step():
        with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
            loss, _ = model(ids, ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    return drive_training(ops, step, n_params, LLAMA_TRAIN_B,
                          cfg.num_hidden_layers, cfg.hidden_size,
                          "llama training", "llama_train")


def phase_llama_generate(pt, ops):
    """Phase 12: greedy parity at LLaMA-2 7B's width cut to 2 layers (f32,
    card vs CPU), then `LLAMA_7B` at full depth in bf16."""
    import torch
    cfg = pt.LlamaConfig(**dict(pt.LLAMA_7B, num_hidden_layers=2))
    rng = generate_parity(
        pt, ops, "llama generate parity",
        lambda device: pt.LlamaForCausalLM(cfg, device=device),
        cfg.vocab_size, cfg.num_hidden_layers, "llama_gen")
    free_device_memory()
    model = pt.LlamaForCausalLM(pt.LlamaConfig(**pt.LLAMA_7B),
                                dtype=torch.bfloat16, seed=SEED).eval()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"  LLAMA_7B: {n_params / 1e9:.3f} B parameters, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card")
    counts, summary = generate_drive(ops, model, rng, "LLAMA_7B",
                                     "llama generate", "llama_gen")
    summary["n_params"] = n_params
    return counts, summary


# ---------------------------------------------------------------------
# phases 14-16: BERT and ERNIE
# ---------------------------------------------------------------------
#: BERT-base (BertConfig()'s widths: hidden 768, 12 heads of 64, ffn 3072,
#: vocab 30522) and bench.py:314-380's bench_bert batch
BERT_B, BERT_S = 64, 128
#: ERNIE eval drive: forwards timed after 2 warm-up forwards
ERNIE_WARMUP, ERNIE_FORWARDS = 2, 10


def phase_bert_train_parity(pt, ops):
    """Phase 14: BERT-base's width cut to 2 layers, f32, both dropouts 0
    (attention takes the flash kernels, not causal), weights from a numpy
    seed, B=2, S=128, token types 0 then 1, labels the ids with about 15%
    at -100: 3 AdamW(1e-4) steps without a clip (bench_bert has none),
    card vs CPU."""
    import torch
    cfg = pt.BertConfig(num_hidden_layers=2, hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)

    def loss_of(model, x, y):     # token type 1 on the second half
        tt = (torch.arange(x.shape[1], device=x.device)
              >= x.shape[1] // 2).long().expand_as(x)
        return model(x, tt, labels=y)[0]
    return train_parity(
        pt, ops, "bert training parity",
        lambda device: pt.BertForMaskedLM(cfg, device=device),
        loss_of, cfg.vocab_size,
        cfg.num_hidden_layers, "bert_parity", clip=False, ignore_share=0.15,
        sign_free=True)


def phase_bert_training(pt, ops):
    """Phase 15: bench_bert's recipe on the card, eagerly: BertConfig()
    (12 layers, dropout 0.1 on the hidden states and the attention
    probabilities), f32 master weights under auto_cast(bf16, O1),
    AdamW(1e-4), B=64, S=128, one batch of ids from
    np.random.default_rng(0) fed as ids and labels."""
    import numpy as np
    import torch
    cfg = pt.BertConfig()
    model = pt.BertForMaskedLM(cfg, dtype=torch.float32, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.parameters())
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (BERT_B, BERT_S))).cuda()

    def step():
        with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
            loss, _ = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    return drive_training(ops, step, n_params, BERT_B,
                          cfg.num_hidden_layers, cfg.hidden_size,
                          "bert training", "bert_train", S=BERT_S)


def phase_ernie(pt, ops):
    """Phase 16: (a) ErnieConfig()'s width cut to 2 layers, f32, eval,
    numpy weights, B=2, S=128 with token types and task types left at
    None: the MLM logits, the pooled output and the classification logits
    on the card within f32's `TOL` of the CPU's, the classifier's
    launches exactly ``ernie_eval``'s per forward; (b)
    ErnieForSequenceClassification at 12 layers in bf16, random weights
    from a seed, eval, B=64, S=128: ms per forward, sequences/s, launches
    per forward, one profiled forward."""
    import numpy as np
    import torch
    cfg = pt.ErnieConfig(num_hidden_layers=2)
    rng = np.random.default_rng(SEED + 5)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 128)))
    token_types = (torch.arange(128) >= 64).long().expand(2, 128)
    outs, counts = {}, None
    for device in ("cuda", "cpu"):
        x, tt = ids.to(device), token_types.to(device)
        mlm = pt.ErnieForMaskedLM(cfg, device=device).eval()
        pt.load_reference_state(mlm, numpy_weights(mlm, SEED + 6))
        clf = pt.ErnieForSequenceClassification(cfg, device=device).eval()
        pt.load_reference_state(clf, numpy_weights(clf, SEED + 7))
        with torch.no_grad():
            logits = mlm(x, tt)
            pooled = mlm.ernie(x, tt)[1]
            reset_launches(ops)
            cls_logits = clf(x, tt)
            if device == "cuda":
                torch.cuda.synchronize()
                counts = launches(ops)
        outs[device] = [t.cpu() for t in (logits, pooled, cls_logits)]
        del mlm, clf
        free_device_memory()
    errs = []
    for what, got, want in zip(("MLM logits", "pooled", "class logits"),
                               outs["cuda"], outs["cpu"]):
        err, _, ok = compare(got, want, "float32")
        errs.append(err)
        if not ok:
            fail(f"ernie parity: {what} differ by {err:.3e} between the "
                 f"card and the CPU")
    say(f"  card vs CPU max abs err: MLM logits {errs[0]:.3e}, pooled "
        f"{errs[1]:.3e}, class logits {errs[2]:.3e} (tolerance "
        f"{TOL['float32'][0]:g} + {TOL['float32'][1]:g}*|cpu|)")
    check_counts("ernie parity", counts, 1, cfg.num_hidden_layers,
                 "ernie_eval")

    cfg = pt.ErnieConfig()
    model = pt.ErnieForSequenceClassification(cfg, dtype=torch.bfloat16,
                                              seed=SEED).eval()
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BERT_B, BERT_S))).cuda()

    def forward():
        with torch.no_grad():
            return model(ids)
    for _ in range(ERNIE_WARMUP):
        forward()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(ops)
    t0 = time.perf_counter()
    for _ in range(ERNIE_FORWARDS):
        out = forward()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = launches(ops)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if out.shape != (BERT_B, cfg.num_labels) or not bool(
            torch.isfinite(out).all()):
        fail(f"ernie eval: logits of shape {tuple(out.shape)} or not finite")
    ms = elapsed / ERNIE_FORWARDS * 1e3
    say(f"  ErnieForSequenceClassification bf16, {cfg.num_hidden_layers} "
        f"layers, B={BERT_B} S={BERT_S}: {ms:.2f} ms per forward, "
        f"{BERT_B / ms * 1e3:.1f} sequences/s, peak memory {peak:.2f} GiB")
    check_counts("ernie eval", counts, ERNIE_FORWARDS,
                 cfg.num_hidden_layers, "ernie_eval")
    summary = dict(parity_max_abs_err=dict(zip(
        ("mlm_logits", "pooled", "class_logits"), errs)),
        batch=BERT_B, seq=BERT_S, forwards=ERNIE_FORWARDS,
        ms_per_forward=ms, sequences_per_s=BERT_B / ms * 1e3,
        peak_memory_gib=peak)
    summary["profile"] = split_profile(profile_device(forward), 1,
                                       "ERNIE forward")
    return counts, summary


# ---------------------------------------------------------------------
# phases 17-20: MoE-GPT
# ---------------------------------------------------------------------
MOE_TRAIN_B, MOE_TRAIN_S = 8, 1024


def moe_serve_cfg(pt, **over):
    """MoE-GPT at the width the repo serves GPT at: GPT_1P3B (hidden 2048,
    24 layers, 16 heads, vocab 50304, experts of 8192) with 4 experts,
    top 2."""
    return pt.MoEGPTConfig(**dict(pt.GPT_1P3B, num_experts=4, top_k=2,
                                  **over))


def phase_moe_parity(pt, ops):
    """Phase 17: MoE-GPT at GPT_1P3B's width (E = 4, top 2) cut to 2
    layers, f32, numpy weights, served by the engine on the card and on
    the CPU with phase 3's 4 requests and geometry, 16 greedy tokens each:
    identical tokens, and identical expert choices of every row at the
    first step (a prefill chunk, padding rows included), each MLP routing
    its own input; a choice that differs is reported with that row's
    top-k margin on the CPU.  Launches exactly ``serve_moe``'s per step."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import moe_gpt
    phase = "moe parity"
    cfg = moe_serve_cfg(pt, num_hidden_layers=2)
    rng = np.random.default_rng(SEED + 1)
    shared = list(rng.integers(1, cfg.vocab_size, size=48))
    prompts = [shared + list(rng.integers(1, cfg.vocab_size, size=n))
               for n in (5, 9, 12, 7)]
    kw = dict(max_batch=4, prefill_chunk=64, max_model_len=256,
              num_blocks=128)
    outs, routes, params = {}, {}, None
    for device in ("cuda", "cpu"):
        model = pt.MoEGPTForCausalLM(cfg, device=device)
        if params is None:
            params = numpy_weights(model, SEED + 2)
        pt.load_reference_state(model, params)
        first = []

        def grab(mod, inp):
            if len(first) < cfg.num_hidden_layers:
                x = inp[0].reshape(-1, inp[0].shape[-1])
                first.append(moe_gpt.route(x, mod.router, mod.top_k))
        hooks = [blk.mlp.register_forward_pre_hook(grab)
                 for blk in model.gpt.h]
        eng = pt.GenerationEngine(model, device=device, **kw)
        reset_launches(ops)
        t0 = time.perf_counter()
        outs[device] = eng.generate(prompts, max_new_tokens=16)
        if device == "cuda":
            torch.cuda.synchronize()
            counts, steps = launches(ops), eng.stats()["steps"]
        say(f"  {device}: {eng.stats()['steps']} steps in "
            f"{time.perf_counter() - t0:.2f} s")
        for h in hooks:
            h.remove()
        routes[device] = [tuple(t.cpu() for t in r) for r in first]
        del eng, model
        free_device_memory()
    flips = []
    for layer, (gpu, cpu) in enumerate(zip(routes["cuda"], routes["cpu"])):
        bad = (gpu[2] != cpu[2]).any(dim=1).nonzero().flatten().tolist()
        for row in bad:
            p = cpu[0][row].sort(descending=True).values
            k = cfg.top_k
            flips.append(f"layer {layer} row {row}: card {gpu[2][row]} cpu "
                         f"{cpu[2][row]}, cpu top-{k} margin "
                         f"{float(p[k - 1] - p[k]):.3e}")
    rows = routes["cpu"][0][2].shape[0]
    say(f"  expert choices at the first step ({rows} rows x "
        f"{cfg.num_hidden_layers} layers): "
        + ("identical on the card and the CPU" if not flips
           else f"{len(flips)} differ: " + "; ".join(flips[:8])))
    if flips:
        fail(f"{phase}: expert choices differ between the card and the CPU")
    if outs["cuda"] != outs["cpu"]:
        fail(f"{phase}: CUDA tokens {outs['cuda']} != CPU tokens "
             f"{outs['cpu']}")
    if not all(len(o) == len(p) + 16 for o, p in zip(outs["cuda"], prompts)):
        fail(f"{phase}: a request did not return 16 tokens")
    say(f"  greedy tokens identical on CUDA and CPU for {len(prompts)} "
        f"requests x 16 tokens")
    check_counts(phase, counts, steps, cfg.num_hidden_layers, "serve_moe")
    return dict(steps=steps, first_step_rows=rows, choices_identical=True,
                tokens_identical=True)


def moe_train_cfg(pt, **over):
    """bench.py's moe_gpt recipe (:1518-1545) at MoEGPTConfig()'s own
    width (hidden 768, 12 layers, 12 heads, vocab 50304, E = 4, top 2,
    experts of 3072): the composite attention (use_flash_attention=False)."""
    return pt.MoEGPTConfig(use_flash_attention=False, **over)


def phase_moe_train_parity(pt, ops):
    """Phase 19: `moe_train_cfg` cut to 2 layers, f32, numpy weights, B=2,
    S=128: 3 AdamW steps with the aux loss on the card and on the CPU,
    held as phase 14 (elements whose gradient lay within the gradient gate
    of 0 held to 2 * 3 * lr); both grouped kernels launch."""
    cfg = moe_train_cfg(pt, num_hidden_layers=2)

    def loss_of(model, x, y):
        return pt.MoEGPTPretrainingCriterion(model=model)(model(x), y)
    return train_parity(
        pt, ops, "moe training parity",
        lambda device: pt.MoEGPTForCausalLM(cfg, device=device), loss_of,
        cfg.vocab_size, cfg.num_hidden_layers, "moe_train", sign_free=True)


def phase_moe_training(pt, ops):
    """Phase 20: bench.py's moe_gpt recipe on one card (ep = 1):
    `moe_train_cfg` at its 12 layers, f32, no auto_cast,
    MoEGPTPretrainingCriterion with the aux loss, AdamW(1e-4), B=8,
    S=1024, one batch of random ids fed as ids and labels.  MFU counts
    the active parameters (the non-expert ones and top_k / E of the
    experts')."""
    import numpy as np
    import torch
    cfg = moe_train_cfg(pt)
    model = pt.MoEGPTForCausalLM(cfg, dtype=torch.float32, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    n_expert = sum(p.numel() for n, p in model.named_parameters()
                   if ".mlp." in n and not n.endswith("router"))
    n_active = n_params - n_expert + n_expert * cfg.top_k // cfg.num_experts
    say(f"  {n_params / 1e6:.1f}M parameters, {n_active / 1e6:.1f}M active "
        f"a token (top {cfg.top_k} of {cfg.num_experts} experts)")
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.parameters())
    crit = pt.MoEGPTPretrainingCriterion(model=model)
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (MOE_TRAIN_B, MOE_TRAIN_S))).cuda()

    def step():
        loss = crit(model(ids), ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    counts, summary = drive_training(
        ops, step, n_active, MOE_TRAIN_B, cfg.num_hidden_layers,
        cfg.hidden_size, "moe training", "moe_train", S=MOE_TRAIN_S)
    summary.update(n_params_total=n_params, n_params_active=n_active,
                   aux_loss=float(model.aux_loss().detach()))
    return counts, summary


# ---------------------------------------------------------------------
# phases 21-24: multi-LoRA serving and LoRA fine-tuning
# ---------------------------------------------------------------------
#: bench.py:959-1068's bench_gpt_multilora, TPU branch: GPT at hidden
#: 1024, 24 layers, 16 heads, max_position_embeddings 1024 (vocab 50304),
#: 64 adapters of rank 16 over 16 device slots, max_batch 8
MULTILORA_CFG = dict(hidden_size=1024, num_hidden_layers=24,
                     num_attention_heads=16, max_position_embeddings=1024)
LORA_ADAPTERS, LORA_MAX_BATCH = 64, 8


def multilora_cfg(pt, **over):
    return pt.GPTConfig(**dict(MULTILORA_CFG, **over))


def make_adapter(sites, i, rank=LORA_RANK, scale=0.02):
    """bench_gpt_multilora's ``make_adapter``: adapter ``i``'s factors
    from ``np.random.default_rng(1000 + i)`` at ``scale``, alpha = rank."""
    import numpy as np
    r = np.random.default_rng(1000 + i)
    return {name: {"A": (r.standard_normal((k, rank)) * scale
                         ).astype(np.float32),
                   "B": (r.standard_normal((rank, n)) * scale
                         ).astype(np.float32),
                   "rank": rank, "alpha": float(rank)}
            for name, k, n in sites}


def serve_requests(eng, reqs, max_new=None):
    """Submit ``(prompt, adapter, max_new_tokens)`` requests and step the
    engine until they finish; returns the finished requests in order."""
    ids = [eng.add_request(p, max_new_tokens=max_new or n, adapter=a)
           for p, a, n in reqs]
    while eng.has_unfinished():
        eng.step()
    return [eng._results[i] for i in ids]


def phase_lora_parity(pt, ops):
    """Phase 21: the multilora width cut to 2 layers, f32, numpy weights,
    served on the card and on the CPU with LoRA on: 4 adapters of rank 16
    (``make_adapter`` at scale 0.3) and 2 base-model rows among 6 requests
    sharing a prefix, 16 greedy tokens each: identical tokens; the SGMV
    epilogue launches 4 x layers a step and fc1's matmul epilogue not at
    all.  A LoRA-free engine on the card gives the base rows' tokens and
    must differ on some adapter row: with the recipe's scale of 0.02 a
    random model with N(0, 1) tied embeddings echoes its input tokens
    whatever the adapters add, and the parity would not show that they
    reach the logits."""
    import numpy as np
    import torch
    from paddle_tpu_torch.inference.serving import lora
    phase = "lora parity"
    cfg = multilora_cfg(pt, num_hidden_layers=2)
    rng = np.random.default_rng(SEED + 1)
    shared = list(rng.integers(1, cfg.vocab_size, size=48))
    reqs = [(shared + list(rng.integers(1, cfg.vocab_size, size=n)), a, 16)
            for n, a in zip((5, 9, 12, 7, 3, 10),
                            ("t0", "t1", None, "t2", "t3", None))]
    kw = dict(max_batch=4, prefill_chunk=64, max_model_len=256,
              num_blocks=128)
    outs, params = {}, None
    for device in ("cuda", "cpu"):
        model = pt.GPTForCausalLM(cfg, device=device)
        if params is None:
            params = numpy_weights(model, SEED + 2)
        pt.load_reference_state(model, params)
        sites = lora.attach_lora_sites(model)
        eng = pt.GenerationEngine(model, device=device, **kw)
        eng.enable_lora(rank=LORA_RANK)
        for i in range(4):
            eng.register_adapter(f"t{i}", make_adapter(sites, i, scale=0.3))
        reset_launches(ops)
        t0 = time.perf_counter()
        outs[device] = [r.generated for r in serve_requests(eng, reqs)]
        if device == "cuda":
            torch.cuda.synchronize()
            counts, steps = launches(ops), eng.stats()["steps"]
            base = pt.GenerationEngine(model, device=device, **kw)
            plain = [r.generated for r in serve_requests(
                base, [(p, None, n) for p, _, n in reqs])]
            del base
        say(f"  {device}: {eng.stats()['steps']} steps in "
            f"{time.perf_counter() - t0:.2f} s, adapter hit rate "
            f"{eng.stats()['adapter_hit_rate']:.3f}")
        del eng, model
        free_device_memory()
    if outs["cuda"] != outs["cpu"]:
        fail(f"{phase}: CUDA tokens {outs['cuda']} != CPU tokens "
             f"{outs['cpu']}")
    if not all(len(o) == 16 for o in outs["cuda"]):
        fail(f"{phase}: a request did not return 16 tokens")
    moved = sum(1 for (_, a, _), o, b in zip(reqs, outs["cuda"], plain)
                if a is not None and o != b)
    base_same = all(o == b for (_, a, _), o, b in zip(reqs, outs["cuda"],
                                                      plain) if a is None)
    say(f"  greedy tokens identical on CUDA and CPU for {len(reqs)} "
        f"requests (4 adapters, 2 base rows) x 16 tokens; {moved} of 4 "
        f"adapter rows differ from the LoRA-free engine's, its base rows "
        f"{'equal' if base_same else 'differ'}")
    if not moved:
        fail(f"{phase}: no adapter changed its request's tokens")
    check_counts(phase, counts, steps, cfg.num_hidden_layers, "serve_lora")
    return dict(steps=steps, tokens_identical=True, adapter_rows_moved=moved,
                base_rows_equal_lora_free=base_same)


def phase_multilora_serving(pt, ops):
    """Phase 22: bench_gpt_multilora's recipe (TPU branch) at full depth in
    bf16 with random weights from a seed: 64 adapters (``make_adapter``),
    ``enable_lora(rank=16, num_slots=16)``, ``max_batch=8``, the
    ``bursty_trace(7, 64 requests, prefix 24, tail < 12, 32 tokens,
    adapter_pool=64)`` trace (a quarter base-model rows) after a warm-up
    of its first 2 requests x 2 tokens: tokens/s, p99 TTFT, ms/step, the
    store's hit rate and spills, peak memory, launches per step, one
    profiled burst.  Then the same trace without adapters on a LoRA-free
    engine (the base twin): its numbers, and the greedy match ratio of
    the base-model rows (reported: fc1 runs another kernel there)."""
    import torch
    from paddle_tpu_torch.inference.serving import lora
    cfg = multilora_cfg(pt)
    L = cfg.num_hidden_layers
    model = pt.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=SEED)
    sites = lora.attach_lora_sites(model)
    trace = bursty_trace(7, n_requests=64, vocab=cfg.vocab_size,
                         prefix_len=24, tail_max=12, max_new_tokens=32,
                         adapter_pool=LORA_ADAPTERS)
    summary, generated, counts = {}, {}, None
    for twin in ("lora", "base"):
        phase = "multi-lora serving" + (" (base twin)" if twin == "base"
                                        else "")
        free_device_memory()
        torch.cuda.reset_peak_memory_stats()
        eng = pt.GenerationEngine(model, max_batch=LORA_MAX_BATCH,
                                  max_model_len=cfg.max_position_embeddings)
        out = dict(weight_gib=state_gib(model))
        if twin == "lora":
            eng.enable_lora(rank=LORA_RANK, num_slots=LORA_SLOTS)
            t0 = time.perf_counter()
            for i in range(LORA_ADAPTERS):
                eng.register_adapter(f"t{i}", make_adapter(sites, i))
            out["register_s"] = time.perf_counter() - t0
        reqs = [(r["prompt"], r["adapter"] if twin == "lora" else None,
                 r["max_new_tokens"]) for r in trace]
        serve_requests(eng, reqs[:2], max_new=2)        # warm-up
        torch.cuda.synchronize()
        steps0 = eng.stats()["steps"]
        reset_launches(ops)
        t0 = time.perf_counter()
        done = serve_requests(eng, reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = launches(ops)
        steps = eng.stats()["steps"] - steps0
        tokens = sum(n for _, _, n in reqs)
        if not all(len(r.generated) == n for r, (_, _, n) in zip(done, reqs)):
            fail(f"{phase}: a request returned too few tokens")
        ttft = sorted((r.t_first_token - r.t_submit) * 1e3 for r in done)
        p99 = ttft[min(len(ttft) - 1, int(round(0.99 * (len(ttft) - 1))))]
        out.update(requests=len(reqs), tokens=tokens, elapsed_s=dt,
                   tokens_per_s=tokens / dt, p99_ttft_ms=p99,
                   median_ttft_ms=ttft[len(ttft) // 2], steps=steps,
                   ms_per_step=dt / steps * 1e3,
                   peak_memory_gib=torch.cuda.max_memory_allocated()
                   / 2 ** 30)
        note = ""
        if twin == "lora":
            ls = eng.stats()["lora"]
            out.update(adapter_hit_rate=ls["hit_rate"],
                       adapter_spills=ls["spills"], lora=ls,
                       tenants=len({a for _, a, _ in reqs} - {None}),
                       base_rows=sum(1 for _, a, _ in reqs if a is None))
            note = (f", {out['tenants']} tenants over {LORA_SLOTS} slots "
                    f"({out['base_rows']} base rows): adapter hit rate "
                    f"{ls['hit_rate']:.4f}, {ls['spills']} spills, "
                    f"{64} adapters registered in {out['register_s']:.2f} s")
        say(f"  {twin}: {len(reqs)} requests, {tokens} tokens in {dt:.3f} "
            f"s: {out['tokens_per_s']:.1f} tokens/s, p99 TTFT {p99:.1f} ms "
            f"(median {out['median_ttft_ms']:.1f}), {steps} steps "
            f"({out['ms_per_step']:.2f} ms/step), peak memory "
            f"{out['peak_memory_gib']:.2f} GiB{note}")
        check_counts(phase, c, steps, L,
                     "serve_lora" if twin == "lora" else "serve")
        if twin == "lora":
            counts = c
        steps0 = eng.stats()["steps"]
        prof = profile_device(lambda: serve_requests(eng, reqs[:8],
                                                     max_new=16))
        out["profile"] = split_profile(prof, eng.stats()["steps"] - steps0,
                                       f"{twin} burst")
        generated[twin] = [list(r.generated) for r in done]
        summary[twin] = out
        eng.close()
        del eng
    base_rows = [i for i, r in enumerate(trace) if r["adapter"] is None]
    match = pt.quantization.greedy_match_ratio(
        [generated["base"][i] for i in base_rows],
        [generated["lora"][i] for i in base_rows])
    summary["base_rows_greedy_match_ratio"] = match
    say(f"  against the base twin: tokens/s {summary['lora']['tokens_per_s']:.1f}"
        f" vs {summary['base']['tokens_per_s']:.1f}, ms/step "
        f"{summary['lora']['ms_per_step']:.2f} vs "
        f"{summary['base']['ms_per_step']:.2f}; the {len(base_rows)} base "
        f"rows' greedy match ratio {match:.4f} (reported, not gated: fc1 "
        f"runs cuBLAS + the SGMV epilogue there, the matmul epilogue in "
        f"the twin)")
    return counts, summary


def lora_finetune_model(pt, cfg, device=None, dtype=None, seed=SEED):
    """GPT with every base parameter frozen, then ``convert_to_lora(rank=
    16)``: the trainable parameters are the adapters' A and B."""
    import torch
    from paddle_tpu_torch.inference.serving import lora
    model = pt.GPTForCausalLM(cfg, device=device,
                              dtype=dtype or torch.float32, seed=seed)
    for p in model.parameters():
        p.requires_grad_(False)
    lora.convert_to_lora(model, rank=LORA_RANK)
    return model


def phase_lora_train_parity(pt, ops):
    """Phase 23: the multilora width cut to 2 layers, f32, flash attention,
    base frozen and ``convert_to_lora(rank=16)``, numpy weights (A and B
    too, so B starts nonzero), B=2, S=128: 3 AdamW steps on the card and
    on the CPU, held as phase 14 (losses, step-1 gradients of the LoRA
    factors, parameters after step 3; elements whose gradient lay within
    the gradient gate of 0 held to 2 * 3 * lr).  The same factors get a
    gradient on both sides (fc1's none: GPT's MLP runs fc1 through the
    matmul epilogue, as the reference's does), and every base parameter
    ends bit-unchanged.  The SGMV epilogue, the grouped forward kernel
    (u, t and dx, the last read transposed) and the grouped dw kernel
    launch."""
    cfg = multilora_cfg(pt, num_hidden_layers=2)
    crit = pt.GPTPretrainingCriterion()
    return train_parity(
        pt, ops, "lora training parity",
        lambda device: lora_finetune_model(pt, cfg, device=device),
        lambda model, x, y: crit(model(x), y), cfg.vocab_size,
        cfg.num_hidden_layers, "lora_train", sign_free=True,
        frozen=lambda n: ".lora_" not in n)


def phase_lora_training(pt, ops):
    """Phase 24: LoRA fine-tuning at the multilora width (24 layers, rank
    16) on bench_gpt's recipe: f32 master weights under ``auto_cast(bf16,
    O1)``, ``AdamW(1e-4, weight_decay=0.01)`` over the LoRA parameters
    with a global-norm clip of 1.0, B=8, S=1024, one fixed batch from a
    numpy seed fed as ids and labels; flash attention.  No MFU:
    bench.py:642's 6N counts weight gradients that LoRA never computes."""
    import numpy as np
    import torch
    cfg = multilora_cfg(pt)
    model = lora_finetune_model(pt, cfg)
    params = [p for p in model.parameters() if p.requires_grad]
    n_train = sum(p.numel() for p in params)
    n_total = sum(p.numel() for p in model.parameters())
    say(f"  {n_total / 1e6:.1f}M parameters, {n_train / 1e6:.3f}M of them "
        f"trainable LoRA factors")
    opt = pt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                             parameters=params,
                             grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    crit = pt.GPTPretrainingCriterion()
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (TRAIN_B[True], TRAIN_S))).cuda()

    def step():
        with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
            loss = crit(model(ids), ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    counts, summary = drive_training(
        ops, step, None, TRAIN_B[True], cfg.num_hidden_layers,
        cfg.hidden_size, "lora training", "lora_train")
    summary.update(n_params_total=n_total, n_params_trainable=n_train,
                   launches_per_step={k: v // TRAIN_STEPS
                                      for k, v in counts.items() if v})
    return counts, summary


# ---------------------------------------------------------------------
# phase 25: the paged decode view
# ---------------------------------------------------------------------
PAGED_PARITY_PROMPT, PAGED_PARITY_STEPS = 64, 16
#: decode steps of phase 25b's profiled burst
PAGED_PROFILE_STEPS = 16


def paged_generate(pt, ops, model, prompts, steps, device, profile=False):
    """Greedy decoding of ``prompts`` ([B, P] ints, equal lengths) through
    ``PagedCacheView``: one ``"prefill"`` forward, then ``steps`` one-token
    ``"decode"`` forwards, block 16.  Returns (tokens [B, steps + 1] on the
    CPU, prefill s, decode s, launch counts of the decode steps, and with
    ``profile`` the decode steps' `profile_device` result, else None: its
    wall time then includes the profiler's overhead)."""
    import numpy as np
    import torch
    cfg = model.config
    B, P = prompts.shape
    H = cfg.num_attention_heads
    bs = 16
    per = -(-(P + steps + 1) // bs)
    cache = pt.inference.serving.PagedKVCache(
        cfg.num_hidden_layers, H, cfg.hidden_size // H, dtype=model.dtype,
        block_size=bs, num_blocks=B * per + 1, max_model_len=per * bs,
        device=device)
    seqs = [f"s{i}" for i in range(B)]
    for s in seqs:
        if not cache.allocate(s, P):
            fail("paged view: the pool cannot hold the prompts")

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()
    sync()
    t0 = time.perf_counter()
    view = pt.PagedCacheView(cache, "prefill")
    view.set_inputs(
        np.concatenate([cache.slot_mapping(s, 0, P) for s in seqs]),
        np.stack([cache.block_table(s) for s in seqs]),
        np.full(B, P, np.int32), np.tile(np.arange(P), (B, 1)))
    ids = torch.as_tensor(np.asarray(prompts), device=device)
    with torch.no_grad():
        tok = model(ids, cache=view)[:, -1].argmax(-1)
    toks = [tok]
    sync()
    prefill_s = time.perf_counter() - t0
    reset_launches(ops)
    view = pt.PagedCacheView(cache, "decode")

    def decode():
        tok = toks[-1]
        for _ in range(steps):
            for s in seqs:
                cache.append(s, 1)
            n = cache.length(seqs[0])
            view.set_inputs(
                np.concatenate([cache.slot_mapping(s, n - 1, 1)
                                for s in seqs]),
                np.stack([cache.block_table(s) for s in seqs]),
                np.full(B, n, np.int32), np.full((B, 1), n - 1))
            with torch.no_grad():
                tok = model(tok[:, None], cache=view)[:, -1].argmax(-1)
            toks.append(tok)
    t0 = time.perf_counter()
    prof = profile_device(decode) if profile else decode()
    sync()
    decode_s = time.perf_counter() - t0
    return (torch.stack(toks, 1).cpu(), prefill_s, decode_s, launches(ops),
            prof)


def phase_paged(pt, ops, gen_keep, gen_summary):
    """Phase 25: (a) GPT_1P3B's width cut to 2 layers, f32, numpy weights,
    eval: 4 prompts of 64 tokens prefilled through the paged view, then
    16 greedy decode steps, on the card and on the CPU: identical tokens,
    and paged attention launching once a layer a decode step.  (b)
    GPT_1P3B in bf16 with phase 9's weights (same seed) and phase 9's 4
    prompts x 128 tokens, 64 decode steps: ms per decode step beside
    phase 9's dense-cache decode from the same call, and the token match
    against phase 9's 64 new tokens (reported: another attention
    kernel), and a profiled burst of `PAGED_PROFILE_STEPS` decode steps
    (the device split and idle share)."""
    import numpy as np
    import torch
    cfg = pt.GPTConfig(**dict(pt.GPT_1P3B, num_hidden_layers=2))
    rng = np.random.default_rng(SEED + 5)
    prompts = rng.integers(1, cfg.vocab_size, (4, PAGED_PARITY_PROMPT))
    toks, params = {}, None
    for device in ("cuda", "cpu"):
        model = pt.GPTForCausalLM(cfg, device=device).eval()
        if params is None:
            params = numpy_weights(model, SEED + 2)
        pt.load_reference_state(model, params)
        toks[device], _, dec_s, c, _ = paged_generate(
            pt, ops, model, prompts, PAGED_PARITY_STEPS, device)
        if device == "cuda":
            counts = c
        say(f"  {device}: {PAGED_PARITY_STEPS} decode steps in "
            f"{dec_s:.2f} s")
        del model
        free_device_memory()
    if not torch.equal(toks["cuda"], toks["cpu"]):
        fail(f"paged parity: CUDA tokens {toks['cuda'].tolist()} != CPU "
             f"tokens {toks['cpu'].tolist()}")
    say(f"  greedy tokens identical on CUDA and CPU for 4 prompts x "
        f"{PAGED_PARITY_PROMPT} tokens, {PAGED_PARITY_STEPS} decode steps")
    check_counts("paged parity", counts, PAGED_PARITY_STEPS,
                 cfg.num_hidden_layers, "paged_decode")
    cfg = pt.GPTConfig(**pt.GPT_1P3B)
    model = pt.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=SEED).eval()
    prompts = gen_keep["prompts"].numpy()
    paged_generate(pt, ops, model, prompts, 2, "cuda")     # first-use costs
    torch.cuda.reset_peak_memory_stats()
    toks, prefill_s, decode_s, counts, _ = paged_generate(
        pt, ops, model, prompts, GEN_NEW, "cuda")
    ms = decode_s / GEN_NEW * 1e3
    match = pt.quantization.greedy_match_ratio(
        gen_keep["tokens"].tolist(), toks[:, :GEN_NEW].tolist())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"  GPT_1P3B bf16, {prompts.shape[0]} prompts x {prompts.shape[1]} "
        f"tokens: prefill {prefill_s * 1e3:.1f} ms, {GEN_NEW} decode steps "
        f"at {ms:.2f} ms/step (phase 9's dense cache: "
        f"{gen_summary['decode_ms_per_step']:.2f}), peak memory {peak:.2f} "
        f"GiB; greedy match against phase 9's tokens {match:.4f} (reported)")
    check_counts("paged decode", counts, GEN_NEW, cfg.num_hidden_layers,
                 "paged_decode")
    prof = paged_generate(pt, ops, model, prompts, PAGED_PROFILE_STEPS,
                          "cuda", profile=True)[4]
    profiled = split_profile(prof, PAGED_PROFILE_STEPS, "decode burst")
    return counts, dict(profile=profiled, batch=int(prompts.shape[0]),
                        prompt=int(prompts.shape[1]), decode_steps=GEN_NEW,
                        prefill_ms=prefill_s * 1e3, decode_ms_per_step=ms,
                        dense_decode_ms_per_step=gen_summary[
                            "decode_ms_per_step"],
                        greedy_match_vs_dense=match, peak_memory_gib=peak,
                        parity_tokens_identical=True)


def free_device_memory():
    """Collect the last phase's objects (the engine and its cache hold
    reference cycles) and return their device memory, so the next phase's
    peak memory is its own."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def kernel_entry(r):
    return dict(max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=r["library_ms"], shape=r["shape"],
                note=r.get("note", ""))


#: the dtype each kernel runs in on its main path (serving: bf16; the
#: training drives under O1: layer norm, RMS norm and cross-entropy in
#: f32 (black list), the fc1 epilogue and attention in bf16 (white list))
MAIN_DTYPE = {"ragged_attention": "bfloat16", "layer_norm": "bfloat16",
              "matmul_epilogue": "bfloat16", "layer_norm_bwd": "float32",
              "matmul_epilogue_bwd": "bfloat16",
              "softmax_xent_fwd": "float32", "softmax_xent_bwd": "float32",
              "flash_attention_fwd": "bfloat16",
              "flash_attention_bwd_dq": "bfloat16",
              "flash_attention_bwd_dkv": "bfloat16",
              "rms_norm": "float32", "rms_norm_bwd": "float32",
              "ragged_attention_int8": "bfloat16",
              "matmul_epilogue_int8": "bfloat16",
              "layer_norm_residual": "float32",
              "grouped_matmul": "bfloat16", "grouped_matmul_dw": "float32",
              "lora_sgmv": "bfloat16", "paged_attention": "bfloat16"}
TRAIN_DTYPE = {"layer_norm": "float32", "matmul_epilogue": "bfloat16",
               "grouped_matmul": "float32"}


def kernels_line(results, counts):
    """One entry per kernel: its main path's dtype and shapes (the
    serving drive's for the serving kernels, int8 ones included, the
    flash drive's for flash attention, the LLaMA training drive's for RMS
    norm, the BERT training drive's for the fused residual layer norm),
    the other
    dtype, the forward kernels at the training drive's shapes too, flash
    attention at its decode and head_dim-64 shapes and RMS norm at
    LLaMA-2 7B's prefill and decode shapes.  ``launches`` counts the main
    path's run (the serving drive, the composite training drive, or the
    ``main`` drive of `KERNEL_INFO`: the flash drive's, the LLaMA or BERT
    training drive's timed steps, the int8 serving drive's or the MoE
    drives');
    ``launches_<drive>`` every drive's."""
    out = []
    for name, info in KERNEL_INFO.items():
        main = MAIN_DTYPE[name]
        other = "float32" if main == "bfloat16" else "bfloat16"
        shapes = FLASH_SHAPES if name.startswith("flash_attention") \
            else RMS_SHAPES if name.startswith("rms_norm") \
            else dict.fromkeys(("out", "fc1", "fc2", *LORA_TRAIN_CASES)) \
            if name == "lora_sgmv" \
            else dict.fromkeys(("w2", "train_dx", *LORA_BWD_CASES)) \
            if name == "grouped_matmul" \
            else dict(LORA_DW_CASES) if name == "grouped_matmul_dw" else {}
        served = any(d in info for d in ("serve", "serve_int8", "serve_moe",
                                         "serve_lora", "paged_decode"))
        key = (name,) if served else (name, "train")
        drive = info.get("main", "serve" if "serve" in info else "train")
        entry = dict(name=name, route="cuda", source=info["source"],
                     replaces=info["replaces"],
                     launches=counts[drive][name], dtype=main,
                     **kernel_entry(results[(key[0], main) + key[1:]]))
        for d, c in counts.items():
            entry[f"launches_{d}"] = c[name]
        for d in ("train_flash", "llama_train", "bert_train", "moe_train",
                  "lora_train"):
            entry[f"launches_per_step_{d}"] = counts[d][name] // TRAIN_STEPS
        entry["launches_per_forward_ernie_eval"] = \
            counts["ernie_eval"][name] // ERNIE_FORWARDS
        entry[other] = kernel_entry(results[(key[0], other) + key[1:]])
        if name in TRAIN_DTYPE:
            entry["train"] = dict(
                dtype=TRAIN_DTYPE[name],
                **kernel_entry(results[(name, TRAIN_DTYPE[name], "train")]))
        for shape_key in shapes:
            if shape_key != "train":
                entry[shape_key] = {
                    dt: kernel_entry(results[(name, dt, shape_key)])
                    for dt in ("bfloat16", "float32")}
        out.append(entry)
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
    flash_resources = kernel_resources(cuda_lib, path, FLASH_KERNEL_NAMES)

    say("[2] kernels vs plain versions at the main path's shapes")
    # the serving drive's token budget: chunk 256 + 7 rows of block_q
    budgets = {"bfloat16": 256 + 7 * 16, "float32": 256 + 7 * 8}
    results = phase_kernels(ops, budgets)

    say("[3] parity: full width, 2 layers, f32, CUDA vs CPU; float, then "
        "int8 weights + int8 KV pool")
    phase_parity(pt, ops)
    phase_parity(pt, ops, int8=True)

    say("[4] serving: GPT_1P3B bf16, 16 requests x 64 tokens")
    serve_counts, serving, serve_tokens = phase_serving(pt, ops)
    free_device_memory()

    say("[5] training parity: full width, 2 layers, f32, 3 AdamW steps, "
        "CUDA vs CPU")
    parity = phase_train_parity(pt, ops)
    free_device_memory()

    say("[6] training: GPT_1P3B, bf16 O1, AdamW, B=4 S=1024")
    train_counts, training = phase_training(pt, ops)
    free_device_memory()

    say("[7] flash training parity: full width, 2 layers, f32, flash "
        "attention + recompute, 3 AdamW steps, CUDA vs CPU")
    flash_parity = phase_train_parity(pt, ops, flash=True)
    free_device_memory()

    say("[8] flash training: GPT_1P3B, bf16 O1, flash attention + "
        "recompute, AdamW, B=8 S=1024")
    flash_counts, training_flash = phase_training(pt, ops, flash=True)
    free_device_memory()

    say("[9] generate: dense KV cache, greedy; parity at full width, "
        "2 layers, f32; GPT_1P3B bf16")
    gen_keep = {}
    gen_counts, generate = phase_generate(pt, ops, keep=gen_keep)
    free_device_memory()

    say("[10] LLaMA training parity: bench_llama width, 2 layers, f32, "
        "GQA, recompute, 3 AdamW steps, CUDA vs CPU")
    llama_parity = phase_llama_train_parity(pt, ops)
    free_device_memory()

    say("[11] LLaMA training: bench_llama recipe, 16 layers, bf16 O1, "
        "recompute, AdamW, B=8 S=1024")
    llama_train_counts, llama_training = phase_llama_training(pt, ops)
    free_device_memory()

    say("[12] LLaMA generate: parity at LLaMA-2 7B width, 2 layers, f32; "
        "LLAMA_7B bf16")
    llama_gen_counts, llama_generate = phase_llama_generate(pt, ops)
    free_device_memory()

    say("[13] int8 serving: GPT_1P3B bf16 with int8 weights and an int8 KV "
        "pool, 16 requests x 64 tokens")
    int8_counts, int8_serving, _ = phase_serving(
        pt, ops, int8=True, base=dict(serving, generated=serve_tokens))
    free_device_memory()

    say("[14] BERT training parity: BERT-base width, 2 layers, f32, "
        "dropout 0, 3 AdamW steps, CUDA vs CPU")
    bert_parity = phase_bert_train_parity(pt, ops)
    free_device_memory()

    say("[15] BERT training: bench_bert recipe, BERT-base MLM, bf16 O1, "
        "dropout 0.1, AdamW, B=64 S=128")
    bert_counts, bert_training = phase_bert_training(pt, ops)
    free_device_memory()

    say("[16] ERNIE: parity at ErnieConfig width, 2 layers, f32, eval; "
        "ErnieForSequenceClassification bf16 forward, B=64 S=128")
    ernie_counts, ernie = phase_ernie(pt, ops)
    free_device_memory()

    say("[17] MoE serving parity: GPT_1P3B width, E=4 top 2, 2 layers, "
        "f32, CUDA vs CPU")
    moe_parity = phase_moe_parity(pt, ops)
    free_device_memory()

    say("[18] MoE serving: GPT_1P3B width, E=4 top 2, 24 layers, bf16, "
        "16 requests x 64 tokens")
    moe_serve_counts, moe_serving, _ = phase_serving(
        pt, ops, moe=True, base=serving)
    free_device_memory()

    say("[19] MoE training parity: MoEGPTConfig width, 2 layers, f32, aux "
        "loss, 3 AdamW steps, CUDA vs CPU")
    moe_train_parity = phase_moe_train_parity(pt, ops)
    free_device_memory()

    say("[20] MoE training: bench.py's moe_gpt recipe at MoEGPTConfig() "
        "width, 12 layers, f32, AdamW, B=8 S=1024")
    moe_train_counts, moe_training = phase_moe_training(pt, ops)
    free_device_memory()

    say("[21] LoRA serving parity: multilora width, 2 layers, f32, 4 "
        "adapters + base rows, CUDA vs CPU")
    lora_parity = phase_lora_parity(pt, ops)
    free_device_memory()

    say("[22] multi-LoRA serving: bench_gpt_multilora recipe, 24 layers, "
        "bf16, 64 adapters over 16 slots; base twin")
    lora_serve_counts, lora_serving = phase_multilora_serving(pt, ops)
    free_device_memory()

    say("[23] LoRA fine-tuning parity: multilora width, 2 layers, f32, "
        "rank 16, 3 AdamW steps, CUDA vs CPU")
    lora_train_parity = phase_lora_train_parity(pt, ops)
    free_device_memory()

    say("[24] LoRA fine-tuning: multilora width, 24 layers, rank 16, bf16 "
        "O1, AdamW, B=8 S=1024")
    lora_train_counts, lora_training = phase_lora_training(pt, ops)
    free_device_memory()

    say("[25] paged decode view: parity at GPT_1P3B width, 2 layers, f32; "
        "GPT_1P3B bf16 decode beside phase 9")
    paged_counts, paged = phase_paged(pt, ops, gen_keep, generate)

    counts = dict(serve=serve_counts, train=train_counts,
                  train_flash=flash_counts, generate=gen_counts,
                  llama_train=llama_train_counts,
                  llama_gen=llama_gen_counts, serve_int8=int8_counts,
                  bert_train=bert_counts, ernie_eval=ernie_counts,
                  serve_moe=moe_serve_counts, moe_train=moe_train_counts,
                  serve_lora=lora_serve_counts, lora_train=lora_train_counts,
                  paged_decode=paged_counts)
    say(json.dumps({"kernels": kernels_line(results, counts),
                    "serving": serving, "training_parity": parity,
                    "training": training,
                    "training_flash_parity": flash_parity,
                    "training_flash": training_flash,
                    "generate": generate,
                    "llama_training_parity": llama_parity,
                    "llama_training": llama_training,
                    "llama_generate": llama_generate,
                    "int8_serving": int8_serving,
                    "bert_training_parity": bert_parity,
                    "bert_training": bert_training, "ernie": ernie,
                    "moe_serving_parity": moe_parity,
                    "moe_serving": moe_serving,
                    "moe_training_parity": moe_train_parity,
                    "moe_training": moe_training,
                    "lora_serving_parity": lora_parity,
                    "multi_lora_serving": lora_serving,
                    "lora_training_parity": lora_train_parity,
                    "lora_training": lora_training, "paged_decode": paged,
                    "flash_resources": flash_resources}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
