#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of paddle-tpu on one NVIDIA H100.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA device, imports nothing
of JAX and nothing of the JAX package, and exits non-zero as soon as a
phase fails.  Phases:

0. the card's name and power limit (``nvidia-smi``);
1. build: every kernel of ``paddle_tpu_torch/csrc`` compiled by ``nvcc``
   for sm_90a into one library (timed); the registers and stack/local
   bytes of every flash attention, grouped matmul, ``wgmma``,
   vector-route layer norm, residual layer norm and RMS norm backward,
   ragged attention tensor-core, paged attention and epilogue-backward
   vector-route and sliced column-sum kernel instantiation; the
   ``wgmma`` kernels (the bf16 matmul epilogue, rows 3 and 11, and
   ``csrc/wgmma_check.cu``) must not spill and their SASS must hold
   HGMMA, the four ragged attention tensor-core
   instantiations (rows 1 and 10) must not spill, nor may the vector
   routes of rows 7 and 9 or the sliced column sum; then the ``wgmma``
   self-check: one TMA-loaded, transpose-B product of small integers,
   and the same product staged by the threads, each exactly equal to
   ``torch.mm``;
2. kernels: one untimed launch of every kernel first, then each kernel
   against its plain PyTorch version on the card, at the shapes the
   serving and the training drives give it (flash attention: the flash
   drive's B=8, S=1024, 16 heads of 128, causal; a decode step's one
   query against 640 keys; heads of 64 at the 0.35B width; BERT-base's
   B=64, S=128, 12 heads of 64, not causal; and heads of 256, causal and
   not; RMS norm: the LLaMA training drive's 8192 rows of 1024, LLaMA-2
   7B's prefill of 512 rows and decode step of 4 rows of 4096, its
   backward run twice, each run held to the plain version, the second
   bit-identical, on the vector route; the fused residual layer norm at
   the BERT drive's 8192 rows of 768, forward (run twice in the same way,
   on the vector route) and, through the layer-norm backward kernel,
   backward), in bf16 and in f32,
   with
   errors against stated tolerances and CUDA-event times of the kernel,
   the plain version and (where one PyTorch call computes the same
   function) the library call, beside the least time the card could take
   (``bound_ms``); layer norm forward and backward (rows 2 and 6) also
   at the flash drive's 8192 rows and the BERT drive's [8192, 768], each
   run twice and held bit-identical; the matmul epilogue (row 3) at the
   serving step's fc1 (368 x 2048 @ 2048 x 8192, gelu_tanh), a decode
   step's 4 rows, the training drive's 4096 rows with z saved and phase
   45's Transformer-base linear1 (4096 x 512 @ 512 x 2048, relu, z
   saved), each run twice and held bit-identical; its backward (row 7)
   at the training drive's [4096, 8192], at the fc1 shapes of phases 8
   ([8192, 8192]), 24 ([8192, 4096]) and 15 ([8192, 3072] and the MLM
   head's [8192, 768]) and at phase 45's [4096, 2048] with relu, each
   run twice and held bit-identical on the vector route, beside
   ``aten.gelu_backward`` (``threshold_backward`` for relu; dz alone);
   the fused residual layer norm (row 13) also at phase 45's [4096,
   512]; flash attention also at phase 45's training (B=32, 128 x 128,
   8 heads of 64, full) and cached decoding (B=8, one query row against
   128 keys) shapes; the int8 serving kernels at the
   serving drive's shapes too (the int8 matmul epilogue at GPT_1P3B's
   qkv, out, fc1 and fc2 on 368 rows, each run twice and held
   bit-identical, beside ``torch._weight_int8pack_mm`` and the float
   twin, the same GEMM with bias and activation on a bf16 copy of the
   dequantized weight; int8 ragged attention at the mixed step with int8
   pools); ragged attention, float and int8 pools, at the mixed step, a
   decode-only step (8 rows at contexts 577-640, padded with null
   q-blocks to the token budget) and the mixed step at heads of 64 (the
   multi-LoRA drive's), each run twice and held bit-identical, bf16 on
   the tensor-core route and f32 on its own;
   and the grouped-expert matmul's forward and dw kernels at the MoE
   drives' shapes with skewed expert counts (one expert empty, one
   holding almost everything): the serving step's 736 assignments (368
   packed rows x top 2) over 4 experts at block rows 128 through w1
   (2048 -> 8192, gelu_tanh) and w2 (8192 -> 2048), a decode step's 16
   (8 rows x top 2, one block of 16 an expert) through both, the training
   drive's 16384 assignments through w1 (768 -> 3072, z saved), its dx
   (w1 read transposed) and its dw; the library yardstick is
   ``torch._grouped_mm`` (bf16, where this torch has it) or a per-expert
   loop of ``torch._addmm_activation`` / ``addmm`` / ``mm``, named in
   each row's note; the LoRA SGMV epilogue at the multi-LoRA serving
   step's qkv, out, fc1 (gelu_tanh) and fc2 (the token budget's rows, 4
   adapters of 16 slots mixed with null blocks, rank 16) and the
   fine-tuning drive's qkv, out and fc2 (8192 rows, one adapter), each
   run twice and held bit-identical, bf16 on the tensor-core route (no
   library call; a one-adapter ``mm`` + ``addmm`` composite timed in the
   note), the grouped kernels at LoRA's backward shapes (8192 rows, one
   adapter: u and dx through the transposed read with N or K = 16, dA and
   dB; yardstick ``torch.mm``; and u's shape over blocks cycling over 4
   adapters in unsorted order, ``lora_u_mixed``, against ``torch.bmm``),
   each grouped kernel also run twice and held bit-identical, and the
   f32 forward's card-test computation repeated 10 times (out, and the
   whole autograd forward and backward, each bit-identical to the first
   and within 1e-4 of the CPU), and paged decode attention at phase 25's
   decode shape (4 sequences at contexts 129-192 and one at 0, 16 heads
   of 128, pages of 16) and at a long decode (4 sequences of 4096 keys),
   each run twice and held bit-identical on the vector route (no library
   call); the softmax cross-entropy rows (8a, 8b) also at the vision
   drives' logits (`XENT_VISION_CASES`: LeNet's [64, 10], ResNet-50's
   [32, 1000] and [256, 1000]), beside ``F.cross_entropy``;
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
   equal its launches per step times the steps; every bf16 matmul
   epilogue launch since phase 2 must have taken the TMA staging route,
   every layer-norm launch (forward, backward, residual forward) and
   every RMS norm backward launch the vector route and
   no LoRA SGMV, ragged attention, paged attention or epilogue backward
   launch the element-wise route (checked after every drive
   and parity run: `check_routes`, run by `check_counts`).  A second,
   profiled burst (8 of the prompts, 16 tokens) then splits device time
   by kernel and gives the device's idle share (``torch.profiler``);
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
    beside phase 9's dense cache and the token match against phase 9;
26. bf16 parity: GPT_1P3B's width cut to 2 layers, numpy weights, f32
    master weights under ``auto_cast(bf16, O1)`` with flash attention and
    recompute: 3 AdamW steps on the card and on the CPU (plain versions):
    losses, step-1 gradients and the 3 steps' parameter updates within
    ``BF16_PARITY_TOL`` of the CPU's, each gate set between this run's
    reading and the control's (the same card run with fc1's bias
    dropped), which must fail every gate; then the engine with bf16
    weights on phase 3's 4 requests, 16 greedy tokens each, the token
    match ratio card vs CPU reported; then phase 23's LoRA fine-tuning
    model (multi-LoRA width, 2 layers, base frozen, rank 16) the same way
    under O1, held to ``BF16_LORA_PARITY_TOL`` against a control with
    qkv's B factors zeroed, the frozen base bit-unchanged;
27. optimizers: ``__graft_entry__.entry()``'s width (hidden 512, vocab
    4096) cut to 2 layers, f32, numpy weights, B=2, S=128: 3 steps of
    each of the 14 optimizers, of AdamW under each of the 17 schedulers,
    of L1Decay, L2Decay, parameter groups, scheduled betas and the three
    clips, on the card and on the CPU, held to ``PARITY_TOL`` as phase 5
    holds AdamW (with ``hold_sign_free``), the kernels' launches per
    forward/backward evaluation; then two state round-trips on the card,
    AdamW under ``LinearWarmup`` and AdamW with a ``GradScaler`` whose
    step 1 a pre-step hook poisons: 3 steps, ``state_dict`` into a fresh
    model, optimizer and scaler, 1 step, bit-identical to 4 uninterrupted
    steps;
28. O2 training: the GPT-1.3B pretraining recipe at phase 8's shape
    (24 layers, flash + recompute, B=8, S=1024) with ``amp.decorate(
    level="O2", dtype="bfloat16")``, ``auto_cast(level="O2")``, AdamW
    (weight decay 0.01 off the biases and norms),
    ``LinearWarmup(CosineAnnealingDecay)``, ``ClipGradByGlobalNorm(1.0)``
    and a ``GradScaler``: ms/step, tokens/s, MFU, peak memory, launches
    per step, the learning rates, the loss falling, one profiled step;
29. O2 parity: GPT_1P3B's width cut to 2 layers, O2 bf16 parameters,
    flash + recompute: 3 AdamW steps on the card and on the CPU held to
    ``O2_PARITY_TOL`` (phase 26's gates, the loss gate at 1e-4) against
    a control with fc1's bias dropped, as phase 26.
30. vision parity: LeNet (B=8, 1 x 28 x 28, 3 Adam steps) and ResNet-50
    (10 classes, B=4, 3 x 64 x 64, batch norm in training mode, 3
    Momentum steps), f32, from the CPU model's initial state and one
    numpy batch, on the CPU and then on the card: losses, step-1
    gradients, parameters and the batch norms' running statistics after
    3 steps within ``PARITY_TOL``, the card's relus taking the CPU's
    derivative at inputs within ``KINK_BAND`` of 0 (`ReluKinks`);
31. LeNet training: bench.py's ``bench_lenet`` recipe (B=64, 1 x 28 x 28,
    f32, ``Adam(1e-3)``, 2 warm-up steps, then 10 timed steps, each
    synchronised): imgs/s, ms/step, MFU against the f32 peak, peak
    memory, launches per step, one profiled step, the loss falling;
32. ResNet-50 training: bench.py's ``bench_resnet50`` recipe (224 x 224,
    1000 classes, ``auto_cast(bf16, O1)``, ``Momentum(0.1, 0.9)``, 2
    warm-up steps, then 5 timed steps) at B=32 (BASELINE's) and B=256:
    imgs/s, ms/step, MFU (3 x the forward's flops, counted from the
    model's convolution and Linear shapes, against 989 TFLOP/s), peak
    memory, launches per step, one profiled step split by
    ``VISION_PROFILE_GROUPS``, finite losses with the last below the
    first;
33. vision parity II (`phase_vision_parity_ii`): SqueezeNet 1.1 and
    AlexNet held as LeNet in phase 30 (f32), MobileNetV1 (0.25),
    ShuffleNetV2 (0.5), GoogLeNet (its loss with both aux heads) and
    DenseNet-121 as ResNet-50 (f64, then one f32 step), 10 classes, B=4,
    3 x 64 x 64, 3 Momentum steps, every dropout at rate 0;
34. vision ops parity (`phase_vision_ops_parity`): every transposed
    convolution form, the other norms, the pooling masks and unpooling,
    roi_align and roi_pool, box_coder, yolo_box, deform_conv2d v1 and
    v2 and nms on the card against the CPU at small shapes, within
    ``VISION_OPS_TOL`` (masks, unpooled maps and nms indices exactly);
35. GoogLeNet training and 36. DenseNet-121 training: phase 32's recipe
    at B=64 (`phase_vision_recipe`), GoogLeNet's loss with both aux heads
    (rows 8a/8b 3 + 3 a step; DenseNet 1 + 1), with the share of the
    busy time in concatenation and batch norm;
37. detection ops (`phase_detection_ops`) at a detector's shapes:
    CUDA-event ms a call, forward and backward, and peak memory of
    roi_align and roi_pool (an 800 x 1216 image pair at stride 4, 512
    boxes an image), yolo_box on YOLOv3-608's heads with nms per image
    (the device IoU and the host sweep apart), box_coder decoding 1000
    priors x 81 classes and a DCN ResNet-50 stage-3 deform_conv2d v2;
38. captured serving (`phase_captured_serving`): phase 4's drive in
    turns eager, captured, captured, eager (the engine's step through
    ``jit.to_static`` on a CUDA graph; the eager twin calls the
    undecorated step, `EagerStep`), tokens identical to the eager turns'
    and phase 4's, ``step_compiles`` the CPU engine's on the same trace,
    launches per step drive ``serve``'s; then phase 13's int8 engine,
    eager and captured, held to phase 13's tokens;
39. captured GPT-1.3B training (`phase_captured_gpt_training`): phase
    8's recipe under phase 28's schedule, 10 steps a turn in turns
    eager, captured, captured, eager, losses and every parameter's
    checksum bit-identical, the launches per step drive ``train_flash``'s;
40. captured ResNet-50 training (`phase_captured_resnet50_training`):
    phase 32's recipe at B=32 in the same four turns, the batch norms'
    statistics in the checksum (bit-identical where the eager turns
    are, else within 2x their distance);
41. fp16 parity (`phase_fp16_parity`): ``__graft_entry__.entry()``'s GPT
    at its width, 2 layers, under ``amp.auto_cast()`` and
    ``amp.GradScaler()`` with their defaults (f16 O1), 3 AdamW steps on
    the card against the CPU's plain run: losses, step-1 unscaled
    gradients and updates within ``FP16_PARITY_TOL``, which the control
    (fc1's bias dropped) fails, and the scaler's decisions equal;
42. fp16 at full depth (`phase_fp16_drives`): GPT_1P3B in f16 served on
    phase 4's trace, ms/step beside phase 4's, greedy tokens equal to the
    plain f16 run's (`plain_serving`); phase 6's recipe under
    ``auto_cast()`` and ``GradScaler()``, ms/step beside phases 6 and 8;
43. nn breadth (`phase_nn_breadth`): every activation and loss of
    ``nn.functional`` and every activation and loss layer, forward and
    input gradients, f32 and bf16 (CTC in f32), card against CPU within
    ``NN_TOL``; the random ones' draws by structure and range;
    ``softmax_with_cross_entropy`` launching rows 8a/8b;
44. nn breadth II (`phase_nn_common`): every function of
    ``nn/functional/common.py`` and layer of ``nn/layer/common.py``,
    ``flash_attn_unpadded`` and ``nn.utils``, card against CPU as phase
    43 holds its cases;
45. Transformer-base (`phase_transformer`): 6 + 6 post-norm relu layers,
    B=32 pairs of 128 tokens, bf16 O1, AdamW, the launches per step of
    rows 3-7 and 13; its 2 + 2 parity in f32, relu, against the CPU
    with the CPU's relu kinks held (`ReluKinks.epilogue`); cached greedy
    decoding equal to the full recompute and to the CPU;
46. recurrent nets (`phase_recurrent`): the PTB "medium" LSTM trained
    with SGD and its parity, GRU/SimpleRNN/RNN/BiRNN and beam search
    card against CPU.
Phase 2 holds every row in float16 too (``TOL["float16"]``), on its
f16 route (the vector routes; the f32 CUDA-core templates where bf16
runs on the tensor cores).
Every captured turn reports ms/step, its rate (tokens/s, MFU or
imgs/s), the idle share of a profiled burst or step, the capture's
seconds and the graph pool's GiB, and fails unless every timed step
replayed the graph.  The serving phases 3, 4, 13, 17, 18, 21 and 22
run the engine's captured step too.

Before the last line come one JSON object (every kernel's results, the
serving, training-parity, training, flash training-parity, flash
training, generate, the three LLaMA, the int8 serving, the two BERT, the
ERNIE, the four MoE, the four LoRA, the paged decode, the bf16 parity,
the optimizer, the O2 training and the O2 parity summaries, the grouped
f32 repetitions, the vision parity, LeNet and ResNet-50 training
summaries, phases 33-43's, the wgmma self-check and the kernels'
resources) and
the card's ``nvidia-smi`` line; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

#: published peaks of one H100 SXM (NVIDIA data sheet, dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

#: max |kernel - plain| allowed, as atol + rtol * |plain|.  bf16: about
#: two bf16 ulps at unit scale (the plain attention also rounds its
#: probabilities to bf16, the kernel keeps f32).  f16: about five f16
#: ulps at unit scale (both round f32 results to f16).  f32: sums taken
#: in another order.
TOL = {"bfloat16": (2e-2, 2e-2), "float16": (5e-3, 5e-3),
       "float32": (1e-4, 1e-4)}

#: column sums (dgamma, dbeta, db) over thousands of rows, taken in
#: another order: atol = SUM_TOL * the largest column's sum of |terms|
#: (f32: 1e-5 of it, ~80 f32 ulps, the rounding a few-thousand-term sum
#: may gather; bf16: 2^-8 of it, one bf16 rounding; f16: 2^-10, one f16
#: rounding), rtol as in TOL.
SUM_TOL = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -10, "float32": 1e-5}

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
def check_layer_norm(ops, rows, dtype, dtype_name, gen, n=HIDDEN):
    """Row 2 on x [rows, n]; run twice, bit-identical."""
    import torch
    x = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
    g = (1 + 0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    b = (0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    first = ops.fused_layer_norm(x, g, b)
    out, mu, rstd = first
    ref, mu_ref, rstd_ref = ops.layer_norm_ref(x, g, b)
    torch.cuda.synchronize()
    err, rel, ok = compare(out, ref, dtype_name)
    ok = ok and compare(mu, mu_ref, "float32")[2] \
        and compare(rstd, rstd_ref, "float32")[2]
    same = repeat_equal(lambda: ops.fused_layer_norm(x, g, b), first)
    isz = x.element_size()
    nbytes = 2 * rows * n * isz + 2 * n * isz + 2 * rows * 4
    bms, by = bound(nbytes, 8 * rows * n, dtype_name)
    return dict(
        err=err, rel=rel, ok=ok and same, shape=f"x[{rows},{n}]",
        note=f"second run bit-identical: {same}",
        ms=time_ms(lambda: ops.fused_layer_norm(x, g, b)),
        plain_ms=time_ms(lambda: ops.layer_norm_ref(x, g, b)),
        library_ms=time_ms(lambda: torch.nn.functional.layer_norm(
            x, (n,), g, b, 1e-5)),
        bound_ms=bms, bound_by=by)


def repeat_equal(fn, first):
    """Run ``fn`` again; True when every output is bit-identical to
    ``first`` (a tensor or a tuple of them)."""
    import torch
    again = fn()
    pairs = zip(first, again) if isinstance(first, tuple) \
        else ((first, again),)
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in pairs)


#: the matmul epilogue's timed cases beside the serving step's fc1
#: (rows: the token budget): a decode step's 4 rows, and the training
#: drive's rows with z saved (as its forward saves it)
ME_DECODE_ROWS = 4


#: row 3 at phase 45's Transformer-base linear1 (training, z written):
#: (rows, K, N, activation), B=32 x 128 tokens, 512 -> 2048, relu
ME_TRANSFORMER = (32 * 128, 512, 2048, "relu")


def check_matmul_epilogue(ops, rows, dtype, dtype_name, gen, with_z=False,
                          K=HIDDEN, N=FFN, act="gelu_tanh"):
    """Row 3 at fc1's shape (K 2048, N 8192, gelu_tanh; or ``K``, ``N``,
    ``act``) for ``rows`` rows, with z written where ``with_z``
    (training); run twice, bit-identical."""
    import torch
    x = torch.randn(rows, K, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(K, N, device="cuda", generator=gen)
         / K ** 0.5).to(dtype)
    b = (0.1 * torch.randn(N, device="cuda", generator=gen)).to(dtype)

    def kernel():
        return ops.fused_linear_act(x, w, b, act, return_z=with_z)
    got = kernel()
    ref = ops.linear_act_ref(x, w, b, act, return_z=with_z)
    torch.cuda.synchronize()
    if with_z:
        (err, rel, ok), z_err = compare(got[0], ref[0], dtype_name), \
            compare(got[1], ref[1], dtype_name)
        ok, err = ok and z_err[2], max(err, z_err[0])
    else:
        err, rel, ok = compare(got, ref, dtype_name)
    same = repeat_equal(kernel, got)
    # the library call: one cuBLASLt GEMM with a bias + tanh-GELU (or
    # relu) epilogue (its CUDA fallback also applies gelu(approximate=
    # "tanh")); timed and compared here only, the port never calls it
    def library():
        return torch._addmm_activation(b, x, w, use_gelu=act == "gelu_tanh")
    lib_err = compare(library(), ref[0] if with_z else ref, dtype_name)[0]
    isz = x.element_size()
    nbytes = (rows * K + K * N + N + (2 if with_z else 1) * rows * N) * isz
    act_ops = 12 if act == "gelu_tanh" else 2
    bms, by = bound(nbytes, 2 * rows * K * N + act_ops * rows * N,
                    dtype_name)
    return dict(
        err=err, rel=rel, ok=ok and same, repeat_identical=same,
        shape=f"x[{rows},{K}] w[{K},{N}]" + (" z" if with_z else "")
        + ("" if act == "gelu_tanh" else f" {act}"),
        note=f"library vs plain max abs err {lib_err:.3e}; second run "
             f"bit-identical {same}",
        ms=time_ms(kernel),
        plain_ms=time_ms(lambda: ops.linear_act_ref(
            x, w, b, act, return_z=with_z)),
        library_ms=time_ms(library), bound_ms=bms, bound_by=by)


#: the int8 epilogue's shapes on the serving step's rows (GPT_1P3B: qkv,
#: out, fc1 and fc2): (K, N, activation)
INT8_CASES = {"qkv": (HIDDEN, 3 * HIDDEN, "none"),
              "out": (HIDDEN, HIDDEN, "none"),
              "fc1": (HIDDEN, FFN, "gelu_tanh"),
              "fc2": (FFN, HIDDEN, "none")}


def check_matmul_epilogue_int8(ops, rows, dtype, dtype_name, gen,
                               case="fc1"):
    """The int8-weight epilogue at one of `INT8_CASES`: x [rows, K] in
    ``dtype``, per-channel int8 codes [K, N] with f32 scales, a bias in
    x's type; run twice, bit-identical.  Two yardsticks: the library call
    ``torch._weight_int8pack_mm`` (no bias or activation), and the float
    twin, one cuBLASLt GEMM with the bias and activation on a bf16 copy of
    the dequantized weight (what an operations-bound int8 launch should
    match)."""
    import torch
    from paddle_tpu_torch.quantization import quantize_weight_int8
    K, N, act = INT8_CASES[case]
    x = torch.randn(rows, K, device="cuda", generator=gen).to(dtype)
    w_q, scale = quantize_weight_int8(
        torch.randn(K, N, device="cuda", generator=gen) / K ** 0.5, axis=1)
    b = (0.1 * torch.randn(N, device="cuda", generator=gen)).to(dtype)
    args = (x, w_q, scale, b, act)
    out = ops.fused_linear_act_int8(*args)
    ref = ops.linear_act_int8_ref(*args)
    torch.cuda.synchronize()
    err, rel, ok = compare(out, ref, dtype_name)
    same = repeat_equal(lambda: ops.fused_linear_act_int8(*args), out)
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
    w_twin = (w_q.float() * scale).to(dtype)

    def twin():
        if act == "gelu_tanh":
            return torch._addmm_activation(b, x, w_twin, use_gelu=True)
        return torch.addmm(b, x, w_twin)
    twin_err = compare(twin(), ref, dtype_name)[0]
    twin_ms = time_ms(twin)
    twin_call = "_addmm_activation" if act != "none" else "addmm"
    isz = x.element_size()
    nbytes = rows * K * isz + K * N + 4 * N + N * isz + rows * N * isz
    bms, by = bound(nbytes, 2 * rows * K * N + 12 * rows * N, dtype_name)
    return dict(
        err=err, rel=rel, ok=ok and same, repeat_identical=same,
        note=f"{note}; float twin ({twin_call} on the dequantized weight "
             f"in {dtype_name}) {twin_ms:.4f} ms, max abs err vs plain "
             f"{twin_err:.3e}; second run bit-identical {same}",
        twin_ms=twin_ms,
        shape=f"x[{rows},{K}] w_q[{K},{N}] int8 {act}",
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


def check_ragged_int8(ops, block_q, dtype, dtype_name, gen, case="mixed"):
    """`check_ragged` over int8 pools with per-slot scales."""
    return check_ragged(ops, block_q, dtype, dtype_name, gen, int8=True,
                        case=case)


#: ragged attention's cases (query lengths, context lengths, heads, head
#: dim): "mixed", a mixed step of the serving drive, one 256-token
#: prefill chunk (positions 256..511) plus seven decode rows at contexts
#: 520-622; "decode", a decode-only step, most of the serving trace's
#: steps: 8 decode rows at contexts 577-640; "d64", the mixed step at the
#: multi-LoRA serving drive's 16 heads of 64.  Each is padded with null
#: q-blocks to the engine's token budget (chunk 256 + 7 q-blocks).
RAGGED_CASES = {
    "mixed": ([1] * 7 + [256], [520 + 17 * i for i in range(7)] + [512],
              16, 128),
    "decode": ([1] * 8, [577 + 9 * i for i in range(8)], 16, 128),
    "d64": ([1] * 7 + [256], [520 + 17 * i for i in range(7)] + [512],
            16, 64),
}


#: the routes a launch is counted under, in `ragged_route_counts` and
#: `lora_route_counts`' order, and the one each dtype must take on the
#: drives' aligned shapes
ROUTES = ("mma", "f32", "f16", "elementwise")
WANT_ROUTE = {"bfloat16": "mma", "float32": "f32", "float16": "f16"}


def ragged_route_counts(ops, int8):
    fn = ops.ragged_paged_attention_int8 if int8 \
        else ops.ragged_paged_attention
    return (fn.mma_launches, fn.f32_launches, fn.f16_launches,
            fn.elementwise_launches)


def check_ragged(ops, block_q, dtype, dtype_name, gen, int8=False,
                 case="mixed"):
    """Ragged attention at one of `RAGGED_CASES`; with ``int8`` the pools
    hold per-slot int8 codes and scales.  Run twice, bit-identical; bf16
    must take the tensor-core route, f32 its own."""
    import numpy as np
    import torch
    qlens, ctxs, H, D = RAGGED_CASES[case]
    bs, W, S = 16, 128, len(qlens)
    nqb = 256 // block_q + 7
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

    def kernel():
        return ops.ragged_paged_attention(*args, **kw)
    n0 = ragged_route_counts(ops, int8)
    out = kernel()
    moved = [name for name, a, b in zip(ROUTES, n0,
                                        ragged_route_counts(ops, int8))
             if b != a]
    route = moved[0] if len(moved) == 1 else f"counts moved: {moved}"
    want_route = WANT_ROUTE[dtype_name]
    ref = ops.ragged_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    err, rel, ok = compare(out, ref, dtype_name)
    same = repeat_equal(kernel, out)
    ok = ok and same and route == want_route
    note = (f"route {route} (want {want_route}); second run "
            f"bit-identical: {same}")
    if dtype == torch.bfloat16:
        pools32 = (kp, vp) if int8 else (kp.float(), vp.float())
        ref32 = ops.ragged_attention_ref(q.float(), *pools32, *ints, **kw)
        k_rms, k_rel = RAGGED_BF16_F32P_TOL
        rms = float(ref32.pow(2).mean().sqrt())
        err32, _, ok32 = compare(out, ref32, dtype_name, k_rms * rms, k_rel)
        ok = ok and ok32
        note += (f"; vs plain with f32 probabilities max abs err "
                 f"{err32:.3e} (tolerance {k_rms * rms:.3e} + "
                 f"{k_rel:g}*|plain|, RMS {rms:.3e})")
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
        err=err, rel=rel, ok=ok, note=note, route=route,
        repeat_identical=same,
        shape=(f"{case}: q[{q.shape[0]},{H},{D}] pool[{nb},{H},{bs},{D}] "
               f"{dtype_name if not int8 else 'int8'} W={W}"),
        ms=time_ms(kernel),
        plain_ms=time_ms(lambda: ops.ragged_attention_ref(*args, **kw),
                         iters=5),
        library_ms=None, bound_ms=bms, bound_by=by)


def compare_sum(got, want, abs_sum, dtype_name):
    """A column sum against its plain version: atol scaled to the sum of
    |terms| of the largest column (`SUM_TOL`), rtol as in `TOL`."""
    atol = SUM_TOL[dtype_name] * float(abs_sum.max())
    err, _, ok = compare(got, want, dtype_name, atol, TOL[dtype_name][1])
    return err, ok, atol


def check_layer_norm_bwd(ops, rows, dtype, dtype_name, gen, n=HIDDEN):
    """Row 6 on x, do [rows, n] (the training drive's: [4096, 2048]); run
    twice, bit-identical."""
    import torch
    x = (torch.randn(rows, n, device="cuda", generator=gen)
         + 0.5).to(dtype)
    g = (1 + 0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    b = (0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    do = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
    _, mu, rstd = ops.layer_norm_ref(x, g, b)
    args = (x, g, mu, rstd, do)
    first = ops.fused_layer_norm_bwd(*args)
    dx, dg, db = first
    dx_r, dg_r, db_r = ops.layer_norm_bwd_ref(*args)
    torch.cuda.synchronize()
    err, rel, ok = compare(dx, dx_r, dtype_name)
    same = repeat_equal(lambda: ops.fused_layer_norm_bwd(*args), first)
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
        err=max(err, dg_err, db_err), rel=rel,
        ok=ok and dg_ok and db_ok and same, shape=f"x[{rows},{n}]",
        note=(f"dx max abs err {err:.3e}; dgamma {dg_err:.3e} (atol "
              f"{dg_tol:.3e}), dbeta {db_err:.3e} (atol {db_tol:.3e}); "
              f"second run bit-identical: {same}"),
        ms=time_ms(lambda: ops.fused_layer_norm_bwd(*args)),
        plain_ms=time_ms(lambda: ops.layer_norm_bwd_ref(*args)),
        library_ms=time_ms(library), bound_ms=bms, bound_by=by)


#: the BERT training drive's residual stream (B=64, S=128, hidden 768):
#: 8192 token rows, f32 under O1 (fused_residual_layer_norm is black-listed)
BERT_ROWS, BERT_HIDDEN = 8192, 768

#: rows 2 and 6 beyond the serving and training drives' shapes: the flash
#: drive's 8192 rows (B=8, S=1024) and the BERT drive's [8192, 768]
#: (row 13's backward is row 6's kernel)
LN_CASES = {"train8192": (8192, HIDDEN), "bert": (BERT_ROWS, BERT_HIDDEN)}


#: row 13 at phase 45's Transformer-base post-norm sublayers: (rows, n)
LN_RES_CASES = {"transformer": ME_TRANSFORMER[:2]}


def check_layer_norm_residual(ops, rows, dtype, dtype_name, gen,
                              n=BERT_HIDDEN):
    """The fused residual add + layer norm forward at the BERT drive's
    [8192, 768] (or [``rows``, ``n``]), run twice: each run held to the
    plain version (out, s, mu, rstd), the second bit-identical to the
    first, on the vector route; and its backward, the layer-norm backward
    kernel on the saved sum (held and timed in the note)."""
    import torch
    x = (2 * torch.randn(rows, n, device="cuda", generator=gen)
         + 0.5).to(dtype)
    r = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
    g = (1 + 0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    b = (0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    fn = ops.fused_layer_norm_residual
    n0 = (fn.vector_launches, fn.scalar_launches)
    runs = [fn(x, r, g, b, 1e-12)]
    route = norm_route(fn, n0)
    runs.append(fn(x, r, g, b, 1e-12))
    ref, s_r, mu_r, rstd_r = ops.layer_norm_residual_ref(x, r, g, b, 1e-12)
    do = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
    bargs = (s_r, g, mu_r, rstd_r, do)
    dx, dg, db = ops.fused_layer_norm_bwd(*bargs)
    dx_r, dg_r, db_r = ops.layer_norm_bwd_ref(*bargs)
    torch.cuda.synchronize()
    err = rel = s_err = 0.0
    ok = True
    for out, s, mu, rstd in runs:
        e, rl, o = compare(out, ref, dtype_name)
        se, _, so = compare(s, s_r, dtype_name)
        err, rel, s_err = max(err, e), max(rel, rl), max(s_err, se)
        ok = ok and o and so and compare(mu, mu_r, "float32")[2] \
            and compare(rstd, rstd_r, "float32")[2]
    same = all(torch.equal(a, c) for a, c in zip(*runs))
    del runs
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
        ok=(ok and same and route == "vector" and dx_ok and dg_ok
            and db_ok), route=route,
        shape=f"x, r[{rows},{n}]",
        note=(f"out {err:.3e}, s {s_err:.3e}, both runs; route {route} "
              f"(want vector); second run bit-identical: {same}; backward "
              f"(layer_norm_bwd on the saved s) dx {dx_err:.3e}, dgamma "
              f"{dg_err:.3e}, dbeta {db_err:.3e}, {bwd_ms:.4f} ms; library: "
              f"F.layer_norm(x + r), two calls"),
        ms=time_ms(lambda: fn(x, r, g, b, 1e-12)),
        plain_ms=time_ms(lambda: ops.layer_norm_residual_ref(x, r, g, b,
                                                             1e-12)),
        library_ms=time_ms(library), bound_ms=bms, bound_by=by)


#: row 7 at the other drives' fc1 shapes (rows, N, activation): phase
#: 8's GPT_1P3B at B=8 S=1024, phase 24's multi-LoRA GPT (hidden 1024) at
#: B=8 S=1024, phase 15's BERT-base fc1 and its MLM head transform at
#: B=64 S=128, all tanh-GELU, and phase 45's Transformer-base linear1
#: (relu); the serving-width training drive's [4096, 8192] is the
#: "train" row
ME_BWD_CASES = {"flash": (8192, FFN, "gelu_tanh"),
                "lora_train": (8192, 4 * 1024, "gelu_tanh"),
                "bert_fc1": (BERT_ROWS, 4 * BERT_HIDDEN, "gelu_tanh"),
                "bert_head": (BERT_ROWS, BERT_HIDDEN, "gelu_tanh"),
                "transformer": (ME_TRANSFORMER[0], *ME_TRANSFORMER[2:])}


def epilogue_bwd_routes(ops):
    fn = ops.fused_linear_act_bwd
    return fn.vector_launches, fn.elementwise_launches


def check_matmul_epilogue_bwd(ops, rows, dtype, dtype_name, gen, n=FFN,
                              act="gelu_tanh"):
    """The fc1 epilogue backward, ``act`` (gelu_tanh by default), z and g
    [rows, n] (the training drive's [4096, 8192] by default); run twice,
    bit-identical; it must take the vector route."""
    import torch
    N = n
    z = torch.randn(rows, N, device="cuda", generator=gen).to(dtype)
    g = (0.1 * torch.randn(rows, N, device="cuda", generator=gen)).to(dtype)
    n0 = epilogue_bwd_routes(ops)
    first = ops.fused_linear_act_bwd(z, g, act)
    moved = [name for name, a, b in zip(("vector", "elementwise"), n0,
                                        epilogue_bwd_routes(ops)) if b != a]
    route = moved[0] if len(moved) == 1 else f"counts moved: {moved}"
    dz, db = first
    dz_r, db_r = ops.linear_act_bwd_ref(z, g, act)
    torch.cuda.synchronize()
    err, rel, ok = compare(dz, dz_r, dtype_name)
    db_err, db_ok, db_tol = compare_sum(db, db_r, dz_r.float().abs().sum(0),
                                        dtype_name)
    del dz_r, db_r
    same = repeat_equal(lambda: ops.fused_linear_act_bwd(z, g, act), first)
    isz = z.element_size()
    nbytes = 3 * rows * N * isz + N * isz
    bms, by = bound(nbytes, (20 if act == "gelu_tanh" else 2) * rows * N,
                    dtype_name)
    if act == "gelu_tanh":
        def library():
            return torch.ops.aten.gelu_backward(g, z, approximate="tanh")
    else:
        def library():
            return torch.ops.aten.threshold_backward(g, z, 0)
    return dict(
        err=max(err, db_err), rel=rel,
        ok=ok and db_ok and same and route == "vector", route=route,
        shape=f"z[{rows},{N}] {act}",
        note=(f"dz max abs err {err:.3e}; db {db_err:.3e} (atol "
              f"{db_tol:.3e}); route {route} (want vector); second run "
              f"bit-identical: {same}; the library call computes dz only"),
        ms=time_ms(lambda: ops.fused_linear_act_bwd(z, g, act)),
        plain_ms=time_ms(lambda: ops.linear_act_bwd_ref(z, g, act)),
        library_ms=time_ms(library), bound_ms=bms, bound_by=by)


def _xent_inputs(rows, dtype, gen, vocab=VOCAB):
    import torch
    x = (2 * torch.randn(rows, vocab, device="cuda",
                         generator=gen)).to(dtype)
    labels = torch.randint(0, vocab, (rows,), device="cuda", generator=gen)
    labels[::97] = -1                     # a few ignored rows
    return x, labels


#: ResNet-50's batches on the card (phase 32): BASELINE's 32, and 256,
#: the per-card batch of the usual ImageNet mixed-precision recipes
RESNET50_BATCHES = (32, 256)

#: the vision drives' logits (rows, classes): LeNet's B=64 over 10
#: classes (phase 31, f32), ResNet-50's two batches over 1000 (phase 32:
#: O1 black-lists cross_entropy, so the bf16 logits reach the kernels as
#: f32), GoogLeNet's (its three heads) and DenseNet-121's B=64 over 1000
#: (phases 35-36)
XENT_VISION_CASES = {"lenet": (64, 10),
                     "resnet50": (RESNET50_BATCHES[0], 1000),
                     "resnet50_large": (RESNET50_BATCHES[-1], 1000),
                     "b64_1000": (64, 1000)}


def check_softmax_xent_fwd(ops, rows, dtype, dtype_name, gen, vocab=VOCAB):
    """The training drive's loss: logits [4092, 50304], or [rows,
    vocab]."""
    import torch
    x, labels = _xent_inputs(rows, dtype, gen, vocab)
    loss, lse = ops.softmax_xent_fwd(x, labels)
    loss_r, lse_r = ops.softmax_xent_fwd_ref(x, labels)
    torch.cuda.synchronize()
    # loss and lse are f32 whatever the logits' type: f32 tolerance
    err, rel, ok = compare(loss, loss_r, "float32")
    lse_err, _, lse_ok = compare(lse, lse_r, "float32")
    isz = x.element_size()
    nbytes = rows * vocab * isz + rows * 8 + 2 * rows * 4
    bms, by = bound(nbytes, 4 * rows * vocab, dtype_name)
    return dict(
        err=max(err, lse_err), rel=rel, ok=ok and lse_ok,
        shape=f"logits[{rows},{vocab}]",
        note=f"loss max abs err {err:.3e}, lse {lse_err:.3e}",
        ms=time_ms(lambda: ops.softmax_xent_fwd(x, labels)),
        plain_ms=time_ms(lambda: ops.softmax_xent_fwd_ref(x, labels)),
        library_ms=time_ms(lambda: torch.nn.functional.cross_entropy(
            x, labels, reduction="none", ignore_index=-1)),
        bound_ms=bms, bound_by=by)


def check_softmax_xent_bwd(ops, rows, dtype, dtype_name, gen, vocab=VOCAB):
    """The training drive's loss gradient: logits [4092, 50304] (or
    [rows, vocab]), g the mean's 1/valid-count per row."""
    import torch
    x, labels = _xent_inputs(rows, dtype, gen, vocab)
    _, lse = ops.softmax_xent_fwd_ref(x, labels)
    g = torch.full((rows,), 1.0 / rows, device="cuda")
    dx = ops.softmax_xent_bwd(x, labels, lse, g)
    dx_r = ops.softmax_xent_bwd_ref(x, labels, lse, g)
    torch.cuda.synchronize()
    # dx is ~1/rows in size: hold it to TOL scaled by the gradient's 1/rows
    atol, rtol = TOL[dtype_name]
    err, rel, ok = compare(dx, dx_r, dtype_name, atol / rows, rtol)
    isz = x.element_size()
    nbytes = 2 * rows * vocab * isz + rows * (8 + 4 + 4)
    bms, by = bound(nbytes, 4 * rows * vocab, dtype_name)
    return dict(
        err=err, rel=rel, ok=ok, shape=f"logits[{rows},{vocab}]",
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


def norm_route(fn, n0):
    """The route of the one launch of the norm wrapper ``fn`` since its
    counts by route were ``n0`` (vector, scalar): "vector" or "scalar"."""
    now = (fn.vector_launches, fn.scalar_launches)
    moved = [name for name, a, b in zip(("vector", "scalar"), n0, now)
             if b != a]
    return moved[0] if len(moved) == 1 else f"counts moved: {moved}"


def check_rms_norm_bwd(ops, shape_key, dtype, dtype_name, gen):
    """dx and dgamma from the plain forward's rstd, run twice: each run
    held to the plain version (dgamma by the column-sum rule,
    `compare_sum`), the second bit-identical to the first, on the vector
    route."""
    import torch
    rows, n = RMS_SHAPES[shape_key]
    x = (torch.randn(rows, n, device="cuda", generator=gen) + 0.5).to(dtype)
    g = (1 + 0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    do = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
    _, rstd = ops.rms_norm_ref(x, g, RMS_EPS)
    args = (x, g, rstd, do)
    fn = ops.fused_rms_norm_bwd
    n0 = (fn.vector_launches, fn.scalar_launches)
    runs = [fn(*args)]
    route = norm_route(fn, n0)
    runs.append(fn(*args))
    dx_r, dg_r = ops.rms_norm_bwd_ref(*args)
    torch.cuda.synchronize()
    abs_sum = (do.float() * x.float() * rstd[:, None]).abs().sum(0)
    err = rel = dg_err = 0.0
    ok = True
    for dx, dg in runs:
        e, r, o = compare(dx, dx_r, dtype_name)
        ge, go, dg_tol = compare_sum(dg, dg_r, abs_sum, dtype_name)
        err, rel, dg_err = max(err, e), max(rel, r), max(dg_err, ge)
        ok = ok and o and go
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    del runs
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
        err=max(err, dg_err), rel=rel,
        ok=ok and same and route == "vector", route=route,
        shape=f"x[{rows},{n}]",
        note=(f"dx max abs err {err:.3e}; dgamma {dg_err:.3e} (atol "
              f"{dg_tol:.3e}), both runs; route {route} (want vector); "
              f"second run bit-identical: {same}; {lib_note}"),
        ms=time_ms(lambda: fn(*args)),
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
                "d256_full": (2, 1024, 1024, 8, 256, False),
                "transformer": (32, 128, 128, 8, 64, False),
                "transformer_decode": (8, 1, 128, 8, 64, False)}


#: the flash kernels' names (the bf16 tensor-core kernels add "_mma")
FLASH_KERNEL_NAMES = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                      "flash_bwd_dkv_kernel")
GROUPED_KERNEL_NAMES = ("gmm_fwd_mma", "gmm_fwd_fma", "gmm_dw_mma",
                        "gmm_dw_fma")
#: the vector routes of layer norm, the residual layer norm and the RMS
#: norm backward (rows 2, 6, 13 and 12)
LN_KERNEL_NAMES = ("ln_fwd_vec_kernel", "ln_bwd_vec_kernel",
                   "ln_res_fwd_vec_kernel", "rms_bwd_vec_kernel")
#: the vector routes of paged attention and of the epilogue backward, and
#: the sliced column sum (row 6's second pass; phase 1: no spills)
VEC_KERNEL_NAMES = ("paged_attn_vec_kernel", "me_bwd_vec_kernel",
                    "column_sum_sliced_kernel")
#: the CUDA-core kernels that serve f16 where bf16 runs on the tensor
#: cores (rows 1, 3, 10, 11 and 15; the flash and grouped ones are in the
#: lists above), and the softmax cross-entropy (8a/8b): phase 1 prints
#: their registers and spills
SIMT_KERNEL_NAMES = ("me_fwd_fma", "ragged_attn_kernel", "lora_sgmv_kernel",
                     "xent_fwd_kernel", "xent_bwd_kernel")


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


#: ragged attention's tensor-core route (phase 1: no spills)
RAGGED_MMA_KERNEL_NAMES = ("ragged_attn_mma_kernel",)


def check_ragged_mma_kernels(resources):
    """Phase 1's gate on ragged attention's tensor-core instantiations
    (bf16 and int8 pools, heads of 64 and 128): all four are in the
    library and none uses stack or local memory (no spills)."""
    if resources is None:
        fail("phase 1: no cuobjdump to check the ragged mma kernels with")
    found = {n: r for n, r in resources.items()
             if any(k in n for k in RAGGED_MMA_KERNEL_NAMES)}
    spills = [n for n, r in found.items() if r["stack"] or r["local"]]
    say(f"  ragged attention mma: {len(found)} instantiations, "
        f"{len(spills)} spill")
    if len(found) != 4:
        fail(f"phase 1: {len(found)} ragged mma instantiations, want 4")
    if spills:
        fail(f"phase 1: ragged mma kernels spill to stack or local "
             f"memory: {spills}")


def check_vec_kernels(resources):
    """Phase 1's gate on the vector routes of rows 7 and 9 and the sliced
    column sum: each is in the library (19 paged attention instantiations:
    lanes a key row 1-32 in the three types, two vectors a lane for f32
    rows past 128; the epilogue backward at 5 activations in the three
    types; the column sum in the three) and none uses stack or local
    memory."""
    if resources is None:
        fail("phase 1: no cuobjdump to check the vector kernels with")
    want = {"paged_attn_vec_kernel": 19, "me_bwd_vec_kernel": 15,
            "column_sum_sliced_kernel": 3}
    for name, n in want.items():
        found = {k: r for k, r in resources.items() if name in k}
        spills = [k for k, r in found.items() if r["stack"] or r["local"]]
        say(f"  {name}: {len(found)} instantiations, {len(spills)} spill")
        if len(found) != n:
            fail(f"phase 1: {len(found)} {name} instantiations, want {n}")
        if spills:
            fail(f"phase 1: {name} spills to stack or local memory: "
                 f"{spills}")


#: the kernels built on `wgmma` (phase 1: no spills, HGMMA in their SASS)
WGMMA_KERNEL_NAMES = ("me_fwd_wgmma", "wgmma_check_kernel")


def check_wgmma_kernels(cuda_lib, lib_path, resources):
    """Phase 1's gate on the `wgmma` kernels: every instantiation named in
    `WGMMA_KERNEL_NAMES` uses no stack or local memory (no spills) and its
    SASS (``cuobjdump -sass``) holds HGMMA, the warpgroup tensor-core
    instruction.  Returns {mangled name: holds HGMMA}."""
    import re
    if resources is None:
        fail("phase 1: no cuobjdump to check the wgmma kernels with")
    spills = [n for n, r in resources.items()
              if any(k in n for k in WGMMA_KERNEL_NAMES)
              and (r["stack"] or r["local"])]
    if spills:
        fail(f"phase 1: wgmma kernels spill to stack or local memory: "
             f"{spills}")
    tool = Path(cuda_lib._nvcc()).parent / "cuobjdump"
    dump = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=600)
    found = {}
    for sec in re.split(r"\n\s*Function : ", dump.stdout)[1:]:
        name = sec.split("\n", 1)[0].strip()
        if any(k in name for k in WGMMA_KERNEL_NAMES):
            found[name] = "HGMMA" in sec
    missing = [n for n, ok in found.items() if not ok]
    say(f"  SASS: {len(found)} wgmma kernel instantiations, HGMMA in "
        f"{len(found) - len(missing)}; none spills")
    if not found:
        fail("phase 1: no wgmma kernel in the library's SASS")
    if missing:
        fail(f"phase 1: no HGMMA in the SASS of {missing}")
    return found


def check_wgmma_product(cuda_lib):
    """`csrc/wgmma_check.cu` on the card: a [64, 64] x [64, 128] product
    of small integers in bf16 through TMA (w as stored, the transpose-B
    form) and through the threads' own swizzled staging, each held
    exactly (bit for bit) against torch.mm."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    a = torch.randint(-3, 4, (64, 64), device="cuda",
                      generator=gen).to(torch.bfloat16)
    b = torch.randint(-3, 4, (64, 128), device="cuda",
                      generator=gen).to(torch.bfloat16)
    c = torch.full((2, 64, 128), float("nan"), device="cuda")
    cuda_lib.check(cuda_lib.library().ptt_wgmma_check(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), 0,
        cuda_lib.stream_handle(a.device)), "wgmma_check")
    torch.cuda.synchronize()
    want = torch.mm(a.float(), b.float())
    diffs = [int((c[i] != want).sum()) for i in range(2)]
    say(f"  wgmma self-check (TMA, MN-major B; thread-staged): "
        f"{diffs[0]} and {diffs[1]} of {want.numel()} values differ from "
        f"torch.mm (exact required)")
    if any(diffs):
        fail("phase 1: the wgmma self-check differs from torch.mm")
    return dict(tma_differ=diffs[0], staged_differ=diffs[1])


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
    if dtype != torch.float32:
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
#: decode/decode_w2: its decode steps (8 rows x top 2 = 16 assignments,
#: bm 16, 5 blocks, every expert in use); train/train_dx: the MoE
#: training drive's 16384 assignments (B=8, S=1024, top 2) through w1
#: (768 -> 3072, z saved) and the backward's dx (3072 -> 768 against w1
#: read transposed).  The mixed step's and training's counts are skewed:
#: one expert empty, one holding almost everything.
GROUPED_CASES = {"serve": ([0, 700, 20, 16], 2048, 8192, "gelu_tanh",
                           False, False),
                 "w2": ([0, 700, 20, 16], 8192, 2048, "none", False, False),
                 "decode": ([5, 4, 4, 3], 2048, 8192, "gelu_tanh", False,
                            False),
                 "decode_w2": ([5, 4, 4, 3], 8192, 2048, "none", False,
                               False),
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
    plain version, and a second run bit-identical to the first.  Library
    yardstick: ``torch._grouped_mm`` on the same rows plus the bias and
    the activation as separate calls (bf16, where this torch has it),
    else a per-expert loop of ``torch._addmm_activation`` (``addmm``
    without activation; for the transposed case the weights' transposed
    views)."""
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
    again = kernel()
    torch.cuda.synchronize()
    # fixed-order sums, no atomics: a second run is bit-identical
    if not torch.equal(got, again[0] if save_z else again):
        fail(f"grouped_matmul {dtype_name} {case}: two runs on the same "
             f"inputs differ")
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
    has it), else a per-expert loop of ``torch.mm``.  A second run must
    be bit-identical to the first."""
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
    if not torch.equal(got, kernel()):
        fail(f"grouped_matmul_dw {dtype_name} {case}: two runs on the same "
             f"inputs differ")
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


#: repetitions of the f32 grouped forward's card-test computation in
#: phase 2 (`check_grouped_repeats`; a search for an intermittent miss
#: calls it with more)
GROUPED_REPEATS = 10


def check_grouped_repeats(ops, reps=GROUPED_REPEATS):
    """The computation of ``tests/test_torch_cuda.py``'s
    ``test_grouped_linear_act_gradients_on_the_card`` in f32 (counts [37,
    0, 80, 11], block rows 32, K 96, N 160, gelu_tanh), ``reps`` times:
    the forward kernel alone (out and z), then the whole autograd forward
    and backward (out, dx, dw, db).  Before each repetition a block of
    NaNs is allocated and freed, so that the outputs land on stale
    memory of changing size and place; ``out`` is also copied right
    after the forward and held to itself after the backward, which would
    show a backward kernel writing into its buffer.  Every repetition
    must equal the first bit for bit and the CPU's plain version within
    the test's tolerances.  Returns the counts of repetitions that
    differed and the element indices of the misses."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    counts, bm, K, N, E = [37, 0, 80, 11], 32, 96, 160, 4
    nb = ops.num_group_blocks(sum(counts), E, bm)
    gid, offsets = ops.group_segments(torch.tensor(counts), bm, nb)
    x = torch.zeros(nb * bm, K, device="cuda")
    for e, c in enumerate(counts):
        o = int(offsets[e])
        x[o:o + c] = torch.randn(c, K, device="cuda", generator=gen)
    gid = gid.cuda()
    w = torch.randn(E, K, N, device="cuda", generator=gen) / 10
    b = torch.randn(E, N, device="cuda", generator=gen)
    g = torch.randn(x.shape[0], N, device="cuda", generator=gen)
    want_k = ops.grouped.fused_grouped_linear_act(
        x.cpu(), w.cpu(), b.cpu(), gid.cpu(), "gelu_tanh", return_z=True)

    def autograd(dev):
        xs, ws, bs = (t.detach().to(dev).requires_grad_() for t in (x, w, b))
        out = ops.grouped_linear_act(xs, ws, bs, block_group=gid.to(dev),
                                     act="gelu_tanh")
        snap = out.detach().clone()
        out.backward(g.to(dev))
        return [out.detach(), xs.grad, ws.grad, bs.grad], snap
    want_a = autograd("cpu")[0]
    tols = (1e-4, 1e-4, 1e-3, 1e-3)            # the test's: dw, db x 10
    first_k = first_a = None
    differ_k = differ_a = miss_k = miss_a = moved = 0
    where, worst = set(), 0.0
    sizes = torch.randint(1, 1 << 16, (reps,), generator=torch.Generator()
                          .manual_seed(1))
    for i in range(reps):
        junk = torch.full((int(sizes[i]) * 64,), float("nan"), device="cuda")
        del junk
        got_k = ops.fused_grouped_linear_act(x, w, b, gid, "gelu_tanh",
                                             return_z=True)
        got_a, snap = autograd("cuda")
        got_k, got_a = [t.cpu() for t in got_k], [t.cpu() for t in got_a]
        if first_k is None:
            first_k, first_a = got_k, got_a
        differ_k += not all(torch.equal(a, c) for a, c in zip(got_k, first_k))
        differ_a += not all(torch.equal(a, c) for a, c in zip(got_a, first_a))
        moved += not torch.equal(snap.cpu(), got_a[0])
        bad = False
        for t, r in zip(got_k, want_k):
            d = (t - r).abs()
            off = d > 1e-4 + 1e-4 * r.abs()
            bad |= bool(off.any())
            where.update(("kernel", *map(int, p)) for p in off.nonzero())
            worst = max(worst, float(d.max()))
        miss_k += bad
        bad = False
        for t, r, tol, name in zip(got_a, want_a, tols,
                                   ("out", "dx", "dw", "db")):
            d = (t - r).abs()
            off = d > tol + 1e-4 * r.abs()
            bad |= bool(off.any())
            where.update((name, *map(int, p)) for p in off.nonzero())
        miss_a += bad
    res = dict(reps=reps, kernel_differs_from_first=differ_k,
               autograd_differs_from_first=differ_a,
               kernel_misses=miss_k, autograd_misses=miss_a,
               out_changed_by_backward=moved,
               kernel_max_abs_err=worst, miss_elements=sorted(where)[:20])
    say(f"  grouped f32 repeats: {json.dumps(res)}")
    return res


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


def lora_route(ops, n0):
    """The route of the SGMV launch made since the counts ``n0`` (a tuple
    of `lora_route_counts`): one of `ROUTES`."""
    fn = ops.fused_lora_segment_epilogue
    now = lora_route_counts(ops)
    moved = [name for name, a, b in zip(ROUTES, n0, now) if b != a]
    if len(moved) != 1:
        fail(f"lora_sgmv: route counts {n0} -> {now} after one launch "
             f"({fn.launches} launches)")
    return moved[0]


def lora_route_counts(ops):
    fn = ops.fused_lora_segment_epilogue
    return (fn.mma_launches, fn.f32_launches, fn.f16_launches,
            fn.elementwise_launches)


def check_lora(ops, case, dtype, dtype_name, gen, rows):
    """The SGMV epilogue at one of `LORA_CASES` (the serving step's mixed
    blocks over `LORA_SLOTS` slots) or `LORA_TRAIN_CASES` (one adapter
    owning every block, as fine-tuning's single-adapter path runs it)
    against its plain version (out; the saved sum against the plain
    version without activation, and equal to z on null rows); run twice,
    bit-identical; bf16 must take the tensor-core route, f32 its own.  No
    single PyTorch call computes it; the note times a one-adapter
    composite (``torch.mm`` for x @ A, ``torch.addmm`` adding t @ B to z,
    the activation) as a yardstick.  Bound: z read and s written for
    every row (and out where act is not "none": with "none" out is s),
    x read for the adapter blocks' rows, the factors of the adapters in
    use; the note also gives the bound with out written as a third
    stream, as earlier runs counted it."""
    import torch
    from paddle_tpu_torch.ops import cuda_lib
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

    def composite():
        s = torch.addmm(z, torch.mm(x, a[0]), b[0])
        return s if act == "none" else ops.matmul_epilogue.act_f32(
            s.float(), act).to(dtype)
    n0 = lora_route_counts(ops)
    first = kernel()
    route = lora_route(ops, n0)
    want, s_want = plain(), plain("none")
    torch.cuda.synchronize()
    out, s = first
    err, rel, ok = compare(out, want, dtype_name)
    s_err, _, s_ok = compare(s, s_want, dtype_name)
    null = (gid == slots).repeat_interleave(bm)
    null_same = bool(torch.equal(s[null], z[null]))
    same = repeat_equal(kernel, first)
    want_route = WANT_ROUTE[dtype_name]
    ok = ok and s_ok and null_same and same and route == want_route
    spans = cuda_lib.library().ptt_lora_sgmv_spans(nb, N, x.device.index) \
        if route == "mma" else None
    used = sorted(set(aid) - {slots})
    real_rows = (nb - aid.count(slots)) * bm
    isz = x.element_size()
    streams = 2 if act == "none" else 3
    rest = real_rows * K + len(used) * r * (K + N)
    flops = 2 * real_rows * r * (K + N)
    bms, by = bound((streams * rows * N + rest) * isz, flops, dtype_name)
    bms3 = bound((3 * rows * N + rest) * isz, flops, dtype_name)[0]
    return dict(
        err=err, rel=rel, ok=ok,
        shape=(f"{case}: z[{rows},{N}] x[{rows},{K}] (bm {bm}, "
               f"{aid.count(slots)} of {nb} blocks null, adapters "
               f"{used} of {slots} slots) r {r} {act}"),
        note=(f"route {route} (want {want_route})"
              + (f", {spans} column spans" if spans else "")
              + f"; s vs plain max abs err {s_err:.3e}, null rows' s == z: "
              f"{null_same}; second run bit-identical: {same}; "
              f"{'out is s, ' if out is s else ''}bound with out as a "
              f"third stream {bms3:.4f} ms; library: none, no single "
              f"PyTorch call applies each row block's own adapter; "
              f"one-adapter composite (mm, addmm"
              f"{'' if act == 'none' else ', ' + act}) "
              f"{time_ms(composite):.4f} ms"),
        route=route, spans=spans, bound_ms_three_streams=bms3,
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
                  "lora_t": (1024, 16, False),
                  "lora_u_mixed": (3072, 16, True)}
#: lora_u_mixed: u's shape over the worst layout for a row tile, blocks
#: cycling over 4 adapters in unsorted order (as a multi-adapter
#: backward passes them), so that every tile holds 4 ids
LORA_MIXED_IDS = (2, 0, 3, 1)
LORA_DW_CASES = {"lora_dA": (1024, 16), "lora_dB": (16, 3072)}


def check_lora_grouped(ops, case, dtype, dtype_name, gen):
    """Row 14a at one of `LORA_BWD_CASES` (x [8192, K], w [L, N, K] read
    transposed, or w [L, K, N] as stored; L = 1, or 4 adapters over
    `LORA_MIXED_IDS` for lora_u_mixed) against its plain version, and a
    second run bit-identical to the first.  Library yardstick:
    ``torch.mm`` of x and the one adapter's factor; for the mixed case
    ``torch.bmm`` of each block against its adapter's factor (one call
    computing the same function)."""
    import torch
    K, N, trans = LORA_BWD_CASES[case]
    R = LORA_BWD_ROWS
    bm = ops.ragged_q_block(dtype)
    mixed = case == "lora_u_mixed"
    L = len(LORA_MIXED_IDS) if mixed else 1
    ids = [LORA_MIXED_IDS[i % L] for i in range(R // bm)] if mixed \
        else [0] * (R // bm)
    gid = torch.tensor(ids, dtype=torch.int32, device="cuda")
    x = torch.randn(R, K, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(L, *((N, K) if trans else (K, N)), device="cuda",
                     generator=gen) / K ** 0.5).to(dtype)

    def kernel():
        return ops.fused_grouped_linear_act(x, w, None, gid, "none",
                                            transpose_w=trans)
    wk = w.transpose(1, 2) if trans else w      # [1, K, N]

    def plain():
        return ops.grouped_linear_act_ref(x, wk, None, block_group=gid)

    if mixed:
        wb = wk[gid.long()]                     # [blocks, K, N]

        def lib_fn():
            return torch.bmm(x.view(-1, bm, K), wb).view(R, N)
    else:
        def lib_fn():
            return torch.mm(x, wk[0])
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if not torch.equal(got, kernel()):
        fail(f"grouped_matmul {dtype_name} {case}: two runs on the same "
             f"inputs differ")
    err, rel, ok = compare(got, want, dtype_name)
    lib_err = compare(lib_fn(), want, dtype_name)[0]
    isz = x.element_size()
    bms, by = bound((R * K + L * N * K + R * N) * isz, 2 * R * K * N,
                    dtype_name)
    return dict(
        err=err, rel=rel, ok=ok,
        shape=(f"{case}: x[{R},{K}] (bm {bm}, "
               + (f"blocks cycling over adapters {list(LORA_MIXED_IDS)}"
                  if mixed else "one adapter")
               + f") w[{L},{w.shape[1]},{w.shape[2]}]"
               + (" read transposed" if trans else "")),
        note=(f"library: {'torch.bmm over the blocks' if mixed else 'torch.mm'}"
              f", vs plain max abs err {lib_err:.3e}"),
        ms=time_ms(kernel), plain_ms=time_ms(plain, iters=5),
        library_ms=time_ms(lib_fn), bound_ms=bms, bound_by=by)


def check_lora_dw(ops, case, dtype, dtype_name, gen):
    """Row 14b at one of `LORA_DW_CASES` (x [8192, K], dz [8192, N], one
    adapter: the rows split into `grouped_dw_slices` slices) against its
    plain version, as a column sum (`SUM_TOL`), and a second run
    bit-identical to the first.  Library yardstick: ``torch.mm(x^T,
    dz)``."""
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
    if not torch.equal(got, kernel()):
        fail(f"grouped_matmul_dw {dtype_name} {case}: two runs on the same "
             f"inputs differ")
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


#: paged decode attention: "decode", phase 25's decode step (GPT_1P3B: 16
#: heads of 128, block 16): 4 sequences at contexts 129-192 plus one at
#: context 0, tables 16 wide (padding entries point at block 0); "long",
#: a long decode: 4 sequences of 4096 keys, tables 256 wide.  (contexts,
#: heads, head_dim, block_size, table width)
PAGED_CASES = {"decode": ((129, 150, 171, 192, 0), 16, 128, 16, 16),
               "long": ((4096,) * 4, 16, 128, 16, 256)}


def paged_routes(ops):
    fn = ops.paged_attention
    return fn.vector_launches, fn.elementwise_launches


def check_paged(ops, dtype, dtype_name, gen, case="decode"):
    """Paged decode attention at one of `PAGED_CASES` against its plain
    version; bf16 also against the plain version run in f32
    (`RAGGED_BF16_F32P_TOL`: the kernel keeps the probabilities in f32).
    Run twice, bit-identical; it must take the vector route.  No single
    PyTorch call gathers the pages and attends.  Bound: q and the visible
    keys' rows of K and V read (not the rest of their last pages: the
    kernel reads only the rows below the context length), the output
    written; 4 operations per visible key element."""
    import torch
    ctxs, H, D, bs, W = PAGED_CASES[case]
    B = len(ctxs)
    pages = [-(-c // bs) for c in ctxs]
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
    ctx = torch.tensor(ctxs, dtype=torch.int32, device="cuda")

    def kernel():
        return ops.paged_attention(q, k, v, tables, ctx)

    def plain():
        return ops.paged_attention_ref(q, k, v, tables, ctx)
    n0 = paged_routes(ops)
    got = kernel()
    moved = [name for name, a, b in zip(("vector", "elementwise"), n0,
                                        paged_routes(ops)) if b != a]
    route = moved[0] if len(moved) == 1 else f"counts moved: {moved}"
    want = plain()
    torch.cuda.synchronize()
    err, rel, ok = compare(got, want, dtype_name)
    del want
    if 0 in ctxs:
        ok = ok and not bool(got[ctxs.index(0)].any())
    same = repeat_equal(kernel, got)
    ok = ok and same and route == "vector"
    note = (f"route {route} (want vector); second run bit-identical: "
            f"{same}; ")
    if dtype == torch.bfloat16:
        w32 = ops.paged_attention_ref(q.float(), k.float(), v.float(),
                                      tables, ctx)
        a, r_ = RAGGED_BF16_F32P_TOL
        rms = float(w32.pow(2).mean().sqrt())
        e32 = float((got.float() - w32).abs().max())
        ok = ok and bool(((got.float() - w32).abs()
                          <= a * rms + r_ * w32.abs()).all())
        note += f"vs plain in f32 max abs err {e32:.3e}; "
        del w32
    isz = q.element_size()
    nbytes = (2 * B * H * D + 2 * sum(ctxs) * H * D) * isz
    bms, by = bound(nbytes, 4 * sum(ctxs) * H * D, dtype_name)
    ctx_text = (f"{list(ctxs)}" if len(set(ctxs)) > 1
                else f"{B} x {ctxs[0]}")
    return dict(
        err=err, rel=rel, ok=ok, route=route,
        shape=(f"{case}: q[{B},1,{H},{D}] pools[{nb},{H},{bs},{D}] "
               f"contexts {ctx_text} tables [{B},{W}]"),
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
    # Transformer-base, post-norm: per encoder + decoder layer pair, the
    # two feed-forward epilogues, flash for encoder self-attention and
    # cross-attention (the decoder's causal self-attention takes the
    # composite), and 2 + 3 residual layer norms
    "matmul_epilogue": dict(
        source="paddle_tpu_torch/csrc/matmul_epilogue.cu",
        replaces="paddle_tpu/ops/pallas_fused.py:266",
        serve=(1, 0), train=(1, 0), train_flash=(2, 0), generate=(1, 0),
        bert_train=(1, 1), bert_parity=(1, 1), ernie_eval=(1, 0),
        lora_train=(1, 0), paged_decode=(1, 0), transformer_train=(2, 0),
        transformer_parity=(2, 0)),
    "layer_norm_bwd": dict(
        source="paddle_tpu_torch/csrc/layer_norm.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:536",
        train=(2, 1), train_flash=(2, 1), bert_train=(2, 2),
        bert_parity=(2, 2), moe_train=(2, 1), lora_train=(2, 0),
        transformer_train=(5, 0), transformer_parity=(5, 0)),
    "matmul_epilogue_bwd": dict(
        source="paddle_tpu_torch/csrc/matmul_epilogue.cu",
        replaces="paddle_tpu/ops/pallas_fused.py:278",
        train=(1, 0), train_flash=(1, 0), bert_train=(1, 1),
        bert_parity=(1, 1), lora_train=(1, 0), transformer_train=(2, 0),
        transformer_parity=(2, 0)),
    "softmax_xent_fwd": dict(
        source="paddle_tpu_torch/csrc/softmax_xent.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:759",
        train=(0, 1), train_flash=(0, 1), llama_train=(0, 1),
        bert_train=(0, 1), bert_parity=(0, 1), moe_train=(0, 1),
        lora_train=(0, 1), vision_parity=(0, 1), lenet_train=(0, 1),
        resnet50_train=(0, 1), googlenet_parity=(0, 3),
        googlenet_train=(0, 3), densenet_train=(0, 1), ptb_train=(0, 1)),
    "softmax_xent_bwd": dict(
        source="paddle_tpu_torch/csrc/softmax_xent.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:802",
        train=(0, 1), train_flash=(0, 1), llama_train=(0, 1),
        bert_train=(0, 1), bert_parity=(0, 1), moe_train=(0, 1),
        lora_train=(0, 1), vision_parity=(0, 1), lenet_train=(0, 1),
        resnet50_train=(0, 1), googlenet_parity=(0, 3),
        googlenet_train=(0, 3), densenet_train=(0, 1), ptb_train=(0, 1)),
    # train_flash recomputes every block's forward inside the backward,
    # so each forward kernel of a block launches twice per step
    "flash_attention_fwd": dict(
        source="paddle_tpu_torch/csrc/flash_attention.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:78",
        main="train_flash", train_flash=(2, 0), generate=(1, 0),
        llama_train=(2, 0), llama_gen=(1, 0), bert_parity=(1, 0),
        ernie_eval=(1, 0), lora_train=(1, 0), transformer_train=(2, 0),
        transformer_parity=(2, 0)),
    "flash_attention_bwd_dq": dict(
        source="paddle_tpu_torch/csrc/flash_attention.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:128",
        main="train_flash", train_flash=(1, 0), llama_train=(1, 0),
        bert_parity=(1, 0), lora_train=(1, 0), transformer_train=(2, 0),
        transformer_parity=(2, 0)),
    "flash_attention_bwd_dkv": dict(
        source="paddle_tpu_torch/csrc/flash_attention.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:170",
        main="train_flash", train_flash=(1, 0), llama_train=(1, 0),
        bert_parity=(1, 0), lora_train=(1, 0), transformer_train=(2, 0),
        transformer_parity=(2, 0)),
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
        ernie_eval=(2, 0), transformer_train=(5, 0),
        transformer_parity=(5, 0)),
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
    "paged_decode", "vision_parity", "lenet_train", "resnet50_train",
    "googlenet_parity", "googlenet_train" (the main head's and the two
    aux heads' losses: rows 8a/8b 3 a step), "densenet_train",
    "transformer_train", "transformer_parity" (``layers``: encoder and
    decoder layer pairs), "ptb_train", or
    "generate", "llama_gen" and "ernie_eval", whose step is one
    forward)."""
    return {name: info[drive][0] * layers + info[drive][1]
            if drive in info else 0 for name, info in KERNEL_INFO.items()}


def check_counts(phase, ops, counts, steps, layers, drive, show=True,
                 routes=True):
    """Each kernel's launches in a drive against its launches per step
    times the steps (``show``: the counts printed); then, with
    ``routes``, `check_routes`."""
    want = per_step(drive, layers)
    if show:
        say(f"  launches {counts}; per step {want}")
    for name, n in counts.items():
        if want[name] and n == 0:
            fail(f"{phase}: kernel {name} was never launched")
        if n != want[name] * steps:
            fail(f"{phase}: {name} launched {n} times in {steps} steps, "
                 f"expected {want[name]} per step")
    if routes:
        check_routes(phase, ops)


def check_profiled_counts(phase, profile, layers, drive):
    """Each kernel of ``drive`` as the profiler saw it launched in a
    profiled window (``split_profile``'s ``launches``), per step and
    rounded, against its launches per step.  A captured step's wrapper
    counts are the capture's, added again at each replay (``jit.trace``);
    the profiler sees what each replay ran, so this holds them to the
    card.  Rounded, because the profiler can miss the first kernels of
    its window (phase 38's bursts, eager and captured: the first step's
    first layer norm and qkv projection), while a launch that a graph
    lacks or repeats is off at every replay, a whole launch per step."""
    want = per_step(drive, layers)
    if profile is None:
        fail(f"{phase}: the profiler saw no device time, so the launches "
             f"of the profiled window are not observed")
    seen = profile["launches"]
    steps = profile["steps"]
    say(f"  profiled launches {seen} in {steps} steps")
    for name, n in want.items():
        if n and round(seen.get(name, 0) / steps) != n:
            fail(f"{phase}: the profiler saw {name} launched "
                 f"{seen.get(name, 0)} times in {steps} steps, expected "
                 f"{n} per step")


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
    generator of their own; ragged attention, float and int8, at the
    other `RAGGED_CASES` (keys (name, dtype, case)), from a generator of
    their own."""
    import torch
    warm_up(ops)
    serve = {"ragged_attention": check_ragged,
             "layer_norm": check_layer_norm,
             "matmul_epilogue": check_matmul_epilogue}
    train = {"layer_norm": (check_layer_norm, TRAIN_ROWS),
             "matmul_epilogue": (functools.partial(check_matmul_epilogue,
                                                   with_z=True), TRAIN_ROWS),
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
    gen_me = torch.Generator(device="cuda").manual_seed(SEED + 3)
    gen_ln = torch.Generator(device="cuda").manual_seed(SEED + 12)
    gen_rg = torch.Generator(device="cuda").manual_seed(SEED + 14)
    gen_pg = torch.Generator(device="cuda").manual_seed(SEED + 15)
    gen_xv = torch.Generator(device="cuda").manual_seed(SEED + 30)
    for dtype, dtype_name in ((torch.bfloat16, "bfloat16"),
                              (torch.float32, "float32"),
                              (torch.float16, "float16")):
        block_q = ops.ragged_q_block(dtype)
        for name, check in serve.items():
            arg = block_q if name == "ragged_attention" \
                else budgets[dtype_name]
            r = check(ops, arg, dtype, dtype_name, gen)
            report(name, dtype_name, r)
            results[(name, dtype_name)] = r
        for case in RAGGED_CASES:
            if case != "mixed":
                r = check_ragged(ops, block_q, dtype, dtype_name, gen_rg,
                                 case=case)
                report("ragged_attention", dtype_name, r)
                results[("ragged_attention", dtype_name, case)] = r
        r = check_matmul_epilogue(ops, ME_DECODE_ROWS, dtype, dtype_name,
                                  gen_me)
        report("matmul_epilogue", dtype_name, r)
        results[("matmul_epilogue", dtype_name, "decode")] = r
        rows, K, N, act = ME_TRANSFORMER
        r = check_matmul_epilogue(ops, rows, dtype, dtype_name, gen_me,
                                  with_z=True, K=K, N=N, act=act)
        report("matmul_epilogue", dtype_name, r)
        results[("matmul_epilogue", dtype_name, "transformer")] = r
        for case, (rows, n) in LN_RES_CASES.items():
            r = check_layer_norm_residual(ops, rows, dtype, dtype_name,
                                          gen_me, n=n)
            report("layer_norm_residual", dtype_name, r)
            results[("layer_norm_residual", dtype_name, case)] = r
        for name, (check, rows) in train.items():
            r = check(ops, rows, dtype, dtype_name, gen)
            report(name, dtype_name, r)
            results[(name, dtype_name, "train")] = r
            torch.cuda.empty_cache()
        for case, (rows, vocab) in XENT_VISION_CASES.items():
            for name, check in (("softmax_xent_fwd", check_softmax_xent_fwd),
                                ("softmax_xent_bwd",
                                 check_softmax_xent_bwd)):
                r = check(ops, rows, dtype, dtype_name, gen_xv, vocab)
                report(name, dtype_name, r)
                results[(name, dtype_name, case)] = r
        for case, (rows, n) in LN_CASES.items():
            for name, check in (("layer_norm", check_layer_norm),
                                ("layer_norm_bwd", check_layer_norm_bwd)):
                r = check(ops, rows, dtype, dtype_name, gen_ln, n=n)
                report(name, dtype_name, r)
                results[(name, dtype_name, case)] = r
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
        for case in RAGGED_CASES:
            if case != "mixed":
                r = check_ragged_int8(ops, block_q, dtype, dtype_name,
                                      gen_rg, case=case)
                twin = results[("ragged_attention", dtype_name, case)]
                r["note"] += (f"; the float kernel at this shape "
                              f"{twin['ms']:.4f} ms")
                report("ragged_attention_int8", dtype_name, r)
                results[("ragged_attention_int8", dtype_name, case)] = r
        for case in INT8_CASES:
            if case != "fc1":
                r = check_matmul_epilogue_int8(ops, budgets[dtype_name],
                                               dtype, dtype_name, gen8, case)
                report("matmul_epilogue_int8", dtype_name, r)
                results[("matmul_epilogue_int8", dtype_name, case)] = r
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
        if dtype == torch.float32:
            rep = check_grouped_repeats(ops)
            if rep["kernel_misses"] or rep["autograd_misses"] \
                    or rep["kernel_differs_from_first"] \
                    or rep["autograd_differs_from_first"] \
                    or rep["out_changed_by_backward"]:
                fail("grouped f32 repeats: a repetition missed or differed")
            results["grouped_repeats"] = rep
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
        for case in PAGED_CASES:
            if case != "decode":
                r = check_paged(ops, dtype, dtype_name, gen_pg, case)
                report("paged_attention", dtype_name, r)
                results[("paged_attention", dtype_name, case)] = r
        for case, (rows, n, act) in ME_BWD_CASES.items():
            r = check_matmul_epilogue_bwd(ops, rows, dtype, dtype_name,
                                          gen_pg, n=n, act=act)
            report("matmul_epilogue_bwd", dtype_name, r)
            results[("matmul_epilogue_bwd", dtype_name, case)] = r
            torch.cuda.empty_cache()
    reset_routes(ops)       # the drives' launches are counted from here
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


def norm_routed(ops):
    """The norm kernels' wrappers that count launches by vector and scalar
    route: layer norm forward and backward, the residual layer norm and
    the RMS norm backward (rows 2, 6, 13 and 12)."""
    return {"layer_norm": ops.fused_layer_norm,
            "layer_norm_bwd": ops.fused_layer_norm_bwd,
            "layer_norm_residual": ops.fused_layer_norm_residual,
            "rms_norm_bwd": ops.fused_rms_norm_bwd}


def reset_routes(ops):
    """Zero the launch counts by route (`check_routes`)."""
    for fn in (ops.fused_linear_act, ops.fused_linear_act_int8):
        fn.tma_launches = fn.elementwise_launches = 0
    for fn in norm_routed(ops).values():
        fn.vector_launches = fn.scalar_launches = 0
    for fn in (ops.fused_lora_segment_epilogue, ops.ragged_paged_attention,
               ops.ragged_paged_attention_int8):
        fn.mma_launches = fn.f32_launches = fn.elementwise_launches = 0
        fn.f16_launches = 0
    for fn in (ops.paged_attention, ops.fused_linear_act_bwd):
        fn.vector_launches = fn.elementwise_launches = 0


def check_routes(phase, ops):
    """The launches by route since `reset_routes` (at the end of phase 2,
    so every launch counted is a drive's, at a model shape): every bf16
    matmul epilogue launch must have staged by TMA, every layer-norm
    launch (forward, backward and the residual forward) and every RMS
    norm backward launch must have taken the vector route, and
    no LoRA SGMV launch and no ragged attention launch, float or int8,
    the element-wise route (bf16 takes the tensor cores, f32 its own
    route), nor any paged attention or matmul epilogue backward launch
    (both take the vector route at every model shape)."""
    epilogue = {name: (fn.tma_launches, fn.elementwise_launches)
                for name, fn in
                (("matmul_epilogue", ops.fused_linear_act),
                 ("matmul_epilogue_int8", ops.fused_linear_act_int8))}
    norm = {name: (fn.vector_launches, fn.scalar_launches)
            for name, fn in norm_routed(ops).items()}
    lora = lora_route_counts(ops)
    ragged = {name: ragged_route_counts(ops, int8) for name, int8 in
              (("ragged_attention", False), ("ragged_attention_int8", True))}
    vector = {"paged_attention": paged_routes(ops),
              "matmul_epilogue_bwd": epilogue_bwd_routes(ops)}
    say("  launches by route since phase 2: bf16 epilogue (TMA, "
        "element-wise) "
        + ", ".join(f"{n} {c}" for n, c in epilogue.items())
        + "; norms (vector, scalar) "
        + ", ".join(f"{n} {c}" for n, c in norm.items())
        + f"; lora_sgmv (mma, f32, f16, element-wise) {lora}; ragged "
        "attention (mma, f32, f16, element-wise) "
        + ", ".join(f"{n} {c}" for n, c in ragged.items())
        + "; (vector, element-wise) "
        + ", ".join(f"{n} {c}" for n, c in vector.items()))
    if any(c[1] for c in epilogue.values()):
        fail(f"{phase}: a model-shape epilogue launch staged element by "
             f"element: {epilogue}")
    if any(c[1] for c in norm.values()):
        fail(f"{phase}: a model-shape norm launch took the scalar route: "
             f"{norm}")
    if lora[-1]:
        fail(f"{phase}: a model-shape LoRA SGMV launch took the "
             f"element-wise route: {lora}")
    if any(c[-1] for c in ragged.values()):
        fail(f"{phase}: a model-shape bf16 ragged attention launch took "
             f"the element-wise route: {ragged}")
    if any(c[1] for c in vector.values()):
        fail(f"{phase}: a model-shape paged attention or epilogue backward "
             f"launch took the element-wise route: {vector}")


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
    check_counts(phase, ops, counts, steps, cfg.num_hidden_layers,
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


def serve_trace(cfg):
    """Phase 4's trace: 16 prompts sharing a 512-token prefix, and the 2
    warm-up prompts."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    shared = list(rng.integers(1, cfg.vocab_size, size=512))
    prompts = [shared + list(rng.integers(
        1, cfg.vocab_size, size=int(rng.integers(4, 64))))
        for _ in range(16)]
    warm = [list(rng.integers(1, cfg.vocab_size, size=40))
            for _ in range(2)]
    return prompts, warm


def phase_serving(pt, ops, int8=False, base=None, moe=False, dtype=None,
                  keep=None):
    """GPT_1P3B in bf16 served by the engine (phase 4).  With ``int8``
    (phase 13) the same weights and trace with int8 weights and an int8
    KV pool, held against ``base``, phase 4's summary.  With ``moe``
    (phase 18) MoE-GPT at GPT_1P3B's width (E = 4, top 2) on the same
    trace, with each step's per-expert counts and their imbalance, beside
    ``base``.  ``dtype`` serves another element type (phase 42: f16),
    and ``keep`` (a dict) receives the model's weights on the CPU.
    Returns (launch counts, summary, the generated tokens of each
    request)."""
    import numpy as np
    import torch
    dtype = torch.bfloat16 if dtype is None else dtype
    phase = "moe serving" if moe else "int8 serving" if int8 else "serving"
    drive = "serve_moe" if moe else "serve_int8" if int8 else "serve"
    torch.cuda.reset_peak_memory_stats()
    if moe:
        cfg = moe_serve_cfg(pt)
        model = pt.MoEGPTForCausalLM(cfg, dtype=dtype, seed=SEED)
    else:
        cfg = pt.GPTConfig(**pt.GPT_1P3B)
        model = pt.GPTForCausalLM(cfg, dtype=dtype, seed=SEED)
    if keep is not None:
        keep.update({k: v.cpu() for k, v in model.state_dict().items()})
    prompts, warm = serve_trace(cfg)
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

    # each MoE layer's per-expert counts, per dispatched step: read after
    # the step (a forward hook would run only when the step is captured,
    # not at its replays; the layers' ``counts`` are the captured outputs,
    # which each replay writes)
    routed = []
    reset_launches(ops)
    t0 = time.perf_counter()
    ids = [eng.add_request(p, max_new_tokens=64) for p in prompts]
    while eng.has_unfinished():
        n0 = eng._steps_dispatched
        eng.step()
        if moe and eng._steps_dispatched > n0:
            routed.extend(blk.mlp.counts.clone() for blk in model.gpt.h)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = launches(ops)

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
    check_counts(phase, ops, counts, steps, cfg.num_hidden_layers, drive)
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
    check_profiled_counts(phase, summary["profile"], cfg.num_hidden_layers,
                          drive)
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
#: is int8_t, "signed char", come before their float twins); layer_norm,
#: layer_norm_bwd, layer_norm_residual, rms_norm_bwd, paged_attention and
#: matmul_epilogue_bwd hold both routes of each, lora_sgmv its three (the
#: element-wise and f32 routes share lora_sgmv_kernel); column_sum is the
#: second pass of the column sums that take one
#: (`column_sum_sliced_kernel`: rows 6 and 12; `column_sum_kernel`: row
#: 14b and row 7's element-wise route; row 7's vector route adds its own
#: in its last blocks), and
#: splitk_epilogue the second pass of a split-K matmul epilogue (int8 or
#: float: its instantiations do not say which)
_PROFILE_GROUPS = (("lora_sgmv", ("lora_sgmv_kernel",
                                   "lora_sgmv_mma_kernel")),
                   ("paged_attention", ("paged_attn_kernel",
                                        "paged_attn_vec_kernel")),
                   ("grouped_matmul", "gmm_fwd_"),
                   ("grouped_matmul_dw", "gmm_dw_"),
                   ("ragged_attention_int8",
                    ("ragged_attn_kernel<float, signed char>",
                     "ragged_attn_kernel<__nv_bfloat16, signed char>",
                     "ragged_attn_mma_kernel<signed char")),
                   ("matmul_epilogue_int8",
                    ("me_fwd_wgmma<signed char",
                     "me_fwd_fma<float, signed char",
                     "me_fwd_fma<__nv_bfloat16, signed char")),
                   ("ragged_attention", ("ragged_attn_kernel",
                                         "ragged_attn_mma_kernel")),
                   ("layer_norm_residual", ("ln_res_fwd_vec_kernel",
                                            "layer_norm_residual_fwd_kernel")),
                   ("layer_norm", ("ln_fwd_vec_kernel",
                                   "layer_norm_fwd_kernel")),
                   ("layer_norm_bwd", ("ln_bwd_vec_kernel",
                                       "layer_norm_bwd_kernel")),
                   ("matmul_epilogue", "me_fwd_"),
                   ("matmul_epilogue_bwd", ("me_bwd_kernel",
                                            "me_bwd_vec_kernel")),
                   ("column_sum", ("column_sum_kernel",
                                   "column_sum_sliced_kernel")),
                   ("splitk_epilogue", "splitk_epilogue_kernel"),
                   ("softmax_xent_fwd", "xent_fwd_kernel"),
                   ("softmax_xent_bwd", "xent_bwd_kernel"),
                   ("flash_attention_fwd", "flash_fwd_kernel"),
                   ("flash_attention_bwd_dq", "flash_bwd_dq_kernel"),
                   ("flash_attention_bwd_dkv", "flash_bwd_dkv_kernel"),
                   ("rms_norm", "rms_norm_fwd_kernel"),
                   ("rms_norm_bwd", ("rms_bwd_vec_kernel",
                                     "rms_norm_bwd_kernel")),
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


def split_profile(prof_wall, steps, what, kernel_groups=_PROFILE_GROUPS):
    """Device time by kernel group (``kernel_groups``) and the device's
    idle share over a profiled window of ``steps`` steps, and each group's
    kernel launches as the profiler saw them (``launches``: a CUDA graph's
    replay shows each kernel it runs).  The profiler's own overhead
    inflates the wall time, so the idle share is an upper bound."""
    from torch.autograd import DeviceType
    prof, wall_ms = prof_wall
    groups = {name: 0.0 for name, _ in kernel_groups}
    groups["other"] = 0.0
    seen = {name: 0 for name, _ in kernel_groups}
    others = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        name = evt.key
        for group, keys in kernel_groups:
            if any(k in name for k in ((keys,) if isinstance(keys, str)
                                       else keys)):
                groups[group] += us / 1e3
                seen[group] += evt.count
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
               launches={k: n for k, n in seen.items() if n},
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
                     device, clip=True, steps=3, track_small=False,
                     make_opt=None, quiet=False):
    """Losses, step-1 gradients and final parameters of ``steps`` AdamW
    steps (global-norm clip 1.0 with ``clip``) of ``make_model(device)``
    on ``device``, with ``loss_of(model, ids, labels)`` as the loss, the
    launch counts of the run, (with ``track_small``) for each parameter
    the elements whose gradient was, at some step, within the gradient
    gate of 0 (at most ``PARITY_TOL["grad"]`` of that gradient's largest
    magnitude), and the number of forward/backward evaluations.
    ``make_opt(model)`` builds another optimizer: its scheduler, if any,
    steps after each step (``ReduceOnPlateau`` on the loss), and an LBFGS
    steps on a closure (its step-1 gradients are its first
    evaluation's)."""
    import torch
    model = make_model(device)
    pt.load_reference_state(model, params)
    opt = make_opt(model) if make_opt is not None else pt.optimizer.AdamW(
        learning_rate=PARITY_LR, weight_decay=0.01,
        parameters=model.parameters(),
        grad_clip=pt.nn.ClipGradByGlobalNorm(1.0) if clip else None)
    x, y = (torch.from_numpy(a).to(device) for a in (ids, labels))
    reset_launches(ops)
    t0 = time.perf_counter()
    losses, small, seen = [], {}, dict(evals=0, grads=None)

    def evaluate():
        loss = loss_of(model, x, y)
        loss.backward()
        seen["evals"] += 1
        if seen["grads"] is None:
            seen["grads"] = {n: p.grad.detach().cpu().clone()
                             for n, p in model.named_parameters()
                             if p.grad is not None}
        for n, p in model.named_parameters() if track_small else ():
            if p.grad is None:
                continue
            g = p.grad.detach().abs()
            m = (g <= PARITY_TOL["grad"] * g.max()).cpu()
            small[n] = small[n] | m if n in small else m
        return loss

    lr = pt.optimizer.lr
    for step in range(steps):
        if isinstance(opt, pt.optimizer.LBFGS):
            def closure():
                opt.clear_grad()
                return evaluate()
            loss = opt.step(closure)
        else:
            loss = evaluate()
            opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        sched = opt._learning_rate
        if isinstance(sched, lr.ReduceOnPlateau):
            sched.step(losses[-1])
        elif isinstance(sched, lr.LRScheduler):
            sched.step()
    if device == "cuda":
        torch.cuda.synchronize()
    counts = launches(ops)
    if not quiet:
        say(f"  {device}: {steps} steps in {time.perf_counter() - t0:.2f} s, "
            f"losses {losses}")
    final = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    return losses, seen["grads"], final, counts, small, seen["evals"]


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
    out = hold_parity(phase, params, runs, sign_free, frozen)
    check_counts(phase, ops, runs["cuda"][3], 3, layers, drive)
    return out


def excess(got, want):
    """The largest ``|got - want| - rtol |want|`` over the tensors (0 at
    least), with `PARITY_TOL`'s parameter rtol, and where it is ("-"
    where nothing exceeds 0)."""
    rtol = PARITY_TOL["param"][1]
    return max([(0.0, "-")] + [
        (float(((got[n] - w).abs() - rtol * w.abs()).max()), n)
        for n, w in want.items()])


def grad_readings(got, want, zero_grads=None):
    """The largest error of each gradient of ``got`` against ``want``
    over that gradient's largest magnitude in ``want``, or, for the names
    ``zero_grads`` accepts (gradients that are exactly 0: a batch norm's
    bias whose output a 1 x 1 convolution feeds to another batch norm in
    training mode), over the largest magnitude of every gradient; the
    worst, with its name."""
    top = max(float(g.abs().max()) for g in want.values())
    return max((float((got[n] - g).abs().max()) / (
        top if zero_grads and zero_grads(n)
        else max(float(g.abs().max()), 1e-30)), n)
        for n, g in want.items())


def hold_parity(phase, params, runs, sign_free=False, frozen=None,
                quiet=False, step_bound=PARITY_LR, zero_grads=None):
    """`train_parity`'s gates on its two runs (``runs["cuda"]`` and
    ``runs["cpu"]``, from `train_parity_run`): the losses, step-1
    gradients (`grad_readings`, with ``zero_grads``) and final parameters
    within `PARITY_TOL`, with the ``sign_free`` (a largest step of
    ``step_bound``) and ``frozen`` holds.  ``quiet`` prints one line."""
    import torch
    (l_gpu, g_gpu, p_gpu, _, _, _), (l_cpu, g_cpu, p_cpu, _, small, _) = \
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
        key_note = hold_sign_free(phase, small, p_gpu, p_cpu,
                                  steps=len(l_cpu), step_bound=step_bound)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    grad_err, grad_at = grad_readings(g_gpu, g_cpu, zero_grads)
    atol, rtol = PARITY_TOL["param"]
    worst, worst_at = excess(p_gpu, p_cpu)
    if quiet:
        say(f"  {phase}: loss {loss_err:.2e}, grad {grad_err:.2e}, param "
            f"excess {worst:.2e} at {worst_at}{key_note}")
    else:
        say(f"  loss max rel err {loss_err:.3e} (tolerance "
            f"{PARITY_TOL['loss']:g}); step-1 grads max err / max |grad| "
            f"{grad_err:.3e} at {grad_at} (tolerance "
            f"{PARITY_TOL['grad']:g}); params after {len(l_cpu)} steps max "
            f"(|err| - {rtol:g}*|p|) {worst:.3e} at {worst_at} "
            f"(tolerance {atol:g}){key_note}")
    if loss_err > PARITY_TOL["loss"]:
        fail(f"{phase}: losses {l_gpu} on CUDA vs {l_cpu} on CPU")
    if grad_err > PARITY_TOL["grad"]:
        fail(f"{phase}: gradient of {grad_at} differs by "
             f"{grad_err:.3e} of its largest value")
    if worst > atol:
        fail(f"{phase}: parameter {worst_at} differs after {len(l_cpu)} "
             f"steps by {worst:.3e} past {rtol:g}*|p|")
    return dict(loss_max_rel_err=loss_err, grad_max_rel_err=grad_err,
                param_max_excess=worst, losses_cuda=l_gpu,
                losses_cpu=l_cpu)


def hold_sign_free(phase, small, p_gpu, p_cpu, steps=3,
                   step_bound=PARITY_LR):
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
    constant).  ``step_bound`` is the largest step such an element can
    take (the learning rate for Adam's family)."""
    import torch
    bound = 2 * steps * step_bound
    worst, count = 0.0, 0
    for n, m in small.items():
        if not bool(m.any()):
            continue
        d = float((p_gpu[n] - p_cpu[n]).abs()[m].max())
        if d > bound:
            fail(f"{phase}: {n} differs by {d:.3e} after {steps} steps where "
                 f"its gradient was ~0, past 2 * {steps} * {step_bound:g}")
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


def drive_training(ops, step, n_params, B, L, H, phase, drive, S=TRAIN_S,
                   steps=TRAIN_STEPS, flops=None):
    """`TRAIN_WARMUP` untimed calls of ``step`` (one training step that
    returns its loss), then ``steps`` timed ones at batch ``B`` of ``S``
    tokens: ms/step, tokens/s, MFU (6N + 12LSH flops per token against the
    bf16 peak, or ``flops``, a (flop per step, formula) pair; none when
    ``n_params`` is None), peak memory;
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
    losses += [step() for _ in range(steps)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = launches(ops)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses]
    step_ms = elapsed / steps * 1e3
    tokens_per_s = B * S * steps / elapsed
    if flops is not None:
        mfu = flops[0] * steps / elapsed / PEAK_BF16
        mfu_note = (f"{n_params / 1e6:.1f}M params, MFU {mfu:.4f} "
                    f"({flops[1]} = {flops[0]:.4e} flop/step vs "
                    f"{PEAK_BF16:.3g} flop/s)")
    elif n_params is None:
        mfu, mfu_note = None, "no MFU"
    else:
        flops_per_token = 6 * n_params + 12 * L * S * H
        mfu = flops_per_token * tokens_per_s / PEAK_BF16
        mfu_note = (f"{n_params / 1e6:.1f}M params, MFU {mfu:.4f} (6N + "
                    f"12LSH = {flops_per_token:.4e} flop/token vs "
                    f"{PEAK_BF16:.3g} flop/s)")
    say(f"  B={B} S={S}: warm-up {TRAIN_WARMUP} steps {warm_s:.2f} s; "
        f"{steps} steps in {elapsed:.3f} s: {step_ms:.2f} ms/step, "
        f"{tokens_per_s:.1f} tokens/s, {mfu_note}, peak memory "
        f"{peak_gib:.2f} GiB; losses {losses}")
    if not all(np.isfinite(losses)):
        fail(f"{phase}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{phase}: the loss did not fall on a repeated batch: "
             f"{losses}")
    check_counts(phase, ops, counts, steps, L, drive)
    summary = dict(n_params=n_params, batch=B, seq=S,
                   steps=steps, step_ms=step_ms,
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
    check_counts(phase, ops, counts, GEN_PARITY_NEW, layers, drive)
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
    check_counts(phase, ops, counts, GEN_NEW, cfg.num_hidden_layers, drive)
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
    check_counts("ernie parity", ops, counts, 1, cfg.num_hidden_layers,
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
    check_counts("ernie eval", ops, counts, ERNIE_FORWARDS,
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
    check_counts(phase, ops, counts, steps, cfg.num_hidden_layers,
                 "serve_moe")
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
    check_counts(phase, ops, counts, steps, cfg.num_hidden_layers,
                 "serve_lora")
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
    the base-model rows (reported: fc1 runs another kernel there).
    Returns (launch counts, summary, each twin's generated tokens)."""
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
        check_counts(phase, ops, c, steps, L,
                     "serve_lora" if twin == "lora" else "serve")
        if twin == "lora":
            counts = c
        steps0 = eng.stats()["steps"]
        prof = profile_device(lambda: serve_requests(eng, reqs[:8],
                                                     max_new=16))
        out["profile"] = split_profile(prof, eng.stats()["steps"] - steps0,
                                       f"{twin} burst")
        check_profiled_counts(phase, out["profile"], L,
                              "serve_lora" if twin == "lora" else "serve")
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
    return counts, summary, generated


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
    check_counts("paged parity", ops, counts, PAGED_PARITY_STEPS,
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
    check_counts("paged decode", ops, counts, GEN_NEW, cfg.num_hidden_layers,
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


# ---------------------------------------------------------------------
# phase 26: bf16 parity, GPT at full width, 2 layers
# ---------------------------------------------------------------------
#: bf16 O1 on the card against the CPU's plain run: the losses' largest
#: relative error, the step-1 gradients' largest error over that
#: gradient's largest magnitude, and the error norm of the 3 AdamW steps'
#: parameter updates over the updates' norm, all parameters together (Adam
#: moves each element by about lr a step, so an element's largest error
#: says only whether its sign flipped: the qkv biases' key slices, whose
#: gradient is 0 in exact arithmetic, flip on either side).  The two
#: sides round to bf16 at the same ops (O1's white list) but sum in other
#: orders, and the card's flash kernels round P and dS to bf16 where the
#: plain version keeps f32, so agreement is to bf16 precision.  Each gate
#: lies between this run's reading and the control's, the card run with
#: fc1's bias dropped (its weights zeroed: what an epilogue that lost the
#: bias would compute), which must fail every gate.  Readings on an H100
#: 80GB HBM3 at 700 W: 7.15e-5, 7.25e-3, 2.42e-2; control 4.40e-4,
#: 9.31e-2, 0.113.
BF16_PARITY_TOL = dict(loss=2e-4, grad=2.5e-2, update=5e-2)


def bf16_parity_readings(run, cpu, start, cpu_start):
    """`BF16_PARITY_TOL`'s readings of a card run against the CPU's (the
    updates each from its own starting weights), and the largest
    parameter error."""
    import torch
    (l_a, g_a, p_a), (l_b, g_b, p_b) = run[:3], cpu[:3]
    loss = max(abs(a - b) / abs(b) for a, b in zip(l_a, l_b))
    grad = max((float((g_a[n] - g_b[n]).abs().max())
                / max(float(g_b[n].abs().max()), 1e-30), n) for n in g_b)
    du = uu = 0.0
    for n in p_b:
        u_a = p_a[n] - torch.from_numpy(start[n])
        u_b = p_b[n] - torch.from_numpy(cpu_start[n])
        du += float((u_a - u_b).square().sum())
        uu += float(u_b.square().sum())
    param = max(float((p_a[n] - p_b[n]).abs().max()) for n in p_b)
    return dict(loss=loss, grad=grad[0], grad_at=grad[1],
                update=(du / uu) ** 0.5, param_max_abs_err=param)


def hold_bf16_gates(phase, runs, start, control_start, tol, control):
    """`bf16_parity_readings` of the card run (``runs["card"]``) and of the
    control (``runs["control"]``, ``control`` naming what it drops)
    against the CPU's: each reading within ``tol``, each of the control's
    past it."""
    got = bf16_parity_readings(runs["card"], runs["cpu"], start, start)
    ctl = bf16_parity_readings(runs["control"], runs["cpu"], control_start,
                               start)
    say(f"  losses card {runs['card'][0]}, CPU {runs['cpu'][0]}, control "
        f"({control}) {runs['control'][0]}")
    for key in tol:
        where = f" at {got[key + '_at']} (control at {ctl[key + '_at']})" \
            if key + "_at" in got else ""
        say(f"  {key}: {got[key]:.3e}, control {ctl[key]:.3e}, tolerance "
            f"{tol[key]:g}{where}")
    say(f"  params after 3 steps max |err| {got['param_max_abs_err']:.3e} "
        f"(control {ctl['param_max_abs_err']:.3e}), reported")
    for key, bound_ in tol.items():
        if got[key] > bound_:
            fail(f"{phase}: {key} reading {got[key]:.3e} over {bound_:g}")
        if ctl[key] <= bound_:
            fail(f"{phase}: the control's {key} reading {ctl[key]:.3e} is "
                 f"within {bound_:g}: the gate cannot see {control}")
    return got, ctl


#: bf16 LoRA fine-tuning against the CPU (phase 26's second part): the
#: readings of `BF16_PARITY_TOL` over phase 23's model (2 layers at the
#: multi-LoRA width, base frozen, rank 16) under O1, where the LoRA
#: factors are the only parameters that move.  Each gate lies between the
#: card run's reading and the control's (near their geometric mean), the
#: card run with qkv's B factors zeroed (what an epilogue that lost the
#: adapter term would compute), which must fail every gate.  Readings on
#: an H100 80GB HBM3 at 700 W: 1.08e-4, 6.41e-3, 3.31e-2; control
#: 9.71e-4, 1.0 (its qkv A gets no gradient at step 1), 0.540.
BF16_LORA_PARITY_TOL = dict(loss=3e-4, grad=8e-2, update=0.13)


def bf16_lora_parity(pt, ops):
    """Phase 23's model in bf16 on the card against the port's CPU plain
    run from the same numpy weights (A and B too) and inputs: 3 AdamW
    steps with f32 master weights under ``auto_cast(bf16, O1)``, held to
    `BF16_LORA_PARITY_TOL` with the control shown to fail each gate; the
    frozen base ends bit-unchanged on every run."""
    import numpy as np
    import torch
    phase = "bf16 lora parity"
    cfg = multilora_cfg(pt, num_hidden_layers=2)
    crit = pt.GPTPretrainingCriterion()

    def make(device):
        return lora_finetune_model(pt, cfg, device=device)

    def loss_of(model, x, y):
        with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
            return crit(model(x), y)

    rng = np.random.default_rng(SEED + 3)
    ids = rng.integers(0, cfg.vocab_size, (2, 128))
    labels = ids.copy()
    labels[0, :3] = -100
    params = numpy_weights(make("cpu"), SEED + 2)
    no_qkv = {n: np.zeros_like(a) if n.endswith("qkv_proj.lora_B") else a
              for n, a in params.items()}
    runs = {}
    for name, device, start in (("control", "cuda", no_qkv),
                                ("card", "cuda", params),
                                ("cpu", "cpu", params)):
        runs[name] = train_parity_run(pt, ops, make, loss_of, start, ids,
                                      labels, device)
        torch.cuda.empty_cache()
        frozen = [n for n in runs[name][2] if ".lora_" not in n]
        changed = [n for n in frozen if not torch.equal(
            runs[name][2][n], torch.from_numpy(start[n]))]
        if not frozen or changed:
            fail(f"{phase}: frozen parameters changed on the {name} run: "
                 f"{changed[:8]}")
    say(f"  {len(frozen)} frozen parameters bit-unchanged on every run; "
        f"{len(runs['cpu'][1])} factors got a gradient")
    if set(runs["card"][1]) != set(runs["cpu"][1]):
        fail(f"{phase}: gradients on one side only: "
             f"{sorted(set(runs['card'][1]) ^ set(runs['cpu'][1]))}")
    got, ctl = hold_bf16_gates(phase, runs, params, no_qkv,
                               BF16_LORA_PARITY_TOL, "qkv's B zeroed")
    check_counts(phase, ops, runs["card"][3], 3, cfg.num_hidden_layers,
                 "lora_train")
    return dict(losses_cuda=runs["card"][0], losses_cpu=runs["cpu"][0],
                losses_control=runs["control"][0], readings=got,
                control=ctl, tolerance=BF16_LORA_PARITY_TOL)


def phase_bf16_parity(pt, ops):
    """GPT_1P3B's width cut to 2 layers in bf16 on the card against the
    port's CPU plain run (which tier-1 holds to the reference) from the
    same numpy weights and inputs: 3 AdamW steps with f32 master weights
    under ``auto_cast(bf16, O1)``, flash attention and recompute (phase
    8's path), held to `BF16_PARITY_TOL`, and the control (the card run
    with fc1's bias dropped) shown to fail each gate; then the engine
    with bf16 weights on phase 3's 4 requests, 16 greedy tokens each, the
    token match ratio reported; then `bf16_lora_parity`."""
    import numpy as np
    import torch
    phase = "bf16 parity"
    cfg = pt.GPTConfig(**dict(pt.GPT_1P3B, num_hidden_layers=2,
                              use_flash_attention=True, use_recompute=True))
    crit = pt.GPTPretrainingCriterion()

    def loss_of(model, x, y):
        with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
            return crit(model(x), y)

    rng = np.random.default_rng(SEED + 3)
    ids = rng.integers(0, cfg.vocab_size, (2, 128))
    labels = ids.copy()
    labels[0, :3] = -100
    params = numpy_weights(pt.GPTForCausalLM(cfg, device="cpu"), SEED + 2)
    no_bias = {n: np.zeros_like(a) if n.endswith("mlp.fc1.bias") else a
               for n, a in params.items()}
    runs = {}
    for name, device, start in (("control", "cuda", no_bias),
                                ("card", "cuda", params),
                                ("cpu", "cpu", params)):
        runs[name] = train_parity_run(
            pt, ops, lambda dev: pt.GPTForCausalLM(cfg, device=dev),
            loss_of, start, ids, labels, device)
        torch.cuda.empty_cache()
    counts = runs["card"][3]
    got, ctl = hold_bf16_gates(phase, runs, params, no_bias,
                               BF16_PARITY_TOL, "fc1's bias dropped")
    check_counts(phase, ops, counts, 3, cfg.num_hidden_layers, "train_flash")

    serve_cfg = pt.GPTConfig(**dict(pt.GPT_1P3B, num_hidden_layers=2))
    rng = np.random.default_rng(SEED + 1)
    shared = list(rng.integers(1, serve_cfg.vocab_size, size=48))
    prompts = [shared + list(rng.integers(1, serve_cfg.vocab_size, size=n))
               for n in (5, 9, 12, 7)]
    outs = {}
    for device in ("cuda", "cpu"):
        model = pt.GPTForCausalLM(serve_cfg, device=device,
                                  dtype=torch.bfloat16)
        pt.load_reference_state(model, params)
        eng = pt.GenerationEngine(model, device=device, max_batch=4,
                                  prefill_chunk=64, max_model_len=256,
                                  num_blocks=128)
        reset_launches(ops)
        outs[device] = eng.generate(prompts, max_new_tokens=16)
        if device == "cuda":
            torch.cuda.synchronize()
            serve_counts, steps = launches(ops), eng.stats()["steps"]
        del eng, model
        torch.cuda.empty_cache()
    new = [(o[len(p):], c[len(p):]) for o, c, p in
           zip(outs["cuda"], outs["cpu"], prompts)]
    if not all(len(a) == len(b) == 16 for a, b in new):
        fail(f"{phase}: a request did not return 16 tokens")
    same = sum(int(x == y) for a, b in new for x, y in zip(a, b))
    match = same / (16 * len(prompts))
    say(f"  greedy tokens, bf16 weights: {same} of {16 * len(prompts)} "
        f"positions equal on the card and the CPU (match ratio "
        f"{match:.4f}, reported)")
    check_counts(phase, ops, serve_counts, steps, serve_cfg.num_hidden_layers,
                 "serve")
    lora = bf16_lora_parity(pt, ops)
    return dict(losses_cuda=runs["card"][0], losses_cpu=runs["cpu"][0],
                losses_control=runs["control"][0], readings=got,
                control=ctl, tolerance=BF16_PARITY_TOL,
                greedy_match_ratio=match, lora=lora)


# ---------------------------------------------------------------------
# phase 27: the optimizer family, card against CPU, and state round-trips
# ---------------------------------------------------------------------
#: the optimizer phase's model: ``__graft_entry__.entry()``'s width
#: (hidden 512, 8 heads of 64, vocab 4096) cut to 2 layers, composite
#: attention, f32.  The updates are elementwise and do not depend on the
#: width, and this width keeps the 2 x 39 runs (half of them on the CPU)
#: to seconds.
OPT_PARITY_CFG = dict(vocab_size=4096, hidden_size=512, num_hidden_layers=2,
                      num_attention_heads=8, max_position_embeddings=512,
                      use_flash_attention=False)


def lr_schedulers(pt, base=PARITY_LR):
    """The 17 schedulers of ``optimizer.lr``, each set so that its rate
    moves within 3 steps and stays at most ``base``."""
    lr = pt.optimizer.lr
    return {
        "NoamDecay": lambda: lr.NoamDecay(d_model=512, warmup_steps=2,
                                          learning_rate=base * 20),
        "PiecewiseDecay": lambda: lr.PiecewiseDecay(
            [1, 2], [base, base / 2, base / 4]),
        "NaturalExpDecay": lambda: lr.NaturalExpDecay(base, gamma=0.5),
        "InverseTimeDecay": lambda: lr.InverseTimeDecay(base, gamma=0.5),
        "PolynomialDecay": lambda: lr.PolynomialDecay(
            base, decay_steps=3, end_lr=base / 10),
        "LinearWarmup": lambda: lr.LinearWarmup(
            lr.CosineAnnealingDecay(base, T_max=3), warmup_steps=1,
            start_lr=base / 10, end_lr=base),
        "ExponentialDecay": lambda: lr.ExponentialDecay(base, gamma=0.5),
        "MultiStepDecay": lambda: lr.MultiStepDecay(base, [1, 2], gamma=0.5),
        "StepDecay": lambda: lr.StepDecay(base, step_size=1, gamma=0.5),
        "LambdaDecay": lambda: lr.LambdaDecay(base, lambda e: 1 / (1 + e)),
        "MultiplicativeDecay": lambda: lr.MultiplicativeDecay(
            base, lambda e: 0.5),
        # mode "max" on a falling loss: no step is better, so it halves
        # the rate after each step past the first, whatever the rounding
        "ReduceOnPlateau": lambda: lr.ReduceOnPlateau(
            base, mode="max", factor=0.5, patience=0),
        "CosineAnnealingDecay": lambda: lr.CosineAnnealingDecay(base,
                                                                T_max=3),
        "CosineAnnealingWarmRestarts": lambda:
            lr.CosineAnnealingWarmRestarts(base, T_0=2),
        "LinearLR": lambda: lr.LinearLR(base, total_steps=3,
                                        start_factor=0.25),
        "OneCycleLR": lambda: lr.OneCycleLR(base, total_steps=3),
        "CyclicLR": lambda: lr.CyclicLR(base / 10, base, step_size_up=1),
    }


def optimizer_cases(pt):
    """name -> ``make_opt(parameters)``: the 14 optimizers, the 17
    schedulers (each AdamW's rate), ``L1Decay``/``L2Decay``, parameter
    groups, scheduled betas and the three clips.  Every optimizer that
    normalises its gradient (Adam's family, Adamax, Adagrad, RMSProp,
    Rprop, Lamb) takes at most `PARITY_LR` a step, the largest step
    `hold_sign_free` allows an element whose gradient's sign rounding
    decides."""
    o, nn, reg = pt.optimizer, pt.nn, pt.regularizer
    L = PARITY_LR

    def clip():
        return nn.ClipGradByGlobalNorm(1.0)

    def no_norm_decay(name):
        return not (name.endswith("bias") or ".ln_" in name)

    cases = {
        "SGD": lambda ps: o.SGD(1e-2, ps, weight_decay=0.01,
                                grad_clip=clip()),
        "Momentum": lambda ps: o.Momentum(1e-2, 0.9, ps, use_nesterov=True,
                                          weight_decay=0.01,
                                          grad_clip=clip()),
        "Adam": lambda ps: o.Adam(L, parameters=ps, weight_decay=0.01,
                                  grad_clip=clip()),
        "AdamW": lambda ps: o.AdamW(L, parameters=ps, weight_decay=0.01,
                                    apply_decay_param_fun=no_norm_decay,
                                    grad_clip=clip()),
        "Adamax": lambda ps: o.Adamax(L, parameters=ps, grad_clip=clip()),
        "Adagrad": lambda ps: o.Adagrad(L, parameters=ps, weight_decay=0.01,
                                        grad_clip=clip()),
        "Adadelta": lambda ps: o.Adadelta(0.5, parameters=ps,
                                          weight_decay=0.01,
                                          grad_clip=clip()),
        "RMSProp": lambda ps: o.RMSProp(L / 8, momentum=0.9, centered=True,
                                        parameters=ps, grad_clip=clip()),
        "Lamb": lambda ps: o.Lamb(L, parameters=ps, grad_clip=clip()),
        "Rprop": lambda ps: o.Rprop(L / 2, parameters=ps, grad_clip=clip()),
        "ASGD": lambda ps: o.ASGD(1e-2, batch_num=2, parameters=ps,
                                  weight_decay=0.01, grad_clip=clip()),
        "NAdam": lambda ps: o.NAdam(L, parameters=ps, weight_decay=0.01,
                                    grad_clip=clip()),
        "RAdam": lambda ps: o.RAdam(L, parameters=ps, weight_decay=0.01,
                                    grad_clip=clip()),
        "LBFGS": lambda ps: o.LBFGS(1e-3, max_iter=2, history_size=4,
                                    parameters=ps),
        "L1Decay": lambda ps: o.SGD(1e-2, ps, weight_decay=reg.L1Decay(1e-4),
                                    grad_clip=clip()),
        "L2Decay": lambda ps: o.Momentum(1e-2, 0.9, ps,
                                         weight_decay=reg.L2Decay(0.01),
                                         grad_clip=clip()),
        "param_groups": lambda ps: o.AdamW(
            L, parameters=[{"params": ps[:9]},
                           {"params": ps[9:], "weight_decay": 0.5}],
            grad_clip=clip()),
        "scheduled_betas": lambda ps: o.Adam(
            L, beta1=lambda: 0.85, beta2=lambda: 0.995, parameters=ps,
            grad_clip=clip()),
        "ClipGradByValue": lambda ps: o.SGD(
            0.1, ps, grad_clip=nn.ClipGradByValue(1e-3)),
        "ClipGradByNorm": lambda ps: o.SGD(
            0.1, ps, grad_clip=nn.ClipGradByNorm(0.01)),
        "ClipGradByGlobalNorm": lambda ps: o.SGD(
            0.1, ps, grad_clip=nn.ClipGradByGlobalNorm(0.5,
                                                       group_name="g")),
    }
    for name, make in lr_schedulers(pt).items():
        cases["lr." + name] = lambda ps, make=make: o.AdamW(
            make(), parameters=ps, weight_decay=0.01, grad_clip=clip())
    return cases


def phase_optimizer_parity(pt, ops):
    """Every case of `optimizer_cases`: 3 steps of `OPT_PARITY_CFG`'s GPT
    on the card and on the CPU from the same numpy weights and batch (as
    `train_parity`), held to `PARITY_TOL` with `hold_sign_free`, each
    kernel's launches to the composite drive's per forward/backward
    evaluation; then `state_round_trip` for AdamW under a scheduler and
    for the GradScaler."""
    import numpy as np
    import torch
    phase = "optimizer parity"
    cfg = pt.GPTConfig(**OPT_PARITY_CFG)
    crit = pt.GPTPretrainingCriterion()

    def make_model(device):
        return pt.GPTForCausalLM(cfg, device=device)

    def loss_of(model, x, y):
        return crit(model(x), y)

    rng = np.random.default_rng(SEED + 3)
    ids = rng.integers(0, cfg.vocab_size, (2, 128))
    labels = ids.copy()
    labels[0, :3] = -100
    params = numpy_weights(make_model("cpu"), SEED + 2)
    out, t0 = {}, time.perf_counter()
    for name, make_opt in optimizer_cases(pt).items():
        runs = {device: train_parity_run(
            pt, ops, make_model, loss_of, params, ids, labels, device,
            track_small=device == "cpu", quiet=True,
            make_opt=lambda m: make_opt(list(m.parameters())))
            for device in ("cuda", "cpu")}
        out[name] = hold_parity(f"{phase} {name}", params, runs,
                                sign_free=True, quiet=True)
        check_counts(f"{phase} {name}", ops, runs["cuda"][3],
                     runs["cuda"][5], cfg.num_hidden_layers, "train",
                     show=False, routes=False)
        out[name]["evaluations"] = runs["cuda"][5]
    say(f"  {len(out)} cases in {time.perf_counter() - t0:.1f} s")
    check_routes(phase, ops)
    out["grad_scaler_detects"] = check_scaler_nonfinite(pt)
    opt = pt.optimizer
    out["round_trip_adamw"] = state_round_trip(
        pt, make_model, loss_of, params, ids, labels,
        lambda ps: opt.AdamW(lr_schedulers(pt)["LinearWarmup"](),
                             parameters=ps, weight_decay=0.01,
                             grad_clip=pt.nn.ClipGradByGlobalNorm(1.0)))
    out["round_trip_grad_scaler"] = state_round_trip(
        pt, make_model, loss_of, params, ids, labels,
        lambda ps: opt.AdamW(PARITY_LR, parameters=ps, weight_decay=0.01,
                             grad_clip=pt.nn.ClipGradByGlobalNorm(1.0)),
        scaler=True)
    torch.cuda.empty_cache()
    return out


def check_scaler_nonfinite(pt):
    """``GradScaler.unscale_`` on the card, f32 and bf16 gradients: it
    divides by the scale and finds a gradient holding one NaN, one inf or
    one -inf among finite values, and none in finite gradients."""
    import torch
    found = {}
    for dtype in (torch.float32, torch.bfloat16):
        for bad in (None, float("nan"), float("inf"), -float("inf")):
            ps = [torch.nn.Parameter(torch.ones(n, device="cuda",
                                                dtype=dtype))
                  for n in (3, 4099, 70000)]
            for p in ps:
                p.grad = torch.full_like(p, 4.0)
            if bad is not None:
                ps[1].grad[4000] = bad
            scaler = pt.amp.GradScaler(init_loss_scaling=4.0)
            scaler.unscale_(pt.optimizer.SGD(0.1, ps))
            key = f"{str(dtype).split('.')[-1]} {bad}"
            found[key] = scaler._found_inf
            if scaler._found_inf != (bad is not None) \
                    or float(ps[0].grad[0]) != 1.0:
                fail(f"GradScaler on the card: {key}: found "
                     f"{scaler._found_inf}, unscaled {float(ps[0].grad[0])}")
    say(f"  GradScaler.unscale_ on the card finds: {found}")
    return found


def state_round_trip(pt, make_model, loss_of, params, ids, labels, make_opt,
                     scaler=False, steps=3):
    """``steps`` + 1 steps on the card uninterrupted, against ``steps``
    steps, then the model's, the optimizer's (its scheduler's inside) and,
    with ``scaler``, a ``GradScaler``'s ``state_dict`` (cloned) into a
    fresh model, optimizer and scaler, and one more step: every parameter
    must be bit-identical.  With ``scaler``, a pre-step hook poisons the
    first gradient at step 1, so the scaler skips that step and backs
    off, and the resumed run must carry its counters."""
    import torch
    from paddle_tpu_torch.optimizer import optimizer as opt_mod
    x, y = (torch.from_numpy(a).cuda() for a in (ids, labels))

    def fresh():
        model = make_model("cuda")
        pt.load_reference_state(model, params)
        sc = pt.amp.GradScaler(init_loss_scaling=2.0 ** 10,
                               incr_every_n_steps=2) if scaler else None
        return model, make_opt(list(model.parameters())), sc

    def run(model, opt, sc, first, last):
        state = {"step": first}

        def poison(o, ps):
            if o is opt and state["step"] == 1:
                ps[0].grad = ps[0].grad * float("inf")

        remove = opt_mod.register_pre_step_hook(poison) if scaler \
            else (lambda: None)
        try:
            for step in range(first, last):
                state["step"] = step
                loss = loss_of(model, x, y)
                if sc is None:
                    loss.backward()
                    opt.step()
                else:
                    sc.scale(loss).backward()
                    opt_mod.run_pre_step_hooks(opt, opt._params_with_grad())
                    sc.step(opt)
                opt.clear_grad()
                if isinstance(opt._learning_rate,
                              pt.optimizer.lr.LRScheduler):
                    opt._learning_rate.step()
        finally:
            remove()

    whole = fresh()
    run(*whole, 0, steps + 1)
    first = fresh()
    run(*first, 0, steps)
    model_state = {k: v.clone() for k, v in first[0].state_dict().items()}
    opt_state = {k: v.clone() if isinstance(v, torch.Tensor) else v
                 for k, v in first[1].state_dict().items()}
    sc_state = first[2].state_dict() if scaler else None
    del first
    resumed = fresh()
    resumed[0].load_state_dict(model_state)
    resumed[1].set_state_dict(opt_state)
    if scaler:
        resumed[2].load_state_dict(sc_state)
    run(*resumed, steps, steps + 1)
    torch.cuda.synchronize()
    differ = [n for (n, a), b in zip(whole[0].named_parameters(),
                                     resumed[0].parameters())
              if not torch.equal(a, b)]
    what = "GradScaler" if scaler else "AdamW + LinearWarmup"
    extra = ""
    if scaler:
        if whole[2].state_dict() != resumed[2].state_dict():
            fail(f"state round-trip ({what}): the scaler's state differs: "
                 f"{whole[2].state_dict()} vs {resumed[2].state_dict()}")
        if whole[1]._step_count != steps:
            fail(f"state round-trip ({what}): {whole[1]._step_count} steps "
                 f"applied, expected {steps} (one skipped)")
        extra = (f", scale {whole[2]._scale:g}, steps applied "
                 f"{whole[1]._step_count} of {steps + 1}")
    say(f"  state round-trip ({what}): {steps} steps, state_dict into a "
        f"fresh model and optimizer, 1 step: {len(differ)} of "
        f"{len(model_state)} parameters differ from {steps + 1} "
        f"uninterrupted steps{extra}")
    if differ:
        fail(f"state round-trip ({what}): not bit-identical: {differ[:8]}")
    return dict(bit_identical=True, parameters=len(model_state),
                scaler=whole[2].state_dict() if scaler else None)


# ---------------------------------------------------------------------
# phase 28: the GPT-1.3B pretraining recipe under O2
# ---------------------------------------------------------------------
#: the recipe's peak learning rate.  O2 keeps no f32 master weights (the
#: reference keeps none), so an update under half a bf16 ulp of its
#: weight is lost: a weight near 0.02 has an ulp of 1.2e-4, a norm weight
#: at 1.0 one of 7.8e-3.
O2_LR = 1e-4


def phase_o2_training(pt, ops, peak_lr=O2_LR):
    """The GPT-1.3B pretraining recipe at phase 8's shape (``GPT_1P3B``,
    24 layers, flash attention + recompute, B=8, S=1024):
    ``amp.decorate(level="O2", dtype="bfloat16")`` and ``auto_cast(level=
    "O2")``; AdamW with weight decay 0.01 masked off the biases and the
    norms; ``LinearWarmup(CosineAnnealingDecay)`` (warm-up over the
    warm-up steps from ``peak_lr / 10``, then a cosine over the timed
    steps to ``peak_lr / 10``); ``ClipGradByGlobalNorm(1.0)``; a
    ``GradScaler``.  Driven by `drive_training`."""
    import numpy as np
    import torch
    B = TRAIN_B[True]
    cfg = pt.GPTConfig(**dict(pt.GPT_1P3B, use_flash_attention=True,
                              use_recompute=True))
    L, H = cfg.num_hidden_layers, cfg.hidden_size
    model = pt.GPTForCausalLM(cfg, dtype=torch.float32, seed=SEED)
    pt.amp.decorate(model, level="O2", dtype="bfloat16")
    n_params = sum(p.numel() for p in model.parameters())
    lr = pt.optimizer.lr
    sched = lr.LinearWarmup(
        lr.CosineAnnealingDecay(peak_lr, T_max=TRAIN_STEPS,
                                eta_min=peak_lr / 10),
        warmup_steps=TRAIN_WARMUP, start_lr=peak_lr / 10, end_lr=peak_lr)
    opt = pt.optimizer.AdamW(
        learning_rate=sched, weight_decay=0.01, parameters=model.parameters(),
        apply_decay_param_fun=lambda n: not (n.endswith("bias")
                                             or ".ln_" in n),
        grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    scaler = pt.amp.GradScaler()
    crit = pt.GPTPretrainingCriterion()
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (B, TRAIN_S))).cuda()
    rates, skipped = [], []

    def step():
        rates.append(opt.get_lr())
        with pt.amp.auto_cast(level="O2", dtype="bfloat16"):
            loss = crit(model(ids), ids)
        scaler.minimize(opt, scaler.scale(loss))
        skipped.append(scaler._found_inf)
        opt.clear_grad()
        sched.step()
        return loss.detach()

    counts, summary = drive_training(ops, step, n_params, B, L, H,
                                     "O2 training", "train_flash")
    if any(skipped):
        fail(f"O2 training: the scaler skipped steps {skipped}")
    dtypes = sorted({str(p.dtype) for p in model.parameters()})
    say(f"  peak lr {peak_lr:g}, rates {rates}, loss scale "
        f"{scaler._scale:g}, parameter dtypes {dtypes}")
    summary.update(peak_lr=peak_lr, rates=rates, loss_scale=scaler._scale,
                   skipped_steps=sum(skipped), parameter_dtypes=dtypes)
    return counts, summary


# ---------------------------------------------------------------------
# phase 29: O2 bf16 parity, GPT at full width, 2 layers
# ---------------------------------------------------------------------
#: the O2 parity's learning rate, phase 26's.  The parameters are bf16
#: and each update rounds into them; at 1e-3 the card's and the CPU's
#: losses part by 4.1e-4 after 3 steps (past the loss gate; the larger
#: steps carry the bf16 rounding differences further), at 1e-4 the
#: readings sit within every gate (PERF.md §5).
O2_PARITY_LR = PARITY_LR
#: `BF16_PARITY_TOL` with the loss gate near the geometric mean of the
#: card run's loss reading and its control's (fc1's bias dropped), as
#: the LoRA gates are set: O2's control parts from the CPU by less than
#: O1's, and the shared 2e-4 lay too close to it (2.19e-4 with AdamW's
#: decay folded into a factor on the weights; 1.79e-4 with the decay in
#: the update's sum, which moves the bf16 roundings).  Readings on an
#: H100 80GB HBM3 at 700 W: loss 6.24e-5, grad 8.51e-3, update 3.33e-2;
#: control 1.79e-4, 9.00e-2, 0.121.
O2_PARITY_TOL = dict(BF16_PARITY_TOL, loss=1e-4)


def phase_o2_parity(pt, ops):
    """GPT_1P3B's width cut to 2 layers, ``amp.decorate(level="O2")``
    bf16 parameters under ``auto_cast(level="O2")``, flash attention and
    recompute, from numpy weights: 3 AdamW steps on the card and on the
    CPU (plain versions), held to `O2_PARITY_TOL` as phase 26 holds O1
    (the updates measured from the bf16 starting weights), and the control
    (the card run with fc1's bias dropped) shown to fail each gate."""
    import numpy as np
    import torch
    phase = "O2 parity"
    cfg = pt.GPTConfig(**dict(pt.GPT_1P3B, num_hidden_layers=2,
                              use_flash_attention=True, use_recompute=True))
    crit = pt.GPTPretrainingCriterion()

    def make(device):
        return pt.amp.decorate(pt.GPTForCausalLM(cfg, device=device),
                               level="O2", dtype="bfloat16")

    def loss_of(model, x, y):
        with pt.amp.auto_cast(level="O2", dtype="bfloat16"):
            return crit(model(x), y)

    def make_opt(model):
        return pt.optimizer.AdamW(
            O2_PARITY_LR, parameters=model.parameters(), weight_decay=0.01,
            grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))

    rng = np.random.default_rng(SEED + 3)
    ids = rng.integers(0, cfg.vocab_size, (2, 128))
    labels = ids.copy()
    labels[0, :3] = -100
    params = numpy_weights(make("cpu"), SEED + 2)
    no_bias = {n: np.zeros_like(a) if n.endswith("mlp.fc1.bias") else a
               for n, a in params.items()}

    def as_bf16(ws):
        return {n: torch.from_numpy(a).bfloat16().float().numpy()
                for n, a in ws.items()}

    runs = {}
    for name, device, start in (("control", "cuda", no_bias),
                                ("card", "cuda", params),
                                ("cpu", "cpu", params)):
        runs[name] = train_parity_run(pt, ops, make, loss_of, start, ids,
                                      labels, device, make_opt=make_opt)
        torch.cuda.empty_cache()
    if {str(p.dtype) for p in runs["card"][2].values()} != {"torch.bfloat16"}:
        fail(f"{phase}: the parameters are not all bf16")
    got, ctl = hold_bf16_gates(phase, runs, as_bf16(params),
                               as_bf16(no_bias), O2_PARITY_TOL,
                               "fc1's bias dropped")
    check_counts(phase, ops, runs["card"][3], 3, cfg.num_hidden_layers,
                 "train_flash")
    return dict(losses_cuda=runs["card"][0], losses_cpu=runs["cpu"][0],
                losses_control=runs["control"][0], readings=got,
                control=ctl, tolerance=O2_PARITY_TOL, lr=O2_PARITY_LR)


# ---------------------------------------------------------------------
# phases 30-32: vision
# ---------------------------------------------------------------------
#: relu's derivative steps from 0 to 1 at 0.  Where a relu input lies
#: within rounding of 0, the two runs' rounding decides the side it falls
#: on, and one input on the other side moves its channel's gradients by
#: its whole upstream value: a ResNet-18's port and reference part by
#: 7.5e-6 at one layer2.0.bn1 input in the CPU tests, which moves that
#: layer's bias gradient by 3% of its largest.  By ResNet-50's layer4, f32
#: activations part from f64 by ~1e-4 of their largest (PERF.md §6, PR
#: 18), ~1e-3 absolute.  The parity runs therefore give the card's relus
#: the reference run's derivative at the inputs within this band of 0
#: (`ReluKinks`); the values stay the card's own.
KINK_BAND = 1e-3


class ReluKinks:
    """The derivatives one run's relus took at their inputs within
    `KINK_BAND` of 0, recorded call by call, and given to other runs'
    relus at the same calls (`attach`; `rewind` before each other run)."""

    def __init__(self, band=KINK_BAND):
        self.band, self.sides, self.calls, self.held = band, [], 0, 0

    def rewind(self):
        self.calls = 0

    def record(self, v):
        """One relu call's input: the flat indices within the band and the
        derivative there (1 above 0, the reference's 0.5 at 0, 0 below)."""
        v = v.detach().double().reshape(-1).cpu()
        idx = (v.abs() <= self.band).nonzero().reshape(-1)
        near = v[idx]
        self.sides.append((idx, (near > 0).float() + 0.5 * (near == 0).float()))

    def hold(self, x, out):
        """``out``, the relu of ``x`` at the next recorded call, with the
        recorded derivative at the recorded indices; its values stay."""
        idx, side = self.sides[self.calls]
        self.calls += 1
        if idx.numel() == 0:
            return out
        self.held += idx.numel()
        idx = idx.to(x.device)
        xs = x.reshape(-1)[idx] * side.to(x.device, x.dtype)
        flat = out.reshape(-1)
        return flat.index_put((idx,), flat[idx].detach()
                              + (xs - xs.detach())).reshape(out.shape)

    def attach(self, model, relu_cls, record):
        """Forward hooks on ``model``'s ``relu_cls`` layers that record
        (``record``) or hold each call; returns their handles."""
        if record:
            def hook(module, inputs, out):
                self.record(inputs[0])
        else:
            def hook(module, inputs, out):
                return self.hold(inputs[0], out)
        return [m.register_forward_hook(hook) for m in model.modules()
                if isinstance(m, relu_cls)]

    @contextlib.contextmanager
    def epilogue(self, pt, record):
        """The same for the relus that run inside row 3's epilogue
        (``F.linear_act(..., act="relu")``, no layer to hook): while the
        context is open, each such call also forms its pre-activation
        ``x @ w + b`` in plain torch, records it (``record``) or holds the
        kernel's output at the recorded indices through it (`hold`: the
        values stay the kernel's, the derivative there is the recorded
        run's, and the kernel's backward sees a zero gradient there)."""
        F = pt.nn.functional
        real = F.linear_act

        def linear_act(x, weight, bias, act="none"):
            out = real(x, weight, bias, act)
            if act != "relu":
                return out
            z = x @ weight + bias
            if record:
                self.record(z)
                return out
            return self.hold(z, out)
        F.linear_act = linear_act
        try:
            yield
        finally:
            F.linear_act = real


#: Momentum's learning rate in the parity runs.  At the recipe's 0.1 a
#: random ResNet-18's loss on 4 images goes 2.0, 3.9, 11.2 over 3 steps
#: (the CPU tests): the parity would measure how that blow-up carries
#: rounding, not the port; at 0.01 it falls to 0.002, where the loss
#: gate's 1e-5 relative is rounding.  At 1e-3 each parameter still moves
#: by ~5e-3 of its gradient in 3 steps, 50 times the parameter gate.
#: Adam runs at `PARITY_LR`.
VISION_MOMENTUM_LR = 1e-3

#: the parity phase's models: (input shape, classes, optimizer).  LeNet at
#: B=8; ResNet-50 at B=4 on 64 x 64, which leaves layer4 2 x 2 x 4 = 16
#: values a channel for its batch norms (at 32 x 32 and B=2 it would have
#: 2, and the norm's output would be nearly a sign function)
VISION_PARITY = {"lenet": ((8, 1, 28, 28), 10, "adam"),
                 "resnet50": ((4, 3, 64, 64), 10, "momentum")}

#: ResNet-50's training-mode batch norms carry f32 rounding so far that
#: no two f32 runs of its parity meet `PARITY_TOL`: on the CPU, f32 parts
#: from f64 by 2.1e-4 of a step-1 gradient's largest (relu kinks held at
#: 1e-3; 5.6e-2 held at 1e-4) and, over 3 Momentum steps, by 20% in the
#: third loss (B=4; 8.3e-4 at B=16 and lr 1e-4: PERF.md §6, PR 18).  Its
#: parity therefore runs in f64, card against CPU, 3 steps under
#: `PARITY_TOL`; and its f32 run on the card (the cuDNN f32 convolutions,
#: rows 8a/8b) takes one step, held against the CPU's f64 step (logits,
#: gradients, buffers) within the larger of `PARITY_TOL` and this multiple
#: of the CPU's own f32 step's distance from it.
F32_FLOOR_FACTOR = 4.0


#: GoogLeNet's auxiliary heads' weight in its training loss (Szegedy et
#: al. 2015, section 5)
AUX_WEIGHT = 0.3


def vision_loss(pt, out, labels):
    """The cross-entropy of a model's logits; for GoogLeNet's ``(out,
    aux1, aux2)`` in training mode, the main head's plus `AUX_WEIGHT`
    times the two auxiliary heads'."""
    ce = pt.nn.functional.cross_entropy
    if not isinstance(out, tuple):
        return ce(out, labels)
    main, aux1, aux2 = out
    loss = ce(main, labels)
    if aux1 is None:
        return loss
    return loss + AUX_WEIGHT * (ce(aux1, labels) + ce(aux2, labels))


def vision_parity_run(pt, ops, make_model, params, x, y, make_opt, device,
                      kinks, record, dtype, steps=3, track_small=False):
    """`train_parity_run` of ``make_model(device)`` in ``dtype`` with
    `vision_loss` of its logits as the loss, its relus recording their
    kinks into ``kinks`` or (``record`` false) holding them; returns its
    readings and ``dict(logits=`` the first step's, ``buffers=`` those
    after each step``)`` in f64 on the CPU."""
    import torch
    seen = dict(logits=None, buffers=[])

    def make(dev):
        model = make_model(dev).to(dtype)
        kinks.rewind()
        kinks.attach(model, pt.nn.ReLU, record)
        return model

    def loss_of(model, xs, ys):
        out = model(xs.to(dtype))
        if seen["logits"] is None:
            main = out[0] if isinstance(out, tuple) else out
            seen["logits"] = main.detach().double().cpu()
        # a copy: an f64 buffer on the CPU would alias the live buffer
        seen["buffers"].append({n: b.detach().double().cpu().clone()
                                for n, b in model.named_buffers()})
        return vision_loss(pt, out, ys)
    return train_parity_run(pt, ops, make, loss_of, params, x, y, device,
                            steps=steps, track_small=track_small,
                            make_opt=make_opt), seen


def step1_readings(run, ref, zero_grads=None):
    """The first step of ``run`` against ``ref`` (`vision_parity_run`
    results): the logits' largest error against their largest magnitude
    (the loss, one number, can land near its f64 value by chance: the
    CPU's f32 loss sat 7e-8 from it, the card's 1.3e-5, with both runs'
    logits ~8e-5 away), the gradients' largest error against each
    tensor's largest magnitude (`grad_readings`), the buffers' excess
    after the step; each with where it is."""
    (_, g_x, *_), e_x = run
    (_, g_r, *_), e_r = ref
    lg = e_r["logits"]
    return dict(
        logits=(float((e_x["logits"] - lg).abs().max() / lg.abs().max()),
                "step-1 logits"),
        grad=grad_readings(g_x, g_r, zero_grads),
        buffer=excess(e_x["buffers"][0], e_r["buffers"][0]))


def hold_f32_floor(phase, card, cpu32, cpu64, zero_grads=None):
    """The card's f32 step against the CPU's f64 step, each reading of
    `step1_readings` within the larger of its `PARITY_TOL` and
    `F32_FLOOR_FACTOR` times the CPU's f32 step's reading against f64."""
    tol = dict(logits=PARITY_TOL["grad"], grad=PARITY_TOL["grad"],
               buffer=PARITY_TOL["param"][0])
    got, floor, direct = (step1_readings(a, b, zero_grads) for a, b in (
        (card, cpu64), (cpu32, cpu64), (card, cpu32)))
    out = {}
    for key, limit in tol.items():
        gate = max(limit, F32_FLOOR_FACTOR * floor[key][0])
        say(f"  f32 step 1, {key}: card vs CPU f64 {got[key][0]:.3e} at "
            f"{got[key][1]}; CPU f32 vs f64 {floor[key][0]:.3e} at "
            f"{floor[key][1]}; gate {gate:.3e} (PARITY_TOL {limit:g}); "
            f"card vs CPU f32 {direct[key][0]:.3e} at {direct[key][1]}")
        if got[key][0] > gate:
            fail(f"{phase}: f32 step-1 {key} of the card {got[key][0]:.3e} "
                 f"from the CPU's f64 step, past {gate:.3e}")
        out[key] = dict(card_vs_f64=got[key][0], cpu32_vs_f64=floor[key][0],
                        card_vs_cpu32=direct[key][0], gate=gate,
                        parity_tol=limit, at=got[key][1])
    return out


def vision_parity(pt, ops, phase, make_model, shape, classes, opt_name,
                  design=None, drive="vision_parity", zero_grads=None,
                  cudnn=True):
    """3 steps of ``make_model`` on the CPU, then on the card, from the
    CPU model's own initial state (its generator seeded with 0) and one
    numpy batch: losses, step-1 gradients, final parameters and the batch
    norms' final running statistics held to `PARITY_TOL`, the card's relus
    at the CPU's kinks (`ReluKinks`).  ``design`` "f32" runs both legs in
    f32 (LeNet, Adam, its sign-free elements by `hold_sign_free`; the
    small nets of phase 33, Momentum); "f64" (ResNet-50, GoogLeNet,
    DenseNet-121) runs them in f64, then one f32 step on the CPU and on
    the card held by `hold_f32_floor` (`F32_FLOOR_FACTOR` says why).  By
    default Adam runs "f32", Momentum "f64".  Each kernel launches as
    ``drive`` says a step in the card's f32 run.  ``zero_grads``: see
    `grad_readings`.  Without ``cudnn`` the card's 3-step run has cuDNN
    off (ATen's own convolutions), and one more f32 step with it on is
    reported against the CPU's, not gated (`VISION_PARITY_II` says
    why)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 30)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.integers(0, classes, shape[0])
    params = {k: v.numpy() for k, v in
              make_model("cpu").state_dict().items()}
    if opt_name == "adam":
        def make_opt(m):
            return pt.optimizer.Adam(learning_rate=PARITY_LR,
                                     parameters=m.parameters())
    else:
        def make_opt(m):
            return pt.optimizer.Momentum(learning_rate=VISION_MOMENTUM_LR,
                                         momentum=0.9,
                                         parameters=m.parameters())
    design = design or ("f64" if opt_name == "momentum" else "f32")
    dtype = {"f32": torch.float32, "f64": torch.float64}[design]
    legs = [("cpu", "cpu", True, dtype, 3), ("cuda", "cuda", False, dtype, 3)]
    if dtype == torch.float64:
        legs += [("cpu32", "cpu", False, torch.float32, 1),
                 ("cuda32", "cuda", False, torch.float32, 1)]
    if not cudnn:
        legs.append(("cuda_cudnn", "cuda", False, torch.float32, 1))
    kinks = ReluKinks()
    runs, counts = {}, None
    for key, device, record, dt, steps in legs:
        held = kinks.held
        cudnn_was = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = cudnn or key != "cuda"
        try:
            runs[key] = vision_parity_run(
                pt, ops, make_model, params, x, y, make_opt, device, kinks,
                record, dt, steps, track_small=record and opt_name == "adam")
        finally:
            torch.backends.cudnn.enabled = cudnn_was
        say(f"  ({key}: {str(dt)[6:]}) " + (
            "its relus recorded" if record else
            f"{kinks.held - held} relu inputs within {KINK_BAND:g} of 0 took "
            f"the CPU {str(dtype)[6:]} run's derivative"))
        if key in ("cuda", "cuda32") and dt == torch.float32:
            counts, launch_steps = runs[key][0][3], steps
        torch.cuda.empty_cache()
    out = hold_parity(phase, params, {k: runs[k][0] for k in ("cuda", "cpu")},
                      sign_free=opt_name == "adam", zero_grads=zero_grads)
    buf = excess(runs["cuda"][1]["buffers"][-1],
                 runs["cpu"][1]["buffers"][-1])
    say(f"  buffers after 3 steps max (|err| - "
        f"{PARITY_TOL['param'][1]:g}*|b|) {buf[0]:.3e} at {buf[1]} "
        f"(tolerance {PARITY_TOL['param'][0]:g})")
    if buf[0] > PARITY_TOL["param"][0]:
        fail(f"{phase}: buffer {buf[1]} differs after 3 steps by "
             f"{buf[0]:.3e}")
    out.update(buffer_max_excess=buf[0], dtype=str(dtype)[6:])
    if not cudnn:
        got = step1_readings(runs["cuda_cudnn"], runs["cpu"], zero_grads)
        say("  with cuDNN (reported, not gated): f32 step 1 against the "
            "CPU's " + ", ".join(f"{k} {v[0]:.3e} at {v[1]}"
                                 for k, v in got.items()))
        out["cudnn_f32_step1_vs_cpu"] = {k: v[0] for k, v in got.items()}
    if dtype == torch.float64:
        out["f32_step1"] = hold_f32_floor(phase, runs["cuda32"],
                                          runs["cpu32"], runs["cpu"],
                                          zero_grads)
    check_counts(phase, ops, counts, launch_steps, 0, drive)
    out.update(relu_inputs_held=kinks.held, batch=list(shape),
               optimizer=opt_name,
               losses={k: r[0][0] for k, r in runs.items()})
    return out


def phase_vision_parity(pt, ops):
    """Phase 30: LeNet (B=8, 3 Adam steps) and ResNet-50 (10 classes, B=4,
    3 x 64 x 64, 3 Momentum steps), f32, batch norm in training mode."""
    models = pt.vision.models
    make = {"lenet": lambda device: models.LeNet(device=device),
            "resnet50": lambda device: models.resnet50(num_classes=10,
                                                       device=device)}
    out = {}
    for name, (shape, classes, opt_name) in VISION_PARITY.items():
        say(f"  {name}: input {list(shape)}, {classes} classes, {opt_name}")
        out[name] = vision_parity(pt, ops, f"{name} parity", make[name],
                                  shape, classes, opt_name)
        free_device_memory()
    return out


#: device-time groups of the vision drives' profiles, by kernel-name
#: substring (first match wins): the cross-entropy rows, cuDNN's
#: convolutions by pass (its kernels name fprop, dgrad and wgrad), the
#: layout transforms cuDNN runs around them, ``torch.cat``'s copies
#: (DenseNet's, the inceptions'), batch norm (cuDNN's and ATen's),
#: pooling, the optimizer's multi-tensor updates, GEMMs (the
#: Linear layers), and elementwise ops and casts
VISION_PROFILE_GROUPS = (
    ("softmax_xent_fwd", "xent_fwd_kernel"),
    ("softmax_xent_bwd", "xent_bwd_kernel"),
    ("conv_wgrad", ("wgrad", "Wgrad")),
    ("conv_dgrad", ("dgrad", "Dgrad")),
    ("conv_fprop", ("fprop", "Fprop", "implicit_convolve", "conv2d",
                    "convolve")),
    ("layout_transform", ("nchwToNhwc", "nhwcToNchw", "nchw_to_nhwc",
                          "nhwc_to_nchw")),
    ("concat", "CatArray"),
    ("batch_norm", ("batch_norm", "bn_fw", "bn_bw", "BatchNorm")),
    ("pooling", ("pool", "Pool")),
    ("optimizer_foreach", "multi_tensor_apply"),
    ("gemm", ("gemm", "xmma", "nvjet", "cutlass", "cublas")),
    ("elementwise_and_casts", ("elementwise", "copy", "Copy", "fill",
                               "reduce", "Reduce")))

VISION_WARMUP = 2
LENET_B, LENET_STEPS = 64, 10
RESNET50_HW, RESNET50_STEPS = 224, 5


def forward_flops(pt, model, x):
    """2 x the multiply-adds of every ``Conv2D`` and ``Linear`` in one
    forward of ``x``, from the shapes the layers see (eval mode, no
    gradient, so the batch norms' buffers stay)."""
    import math
    import torch
    total = [0]

    def conv(m, inputs, out):
        total[0] += 2 * out.numel() * math.prod(m.weight.shape[1:])

    def linear(m, inputs, out):
        total[0] += 2 * out.numel() * m.weight.shape[0]    # [in, out]
    hooks = [m.register_forward_hook(conv if isinstance(m, pt.nn.Conv2D)
                                     else linear)
             for m in model.modules()
             if isinstance(m, (pt.nn.Conv2D, pt.nn.Linear))]
    model.eval()
    with torch.no_grad():
        model(x)
    model.train()
    for h in hooks:
        h.remove()
    return total[0]


def drive_vision(ops, step, B, steps, phase, drive, flops_per_img, peak):
    """`VISION_WARMUP` untimed calls of ``step`` (one training step that
    returns its loss), then ``steps`` timed ones, each synchronised by
    reading its loss, as bench.py does: imgs/s, ms/step, MFU (3 x the
    forward's ``flops_per_img`` a trained image against ``peak``), peak
    memory; the losses must be finite and fall; each kernel's launches
    must equal ``drive``'s per step; one profiled step splits device time
    by `VISION_PROFILE_GROUPS`.  Returns (launch counts, summary)."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    losses = [float(step()) for _ in range(VISION_WARMUP)]
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches(ops)
    t0 = time.perf_counter()
    losses += [float(step()) for _ in range(steps)]
    elapsed = time.perf_counter() - t0
    counts = launches(ops)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = elapsed / steps * 1e3
    imgs_per_s = B * steps / elapsed
    mfu = 3 * flops_per_img * imgs_per_s / peak
    say(f"  B={B}: warm-up {VISION_WARMUP} steps {warm_s:.2f} s; {steps} "
        f"steps in {elapsed:.3f} s: {step_ms:.2f} ms/step, "
        f"{imgs_per_s:.1f} imgs/s, forward {flops_per_img / 1e9:.4f} "
        f"GFLOP an image, MFU {mfu:.4f} (3 x forward vs {peak:.3g} "
        f"flop/s), peak memory {peak_gib:.2f} GiB; losses {losses}")
    if not all(np.isfinite(losses)):
        fail(f"{phase}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{phase}: the loss did not fall on a repeated batch: "
             f"{losses}")
    check_counts(phase, ops, counts, steps, 0, drive)
    summary = dict(batch=B, steps=steps, step_ms=step_ms,
                   imgs_per_s=imgs_per_s, forward_flops_per_img=flops_per_img,
                   mfu=mfu, mfu_peak_flops=peak, peak_memory_gib=peak_gib,
                   losses=losses,
                   launches_per_step={n: c // steps
                                      for n, c in counts.items() if c})
    prof_wall = profile_device(step)
    summary["profile"] = split_profile(prof_wall, 1, f"{phase} step",
                                       VISION_PROFILE_GROUPS)
    if summary["profile"] is not None:
        summary["profile"]["largest_kernels"] = largest_kernels(prof_wall[0])
    return counts, summary


def largest_kernels(prof, n=3):
    """The ``n`` kernels with the most device time in each
    `VISION_PROFILE_GROUPS` group of a profile: {group: [(name, ms)]},
    printed."""
    from torch.autograd import DeviceType
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        group = next((g for g, keys in VISION_PROFILE_GROUPS
                      if any(k in evt.key for k in ((keys,) if isinstance(
                          keys, str) else keys))), "other")
        out.setdefault(group, []).append((evt.key[:100], us / 1e3))
    out = {g: sorted(rows, key=lambda r: -r[1])[:n]
           for g, rows in out.items()}
    for g, rows in out.items():
        say(f"  largest {g} kernels (ms): " + "; ".join(
            f"{name} {ms:.3f}" for name, ms in rows))
    return out


def phase_lenet_training(pt, ops):
    """Phase 31: bench.py's ``bench_lenet`` recipe (bench.py:449-511):
    ``LeNet(num_classes=10)``, f32 (TF32 off), ``Adam(1e-3)``, one batch
    of B=64 1 x 28 x 28 images and labels from ``default_rng(0)``."""
    import numpy as np
    import torch
    model = pt.vision.models.LeNet(num_classes=10)
    opt = pt.optimizer.Adam(learning_rate=1e-3, parameters=model.parameters())
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.standard_normal(
        (LENET_B, 1, 28, 28)).astype(np.float32)).cuda()
    label = torch.from_numpy(rng.integers(0, 10, (LENET_B,))).cuda()

    def step():
        loss = pt.nn.functional.cross_entropy(model(img), label)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    flops = forward_flops(pt, model, img[:1])
    return drive_vision(ops, step, LENET_B, LENET_STEPS, "lenet training",
                        "lenet_train", flops, PEAK_OPS_PER_S["float32"])


def phase_resnet50_training(pt, ops):
    """Phase 32: bench.py's ``bench_resnet50`` recipe (bench.py:514-591)
    at each of `RESNET50_BATCHES`: ``resnet50(num_classes=1000)``, f32
    parameters under ``auto_cast(bf16, O1)`` (convolutions and the
    classifier in bf16, batch norm and the loss in f32),
    ``Momentum(0.1, 0.9)``, one batch of 224 x 224 images and labels from
    ``default_rng(0)``; the model and optimizer built anew for each batch
    (its generator seeded with 0).  bench.py's halving on a memory error
    is not ported: a batch that does not fit fails the phase.  Returns
    the first batch's launch counts and both summaries."""
    import numpy as np
    import torch
    out, first = {}, None
    for B in RESNET50_BATCHES:
        model = pt.vision.models.resnet50(num_classes=1000)
        opt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                    parameters=model.parameters())
        rng = np.random.default_rng(0)
        img = torch.from_numpy(rng.standard_normal(
            (B, 3, RESNET50_HW, RESNET50_HW)).astype(np.float32)).cuda()
        label = torch.from_numpy(rng.integers(0, 1000, (B,))).cuda()

        def step():
            with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
                loss = pt.nn.functional.cross_entropy(model(img), label)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()

        flops = forward_flops(pt, model, img[:1])
        counts, out[f"batch_{B}"] = drive_vision(
            ops, step, B, RESNET50_STEPS, f"resnet50 training B={B}",
            "resnet50_train", flops, PEAK_BF16)
        first = first or counts
        del model, opt, img, step
        free_device_memory()
    return first, out


# ---------------------------------------------------------------------
# phases 33-37: the rest of vision
# ---------------------------------------------------------------------
#: phase 33's models: (constructor, its arguments, `vision_parity`'s
#: design, the names of its exactly-zero gradients for `grad_readings`,
#: whether its card run uses cuDNN).
#: From `scripts/torch_vision_diag.py --cpu` at B=4, 64 x 64, 3
#: Momentum(1e-3) steps, relu kinks held within 1e-3 (PERF.md section
#: 6): SqueezeNet's and AlexNet's f32 runs stay within `PARITY_TOL`
#: of f64 (gradients 9.5e-7 and 6.0e-7), so they are held in f32 card
#: against CPU; the four with training-mode batch norms carry f32 past it
#: (MobileNetV1's step-1 gradients 3.3e-3 and third loss 6.3e-4 from
#: f64, ShuffleNetV2's third loss 3.8e-3, GoogLeNet's gradients 1.8e-3,
#: DenseNet-121's 3.5e-2 at its first batch norm), so they take phase
#: 30's f64 design.  ShuffleNetV2's units feed a batch norm's output
#: through a 1 x 1 convolution to another batch norm, which makes that
#: first norm's bias gradient exactly 0.  cuDNN's f32 weight gradient of
#: AlexNet's 64 -> 192 5 x 5 convolution on 7 x 7 maps sits 1.2e-3 to
#: 1.7e-3 from f64 under every setting (default, deterministic,
#: benchmark, ``fp32_precision="ieee"``; ATen's own convolution 1.8e-7:
#: `scripts/torch_vision_diag.py --convs` on one H100 80GB HBM3 at 700 W),
#: so AlexNet's card run has cuDNN off and its cuDNN step is reported
#: beside it
VISION_PARITY_II = {
    "squeezenet1_1": ("squeezenet1_1", {}, "f32", None, True),
    "alexnet": ("alexnet", {}, "f32", None, False),
    "mobilenet_v1": ("mobilenet_v1", {"scale": 0.25}, "f64", None, True),
    "shufflenet_v2": ("ShuffleNetV2", {"scale": 0.5}, "f64",
                      lambda n: n.endswith(("branch1.1.bias",
                                            "branch2.4.bias")), True),
    "googlenet": ("googlenet", {}, "f64", None, True),
    "densenet121": ("densenet121", {}, "f64", None, True),
}
VISION_PARITY_II_SHAPE = (4, 3, 64, 64)


def vision_model(pt, name, device):
    """A phase 33 model (`VISION_PARITY_II`, 10 classes) on ``device``,
    every dropout's rate set to 0 (the card's and the CPU's masks
    differ)."""
    ctor, kw = VISION_PARITY_II[name][:2]
    model = getattr(pt.vision.models, ctor)(num_classes=10, device=device,
                                            **kw)
    for m in model.modules():
        if isinstance(m, pt.nn.Dropout):
            m.p = 0.0
    return model


def phase_vision_parity_ii(pt, ops):
    """Phase 33: `VISION_PARITY_II`'s six models, 10 classes, B=4, 3 x 64
    x 64, 3 Momentum steps, dropout 0, batch norm in training mode,
    GoogLeNet's loss with its aux heads (`vision_loss`), card against the
    CPU's plain run by `vision_parity` in each model's design."""
    out = {}
    for name, (_, kw, design, zero_grads, cudnn) in \
            VISION_PARITY_II.items():
        say(f"  {name} {kw or ''}: input {list(VISION_PARITY_II_SHAPE)}, "
            f"{design} design" + ("" if cudnn else ", cuDNN off"))
        t0 = time.perf_counter()
        out[name] = vision_parity(
            pt, ops, f"{name} parity",
            lambda device, name=name: vision_model(pt, name, device),
            VISION_PARITY_II_SHAPE, 10, "momentum", design,
            "googlenet_parity" if name == "googlenet" else "vision_parity",
            zero_grads, cudnn)
        out[name]["seconds"] = time.perf_counter() - t0
        free_device_memory()
    return out


#: phase 34's gate: each output and gradient of an op on the card within
#: this share of its largest magnitude on the CPU (f32, TF32 off: cuDNN
#: and the CPU sum in other orders; the gathers' backward adds with
#: atomics on the card); masks, unpooled maps and nms indices exactly
VISION_OPS_TOL = 1e-4

#: phase 34's transposed convolutions: (dims, padding, stride, dilation,
#: groups, output_padding, layout), every form of module 4
CONV_T_CASES = (
    (2, 1, 2, 1, 1, 0, "NCHW"), (2, 1, 2, 1, 1, 1, "NCHW"),
    (2, [0, 1, 2, 0], 2, 1, 2, 1, "NCHW"), (2, [[1, 0], [0, 2]], 2, 1, 1, 0,
                                            "NCHW"),
    (2, 0, 3, 2, 2, [2, 1], "NCHW"), (2, 0, 2, 1, 1, 1, "NCHW"),
    (2, 2, 2, 1, 1, 1, "NHWC"), (1, [1, 3], 2, 1, 1, 1, "NCL"),
    (1, 2, 2, 1, 2, 0, "NLC"), (3, [0, 1, 1, 0, 2, 1], 2, 1, 1, 0, "NCDHW"),
    (3, 1, 2, 1, 1, 1, "NDHWC"))


def card_vs_cpu(what, fn, arrays, grad=(), exact=False):
    """``fn`` on the CPU and on the card from the same numpy ``arrays``
    (those indexed by ``grad`` with gradients, under one upstream
    gradient): every output and gradient within `VISION_OPS_TOL` of its
    largest CPU magnitude, or with ``exact`` equal.  Returns the largest
    reading."""
    import numpy as np
    import torch
    res = {}
    for device in ("cpu", "cuda"):
        ts = [torch.from_numpy(a).to(device) for a in arrays]
        for i in grad:
            ts[i].requires_grad_()
        out = fn(*ts)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        if grad:
            up = np.random.default_rng(SEED + 1).standard_normal(
                tuple(outs[0].shape)).astype(np.float32)
            (outs[0] * torch.from_numpy(up).to(device)).sum().backward()
            outs += [ts[i].grad for i in grad]
        res[device] = [o.detach().cpu() for o in outs]
    worst = 0.0
    for got, want in zip(res["cuda"], res["cpu"]):
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"vision ops parity: {what}: {got.dtype} {tuple(got.shape)} "
                 f"on the card, {want.dtype} {tuple(want.shape)} on the CPU")
        if exact:
            if not torch.equal(got, want):
                fail(f"vision ops parity: {what} differs on the card")
            continue
        g, w = got.double(), want.double()
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        if not err <= VISION_OPS_TOL:
            fail(f"vision ops parity: {what}: {err:.3e} of the largest "
                 f"magnitude, past {VISION_OPS_TOL:g}")
        worst = max(worst, err)
    return worst


def _boxes(rng, n, lo, hi, size):
    import numpy as np
    c = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(size[0], size[1], (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)


def phase_vision_ops_parity(pt):
    """Phase 34: module 4-8 ops on the card against the CPU at small
    shapes (`card_vs_cpu`): every transposed-convolution form of
    `CONV_T_CASES`, forward and backward; instance, group and local
    response norm, ``normalize`` and ``spectral_norm``, forward and
    backward; the fixed and adaptive pooling masks on integer-valued
    (tie-rich) inputs and the unpooled maps, exactly, with the round trip
    (pooling the unpooled map gives the pooled values back); roi_align
    (forward, and backward to the features and the boxes) and roi_pool;
    box_coder encode and decode, yolo_box; deform_conv2d v1 and v2,
    forward and backward; nms indices, exactly, plain and per category."""
    import numpy as np
    import torch
    F, V = pt.nn.functional, pt.vision.ops
    rng = np.random.default_rng(SEED + 34)
    out = {}

    def randn(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    for i, (nsp, pad, st, dil, groups, opad, df) in enumerate(CONV_T_CASES):
        sp = (6, 5, 4)[:nsp]
        shape = (2, 4) + sp if df.startswith("NC") else (2,) + sp + (4,)
        fn = getattr(F, f"conv{nsp}d_transpose")
        out[f"conv_transpose_{i}_{nsp}d_{df}"] = card_vs_cpu(
            f"conv{nsp}d_transpose {pad} {df}",
            lambda x, w, b, fn=fn, pad=pad, st=st, dil=dil, g=groups,
            o=opad, df=df: fn(x, w, b, st, pad, o, g, dil, data_format=df),
            [randn(*shape), randn(4, 6 // groups, *(3,) * nsp, scale=0.3),
             randn(6)], grad=(0, 1, 2))
    norms = {
        "instance_norm": (lambda x, w, b: F.instance_norm(
            x, weight=w, bias=b), (2, 4, 5, 6), 2),
        "instance_norm_nhwc": (lambda x, w, b: F.instance_norm(
            x, weight=w, bias=b, data_format="NHWC"), (2, 5, 6, 4), 2),
        "group_norm": (lambda x, w, b: F.group_norm(x, 3, weight=w, bias=b),
                       (2, 6, 5, 4), 2),
        "local_response_norm": (lambda x: F.local_response_norm(x, 5),
                                (2, 7, 4, 3), 0),
        "normalize": (lambda x: F.normalize(x, p=1.5, axis=-1), (3, 5, 4),
                      0)}
    for name, (fn, shape, n_par) in norms.items():
        c = shape[-1] if name.endswith("nhwc") else shape[1]
        arrays = [randn(*shape) + 0.5] + [1 + randn(c, scale=0.3)
                                          for _ in range(n_par)]
        out[name] = card_vs_cpu(name, fn, arrays,
                                grad=tuple(range(len(arrays))))
    u, v = randn(4), randn(18)
    out["spectral_norm"] = card_vs_cpu(
        "spectral_norm", lambda w, u_, v_: F.spectral_norm(w, u_, v_, 0, 2),
        [randn(4, 3, 2, 3), u, v], grad=(0,))
    masks = {"max_pool1d": ((2, 3, 13), (3, 2, 1)),
             "max_pool2d": ((2, 3, 9, 8), (3, 2, 1)),
             "max_pool3d": ((1, 2, 5, 6, 7), (3, 2, 1)),
             "adaptive_max_pool1d": ((2, 3, 10), (4,)),
             "adaptive_max_pool2d": ((2, 3, 9, 8), ((3, 5),)),
             "adaptive_max_pool3d": ((1, 2, 5, 6, 7), ((3, 2, 4),))}
    for name, (shape, args) in masks.items():
        x = rng.integers(0, 3, shape).astype(np.float32)
        card_vs_cpu(f"{name} mask", lambda t, name=name, args=args: getattr(
            F, name)(t, *args, return_mask=True), [x], exact=True)
    for nsp, shape in ((1, (2, 3, 12)), (2, (2, 3, 9, 8)),
                       (3, (1, 2, 6, 6, 7))):
        x = (np.abs(randn(*shape)) + 0.1).astype(np.float32)

        def round_trip(t, nsp=nsp):
            pooled, mask = getattr(F, f"max_pool{nsp}d")(t, 2, 2,
                                                         return_mask=True)
            back = getattr(F, f"max_unpool{nsp}d")(
                pooled, mask, 2, 2, output_size=list(t.shape[2:]))
            if not torch.equal(getattr(F, f"max_pool{nsp}d")(back, 2, 2),
                               pooled):
                fail(f"vision ops parity: max_unpool{nsp}d does not round "
                     f"trip its mask on {t.device}")
            return back, mask
        card_vs_cpu(f"max_unpool{nsp}d", round_trip, [x], exact=True)
    out["masks_and_unpool"] = "exact"
    x = randn(2, 5, 12, 14)
    boxes = _boxes(rng, 9, -4.0, 30.0, (2.0, 16.0))
    num = np.array([4, 5], np.int32)
    out["roi_align"] = card_vs_cpu(
        "roi_align", lambda f, b, n: V.roi_align(f, b, n, (3, 4), 0.5, 2),
        [x, boxes, num], grad=(0, 1))
    out["roi_align_unaligned"] = card_vs_cpu(
        "roi_align unaligned", lambda f, b, n: V.roi_align(
            f, b, n, 2, 0.5, -1, aligned=False), [x, boxes, num],
        grad=(0, 1))
    out["roi_pool"] = card_vs_cpu(
        "roi_pool", lambda f, b, n: V.roi_pool(f, b, n, 3, 0.5),
        [x, boxes, num])
    prior, target = _boxes(rng, 6, 0, 50, (2, 20)), _boxes(rng, 5, 0, 50,
                                                           (2, 20))
    out["box_coder_encode"] = card_vs_cpu(
        "box_coder encode", lambda p, t: V.box_coder(
            p, [0.1, 0.1, 0.2, 0.2], t), [prior, target])
    out["box_coder_decode"] = card_vs_cpu(
        "box_coder decode", lambda p, d: V.box_coder(
            p, [0.1, 0.1, 0.2, 0.2], d, "decode_center_size", False, 0),
        [prior, randn(6, 3, 4, scale=0.3)])
    out["yolo_box"] = card_vs_cpu(
        "yolo_box", lambda h, s: V.yolo_box(
            h, s, [10, 13, 16, 30, 33, 23], 4, 0.5, 32, scale_x_y=1.05),
        [randn(2, 27, 5, 6), np.array([[320, 416], [288, 256]], np.int32)])
    for version in ("v1", "v2"):
        arrays = [randn(2, 3, 10, 9), randn(2, 18, 5, 5, scale=2.5),
                  randn(4, 3, 3, 3, scale=0.3), randn(4)]
        if version == "v2":
            arrays.append(rng.uniform(0, 1, (2, 9, 5, 5)).astype(np.float32))
        out[f"deform_conv2d_{version}"] = card_vs_cpu(
            f"deform_conv2d {version}", lambda x_, o, w, b, *m: (
                V.deform_conv2d(x_, o, w, b, 2, 2, 2,
                                mask=m[0] if m else None)), arrays,
            grad=tuple(range(len(arrays))))
    nb = _boxes(rng, 300, 0, 200, (5, 60))
    scores = (rng.permutation(300) / 300).astype(np.float32)
    cats = rng.integers(0, 5, 300)
    card_vs_cpu("nms", lambda b, s: V.nms(b, 0.4, s), [nb, scores],
                exact=True)
    card_vs_cpu("nms per category", lambda b, s, c: V.nms(
        b, 0.4, s, c, top_k=50), [nb, scores, cats], exact=True)
    out["nms"] = "exact"
    say("  card vs CPU, largest error over the largest magnitude (gate "
        f"{VISION_OPS_TOL:g}; masks, unpooled maps and nms exact): " +
        ", ".join(f"{k} {v:.2e}" if isinstance(v, float) else f"{k} {v}"
                  for k, v in out.items()))
    return out


VISION_II_B, VISION_II_HW, VISION_II_STEPS = 64, 224, 5


def phase_vision_recipe(pt, ops, name, phase, drive):
    """Phases 35 (GoogLeNet) and 36 (DenseNet-121): phase 32's recipe at
    B=`VISION_II_B`: 224 x 224, 1000 classes, f32 parameters under
    ``auto_cast(bf16, O1)``, ``Momentum(0.1, 0.9)``, dropout on (masks
    from the model's generator), GoogLeNet's loss with its aux heads
    (`vision_loss`), one batch of images and labels from
    ``default_rng(0)``, through `drive_vision`; returns (launch counts,
    summary)."""
    import numpy as np
    import torch
    ctor = VISION_PARITY_II[name][0]
    model = getattr(pt.vision.models, ctor)(num_classes=1000)
    opt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                parameters=model.parameters())
    rng = np.random.default_rng(0)
    B, hw = VISION_II_B, VISION_II_HW
    img = torch.from_numpy(rng.standard_normal(
        (B, 3, hw, hw)).astype(np.float32)).cuda()
    label = torch.from_numpy(rng.integers(0, 1000, (B,))).cuda()

    def step():
        with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
            loss = vision_loss(pt, model(img), label)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    flops = forward_flops(pt, model, img[:1])
    counts, summary = drive_vision(ops, step, B, VISION_II_STEPS, phase,
                                   drive, flops, PEAK_BF16)
    prof = summary["profile"]
    if prof is not None:
        busy = prof["device_busy_ms"]
        split = prof["device_ms_per_step"]
        share = {k: split[k] / busy for k in ("concat", "batch_norm")}
        say(f"  concatenation {split['concat']:.2f} ms and batch norm "
            f"{split['batch_norm']:.2f} ms of {busy:.2f} busy ms: "
            f"{share['concat']:.3f} and {share['batch_norm']:.3f}")
        prof["busy_share"] = share
    return counts, summary


#: YOLOv3-608's heads (stride, anchors in pixels: Redmon and Farhadi
#: 2018, COCO's 9 clusters, 3 a head), 80 classes
YOLO_HEADS = ((32, (116, 90, 156, 198, 373, 326)),
              (16, (30, 61, 62, 45, 59, 119)),
              (8, (10, 13, 16, 30, 33, 23)))
YOLO_B, YOLO_IMG, YOLO_CLASSES = 8, 608, 80
NMS_PRE, NMS_TOP_K, NMS_IOU = 1000, 100, 0.45


def _op_timing(what, fwd, inputs=(), bwd=True):
    """CUDA-event ms of ``fwd()`` and (``bwd``) of the backward of its
    first output to ``inputs`` under a random upstream, and the peak
    device memory of one forward and backward; printed."""
    import torch
    out = fwd()
    first = out[0] if isinstance(out, tuple) else out
    if not all(bool(torch.isfinite(o).all()) for o in (
            out if isinstance(out, tuple) else (out,))):
        fail(f"detection ops: {what} gives a non-finite value")
    r = dict(fwd_ms=time_ms(fwd, iters=10, warmup=2))
    if bwd:
        up = torch.randn_like(first)
        r["bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            first, inputs, up, retain_graph=True), iters=10, warmup=2)
    del out, first
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    o = fwd()
    if bwd:
        f = o[0] if isinstance(o, tuple) else o
        torch.autograd.grad(f, inputs, torch.ones_like(f))
    torch.cuda.synchronize()
    r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    r["peak_above_inputs_gib"] = (torch.cuda.max_memory_allocated()
                                  - base) / 2 ** 30
    say(f"  {what}: forward {r['fwd_ms']:.3f} ms" + (
        f", backward {r['bwd_ms']:.3f} ms" if bwd else "") +
        f", peak {r['peak_gib']:.2f} GiB ({r['peak_above_inputs_gib']:.2f} "
        f"above the inputs)")
    return r


def phase_detection_ops(pt):
    """Phase 37: the detection ops at a detector's shapes, CUDA-event ms a
    call and the peak memory: roi_align and roi_pool over an 800 x 1216
    image pair's stride-4 features [2, 256, 200, 304] f32 with 512 boxes
    an image (output 7, ``sampling_ratio`` 2, ``spatial_scale`` 0.25,
    aligned), forward and, for roi_align, backward; yolo_box on
    YOLOv3-608's three heads at B=8 (`YOLO_HEADS`, ``conf_thresh``
    0.005), then nms per image over its `NMS_PRE` best boxes by their
    best class score, per category, ``top_k`` `NMS_TOP_K`: the IoU
    matrix's device time and the host sweep's time apart, the kept
    indices equal to the CPU's; box_coder decoding 1000 priors x 81
    classes; deform_conv2d v2 at a DCN ResNet-50 stage-3 3 x 3 (x [2,
    128, 100, 152], padding 1), forward and backward, and with zero
    offsets and a unit mask equal to ``conv2d``."""
    import numpy as np
    import torch
    V = pt.vision.ops
    gen = torch.Generator(device="cuda").manual_seed(SEED + 37)
    rng = np.random.default_rng(SEED + 37)
    out = {}

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, device="cuda", generator=gen)

    feats = randn(2, 256, 200, 304).requires_grad_()
    wh = np.exp(rng.uniform(np.log(16), np.log(512), (1024, 2)))
    lo = rng.uniform(0, 1, (1024, 2)) * (np.array([1216, 800]) - wh)
    boxes = torch.from_numpy(np.concatenate([lo, lo + wh], 1).astype(
        np.float32)).cuda().requires_grad_()
    num = torch.tensor([512, 512], device="cuda")
    out["roi_align"] = _op_timing(
        "roi_align [2, 256, 200, 304], 1024 boxes, 7 x 7",
        lambda: V.roi_align(feats, boxes, num, 7, 0.25, 2, True),
        (feats, boxes))
    out["roi_pool"] = _op_timing(
        "roi_pool, the same inputs",
        lambda: V.roi_pool(feats, boxes, num, 7, 0.25), bwd=False)
    del feats, boxes
    torch.cuda.empty_cache()
    size = torch.full((YOLO_B, 2), YOLO_IMG, device="cuda",
                      dtype=torch.int32)
    heads, yolo = [], {}
    for stride, anchors in YOLO_HEADS:
        g = YOLO_IMG // stride
        h = randn(YOLO_B, 3 * (5 + YOLO_CLASSES), g, g)
        yolo[f"stride_{stride}"] = _op_timing(
            f"yolo_box [{YOLO_B}, 255, {g}, {g}]",
            lambda h=h, a=anchors, s=stride: V.yolo_box(
                h, size, list(a), YOLO_CLASSES, 0.005, s), bwd=False)
        heads.append(V.yolo_box(h, size, list(anchors), YOLO_CLASSES, 0.005,
                                stride))
    out["yolo_box"] = yolo
    boxes = torch.cat([b for b, _ in heads], 1)
    scores = torch.cat([s for _, s in heads], 1)
    best, cats = scores.max(-1)
    top = best.topk(NMS_PRE, -1).indices
    iou_ms, sweep_ms, nms_ms, kept = [], [], [], []
    for i in range(YOLO_B):
        b, s, c = boxes[i, top[i]], best[i, top[i]], cats[i, top[i]]
        iou_ms.append(time_ms(lambda: V.nms_iou(b), iters=10, warmup=2))
        iou = V.nms_iou(b).cpu().numpy()
        s_h, c_h = s.double().cpu().numpy(), c.cpu().numpy()
        t0 = time.perf_counter()
        V.nms_sweep(iou, NMS_IOU, s_h, c_h, top_k=NMS_TOP_K)
        sweep_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keep = V.nms(b, NMS_IOU, s, c, top_k=NMS_TOP_K)
        torch.cuda.synchronize()
        nms_ms.append((time.perf_counter() - t0) * 1e3)
        want = V.nms(b.cpu(), NMS_IOU, s.cpu(), c.cpu(), top_k=NMS_TOP_K)
        if not torch.equal(keep.cpu(), want):
            fail(f"detection ops: nms on image {i} keeps other boxes on the "
                 f"card than on the CPU")
        kept.append(len(keep))
    out["nms"] = dict(
        boxes=NMS_PRE, top_k=NMS_TOP_K, iou_threshold=NMS_IOU,
        device_iou_ms=float(np.median(iou_ms)),
        host_sweep_ms=float(np.median(sweep_ms)),
        call_ms=float(np.median(nms_ms)), kept=kept)
    say(f"  nms over {NMS_PRE} boxes an image, per category, top_k "
        f"{NMS_TOP_K} (median of {YOLO_B} images): device IoU "
        f"{out['nms']['device_iou_ms']:.3f} ms (CUDA events), host sweep "
        f"{out['nms']['host_sweep_ms']:.3f} ms, whole call "
        f"{out['nms']['call_ms']:.3f} ms (host clock); kept {kept}; equal "
        f"to the CPU's")
    del heads, boxes, scores
    prior = torch.from_numpy(_boxes(rng, 1000, 0.1, 0.9, (0.02, 0.3))).cuda()
    deltas = randn(1000, 81, 4, scale=0.5)
    out["box_coder_decode"] = _op_timing(
        "box_coder decode, 1000 priors x 81 classes",
        lambda: V.box_coder(prior, [0.1, 0.1, 0.2, 0.2], deltas,
                            "decode_center_size", True, 0), bwd=False)
    x = randn(2, 128, 100, 152).requires_grad_()
    off = randn(2, 18, 100, 152, scale=2.0).requires_grad_()
    mask = torch.sigmoid(randn(2, 9, 100, 152)).requires_grad_()
    w = randn(128, 128, 3, 3, scale=1 / 34).requires_grad_()
    out["deform_conv2d_v2"] = _op_timing(
        "deform_conv2d v2 x [2, 128, 100, 152], 3 x 3",
        lambda: V.deform_conv2d(x, off, w, None, 1, 1, mask=mask),
        (x, off, mask, w))
    with torch.no_grad():
        got = V.deform_conv2d(x, torch.zeros_like(off), w, None, 1, 1,
                              mask=torch.ones_like(mask))
        want = pt.nn.functional.conv2d(x, w, None, 1, 1)
    err = float((got - want).abs().max() / want.abs().max())
    if not err <= VISION_OPS_TOL:
        fail(f"detection ops: deform_conv2d with zero offsets is "
             f"{err:.3e} from conv2d")
    out["deform_conv2d_v2"]["zero_offset_vs_conv2d"] = err
    say(f"  deform_conv2d with zero offsets and a unit mask vs conv2d: "
        f"{err:.2e} of the largest magnitude")
    return out


# ---------------------------------------------------------------------
# phases 38-40: jit.to_static on CUDA graphs
# ---------------------------------------------------------------------
#: phases 39-40: the steps of a turn, the untimed ones first (a captured
#: turn: the discovery run and the capture; an eager turn: as many plain
#: calls), and the peak rate of the scheduled GPT turns (phase 28's
#: schedule: a linear warm-up over `CAPTURE_WARMUP` steps from a tenth of
#: it, then a cosine to a tenth over the rest, so the rate changes at every
#: step)
CAPTURE_STEPS, CAPTURE_WARMUP, CAPTURE_LR = 10, 2, 1e-4
#: the turns of each comparison, in the order they run in one process
TURNS = ("eager", "captured", "captured", "eager")


class EagerStep:
    """A traced step run eagerly: the undecorated function of a
    ``jit.TracedFunction`` (its ``_orig_fn``), keeping the traced
    function's ``_cache`` so that ``stats()`` reads the same; counts its
    calls.  Phases 38-40's eager twins (the package has no switch)."""

    def __init__(self, traced):
        self._orig_fn = traced._orig_fn
        self._cache = traced._cache
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self._orig_fn(*args, **kwargs)


def capture_facts(traced):
    """The capture of a traced function's one signature: seconds, the
    graph pool's growth of ``memory_reserved`` in GiB, replays."""
    entries = list(traced._cache.values())
    if len(entries) != 1 or entries[0].graph is None:
        fail(f"to_static: {len(entries)} signatures, graph "
             f"{[e.graph is not None for e in entries]}: expected one "
             f"captured signature")
    e = entries[0]
    return dict(capture_s=e.capture_s, graph_pool_gib=e.pool_bytes / 2 ** 30,
                replays=e.replays)


def check_replayed(phase, traced, replays0, eager0, steps):
    """No fallback: the timed steps of a captured turn were all replays
    and no eager call ran."""
    if traced.eager_calls != eager0 or traced.replays - replays0 != steps:
        fail(f"{phase}: {traced.replays - replays0} replays and "
             f"{traced.eager_calls - eager0} eager calls in {steps} timed "
             f"steps: every step must replay the captured graph")


def cpu_step_compiles(pt, cfg, prompts, warm, num_blocks):
    """``stats()["step_compiles"]`` of a CPU engine on the same trace: a
    1-layer bf16 GPT of GPT_1P3B's vocabulary (the step's signature
    follows the token budget, ``max_batch`` and the table width, not the
    model's width)."""
    import torch
    tiny = pt.GPTConfig(vocab_size=cfg.vocab_size, hidden_size=64,
                        num_hidden_layers=1, num_attention_heads=4,
                        max_position_embeddings=cfg.max_position_embeddings)
    model = pt.GPTForCausalLM(tiny, device="cpu", dtype=torch.bfloat16,
                              seed=SEED)
    eng = pt.GenerationEngine(model, max_batch=8, prefill_chunk=256,
                              max_model_len=cfg.max_position_embeddings,
                              num_blocks=num_blocks, device="cpu")
    eng.generate(warm, max_new_tokens=4)
    eng.generate(prompts, max_new_tokens=64)
    return eng.stats()["step_compiles"]


def serve_turn(pt, ops, model, cfg, captured, phase, drive, kw=None):
    """One turn of phase 38: a fresh engine over ``model`` on phase 4's
    trace, its step replayed from a CUDA graph (``captured``) or run
    eagerly (`EagerStep`), timed as phase 4 times it, the launches per
    step held to ``drive``'s, one profiled burst.  Returns (summary, the
    generated tokens, the engine's pool blocks)."""
    import torch
    prompts, warm = serve_trace(cfg)
    eng = pt.GenerationEngine(model, max_batch=8, prefill_chunk=256,
                              max_model_len=cfg.max_position_embeddings,
                              **(kw or {}))
    traced = eng._step_fn
    if not captured:
        eng._step_fn = EagerStep(traced)
    eng.generate(warm, max_new_tokens=4)        # discovery and capture
    torch.cuda.synchronize()
    summary = dict(turn="captured" if captured else "eager")
    if captured:
        summary.update(capture_facts(traced))
    replays0, eager0 = traced.replays, traced.eager_calls
    steps0 = eng.stats()["steps"]
    toks0 = eng.stats()["tokens_generated"]
    reset_launches(ops)
    t0 = time.perf_counter()
    ids = [eng.add_request(p, max_new_tokens=64) for p in prompts]
    while eng.has_unfinished():
        eng.step()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = launches(ops)
    steps = eng.stats()["steps"] - steps0
    tokens = eng.stats()["tokens_generated"] - toks0
    if captured:
        check_replayed(phase, traced, replays0, eager0, steps)
    check_counts(phase, ops, counts, steps, cfg.num_hidden_layers, drive,
                 show=False)
    reqs = [eng._results[i] for i in ids]
    ttft = sorted((r.t_first_token - r.t_submit) * 1e3 for r in reqs)
    summary.update(steps=steps, ms_per_step=elapsed / steps * 1e3,
                   tokens_per_s=tokens / elapsed,
                   median_ttft_ms=ttft[len(ttft) // 2],
                   step_compiles=len(traced._cache))
    steps0 = eng.stats()["steps"]
    prof = split_profile(profile_device(
        lambda: eng.generate(prompts[:8], max_new_tokens=16)),
        eng.stats()["steps"] - steps0, f"{summary['turn']} burst")
    check_profiled_counts(phase, prof, cfg.num_hidden_layers, drive)
    summary["idle_share"] = None if prof is None \
        else prof["device_idle_share"]
    say(f"  {summary['turn']}: {summary['ms_per_step']:.2f} ms/step, "
        f"{summary['tokens_per_s']:.1f} tokens/s, median TTFT "
        f"{summary['median_ttft_ms']:.1f} ms, idle share "
        f"{summary['idle_share']}, {steps} steps"
        + (f"; capture {summary['capture_s']:.3f} s, graph pool "
           f"{summary['graph_pool_gib']:.3f} GiB" if captured else ""))
    blocks = eng.cache.num_blocks
    eng.close()
    return summary, [list(r.generated) for r in reqs], blocks


def phase_captured_serving(pt, ops, base_tokens, int8_tokens):
    """Phase 38: phase 4's drive (GPT_1P3B bf16, random weights,
    ``max_batch=8``, chunk 256, 16 requests sharing a 512-token prefix, 64
    greedy tokens each) in four turns, eager, captured, captured, eager:
    the captured turns' tokens must equal the eager turns' and phase 4's,
    ``step_compiles`` the CPU engine's on the same trace, and the launches
    per step drive ``serve``'s.  Then phase 13's int8 engine in an eager
    and a captured turn, held to phase 13's tokens."""
    import torch
    cfg = pt.GPTConfig(**pt.GPT_1P3B)
    out = {}
    for int8, turns, want in ((False, TURNS, base_tokens),
                              (True, ("eager", "captured"), int8_tokens)):
        what = "int8 captured serving" if int8 else "captured serving"
        model = pt.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=SEED)
        kw = dict(weight_dtype="int8", kv_cache_dtype="int8") if int8 \
            else None
        rows = []
        for turn in turns:
            summary, tokens, blocks = serve_turn(
                pt, ops, model, cfg, turn == "captured", what,
                "serve_int8" if int8 else "serve", kw)
            if tokens != want:
                fail(f"{what}: the {turn} turn's tokens differ from phase "
                     f"{13 if int8 else 4}'s")
            rows.append(summary)
            free_device_memory()
        if not int8:
            prompts, warm = serve_trace(cfg)
            cpu = cpu_step_compiles(pt, cfg, prompts, warm, blocks)
            card = {r["step_compiles"] for r in rows
                    if r["turn"] == "captured"}
            say(f"  step_compiles: card {card}, CPU engine on the same "
                f"trace {cpu}")
            if card != {cpu}:
                fail(f"{what}: step_compiles {card}, the CPU engine's {cpu}")
        out["int8" if int8 else "bf16"] = rows
        del model
        free_device_memory()
    return out


def param_checksum(model):
    """Every parameter's and buffer's bits, summed as int64 per tensor on
    the device: a change of any element changes its sum."""
    import torch
    out = []
    for t in list(model.parameters()) + list(model.buffers()):
        bits = t.detach().contiguous().view(
            {1: torch.uint8, 2: torch.int16, 4: torch.int32,
             8: torch.int64}[t.element_size()])
        out.append(int(bits.to(torch.int64).sum()))
    return out


def train_turn(pt, ops, make, captured, phase, drive, L, flops_of, peak,
               per_img=None):
    """One training turn of phases 39-40: ``make()`` builds (model, step
    function of the batch, the batch, a scheduler or None) from the seed;
    `CAPTURE_STEPS` steps, the last ``CAPTURE_STEPS - CAPTURE_WARMUP``
    timed, ``sched.step()`` between the calls.  The captured turn runs the
    step through ``jit.to_static``.  ``flops_of(model, batch)``: the flops
    of a step, for the MFU against ``peak``; ``per_img``: the batch, for
    imgs/s.  Returns the summary (losses, rates, the parameter checksum
    and sums, ms/step, MFU, idle share, peak GiB)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    model, step, batch, sched = make()
    flops_per_step = flops_of(model, batch)
    fn = pt.jit.to_static(step) if captured else step
    losses, rates = [], []
    timed = CAPTURE_STEPS - CAPTURE_WARMUP
    for i in range(CAPTURE_STEPS):
        if i == CAPTURE_WARMUP:
            torch.cuda.synchronize()
            if captured:
                facts = capture_facts(fn)
                replays0, eager0 = fn.replays, fn.eager_calls
            reset_launches(ops)
            t0 = time.perf_counter()
        rates.append(sched() if sched is not None else None)
        losses.append(fn(*batch))
        if sched is not None:
            sched.step()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = launches(ops)
    if captured:
        check_replayed(phase, fn, replays0, eager0, timed)
    check_counts(phase, ops, counts, timed, L, drive, show=False)
    losses = [float(v) for v in losses]
    step_ms = elapsed / timed * 1e3
    summary = dict(turn="captured" if captured else "eager",
                   losses=losses, rates=rates,
                   checksum=param_checksum(model),
                   sums=param_sums(model), step_ms=step_ms,
                   mfu=flops_per_step / (step_ms / 1e3) / peak,
                   peak_memory_gib=torch.cuda.max_memory_allocated()
                   / 2 ** 30)
    if per_img is not None:
        summary["imgs_per_s"] = per_img / (step_ms / 1e3)
    if captured:
        summary.update(facts)
    prof = split_profile(profile_device(lambda: fn(*batch)), 1,
                         f"{summary['turn']} step")
    summary["idle_share"] = None if prof is None \
        else prof["device_idle_share"]
    say(f"  {summary['turn']}: {step_ms:.2f} ms/step, MFU "
        f"{summary['mfu']:.4f}, idle share {summary['idle_share']}, peak "
        f"{summary['peak_memory_gib']:.2f} GiB"
        + (f", {summary['imgs_per_s']:.1f} imgs/s" if per_img else "")
        + (f"; capture {summary['capture_s']:.3f} s, graph pool "
           f"{summary['graph_pool_gib']:.3f} GiB" if captured else "")
        + f"; losses {losses}")
    if not all(v == v and abs(v) != float("inf") for v in losses) or \
            not losses[-1] < losses[0]:
        fail(f"{phase}: the losses must be finite and fall: {losses}")
    del model, step, batch, fn
    free_device_memory()
    return summary


def param_sums(model):
    """Every parameter's and buffer's f64 sum and sum of magnitudes."""
    import torch
    return [(float(t.detach().double().sum()),
             float(t.detach().double().abs().sum()))
            for t in list(model.parameters()) + list(model.buffers())]


def hold_turns(phase, rows, exact):
    """The captured turns against the eager ones: bit-identical losses and
    parameter checksums where ``exact`` (else within 2x the distance
    between the two eager turns, `turn_distance`)."""
    eager = [r for r in rows if r["turn"] == "eager"]
    captured = [r for r in rows if r["turn"] == "captured"]
    if exact:
        for r in captured:
            if r["losses"] != eager[0]["losses"] or \
                    r["checksum"] != eager[0]["checksum"]:
                fail(f"{phase}: a captured turn is not bit-identical to "
                     f"the eager turns: losses {r['losses']} vs "
                     f"{eager[0]['losses']}, checksums differ in "
                     f"{sum(a != b for a, b in zip(r['checksum'], eager[0]['checksum']))} "
                     f"tensors")
        return "bit-identical"
    spread = turn_distance(eager[0], eager[1])
    for r in captured:
        d = turn_distance(r, eager[0])
        if d > 2 * spread:
            fail(f"{phase}: a captured turn is {d:.3e} from the eager "
                 f"turn, over 2x the eager turns' {spread:.3e}")
    return f"within 2x the eager turns' distance {spread:.3e}"


def turn_distance(a, b):
    """The largest relative difference of two turns' losses and of their
    parameters' and buffers' sums (each against its sum of magnitudes)."""
    losses = max(abs(x - y) / max(abs(y), 1e-30)
                 for x, y in zip(a["losses"], b["losses"]))
    sums = max(abs(x[0] - y[0]) / max(y[1], 1e-30)
               for x, y in zip(a["sums"], b["sums"]))
    return max(losses, sums)


def phase_captured_gpt_training(pt, ops):
    """Phase 39: phase 8's recipe (GPT_1P3B, flash attention + recompute,
    B=8, S=1024, f32 parameters under bf16 O1, AdamW with
    ``ClipGradByGlobalNorm(1.0)``) under phase 28's schedule, the step
    through ``jit.to_static`` in the captured turns, ``sched.step()``
    outside it: the rate changes at every call.  Four turns from the same
    seed, each freed before the next; losses and a checksum of every
    parameter after `CAPTURE_STEPS` steps bit-identical across turns."""
    import numpy as np
    import torch
    B = TRAIN_B[True]
    cfg = pt.GPTConfig(**dict(pt.GPT_1P3B, use_flash_attention=True,
                              use_recompute=True))
    L, H = cfg.num_hidden_layers, cfg.hidden_size

    def make():
        model = pt.GPTForCausalLM(cfg, dtype=torch.float32, seed=SEED)
        lr = pt.optimizer.lr
        sched = lr.LinearWarmup(
            lr.CosineAnnealingDecay(CAPTURE_LR,
                                    T_max=CAPTURE_STEPS - CAPTURE_WARMUP,
                                    eta_min=CAPTURE_LR / 10),
            warmup_steps=CAPTURE_WARMUP, start_lr=CAPTURE_LR / 10,
            end_lr=CAPTURE_LR)
        opt = pt.optimizer.AdamW(
            learning_rate=sched, weight_decay=0.01,
            parameters=model.parameters(),
            grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
        crit = pt.GPTPretrainingCriterion()
        rng = np.random.default_rng(SEED)
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (B, TRAIN_S))).cuda()

        def step(x):
            with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
                loss = crit(model(x), x)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()
        return model, step, (ids,), sched

    def flops(model, batch):
        n_params = sum(p.numel() for p in model.parameters())
        return (6 * n_params + 12 * L * TRAIN_S * H) * B * TRAIN_S

    rows = [train_turn(pt, ops, make, turn == "captured",
                       "captured gpt training", "train_flash", L, flops,
                       PEAK_BF16) for turn in TURNS]
    if len({tuple(r["rates"]) for r in rows}) != 1 or \
            len(set(rows[0]["rates"])) < CAPTURE_STEPS - 1:
        fail(f"captured gpt training: the rates must change at every step "
             f"and agree across turns: {[r['rates'] for r in rows]}")
    held = hold_turns("captured gpt training", rows, exact=True)
    say(f"  turns {held}; rates {rows[0]['rates']}")
    return dict(turns=rows, held=held)


def phase_captured_resnet50_training(pt, ops):
    """Phase 40: phase 32's recipe at B=32 (``resnet50(num_classes=1000)``,
    224 x 224, f32 parameters under bf16 O1, ``Momentum(0.1, 0.9)``),
    BASELINE's metric, the step through ``jit.to_static`` in the captured
    turns.  Four turns from the same seed; the checksum covers the batch
    norms' running statistics.  cuDNN's weight gradients may add in any
    order, so the eager turns are compared first: bit-identical, then the
    captured turns must be too; else within 2x the eager turns'
    distance."""
    import numpy as np
    import torch
    B = RESNET50_BATCHES[0]

    def make():
        model = pt.vision.models.resnet50(num_classes=1000)
        opt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                    parameters=model.parameters())
        rng = np.random.default_rng(0)
        img = torch.from_numpy(rng.standard_normal(
            (B, 3, RESNET50_HW, RESNET50_HW)).astype(np.float32)).cuda()
        label = torch.from_numpy(rng.integers(0, 1000, (B,))).cuda()

        def step(x, y):
            with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
                loss = pt.nn.functional.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()
        return model, step, (img, label), None

    def flops(model, batch):
        return 3 * forward_flops(pt, model, batch[0][:1]) * B

    rows = [train_turn(pt, ops, make, turn == "captured",
                       "captured resnet50 training", "resnet50_train", 0,
                       flops, PEAK_BF16, per_img=B) for turn in TURNS]
    eager = [r for r in rows if r["turn"] == "eager"]
    exact = eager[0]["losses"] == eager[1]["losses"] and \
        eager[0]["checksum"] == eager[1]["checksum"]
    held = hold_turns("captured resnet50 training", rows, exact)
    say(f"  eager turns bit-identical: {exact}; captured turns {held}")
    return dict(turns=rows, eager_bit_identical=exact, held=held)


def free_device_memory():
    """Collect the last phase's objects (the engine and its cache hold
    reference cycles) and return their device memory, so the next phase's
    peak memory is its own."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------
# phases 41-43: float16 (auto_cast's default) and nn breadth
# ---------------------------------------------------------------------
#: GPT O1 float16 parity (phase 41): `BF16_PARITY_TOL`'s readings for a
#: run under ``auto_cast()`` and ``GradScaler()`` with their defaults (f16
#: white-list ops, the f32 black list, the loss scaled by 2^15), each gate
#: between the card run's reading and the control's (fc1's bias dropped,
#: as phase 26), which must fail it.
FP16_PARITY_TOL = dict(loss=6e-5, grad=9e-3, update=1.8e-2)


def fp16_parity_run(pt, ops, cfg, params, ids, labels, device):
    """3 AdamW steps (phase 26's optimizer and clip) of GPT ``cfg`` from
    ``params`` on ``device`` under ``amp.auto_cast()`` and
    ``amp.GradScaler()`` with their defaults: the losses, the step-1
    gradients unscaled (each divided by the scale in f32), the final
    parameters, the launch counts, and the scaler's (found inf, scale)
    after each step."""
    import torch
    model = pt.GPTForCausalLM(cfg, device=device)
    pt.load_reference_state(model, params)
    opt = pt.optimizer.AdamW(
        learning_rate=PARITY_LR, weight_decay=0.01,
        parameters=model.parameters(),
        grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    scaler = pt.amp.GradScaler()
    crit = pt.GPTPretrainingCriterion()
    x, y = (torch.from_numpy(a).to(device) for a in (ids, labels))
    reset_launches(ops)
    losses, grads, decisions = [], None, []
    for _ in range(3):
        with pt.amp.auto_cast():
            loss = crit(model(x), y)
        scaler.scale(loss).backward()
        if grads is None:
            grads = {n: (p.grad.float() / scaler._scale).cpu()
                     for n, p in model.named_parameters()
                     if p.grad is not None}
        scaler.step(opt)
        decisions.append((bool(scaler._found_inf), scaler._scale))
        opt.clear_grad()
        losses.append(float(loss.detach()))
    if device == "cuda":
        torch.cuda.synchronize()
    counts = launches(ops)
    final = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    return losses, grads, final, counts, decisions


def phase_fp16_parity(pt, ops):
    """Phase 41: ``__graft_entry__.entry()``'s GPT at its full width
    (hidden 512, 8 heads, vocab 4096; `OPT_PARITY_CFG`), 2 layers, as
    phase 26 runs GPT_1P3B's (f16 takes no flash kernel in the
    reference's routing, so attention is the composite), under
    ``amp.auto_cast()`` and ``amp.GradScaler()`` with their defaults on
    the card against the port's CPU plain run from the same numpy weights
    and inputs: the losses of 3 steps, the step-1 unscaled gradients and
    the 3 AdamW updates held to `FP16_PARITY_TOL` with the control (fc1's
    bias dropped) failing each gate, and the scaler's found-inf decisions
    and scale after each step equal to the CPU's.  The f16 fc1 epilogue
    (rows 3 and 7) runs on the card.  (At GPT_1P3B's width the CPU leg
    took ~15 minutes: the card's host multiplies f16 at ~1 GFLOP/s.)"""
    import numpy as np
    import torch
    phase = "fp16 parity"
    cfg = pt.GPTConfig(**OPT_PARITY_CFG)
    rng = np.random.default_rng(SEED + 3)
    ids = rng.integers(0, cfg.vocab_size, (2, 128))
    labels = ids.copy()
    labels[0, :3] = -100
    params = numpy_weights(pt.GPTForCausalLM(cfg, device="cpu"), SEED + 2)
    no_bias = {n: np.zeros_like(a) if n.endswith("mlp.fc1.bias") else a
               for n, a in params.items()}
    runs = {}
    for name, device, start in (("control", "cuda", no_bias),
                                ("card", "cuda", params),
                                ("cpu", "cpu", params)):
        runs[name] = fp16_parity_run(pt, ops, cfg, start, ids, labels,
                                     device)
        torch.cuda.empty_cache()
    got, ctl = hold_bf16_gates(phase, runs, params, no_bias,
                               FP16_PARITY_TOL, "fc1's bias dropped")
    decisions = {k: runs[k][4] for k in runs}
    say(f"  scaler (found inf, scale) after each step: card "
        f"{decisions['card']}, CPU {decisions['cpu']}")
    if decisions["card"] != decisions["cpu"]:
        fail(f"{phase}: the scaler decided otherwise on the card: "
             f"{decisions['card']} against {decisions['cpu']}")
    counts = runs["card"][3]
    if not counts["matmul_epilogue"]:
        fail(f"{phase}: the f16 fc1 epilogue never launched")
    check_counts(phase, ops, counts, 3, cfg.num_hidden_layers, "train")
    return dict(losses_cuda=runs["card"][0], losses_cpu=runs["cpu"][0],
                losses_control=runs["control"][0], readings=got,
                control=ctl, tolerance=FP16_PARITY_TOL,
                scaler=decisions["card"])


@contextlib.contextmanager
def plain_serving(pt):
    """The serving path's kernel entry points (ragged attention, layer
    norm, the fc1 epilogue) swapped for their plain versions, which run
    on CUDA tensors as on the CPU: the plain run of a model on the card."""
    from paddle_tpu_torch.inference.serving import attention
    from paddle_tpu_torch.ops import ragged
    ops = pt.ops

    def ragged_plain(q, k_pool, v_pool, *ints, block_q=None, scale=None,
                     k_scales=None, v_scales=None):
        block_q, _, scale = ragged._geometry(q, ints[2], block_q, scale)
        return ops.ragged_attention_ref(q, k_pool, v_pool, *ints, block_q,
                                        scale, k_scales, v_scales)
    saved = (attention.ragged_paged_attention, ops.layer_norm,
             ops.linear_act)
    attention.ragged_paged_attention = ragged_plain
    ops.layer_norm = lambda x, w, b, eps=1e-5: ops.layer_norm_ref(
        x, w, b, eps)[0]
    ops.linear_act = lambda x, w, b, act="none": ops.linear_act_ref(
        x, w, b, act)
    try:
        yield
    finally:
        (attention.ragged_paged_attention, ops.layer_norm,
         ops.linear_act) = saved


def phase_fp16_drives(pt, ops, serving, training, training_flash):
    """Phase 42: float16 at full depth.  The engine serves phase 4's
    trace with GPT_1P3B in f16 (the ragged attention, layer norm and
    epilogue f16 routes), its ms/step beside phase 4's bf16; every
    request's 64 greedy tokens equal the plain f16 run's, the same engine
    and weights with the plain versions (`plain_serving`) on the card (the
    host's CPU multiplies f16 at ~1 GFLOP/s, so a CPU leg of 1.3B
    parameters would take hours).  Then phase 6's recipe (B=4, S=1024,
    composite attention, AdamW, clip 1.0) under ``auto_cast()`` and
    ``GradScaler()`` with their defaults, its ms/step beside phases 6
    and 8 (bf16 O1).  Returns (serving counts, serving summary, training
    counts, training summary)."""
    import numpy as np
    import torch
    phase = "fp16 serving"
    keep = {}
    serve_counts, summary, generated = phase_serving(
        pt, ops, dtype=torch.float16, keep=keep)
    free_device_memory()
    cfg = pt.GPTConfig(**pt.GPT_1P3B)
    prompts, _ = serve_trace(cfg)
    model = pt.GPTForCausalLM(cfg, dtype=torch.float16)
    model.load_state_dict(keep)
    del keep
    with plain_serving(pt):
        eng = pt.GenerationEngine(model, max_batch=8, prefill_chunk=256,
                                  max_model_len=cfg.max_position_embeddings)
        reset_launches(ops)
        t0 = time.perf_counter()
        plain = eng.generate(prompts, max_new_tokens=64)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        plain_counts = launches(ops)
    del eng, model
    if any(plain_counts.values()):
        fail(f"{phase}: the plain run launched kernels: {plain_counts}")
    plain_new = [c[len(p):] for c, p in zip(plain, prompts)]
    same = sum(int(a == b) for x, y in zip(generated, plain_new)
               for a, b in zip(x, y))
    total = sum(len(g) for g in generated)
    say(f"  f16 {summary['ms_per_step']:.2f} ms/step against phase 4's "
        f"bf16 {serving['ms_per_step']:.2f} (this call); greedy tokens: "
        f"{same} of {total} equal to the plain f16 run's ({plain_s:.1f} s, "
        f"no kernel launched)")
    if same != total or any(len(c) != 64 for c in plain_new):
        fail(f"{phase}: {total - same} of {total} greedy tokens differ "
             f"from the plain run's")
    summary.update(greedy_equal=same, greedy_total=total,
                   bf16_ms_per_step=serving["ms_per_step"])

    B = TRAIN_B[False]
    cfg = pt.GPTConfig(**dict(pt.GPT_1P3B, use_flash_attention=False,
                              use_recompute=False))
    L, H = cfg.num_hidden_layers, cfg.hidden_size
    model = pt.GPTForCausalLM(cfg, dtype=torch.float32, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    opt = pt.optimizer.AdamW(
        learning_rate=1e-4, weight_decay=0.01, parameters=model.parameters(),
        grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    scaler = pt.amp.GradScaler()
    crit = pt.GPTPretrainingCriterion()
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (B, TRAIN_S))).cuda()

    def step():
        with pt.amp.auto_cast():
            loss = crit(model(ids), ids)
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        return loss.detach()

    train_counts, train = drive_training(ops, step, n_params, B, L, H,
                                         "fp16 training", "train")
    train.update(scale=scaler._scale,
                 bf16_step_ms={"phase 6": training["step_ms"],
                               "phase 8": training_flash["step_ms"]})
    say(f"  f16 {train['step_ms']:.2f} ms/step against bf16 O1: phase 6 "
        f"{training['step_ms']:.2f}, phase 8 "
        f"{training_flash['step_ms']:.2f} (this call); loss scale "
        f"{scaler._scale:g}")
    return serve_counts, summary, train_counts, train


#: phase 43's cases held in f32 alone: CTC's 50-step forward recursion in
#: bf16 rounds its log-alphas (~-100, an ulp of 0.5) at every step, and
#: the card's and the CPU's bf16 runs parted by 0.13 of the largest
#: magnitude on an H100 80GB HBM3 at 700 W: bf16 is no precision for it.
F32_ONLY = ("ctc_loss", "CTCLoss")

#: phase 43's tolerances: the largest |card - CPU| over the largest CPU
#: magnitude of each output and input gradient.  f32: 1e-5 (transcendentals
#: and sums taken in another order); bf16: 2^-6 (four bf16 ulps at the
#: largest magnitude: elementwise ops round each result once, sums and the
#: CTC recursion in bf16 a few times more).  The cases' thresholds and
#: margins are exact in bf16: with 0.3, PyTorch's CPU and CUDA kernels
#: decided a bf16 input lying on the margin (a kink) differently.
NN_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


def nn_cases(rng):
    """Phase 43's cases: name -> (fn on tensors, numpy inputs, indices of
    the inputs that take a gradient).  Every activation and loss of
    ``nn.functional`` and every activation and loss layer, at a serving
    row block's size (256 x 1024 activations; 256 rows of 1000 classes).
    CTC (`F32_ONLY`) runs in f32 alone."""
    import numpy as np

    def f(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def u(*shape, lo=0.05, hi=0.95):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def i(*shape, hi, lo=0):
        return rng.integers(lo, hi, shape).astype(np.int64)

    def sign(*shape):
        return np.where(rng.standard_normal(shape) >= 0, 1.0,
                        -1.0).astype(np.float32)

    x = f(256, 1024, scale=2.0)
    acts = {
        "relu": lambda F, t: F.relu(t), "relu6": lambda F, t: F.relu6(t * 4),
        "gelu": lambda F, t: F.gelu(t),
        "gelu_tanh": lambda F, t: F.gelu(t, True),
        "sigmoid": lambda F, t: F.sigmoid(t), "silu": lambda F, t: F.silu(t),
        "swish": lambda F, t: F.swish(t), "mish": lambda F, t: F.mish(t),
        "hardswish": lambda F, t: F.hardswish(t),
        "hardsigmoid": lambda F, t: F.hardsigmoid(t),
        "hardtanh": lambda F, t: F.hardtanh(t, -0.5, 1.5),
        "leaky_relu": lambda F, t: F.leaky_relu(t, 0.1),
        "elu": lambda F, t: F.elu(t, 0.5), "selu": lambda F, t: F.selu(t),
        "celu": lambda F, t: F.celu(t, 2.0),
        "rrelu_eval": lambda F, t: F.rrelu(t),
        "softplus": lambda F, t: F.softplus(t, 2.0, 3.0),
        "softshrink": lambda F, t: F.softshrink(t, 0.25),
        "hardshrink": lambda F, t: F.hardshrink(t, 0.25),
        "softsign": lambda F, t: F.softsign(t),
        "tanhshrink": lambda F, t: F.tanhshrink(t),
        "tanh": lambda F, t: F.tanh(t),
        "log_sigmoid": lambda F, t: F.log_sigmoid(t),
        "log_softmax": lambda F, t: F.log_softmax(t),
        "softmax": lambda F, t: F.softmax(t),
        "softmin": lambda F, t: F.softmin(t, axis=0),
        "glu": lambda F, t: F.glu(t), "maxout": lambda F, t: F.maxout(
            t.reshape(256, 64, 16), 4),
        "thresholded_relu": lambda F, t: F.thresholded_relu(t, 0.5, 0.1)}
    cases = {n: (fn, [x], (0,)) for n, fn in acts.items()}
    cases["prelu"] = (lambda F, t, w: F.prelu(t.reshape(16, 64, 256), w),
                      [x, u(64)], (0, 1))
    logits, lab = f(256, 1000), i(256, hi=1000)
    lab[::17] = -100
    logp = (logits - np.log(np.exp(logits).sum(1, keepdims=True))) \
        .astype(np.float32)
    a, b = f(256, 64), f(256, 64)
    p01, y01 = u(256, 64), u(256, 64, lo=0.0, hi=1.0)
    losses = {
        "cross_entropy": (lambda F, t, y, r: F.cross_entropy(t, y,
                                                             reduction=r),
                          [logits, lab]),
        "cross_entropy_smoothed": (
            lambda F, t, y, r: F.cross_entropy(t, y, label_smoothing=0.1,
                                               reduction=r), [logits, lab]),
        "nll_loss": (lambda F, t, y, r: F.nll_loss(t, y, reduction=r),
                     [logp, lab]),
        "mse_loss": (lambda F, t, y, r: F.mse_loss(t, y, r), [a, b]),
        "l1_loss": (lambda F, t, y, r: F.l1_loss(t, y, r), [a, b]),
        "binary_cross_entropy": (
            lambda F, t, y, r: F.binary_cross_entropy(t, y, reduction=r),
            [p01, y01]),
        "binary_cross_entropy_with_logits": (
            lambda F, t, y, r: F.binary_cross_entropy_with_logits(
                t, y, reduction=r), [a, y01]),
        "smooth_l1_loss": (lambda F, t, y, r: F.smooth_l1_loss(
            t, y, r, delta=0.5), [a, b]),
        "huber_loss": (lambda F, t, y, r: F.huber_loss(t, y, 0.75, r),
                       [a, b]),
        "kl_div": (lambda F, t, y, r: F.kl_div(t, y, r),
                   [logp, u(256, 1000)]),
        "margin_ranking_loss": (lambda F, t, o, y, r: F.margin_ranking_loss(
            t, o, y, 0.25, r), [f(4096), f(4096), sign(4096)]),
        "hinge_embedding_loss": (lambda F, t, y, r: F.hinge_embedding_loss(
            t, y, 1.25, r), [a, sign(256, 64)]),
        "cosine_embedding_loss": (
            lambda F, t, o, y, r: F.cosine_embedding_loss(t, o, y, 0.25, r),
            [a, b, sign(256)]),
        "triplet_margin_loss": (
            lambda F, t, p, n, r: F.triplet_margin_loss(t, p, n,
                                                        reduction=r),
            [a, b, f(256, 64)]),
        "poisson_nll_loss": (lambda F, t, y, r: F.poisson_nll_loss(
            t, y, reduction=r), [a, u(256, 64, lo=0.0, hi=4.0)]),
        "gaussian_nll_loss": (lambda F, t, y, v, r: F.gaussian_nll_loss(
            t, y, v, True, reduction=r), [a, b, u(256, 64, lo=0.1, hi=2.0)]),
        "multi_label_soft_margin_loss": (
            lambda F, t, y, r: F.multi_label_soft_margin_loss(
                t, y, reduction=r), [a, y01]),
        "soft_margin_loss": (lambda F, t, y, r: F.soft_margin_loss(t, y, r),
                             [a, sign(256, 64)]),
        "sigmoid_focal_loss": (lambda F, t, y, r: F.sigmoid_focal_loss(
            t, y, reduction=r), [a, y01]),
        "multi_margin_loss": (lambda F, t, y, r: F.multi_margin_loss(
            t, y, reduction=r), [f(256, 10), i(256, hi=10)]),
        "ctc_loss": (lambda F, t, y, il, ll, r: F.ctc_loss(
            t, y, il, ll, reduction=r),
            [f(50, 16, 20), i(16, 10, hi=20, lo=1),
             rng.integers(30, 51, 16).astype(np.int64),
             rng.integers(1, 11, 16).astype(np.int64)]),
        "triplet_margin_with_distance_loss": (
            lambda F, t, p, n, r: F.triplet_margin_with_distance_loss(
                t, p, n, reduction=r), [a, b, f(256, 64)]),
    }
    for n, (fn, arrays) in losses.items():
        for r in ("mean", "sum", "none"):
            cases[f"{n}_{r}"] = (
                lambda F, *t, fn=fn, r=r: fn(F, *t, r), arrays,
                tuple(k for k, arr in enumerate(arrays)
                      if arr.dtype.kind == "f" and k == 0))
    cases["kl_div_batchmean"] = (
        lambda F, t, y: F.kl_div(t, y, "batchmean"), [logp, u(256, 1000)],
        (0,))
    cases["softmax_with_cross_entropy"] = (
        lambda F, t, y: F.softmax_with_cross_entropy(t, y[:, None]),
        [logits, lab], (0,))
    cases["square_error_cost"] = (lambda F, t, y: F.square_error_cost(t, y),
                                  [a, b], (0,))
    cases["log_loss"] = (lambda F, t, y: F.log_loss(t, y),
                         [u(256, 1), u(256, 1, lo=0.0, hi=1.0)], (0,))
    cases["dice_loss"] = (lambda F, t, y: F.dice_loss(t, y),
                          [u(16, 64, 10), i(16, 64, 1, hi=10)], (0,))
    cases["npair_loss"] = (lambda F, t, p, y: F.npair_loss(t, p, y),
                           [a, b, i(256, hi=20)], (0, 1))
    cases["hsigmoid_loss"] = (lambda F, t, y, w, bb: F.hsigmoid_loss(
        t, y, 1000, w, bb), [a, i(256, hi=1000), f(999, 64, scale=0.2),
                             f(999, 1)], (0, 2))
    return cases


def nn_layer_cases(pt, rng):
    """Every activation and loss layer, built alike on both sides (the
    layers with parameters from the CPU layer's state): name -> (layer
    factory taking a device, numpy inputs, gradient indices)."""
    import numpy as np
    import torch
    x = (2 * rng.standard_normal((256, 1024))).astype(np.float32)
    nn = pt.nn
    acts = ["ReLU", "ReLU6", "GELU", "Sigmoid", "Silu", "Swish", "Mish",
            "Hardswish", "Hardsigmoid", "Hardtanh", "LeakyReLU", "ELU",
            "SELU", "CELU", "Softplus", "Softshrink", "Hardshrink",
            "Softsign", "Tanhshrink", "LogSigmoid", "LogSoftmax", "Softmax",
            "Tanh", "GLU", "ThresholdedReLU"]
    cases = {n: (lambda dev, n=n: getattr(nn, n)(), [x], (0,)) for n in acts}
    cases["Maxout"] = (lambda dev: nn.Maxout(4),
                       [x.reshape(256, 64, 16)], (0,))
    cases["RReLU"] = (lambda dev: nn.RReLU().eval(), [x], (0,))
    cases["Softmax2D"] = (lambda dev: nn.Softmax2D(),
                          [x.reshape(4, 16, 64, 64)], (0,))
    logits = rng.standard_normal((256, 1000)).astype(np.float32)
    lab = rng.integers(0, 1000, 256).astype(np.int64)
    a, b = (rng.standard_normal((256, 64)).astype(np.float32)
            for _ in range(2))
    y01 = rng.uniform(0, 1, (256, 64)).astype(np.float32)
    pos = rng.uniform(0.05, 0.95, (256, 64)).astype(np.float32)
    sgn = np.sign(rng.standard_normal((256, 64))).astype(np.float32)
    pairs = {"MSELoss": [a, b], "L1Loss": [a, b], "SmoothL1Loss": [a, b],
             "HuberLoss": [a, b], "SoftMarginLoss": [a, sgn],
             "BCELoss": [pos, y01], "BCEWithLogitsLoss": [a, y01],
             "MultiLabelSoftMarginLoss": [a, y01],
             "PoissonNLLLoss": [a, np.abs(b)],
             "HingeEmbeddingLoss": [a, sgn],
             "KLDivLoss": [np.log(pos), y01],
             "CrossEntropyLoss": [logits, lab],
             "NLLLoss": [logits - np.log(np.exp(logits).sum(1,
                                                            keepdims=True)),
                         lab],
             "MultiMarginLoss": [logits[:, :10], lab % 10]}
    for n, arrays in pairs.items():
        cases[n] = (lambda dev, n=n: getattr(nn, n)(),
                    [np.asarray(v, v.dtype) for v in arrays], (0,))
    cases["MarginRankingLoss"] = (lambda dev: nn.MarginRankingLoss(0.25),
                                  [a[:, 0], b[:, 0], sgn[:, 0]], (0, 1))
    cases["CosineEmbeddingLoss"] = (lambda dev: nn.CosineEmbeddingLoss(0.25),
                                    [a, b, sgn[:, 0]], (0, 1))
    cases["TripletMarginLoss"] = (lambda dev: nn.TripletMarginLoss(),
                                  [a, b, a[::-1].copy()], (0, 1, 2))
    cases["TripletMarginWithDistanceLoss"] = (
        lambda dev: nn.TripletMarginWithDistanceLoss(),
        [a, b, a[::-1].copy()], (0,))
    cases["GaussianNLLLoss"] = (lambda dev: nn.GaussianNLLLoss(),
                                [a, b, pos], (0, 2))
    cases["CTCLoss"] = (lambda dev: nn.CTCLoss(), [
        rng.standard_normal((50, 16, 20)).astype(np.float32),
        rng.integers(1, 20, (16, 10)).astype(np.int64),
        rng.integers(30, 51, 16).astype(np.int64),
        rng.integers(1, 11, 16).astype(np.int64)], (0,))
    hs = nn.HSigmoidLoss(64, 1000, device="cpu")
    state = {k: v.clone() for k, v in hs.state_dict().items()}

    def hsigmoid(dev):
        layer = nn.HSigmoidLoss(64, 1000, device=dev)
        layer.load_state_dict(state)
        return layer
    cases["HSigmoidLoss"] = (hsigmoid, [a, lab], (0,))
    prelu_state = {"weight": torch.from_numpy(
        rng.uniform(0.05, 0.5, 64).astype(np.float32))}

    def prelu(dev):
        layer = nn.PReLU(64, device=dev)
        layer.load_state_dict(prelu_state)
        return layer
    cases["PReLU"] = (prelu, [x.reshape(16, 64, 256)], (0,))
    return cases


def nn_card_vs_cpu(what, fn, arrays, grad, dtype_name):
    """``fn`` on the CPU and on the card from the same numpy ``arrays``,
    the floating ones in ``dtype_name``, those indexed by ``grad`` (if
    any) with gradients under one upstream gradient: the largest error of
    every output and gradient over its largest CPU magnitude (`NN_TOL`
    holds it).  Returns the reading."""
    import numpy as np
    import torch
    dtype = getattr(torch, dtype_name)
    res = {}
    for device in ("cpu", "cuda"):
        ts = []
        for k, a in enumerate(arrays):
            t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
            if t.is_floating_point():
                t = t.to(dtype)
            ts.append(t.requires_grad_() if k in grad else t)
        out = fn(device, *ts)
        if grad:
            up = torch.from_numpy(np.random.default_rng(
                SEED + 43).standard_normal(tuple(out.shape)).astype(
                    np.float32)).to(device)
            (out.float() * up).sum().backward()
        res[device] = [out.detach().cpu()] + [ts[k].grad.cpu() for k in grad]
    worst = 0.0
    for got, want in zip(res["cuda"], res["cpu"]):
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"nn breadth: {what} {dtype_name}: {got.dtype} "
                 f"{tuple(got.shape)} on the card, {want.dtype} "
                 f"{tuple(want.shape)} on the CPU")
        g, w = got.double(), want.double()
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        worst = max(worst, err)
    return worst


def phase_nn_breadth(pt, ops):
    """Phase 43: every activation and loss of ``nn.functional`` and every
    activation and loss layer on the card against the CPU, forward and
    input gradients, in f32 and bf16 (`NN_TOL`); the random ones' draws
    (``rrelu`` in training, ``gumbel_softmax``) by their structure and
    range on the card; ``softmax_with_cross_entropy`` launching the
    softmax cross-entropy kernels (rows 8a/8b) on the card."""
    import numpy as np
    import torch
    F = pt.nn.functional
    rng = np.random.default_rng(SEED + 43)
    worst = {}
    for dtype_name in ("float32", "bfloat16"):
        for name, (fn, arrays, grad) in nn_cases(rng).items():
            if dtype_name == "float32" or not name.startswith(F32_ONLY):
                worst[f"{name} {dtype_name}"] = nn_card_vs_cpu(
                    name, lambda dev, *t, fn=fn: fn(F, *t), arrays, grad,
                    dtype_name)
        for name, (make, arrays, grad) in nn_layer_cases(pt, rng).items():
            if dtype_name == "float32" or not name.startswith(F32_ONLY):
                worst[f"{name} {dtype_name}"] = nn_card_vs_cpu(
                    name, lambda dev, *t, make=make: make(dev).to(
                        getattr(torch, dtype_name))(*t), arrays, grad,
                    dtype_name)
    over = {k: v for k, v in worst.items()
            if not v <= NN_TOL[k.rsplit(" ", 1)[1]]}
    if over:
        fail(f"nn breadth: past {NN_TOL} of the largest magnitude: "
             + ", ".join(f"{k} {v:.3e}" for k, v in over.items()))
    x = torch.randn(256, 1024, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    gen = torch.Generator(device="cuda").manual_seed(2)
    r = F.rrelu(x, 0.1, 0.3, training=True, generator=gen)
    slope = (r[x < 0] / x[x < 0])
    y = F.gumbel_softmax(x, 0.5, hard=True, generator=gen)
    if not (bool(torch.equal(r[x >= 0], x[x >= 0]))
            and 0.1 - 1e-6 <= float(slope.min())
            and float(slope.max()) < 0.3 + 1e-6
            and bool(torch.equal(y.sum(-1), torch.ones(256, device="cuda")))
            and set(torch.unique(y).tolist()) <= {0.0, 1.0}):
        fail("nn breadth: rrelu's or gumbel_softmax's draws on the card")
    logits = torch.randn(4096, 1000, device="cuda", requires_grad=True)
    lab = torch.randint(0, 1000, (4096, 1), device="cuda")
    reset_launches(ops)
    F.softmax_with_cross_entropy(logits, lab).sum().backward()
    torch.cuda.synchronize()
    xent = {k: ops.KERNELS[k].launches for k in ("softmax_xent_fwd",
                                                  "softmax_xent_bwd")}
    if xent != {"softmax_xent_fwd": 1, "softmax_xent_bwd": 1}:
        fail(f"nn breadth: softmax_with_cross_entropy launched {xent}, "
             f"want one forward and one backward kernel")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:6]
    say(f"  {len(worst)} cases (functions, each reduction, layers; f32 and "
        f"bf16) card vs CPU within {NN_TOL}; largest readings: " +
        ", ".join(f"{k} {v:.2e}" for k, v in top) +
        f"; rrelu/gumbel draws in range; softmax_with_cross_entropy "
        f"launches {xent}")
    return dict(cases=len(worst), worst=dict(top), tolerance=NN_TOL,
                softmax_with_cross_entropy_launches=xent)


# ---------------------------------------------------------------------
# phase 44: nn breadth II (common functionals and layers, nn.utils)
# ---------------------------------------------------------------------
def nn_common_cases(rng):
    """Phase 44's cases: name -> (fn on (functional module, *tensors),
    numpy inputs, gradient indices).  Every function of ``nn.functional``
    's ``common`` module and ``flash_attn_unpadded`` at a vision or
    serving block's size: feature maps 8 x 16 x 32 x 32, volumes 2 x 8 x 8
    x 16 x 16, 256 rows of 1024, 1000 packed tokens of 8 heads."""
    import numpy as np

    def f(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    img, vol, seq = f(8, 16, 32, 32), f(2, 8, 8, 16, 16), f(8, 16, 64)
    rows, rows2 = f(256, 1024), f(256, 1024)
    theta = (np.tile(np.eye(2, 3, dtype=np.float32), (8, 1, 1))
             + f(8, 2, 3, scale=0.2))
    grid = rng.uniform(-1.2, 1.2, (8, 24, 24, 2)).astype(np.float32)
    cu = np.array([0, 100, 350, 600, 1000], np.int32)
    qkv = [f(1000, 8, 64) for _ in range(3)]
    lab = rng.integers(0, 1000, (64, 128)).astype(np.int64)
    soft = rng.uniform(0, 1, (256, 1000)).astype(np.float32)

    def interp(**kw):
        return lambda F, t: F.interpolate(t, **kw)

    cases = {
        "interpolate nearest up": (interp(scale_factor=2), [img], (0,)),
        "interpolate nearest down": (interp(size=[20, 13]), [img], (0,)),
        "interpolate bilinear up": (interp(size=[45, 50], mode="bilinear"),
                                    [img], (0,)),
        "interpolate bilinear down": (interp(size=[20, 13], mode="bilinear"),
                                      [img], (0,)),
        "interpolate bicubic up": (interp(size=[45, 50], mode="bicubic"),
                                   [img], (0,)),
        "interpolate bicubic down": (interp(size=[20, 13], mode="bicubic"),
                                     [img], (0,)),
        "interpolate area down": (interp(size=[20, 13], mode="area"), [img],
                                  (0,)),
        "interpolate linear down": (interp(size=[40], mode="linear",
                                           data_format="NCW"), [seq], (0,)),
        "interpolate trilinear down": (interp(size=[5, 9, 11],
                                              mode="trilinear",
                                              data_format="NCDHW"),
                                       [vol], (0,)),
        "interpolate trilinear up": (interp(size=[12, 20, 24],
                                            mode="trilinear",
                                            data_format="NCDHW"), [vol],
                                     (0,)),
        "interpolate align_corners": (interp(size=[45, 50], mode="bilinear",
                                             align_corners=True), [img],
                                      (0,)),
        "interpolate align_mode 1": (interp(size=[20, 13], mode="bilinear",
                                            align_mode=1), [img], (0,)),
        "interpolate NHWC": (interp(size=[20, 45], mode="bilinear",
                                    data_format="NHWC"),
                             [img.transpose(0, 2, 3, 1).copy()], (0,)),
        "pad full form reflect": (lambda F, t: F.pad(
            t, [0, 1, 1, 0, 2, 2, 1, 1], mode="reflect"), [img], (0,)),
        "zeropad2d": (lambda F, t: F.zeropad2d(t, [1, 2, 0, 3]), [img], (0,)),
        "cosine_similarity": (lambda F, a, b: F.cosine_similarity(a, b),
                              [rows, rows2], (0, 1)),
        "pixel_shuffle": (lambda F, t: F.pixel_shuffle(t, 2), [img], (0,)),
        "pixel_unshuffle": (lambda F, t: F.pixel_unshuffle(t, 2), [img],
                            (0,)),
        "unfold": (lambda F, t: F.unfold(t, 3, strides=2,
                                         paddings=[1, 0, 2, 1],
                                         dilations=[1, 2]), [img], (0,)),
        "fold": (lambda F, t: F.fold(t, [32, 32], 3, paddings=1),
                 [f(8, 144, 1024)], (0,)),
        "one_hot": (lambda F, t: F.one_hot(t, 1000), [lab], ()),
        "embedding padding_idx": (lambda F, i, w: F.embedding(
            i, w, padding_idx=0), [lab, f(1000, 256)], (1,)),
        "label_smooth": (lambda F, t: F.label_smooth(t, epsilon=0.1), [soft],
                         (0,)),
        "label_smooth prior": (lambda F, t, p: F.label_smooth(
            t, p, epsilon=0.2), [soft, soft[:1] / soft[:1].sum()], (0, 1)),
        "bilinear": (lambda F, a, b, w, c: F.bilinear(a, b, w, c),
                     [f(256, 64), f(256, 48), f(32, 64, 48, scale=0.1),
                      f(1, 32)], (0, 1, 2, 3)),
        "channel_shuffle": (lambda F, t: F.channel_shuffle(t, 4), [img],
                            (0,)),
        "pairwise_distance": (lambda F, a, b: F.pairwise_distance(a, b),
                              [rows, rows2], (0, 1)),
        "affine_grid": (lambda F, t: F.affine_grid(t, [8, 16, 32, 32]),
                        [theta], (0,)),
        "temporal_shift": (lambda F, t: F.temporal_shift(t, 4),
                           [f(16, 16, 8, 8)], (0,)),
        "flash_attn_unpadded": (lambda F, q, k, v, c: F.flash_attn_unpadded(
            q, k, v, c, c, 400, 400, 0.125)[0], qkv + [cu], (0, 1, 2)),
        "flash_attn_unpadded causal": (
            lambda F, q, k, v, c: F.flash_attn_unpadded(
                q, k, v, c, c, 400, 400, 0.125, causal=True)[0],
            qkv + [cu], (0, 1, 2)),
    }
    for mode in ("constant", "reflect", "replicate", "circular"):
        cases[f"pad {mode}"] = (
            lambda F, t, m=mode: F.pad(t, [1, 2, 3, 4], mode=m, value=0.5),
            [img], (0,))
    # the grid's gradient where a sample's cell is fixed: bilinear with
    # zero or border padding (reflection and nearest hold the image's:
    # a position rounded across a pixel edge moves the grid's gradient)
    for mode, pad, g in (("bilinear", "zeros", (0, 1)),
                         ("bilinear", "border", (0, 1)),
                         ("bilinear", "reflection", (0,)),
                         ("nearest", "zeros", (0,))):
        for align in (True, False):
            cases[f"grid_sample {mode} {pad} {int(align)}"] = (
                lambda F, x, gr, m=mode, p=pad, a=align: F.grid_sample(
                    x, gr, mode=m, padding_mode=p, align_corners=a),
                [img, grid], g)
    return cases


def nn_common_layer_cases(pt, rng):
    """Every layer of ``nn/layer/common.py`` (the random ones in eval),
    ``Bilinear`` from the CPU layer's state: name -> (layer factory taking
    a device, numpy inputs, gradient indices)."""
    import numpy as np
    nn = pt.nn
    img = rng.standard_normal((8, 16, 32, 32)).astype(np.float32)
    a, b = (rng.standard_normal((256, 64)).astype(np.float32)
            for _ in range(2))
    bil = nn.Bilinear(64, 64, 32, device="cpu")
    state = {k: v.clone() for k, v in bil.state_dict().items()}

    def bilinear(dev):
        layer = nn.Bilinear(64, 64, 32, device=dev)
        layer.load_state_dict(state)
        return layer

    return {
        "Identity": (lambda dev: nn.Identity(), [img], (0,)),
        "Dropout2D eval": (lambda dev: nn.Dropout2D(0.5).eval(), [img],
                           (0,)),
        "Dropout3D eval": (lambda dev: nn.Dropout3D(0.5).eval(),
                           [img.reshape(8, 16, 4, 8, 32)], (0,)),
        "AlphaDropout eval": (lambda dev: nn.AlphaDropout(0.5).eval(), [a],
                              (0,)),
        "Upsample": (lambda dev: nn.Upsample(size=[20, 13], mode="bicubic"),
                     [img], (0,)),
        "UpsamplingNearest2D": (lambda dev: nn.UpsamplingNearest2D(
            scale_factor=2), [img], (0,)),
        "UpsamplingBilinear2D": (lambda dev: nn.UpsamplingBilinear2D(
            size=[45, 50]), [img], (0,)),
        "Pad1D": (lambda dev: nn.Pad1D([2, 3], mode="reflect"),
                  [img.reshape(8, 16, 1024)], (0,)),
        "Pad2D": (lambda dev: nn.Pad2D([1, 2, 0, 1], mode="replicate"),
                  [img], (0,)),
        "Pad3D": (lambda dev: nn.Pad3D([1, 0, 1, 1, 2, 0], mode="circular"),
                  [img.reshape(8, 16, 4, 8, 32)], (0,)),
        "ZeroPad2D": (lambda dev: nn.ZeroPad2D([1, 1, 2, 0]), [img], (0,)),
        "CosineSimilarity": (lambda dev: nn.CosineSimilarity(axis=1),
                             [a, b], (0, 1)),
        "Bilinear": (bilinear, [a, b], (0, 1)),
        "Unfold": (lambda dev: nn.Unfold(2, strides=2), [img], (0,)),
        "Fold": (lambda dev: nn.Fold([32, 32], 2, strides=2),
                 [img.reshape(8, 64, 256)], (0,)),
        "PixelShuffle": (lambda dev: nn.PixelShuffle(2), [img], (0,)),
        "PixelUnshuffle": (lambda dev: nn.PixelUnshuffle(2), [img], (0,)),
        "Unflatten": (lambda dev: nn.Unflatten(1, [4, 4]), [img], (0,)),
        "PairwiseDistance": (lambda dev: nn.PairwiseDistance(1.5), [a, b],
                             (0, 1)),
        "ChannelShuffle": (lambda dev: nn.ChannelShuffle(4), [img], (0,)),
    }


def nn_utils_card_vs_cpu(pt, dtype_name):
    """``nn.utils`` on the card against the CPU: ``clip_grad_norm_`` (2 and
    inf), ``clip_grad_value_``, ``parameters_to_vector`` /
    ``vector_to_parameters``, and ``weight_norm`` / ``spectral_norm`` on a
    ``Linear`` and a ``Conv2D`` (forward, the input's and every
    parameter's gradient).  Returns name -> reading (`nn_card_vs_cpu`'s)."""
    import numpy as np
    import torch
    dtype = getattr(torch, dtype_name)
    rng = np.random.default_rng(SEED + 44)
    worst = {}

    def reading(got, want):
        g, w = got.detach().cpu().double(), want.detach().cpu().double()
        return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)

    shapes = ((1024, 1024), (4096,), (64, 3, 7, 7))
    ws = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    gs = [3 * rng.standard_normal(s).astype(np.float32) for s in shapes]

    def params(dev):
        # copies: the functions write the parameters and gradients in place
        ps = [torch.nn.Parameter(torch.tensor(w, dtype=dtype, device=dev))
              for w in ws]
        for p, g in zip(ps, gs):
            p.grad = torch.tensor(g, dtype=dtype, device=dev)
        return ps

    for norm in (2.0, float("inf")):
        res = {}
        for dev in ("cpu", "cuda"):
            ps = params(dev)
            total = pt.nn.clip_grad_norm_(ps, 5.0, norm)
            res[dev] = [total] + [p.grad for p in ps]
        worst[f"clip_grad_norm_ {norm}"] = max(
            reading(g, w) for g, w in zip(res["cuda"], res["cpu"]))
    res = {}
    for dev in ("cpu", "cuda"):
        ps = params(dev)
        pt.nn.clip_grad_value_(ps, 1.5)
        vec = pt.nn.utils.parameters_to_vector(ps)
        pt.nn.utils.vector_to_parameters(vec * 0.5, ps)
        res[dev] = [p.grad for p in ps] + [vec] + ps
    worst["clip_grad_value_, parameter vectors"] = max(
        reading(g, w) for g, w in zip(res["cuda"], res["cpu"]))
    x_lin = rng.standard_normal((256, 512)).astype(np.float32)
    x_conv = rng.standard_normal((8, 16, 32, 32)).astype(np.float32)
    for reparam in ("weight_norm", "spectral_norm"):
        for kind, x in (("Linear", x_lin), ("Conv2D", x_conv)):
            cpu_layer = (pt.nn.Linear(512, 256, device="cpu")
                         if kind == "Linear"
                         else pt.nn.Conv2D(16, 32, 3, device="cpu"))
            getattr(pt.nn.utils, reparam)(cpu_layer)
            state = {k: v.clone() for k, v in cpu_layer.state_dict().items()}
            res = {}
            for dev in ("cpu", "cuda"):
                layer = (pt.nn.Linear(512, 256, device=dev)
                         if kind == "Linear"
                         else pt.nn.Conv2D(16, 32, 3, device=dev))
                getattr(pt.nn.utils, reparam)(layer)
                layer.load_state_dict(state)
                layer.to(dtype)
                t = torch.from_numpy(x).to(dev, dtype).requires_grad_()
                out = layer(t)
                up = torch.from_numpy(np.random.default_rng(
                    SEED + 45).standard_normal(tuple(out.shape)).astype(
                        np.float32)).to(dev)
                (out.float() * up).sum().backward()
                res[dev] = [out, t.grad] + [p.grad for p in
                                            layer.parameters()]
            worst[f"{reparam} {kind}"] = max(
                reading(g, w) for g, w in zip(res["cuda"], res["cpu"]))
    return {f"{k} {dtype_name}": v for k, v in worst.items()}


def phase_nn_common(pt):
    """Phase 44: every function of ``nn.functional``'s ``common`` module,
    ``flash_attn_unpadded`` (causal and not), every layer of
    ``nn/layer/common.py`` and the ``nn.utils`` functions on the card
    against the CPU, forward and input gradients, in f32 and bf16
    (`NN_TOL`); ``class_center_sample`` equal on both; the random ones'
    draws by their structure on the card: whole channels kept or dropped
    by ``dropout2d``/``dropout3d`` (kept ones scaled by 1/(1-p)), one
    draw along ``axis``, ``downscale_in_infer`` unscaled in training, the
    mean and variance ``alpha_dropout`` keeps, ``feature_alpha_dropout``
    constant over each feature map."""
    import numpy as np
    import torch
    F = pt.nn.functional
    rng = np.random.default_rng(SEED + 44)
    worst = {}
    for dtype_name in ("float32", "bfloat16"):
        for name, (fn, arrays, grad) in nn_common_cases(rng).items():
            worst[f"{name} {dtype_name}"] = nn_card_vs_cpu(
                name, lambda dev, *t, fn=fn: fn(F, *t), arrays, grad,
                dtype_name)
        for name, (make, arrays, grad) in nn_common_layer_cases(
                pt, rng).items():
            worst[f"{name} {dtype_name}"] = nn_card_vs_cpu(
                name, lambda dev, *t, make=make: make(dev).to(
                    getattr(torch, dtype_name))(*t), arrays, grad,
                dtype_name)
        worst.update(nn_utils_card_vs_cpu(pt, dtype_name))
    over = {k: v for k, v in worst.items()
            if not v <= NN_TOL[k.rsplit(" ", 1)[1]]}
    if over:
        fail(f"nn breadth II: past {NN_TOL} of the largest magnitude: "
             + ", ".join(f"{k} {v:.3e}" for k, v in over.items()))
    lab = rng.integers(0, 5000, 4096)
    sampled = [F.class_center_sample(torch.from_numpy(lab).to(dev), 5000,
                                     3000) for dev in ("cpu", "cuda")]
    if not all(torch.equal(a, b.cpu()) for a, b in zip(*sampled)):
        fail("nn breadth II: class_center_sample differs on the card")
    gen = torch.Generator(device="cuda").manual_seed(3)
    ones = torch.ones(64, 32, 16, 16, device="cuda")
    d2 = F.dropout2d(ones, 0.4, generator=gen).reshape(64, 32, -1)
    d3 = F.dropout3d(ones.reshape(64, 32, 4, 4, 16), 0.4,
                     generator=gen).reshape(64, 32, -1)
    ax = F.dropout(ones, 0.5, axis=[0, 2], generator=gen)
    down = F.dropout(ones, 0.5, mode="downscale_in_infer", generator=gen)
    normal = torch.randn(1 << 20, device="cuda", generator=gen)
    ad = F.alpha_dropout(normal, 0.5, generator=gen)
    fa = F.feature_alpha_dropout(ones, 0.5, generator=gen).reshape(64, 32, -1)
    kept = float((d2[..., 0] != 0).float().mean())
    checks = {
        "dropout2d whole channels": bool(torch.equal(d2.amin(-1),
                                                     d2.amax(-1))),
        "dropout3d whole channels": bool(torch.equal(d3.amin(-1),
                                                     d3.amax(-1))),
        "dropout2d values": set(torch.unique(d2).tolist())
        <= {0.0, float(torch.tensor(1 / 0.6))},
        "dropout2d keep share": abs(kept - 0.6) < 0.05,
        "dropout axis": bool(torch.equal(ax.amin((1, 3)), ax.amax((1, 3)))),
        "downscale_in_infer": set(torch.unique(down).tolist()) <= {0.0, 1.0},
        "alpha_dropout mean": abs(float(ad.mean())) < 0.01,
        "alpha_dropout variance": abs(float(ad.var()) - 1.0) < 0.02,
        "feature_alpha_dropout maps": bool(torch.equal(fa.amin(-1),
                                                       fa.amax(-1))),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"nn breadth II: draws on the card: {bad}")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:6]
    say(f"  {len(worst)} cases (functions, layers, nn.utils; f32 and bf16) "
        f"card vs CPU within {NN_TOL}; largest readings: " +
        ", ".join(f"{k} {v:.2e}" for k, v in top) +
        f"; class_center_sample equal; draws by structure: {len(checks)} "
        f"checks (dropout2d keeps {kept:.3f}, alpha_dropout mean "
        f"{float(ad.mean()):.4f} var {float(ad.var()):.4f})")
    return dict(cases=len(worst), worst=dict(top), tolerance=NN_TOL,
                draw_checks=len(checks), dropout2d_keep_share=kept)


# ---------------------------------------------------------------------
# phase 45: Transformer-base (Vaswani et al. 2017, Table 3 "base")
# ---------------------------------------------------------------------
#: the paper's shared WMT14 en-de BPE vocabulary, about 37000 tokens
TRANSFORMER_VOCAB = 37000
TRANSFORMER_D, TRANSFORMER_FF, TRANSFORMER_HEADS = 512, 2048, 8
TRANSFORMER_LAYERS = 6
#: 32 pairs of 128 source and 128 target tokens: 4096 tokens a side
TRANSFORMER_B, TRANSFORMER_S = 32, 128
TRANSFORMER_STEPS = 10
DECODE_B, DECODE_STEPS, DECODE_BOS = 8, 32, 1


def seq2seq(pt, device, layers=TRANSFORMER_LAYERS, dropout=0.1, seed=SEED):
    """Transformer-base as a translation model: ``nn.Transformer``
    (post-norm, relu, dropout on the sublayer outputs only) with one
    ``[vocab, 512]`` embedding shared by source, target and the
    pre-softmax projection (N(0, 512^-0.5)), scaled by sqrt(512) and
    added to sinusoidal positional encodings, dropout on the sums."""
    import numpy as np
    import torch
    d = TRANSFORMER_D

    class Seq2Seq(torch.nn.Module):
        def __init__(self):
            super().__init__()
            gen = torch.Generator(device=device).manual_seed(seed)
            self.embedding = pt.nn.Embedding(TRANSFORMER_VOCAB, d,
                                             device=device, generator=gen)
            pt.nn.initializer.Normal(0.0, d ** -0.5)(self.embedding.weight,
                                                     gen)
            self.transformer = pt.nn.Transformer(
                d, TRANSFORMER_HEADS, layers, layers, TRANSFORMER_FF,
                dropout=dropout, activation="relu", attn_dropout=0.0,
                act_dropout=0.0, device=device, generator=gen)
            self.dropout = pt.nn.Dropout(dropout, generator=gen)
            pos = np.arange(1024)[:, None]
            freq = 10000.0 ** (-np.arange(0, d, 2) / d)
            pe = np.zeros((1024, d))
            pe[:, 0::2], pe[:, 1::2] = np.sin(pos * freq), np.cos(pos * freq)
            self.register_buffer("pe", torch.tensor(
                pe, dtype=torch.float32, device=device), persistent=False)

        def embed(self, ids, start=0):
            x = self.embedding(ids) * d ** 0.5
            return self.dropout(x + self.pe[start:start + ids.shape[1]])

        def logits(self, h):
            return pt.nn.functional.matmul(h, self.embedding.weight,
                                           transpose_y=True)

        def forward(self, src, tgt):
            mask = self.transformer.generate_square_subsequent_mask(
                tgt.shape[1], device=src.device)
            return self.logits(self.transformer(
                self.embed(src), self.embed(tgt), tgt_mask=mask))

    return Seq2Seq()


def smoothed_loss(pt, logits, labels):
    """PaddleNLP's criterion for this model: cross-entropy against the
    one-hot labels smoothed by 0.1, as soft labels."""
    F = pt.nn.functional
    soft = F.label_smooth(F.one_hot(labels, logits.shape[-1]), epsilon=0.1)
    return F.cross_entropy(logits, soft, soft_label=True)


def transformer_flops(B, S, T, layers=TRANSFORMER_LAYERS):
    """Training flop per step: 6 N per token for the matmul parameters
    (the encoder's over the source tokens; the decoder's and the tied
    projection's over the target tokens) plus 12 d per query-key pair for
    the attention products (QK^T and PV, forward and backward) of encoder
    self-attention (S x S), decoder self-attention (T x T, the full
    matrix the masked composite computes) and cross-attention (T x S)."""
    d, ff, v = TRANSFORMER_D, TRANSFORMER_FF, TRANSFORMER_VOCAB
    n_enc = layers * (4 * d * d + 2 * d * ff)
    n_dec = layers * (8 * d * d + 2 * d * ff) + d * v
    attn = 12 * d * B * layers * (S * S + T * T + T * S)
    return 6 * (n_enc * B * S + n_dec * B * T) + attn


def seq2seq_batch(rng, B, S):
    """Synthetic pairs: source ids and a target of ``S + 1`` ids split
    into the decoder's input and its labels (ids from 4 up: 0-3 are the
    special tokens)."""
    src = rng.integers(4, TRANSFORMER_VOCAB, (B, S))
    tgt = rng.integers(4, TRANSFORMER_VOCAB, (B, S + 1))
    tgt[:, 0] = DECODE_BOS
    return src, tgt[:, :-1], tgt[:, 1:]


def greedy_decode(model, src, steps, cached):
    """``steps`` greedy tokens from ``DECODE_BOS`` for each source row:
    with ``cached`` the decoder runs one new position a step over the
    ``gen_cache`` caches (Cache for self-attention, StaticCache of the
    projected memory); otherwise it runs again over the whole prefix
    under the causal mask.  Returns the tokens [B, steps] and the gap
    between the two largest logits of each step [steps, B]."""
    import torch
    dec = model.transformer.decoder
    with torch.no_grad():
        memory = model.transformer.encoder(model.embed(src))
        toks = torch.full((src.shape[0], 1), DECODE_BOS, dtype=torch.long,
                          device=src.device)
        caches = dec.gen_cache(memory) if cached else None
        gaps = []
        for t in range(steps):
            if cached:
                h, caches = dec(model.embed(toks[:, -1:], start=t), memory,
                                cache=caches)
            else:
                mask = model.transformer.generate_square_subsequent_mask(
                    t + 1, device=src.device)
                h = dec(model.embed(toks), memory, tgt_mask=mask)
            logits = model.logits(h[:, -1])
            top2 = logits.topk(2, dim=-1).values
            gaps.append((top2[:, 0] - top2[:, 1]).cpu())
            toks = torch.cat([toks, logits.argmax(-1, keepdim=True)], 1)
    return toks[:, 1:].cpu(), torch.stack(gaps)


def tokens_gate(phase, what, got, want, gaps):
    """``got`` must equal ``want``; else the first differing step and row
    and the logit gap there are reported and the phase fails."""
    import torch
    if torch.equal(got, want):
        return
    rows, cols = (got != want).nonzero(as_tuple=True)
    t = int(cols.min())
    b = int(rows[cols == t][0])
    fail(f"{phase}: {what}: tokens part at step {t}, row {b} "
         f"({int(got[b, t])} vs {int(want[b, t])}); the top-2 logit gap "
         f"there {float(gaps[t, b]):.3e}")


def phase_transformer(pt, ops):
    """Phase 45: Transformer-base (d_model 512, 8 heads, FFN 2048, 6 + 6
    post-norm layers, relu; the shared [37000, 512] embedding).
    (a) Training: B=32 pairs of 128 + 128 tokens, dropout 0.1 on the
    sublayer outputs and embeddings only (attention and activation
    dropout 0, so attention can take flash), bf16 O1, AdamW(7e-4, 0.9,
    0.98, 1e-9), the label-smoothed loss: 2 warm-up and 10 timed steps;
    ms/step, target tokens/s, MFU, peak memory, the idle share, and the
    launches per step of rows 3-7 and 13 (`KERNEL_INFO`'s
    ``transformer_train``).  (b) Parity: the same widths at 2 + 2 layers,
    f32, dropout 0, relu, 3 AdamW steps, card vs CPU, held as phase 5
    holds GPT.  Where a relu's input lies within rounding of 0 the two
    devices take its two sides, and AdamW turns the parted gradient of
    that unit's weights into steps of +-lr: the CPU runs first and
    records the feed-forward pre-activations within `KINK_BAND` of 0,
    and the card's relus take the CPU's derivative there
    (`ReluKinks.epilogue`; the relu runs inside row 3's epilogue).  The
    key projections' biases have a zero gradient in exact arithmetic:
    theirs is held against the largest gradient (``zero_grads``).
    (c) Incremental decoding on the 6 + 6 model in f32: B=8 sources of
    128 tokens, 32 greedy steps with ``gen_cache`` (flash with one query
    row a step), against the full recompute under the causal mask on the
    card (the composite) and the cached steps on the CPU: tokens equal."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 45)
    B, S = TRANSFORMER_B, TRANSFORMER_S
    model = seq2seq(pt, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    opt = pt.optimizer.AdamW(learning_rate=7e-4, beta1=0.9, beta2=0.98,
                             epsilon=1e-9, parameters=model.parameters())
    src, tgt_in, labels = (torch.from_numpy(a).cuda()
                           for a in seq2seq_batch(rng, B, S))

    def step():
        with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
            loss = smoothed_loss(pt, model(src, tgt_in), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    flops = transformer_flops(B, S, S)
    counts, training = drive_training(
        ops, step, n_params, B, TRANSFORMER_LAYERS, TRANSFORMER_D,
        "transformer training", "transformer_train", S=S,
        steps=TRANSFORMER_STEPS,
        flops=(flops, "6 N_enc B S + 6 (N_dec + N_proj) B T + 12 d B L "
                      "(S^2 + T^2 + T S)"))
    training["flop_per_step"] = flops
    training["launches_per_step"] = {k: v // TRANSFORMER_STEPS
                                     for k, v in counts.items() if v}
    del model, opt
    free_device_memory()

    # (b) parity at 2 + 2 layers
    layers = 2
    src2, tin2, lab2 = seq2seq_batch(rng, 2, S)
    ids = np.concatenate([src2, tin2], 1)
    params = {k: v.numpy() for k, v in seq2seq(
        pt, "cpu", layers, 0.0).state_dict().items()}

    def loss_of(m, x, y):
        return smoothed_loss(pt, m(x[:, :S], x[:, S:]), y)

    runs, kinks = {}, ReluKinks()
    for device in ("cpu", "cuda"):
        kinks.rewind()
        with kinks.epilogue(pt, record=device == "cpu"):
            runs[device] = train_parity_run(
                pt, ops, lambda dev: seq2seq(pt, dev, layers, 0.0), loss_of,
                params, ids, lab2, device, track_small=device == "cpu")
    if kinks.calls != len(kinks.sides):
        fail(f"transformer training parity: the card ran {kinks.calls} "
             f"relu epilogues, the CPU {len(kinks.sides)}")
    say(f"  {kinks.held} relu inputs within {KINK_BAND:g} of 0 in "
        f"{kinks.calls} epilogue calls took the CPU run's derivative")
    parity = hold_parity("transformer training parity", params, runs,
                         sign_free=True,
                         zero_grads=lambda n: n.endswith("k_proj.bias"))
    parity["relu_inputs_held"] = kinks.held
    check_counts("transformer training parity", ops, runs["cuda"][3], 3,
                 layers, "transformer_parity")
    free_device_memory()

    # (c) incremental decoding, f32, 6 + 6 layers
    card = seq2seq(pt, "cuda", dropout=0.0).eval()
    cpu = seq2seq(pt, "cpu", dropout=0.0).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    dsrc = rng.integers(4, TRANSFORMER_VOCAB, (DECODE_B, S))
    reset_launches(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cached, gaps = greedy_decode(card, torch.from_numpy(dsrc).cuda(),
                                 DECODE_STEPS, True)
    torch.cuda.synchronize()
    cached_s = time.perf_counter() - t0
    flash = ops.KERNELS["flash_attention_fwd"].launches
    want_flash = TRANSFORMER_LAYERS + 2 * TRANSFORMER_LAYERS * DECODE_STEPS
    if flash != want_flash:
        fail(f"transformer decoding: flash forward launched {flash} times, "
             f"want {want_flash} (the encoder's 6, then self- and "
             f"cross-attention of each layer each step)")
    t0 = time.perf_counter()
    full, _ = greedy_decode(card, torch.from_numpy(dsrc).cuda(),
                            DECODE_STEPS, False)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    on_cpu, cpu_gaps = greedy_decode(cpu, torch.from_numpy(dsrc),
                                     DECODE_STEPS, True)
    tokens_gate("transformer decoding", "cached vs full recompute on the "
                "card", cached, full, gaps)
    tokens_gate("transformer decoding", "card vs CPU", cached, on_cpu,
                cpu_gaps)
    decoding = dict(batch=DECODE_B, steps=DECODE_STEPS,
                    ms_per_step_cached=cached_s / DECODE_STEPS * 1e3,
                    ms_per_step_recompute=full_s / DECODE_STEPS * 1e3,
                    flash_launches=flash,
                    min_top2_logit_gap=float(gaps.min()),
                    tokens_equal=True)
    say(f"  decoding B={DECODE_B}, {DECODE_STEPS} greedy steps (f32): cached "
        f"{decoding['ms_per_step_cached']:.2f} ms/step ({flash} flash "
        f"launches), full recompute "
        f"{decoding['ms_per_step_recompute']:.2f} ms/step; tokens equal "
        f"(cached = recompute = CPU); smallest top-2 logit gap "
        f"{decoding['min_top2_logit_gap']:.3e}")
    del card, cpu
    free_device_memory()
    return counts, dict(training=training, parity=parity, decoding=decoding)


# ---------------------------------------------------------------------
# phase 46: recurrent nets (Zaremba et al. 2014 "medium" PTB LSTM)
# ---------------------------------------------------------------------
PTB_VOCAB, PTB_HIDDEN, PTB_LAYERS = 10000, 650, 2
PTB_B, PTB_T, PTB_STEPS, PTB_LR, PTB_CLIP = 20, 35, 20, 1.0, 5.0


def ptb_model(pt, device, dropout, seed=SEED):
    """The "medium" PTB language model: a 650-wide embedding, a 2-layer
    ``LSTM`` of 650 units and a projection to the 10000 words, weights
    uniform in [-0.05, 0.05], dropout ``dropout`` on the embedding and
    the LSTM's output (the LSTM's own ``dropout`` between layers is not
    applied, as in the reference)."""
    import torch

    class PTBModel(torch.nn.Module):
        def __init__(self):
            super().__init__()
            gen = torch.Generator(device=device).manual_seed(seed)
            kw = dict(device=device, generator=gen)
            self.embedding = pt.nn.Embedding(PTB_VOCAB, PTB_HIDDEN, **kw)
            self.lstm = pt.nn.LSTM(PTB_HIDDEN, PTB_HIDDEN, PTB_LAYERS,
                                   dropout=dropout, **kw)
            self.fc = pt.nn.Linear(PTB_HIDDEN, PTB_VOCAB, **kw)
            self.dropout = pt.nn.Dropout(dropout, generator=gen)
            for p in self.parameters():
                pt.nn.initializer.Uniform(-0.05, 0.05)(p, gen)

        def forward(self, x, state=None):
            y, state = self.lstm(self.dropout(self.embedding(x)), state)
            return self.fc(self.dropout(y)), state

    return PTBModel()


def ptb_loss(pt, logits, y):
    return pt.nn.functional.cross_entropy(logits.reshape(-1, PTB_VOCAB),
                                          y.reshape(-1))


def ptb_stream(rng, steps):
    """A Zipf-distributed token stream (a=1.2, folded into the
    vocabulary) cut into ``PTB_B`` rows, ``steps`` windows of ``PTB_T``
    inputs and their next-word labels."""
    import numpy as np
    n = PTB_T * steps + 1
    stream = (rng.zipf(1.2, PTB_B * n) - 1) % PTB_VOCAB
    rows = stream.reshape(PTB_B, n).astype(np.int64)
    return [(rows[:, i * PTB_T:(i + 1) * PTB_T],
             rows[:, i * PTB_T + 1:(i + 1) * PTB_T + 1])
            for i in range(steps)]


def ptb_parity(pt, ops):
    """Card vs CPU, f32, dropout 0: 3 SGD(1.0) steps with
    ``nn.utils.clip_grad_norm_`` at 5 on consecutive windows with the
    state carried: losses, step-1 gradients, parameters (`hold_parity`)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 46)
    windows = ptb_stream(rng, 3)
    params = {k: v.numpy() for k, v in
              ptb_model(pt, "cpu", 0.0).state_dict().items()}
    runs = {}
    for device in ("cuda", "cpu"):
        model = ptb_model(pt, device, 0.0)
        pt.load_reference_state(model, params)
        opt = pt.optimizer.SGD(learning_rate=PTB_LR,
                               parameters=model.parameters())
        reset_launches(ops)
        losses, grads, state = [], None, None
        for x, y in windows:
            x, y = (torch.from_numpy(a).to(device) for a in (x, y))
            logits, state = model(x, state)
            state = tuple(s.detach() for s in state)
            loss = ptb_loss(pt, logits, y)
            loss.backward()
            if grads is None:
                grads = {n: p.grad.detach().cpu().clone()
                         for n, p in model.named_parameters()}
            pt.nn.clip_grad_norm_(model.parameters(), PTB_CLIP)
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.detach()))
        final = {n: p.detach().cpu().clone()
                 for n, p in model.named_parameters()}
        runs[device] = (losses, grads, final, launches(ops), {}, 3)
    out = hold_parity("ptb parity", params, runs, step_bound=PTB_LR)
    check_counts("ptb parity", ops, runs["cuda"][3], 3, PTB_LAYERS,
                 "ptb_train", routes=False)
    return out


def rnn_cases(pt, rng):
    """Phase 46's held layers: name -> (layer factory on a device, numpy
    inputs, gradient indices); each layer's state from its CPU twin."""
    import numpy as np
    import torch
    nn = pt.nn

    def twin(make):
        state = {k: v.clone() for k, v in make("cpu").state_dict().items()}

        def build(dev):
            layer = make(dev)
            layer.load_state_dict(state)
            return layer
        return build

    x = rng.standard_normal((16, 50, 128)).astype(np.float32)
    lens = rng.integers(10, 51, 16).astype(np.int64)
    lens[0] = 50
    small = rng.standard_normal((8, 20, 64)).astype(np.float32)
    slens = rng.integers(5, 21, 8).astype(np.int64)
    gru = twin(lambda d: nn.GRU(128, 256, 2, direction="bidirect", device=d))
    relu = twin(lambda d: nn.SimpleRNN(128, 256, activation="relu",
                                       time_major=True, device=d))
    cell = twin(lambda d: nn.RNN(nn.LSTMCell(64, 128, device=d)))
    bi = twin(lambda d: nn.BiRNN(nn.GRUCell(64, 128, device=d),
                                 nn.GRUCell(64, 128, device=d)))

    def first(out):
        return out[0]
    return {
        "GRU bidirect 2 layers, lengths": (
            lambda d, t, n: first(gru(d)(t, sequence_length=n)), [x, lens],
            (0,)),
        "SimpleRNN relu time_major": (
            lambda d, t: first(relu(d)(t)), [x.transpose(1, 0, 2).copy()],
            (0,)),
        "RNN(LSTMCell) lengths": (
            lambda d, t, n: first(cell(d)(t, sequence_length=n)),
            [small, slens], (0,)),
        "BiRNN(GRUCell) lengths": (
            lambda d, t, n: first(bi(d)(t, sequence_length=n)),
            [small, slens], (0,)),
    }


def beam_search_card_vs_cpu(pt):
    """``BeamSearchDecoder`` over an ``LSTMCell`` (embedding 256, 1000
    words), beam 4, 32 steps, B=4, from the same weights and states:
    token ids and lengths equal on the card and the CPU."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 47)
    h0 = (0.5 * rng.standard_normal((4, 256))).astype(np.float32)
    c0 = (0.5 * rng.standard_normal((4, 256))).astype(np.float32)
    parts = {}
    for dev in ("cpu", "cuda"):
        gen = torch.Generator().manual_seed(SEED)
        emb = pt.nn.Embedding(1000, 256, device="cpu", generator=gen)
        cell = pt.nn.LSTMCell(256, 256, device="cpu", generator=gen)
        proj = pt.nn.Linear(256, 1000, device="cpu", generator=gen)
        emb, cell, proj = (m.to(dev) for m in (emb, cell, proj))
        dec = pt.nn.BeamSearchDecoder(cell, 0, 999, 4, embedding_fn=emb,
                                      output_fn=proj)
        with torch.no_grad():
            parts[dev] = pt.nn.dynamic_decode(
                dec, inits=(torch.from_numpy(h0).to(dev),
                            torch.from_numpy(c0).to(dev)), max_step_num=32)
    seq, lens = (t.cpu() for t in parts["cuda"])
    if not (torch.equal(seq, parts["cpu"][0])
            and torch.equal(lens, parts["cpu"][1])):
        fail("recurrent nets: beam search tokens or lengths differ on the "
             "card")
    return dict(shape=list(seq.shape), lengths=lens.tolist())


def phase_recurrent(pt, ops):
    """Phase 46: (a) the PTB "medium" LSTM trained on the card, f32, SGD
    at lr 1.0 with ``clip_grad_norm_`` at 5, dropout 0.5, B=20 windows of
    35 words of a Zipf stream with the state carried: 2 warm-up and 20
    timed steps, ms/step, words/s, the loss falls, the softmax
    cross-entropy kernels once a step, the LSTM's weights still one flat
    buffer after the steps; (b) its parity card vs CPU; (c)
    card vs CPU in f32 (`NN_TOL`): a bidirectional 2-layer GRU with
    ``sequence_length``, ``SimpleRNN`` relu ``time_major``, ``RNN
    (LSTMCell)`` and ``BiRNN(GRUCell)`` with lengths, forward and input
    gradient; beam search tokens and lengths exactly equal; (d) the
    whole-sequence op under O2 bf16 on the card (cuDNN's bf16 route)
    against the CPU within 2^-5."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 46)
    model = ptb_model(pt, "cuda", 0.5)
    opt = pt.optimizer.SGD(learning_rate=PTB_LR,
                           parameters=model.parameters())
    windows = [tuple(torch.from_numpy(a).cuda() for a in w)
               for w in ptb_stream(rng, PTB_STEPS + 2)]
    carry = {"state": None, "i": 0}

    def step():
        x, y = windows[carry["i"] % len(windows)]
        carry["i"] += 1
        logits, state = model(x, carry["state"])
        carry["state"] = tuple(s.detach() for s in state)
        loss = ptb_loss(pt, logits, y)
        loss.backward()
        pt.nn.clip_grad_norm_(model.parameters(), PTB_CLIP)
        opt.step()
        opt.clear_grad()
        return loss.detach()

    losses = [float(step()) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    reset_launches(ops)
    t0 = time.perf_counter()
    losses += [step() for _ in range(PTB_STEPS)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = launches(ops)
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"ptb training: the loss did not fall: {losses}")
    check_counts("ptb training", ops, counts, PTB_STEPS, PTB_LAYERS,
                 "ptb_train", routes=False)
    storages = {p.untyped_storage().data_ptr()
                for p in model.lstm.parameters()}
    if len(storages) != 1:
        fail(f"ptb training: the LSTM's weights lie in {len(storages)} "
             f"buffers, not one (cuDNN would copy them on every call)")
    training = dict(batch=PTB_B, unroll=PTB_T, steps=PTB_STEPS,
                    step_ms=elapsed / PTB_STEPS * 1e3,
                    words_per_s=PTB_B * PTB_T * PTB_STEPS / elapsed,
                    losses=losses,
                    n_params=sum(p.numel() for p in model.parameters()))
    say(f"  PTB medium LSTM: {PTB_STEPS} steps in {elapsed:.3f} s: "
        f"{training['step_ms']:.2f} ms/step, {training['words_per_s']:.1f} "
        f"words/s; losses {losses[0]:.3f} -> {losses[-1]:.3f}")
    training["profile"] = split_profile(profile_device(step), 1, "PTB step")
    del model, opt
    free_device_memory()
    parity = ptb_parity(pt, ops)
    worst = {}
    for name, (fn, arrays, grad) in rnn_cases(pt, rng).items():
        worst[name] = nn_card_vs_cpu(name, fn, arrays, grad, "float32")
    over = {k: v for k, v in worst.items() if not v <= NN_TOL["float32"]}
    if over:
        fail(f"recurrent nets: past {NN_TOL['float32']} of the largest "
             f"magnitude: {over}")
    beam = beam_search_card_vs_cpu(pt)
    x = np.random.default_rng(SEED + 48).standard_normal(
        (16, 50, 128)).astype(np.float32)
    lstm = pt.nn.LSTM(128, 256, 2, direction="bidirect", device="cpu")
    state = {k: v.clone() for k, v in lstm.state_dict().items()}

    def o2_lstm(dev, t):
        layer = pt.nn.LSTM(128, 256, 2, direction="bidirect", device=dev)
        layer.load_state_dict(state)
        with pt.amp.auto_cast(level="O2", dtype="bfloat16"):
            return layer(t)[0]
    bf16 = nn_card_vs_cpu("LSTM under O2 bf16", o2_lstm, [x], (0,),
                          "float32")
    if not bf16 <= 2.0 ** -5:
        fail(f"recurrent nets: the O2 bf16 LSTM parts from the CPU's by "
             f"{bf16:.3e} of the largest magnitude")
    say(f"  card vs CPU (f32, {NN_TOL['float32']}): " + ", ".join(
        f"{k} {v:.2e}" for k, v in worst.items())
        + f"; beam search {beam['shape']} tokens and lengths equal; O2 bf16 "
        f"LSTM {bf16:.2e}")
    return counts, dict(training=training, parity=parity, held=worst,
                        beam_search=beam, o2_bf16_lstm=bf16)


def kernel_entry(r):
    entry = dict(max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
                 bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                 library_ms=r["library_ms"], shape=r["shape"],
                 note=r.get("note", ""))
    if "twin_ms" in r:
        entry["float_twin_ms"] = r["twin_ms"]
    for key in ("route", "bound_ms_three_streams"):
        if key in r:
            entry[key + "_taken" if key == "route" else key] = r[key]
    return entry


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


#: the CUDA kernels of each row, every route's, the main path's first;
#: a column sum's second pass beside its first
CUDA_KERNELS = {
    "ragged_attention": ("ragged_attn_mma_kernel", "ragged_attn_kernel"),
    "layer_norm": ("ln_fwd_vec_kernel", "layer_norm_fwd_kernel"),
    "matmul_epilogue": ("me_fwd_wgmma", "me_fwd_fma",
                        "splitk_epilogue_kernel"),
    "layer_norm_bwd": ("ln_bwd_vec_kernel", "column_sum_sliced_kernel",
                       "layer_norm_bwd_kernel"),
    "matmul_epilogue_bwd": ("me_bwd_vec_kernel", "me_bwd_kernel",
                            "column_sum_kernel"),
    "softmax_xent_fwd": ("xent_fwd_kernel",),
    "softmax_xent_bwd": ("xent_bwd_kernel",),
    "flash_attention_fwd": ("flash_fwd_kernel_mma", "flash_fwd_kernel"),
    "flash_attention_bwd_dq": ("flash_bwd_dq_kernel_mma",
                               "flash_bwd_dq_kernel"),
    "flash_attention_bwd_dkv": ("flash_bwd_dkv_kernel_mma",
                                "flash_bwd_dkv_kernel"),
    "rms_norm": ("rms_norm_fwd_kernel",),
    "rms_norm_bwd": ("rms_bwd_vec_kernel", "column_sum_sliced_kernel",
                     "rms_norm_bwd_kernel"),
    "ragged_attention_int8": ("ragged_attn_mma_kernel",
                              "ragged_attn_kernel"),
    "matmul_epilogue_int8": ("me_fwd_wgmma", "me_fwd_fma",
                             "splitk_epilogue_kernel"),
    "layer_norm_residual": ("ln_res_fwd_vec_kernel",
                            "layer_norm_residual_fwd_kernel"),
    "grouped_matmul": ("gmm_fwd_mma", "gmm_fwd_fma"),
    "grouped_matmul_dw": ("gmm_dw_mma", "gmm_dw_fma", "column_sum_kernel"),
    "lora_sgmv": ("lora_sgmv_mma_kernel", "lora_sgmv_kernel"),
    "paged_attention": ("paged_attn_vec_kernel", "paged_attn_kernel"),
}


def kernels_line(results, counts):
    """One entry per kernel: its main path's dtype and shapes (the
    serving drive's for the serving kernels, int8 ones included, the
    flash drive's for flash attention, the LLaMA training drive's for RMS
    norm, the BERT training drive's for the fused residual layer norm),
    the other
    dtype and float16 (``float16``: auto_cast's default, its route in
    ``route_taken`` where the kernel has several), the forward kernels at
    the training drive's shapes too (``train_float16`` beside), flash
    attention at its decode and head_dim-64 shapes and RMS norm at
    LLaMA-2 7B's prefill and decode shapes.  ``launches`` counts the main
    path's run (the serving drive, the composite training drive, or the
    ``main`` drive of `KERNEL_INFO`: the flash drive's, the LLaMA or BERT
    training drive's timed steps, the int8 serving drive's or the MoE
    drives');
    ``launches_<drive>`` every drive's; ``cuda_kernels`` names the row's
    kernels, every route's."""
    out = []
    for name, info in KERNEL_INFO.items():
        main = MAIN_DTYPE[name]
        other = "float32" if main == "bfloat16" else "bfloat16"
        shapes = FLASH_SHAPES if name.startswith("flash_attention") \
            else RMS_SHAPES if name.startswith("rms_norm") \
            else dict.fromkeys(("out", "fc1", "fc2", *LORA_TRAIN_CASES)) \
            if name == "lora_sgmv" \
            else dict.fromkeys(("w2", "decode", "decode_w2", "train_dx",
                                *LORA_BWD_CASES)) \
            if name == "grouped_matmul" \
            else dict(LORA_DW_CASES) if name == "grouped_matmul_dw" \
            else dict.fromkeys(c for c in RAGGED_CASES if c != "mixed") \
            if name.startswith("ragged_attention") \
            else {"decode": None, "transformer": None} \
            if name == "matmul_epilogue" \
            else LN_RES_CASES if name == "layer_norm_residual" \
            else dict(ME_BWD_CASES) if name == "matmul_epilogue_bwd" \
            else {c: None for c in PAGED_CASES if c != "decode"} \
            if name == "paged_attention" \
            else dict.fromkeys(("qkv", "out", "fc2")) \
            if name == "matmul_epilogue_int8" \
            else LN_CASES if name in ("layer_norm", "layer_norm_bwd") \
            else dict(XENT_VISION_CASES) if name.startswith("softmax_xent") \
            else {}
        served = any(d in info for d in ("serve", "serve_int8", "serve_moe",
                                         "serve_lora", "paged_decode"))
        key = (name,) if served else (name, "train")
        drive = info.get("main", "serve" if "serve" in info else "train")
        entry = dict(name=name, route="cuda", source=info["source"],
                     replaces=info["replaces"],
                     cuda_kernels=list(CUDA_KERNELS[name]),
                     launches=counts[drive][name], dtype=main,
                     **kernel_entry(results[(key[0], main) + key[1:]]))
        for d, c in counts.items():
            entry[f"launches_{d}"] = c[name]
        for d in ("train_flash", "llama_train", "bert_train", "moe_train",
                  "lora_train", "train_o2"):
            entry[f"launches_per_step_{d}"] = counts[d][name] // TRAIN_STEPS
        entry["launches_per_forward_ernie_eval"] = \
            counts["ernie_eval"][name] // ERNIE_FORWARDS
        entry["launches_per_step_lenet_train"] = \
            counts["lenet_train"][name] // LENET_STEPS
        entry["launches_per_step_resnet50_train"] = \
            counts["resnet50_train"][name] // RESNET50_STEPS
        for d in ("googlenet_train", "densenet_train"):
            entry[f"launches_per_step_{d}"] = \
                counts[d][name] // VISION_II_STEPS
        entry["launches_per_step_transformer_train"] = \
            counts["transformer_train"][name] // TRANSFORMER_STEPS
        entry["launches_per_step_ptb_train"] = \
            counts["ptb_train"][name] // PTB_STEPS
        entry[other] = kernel_entry(results[(key[0], other) + key[1:]])
        entry["float16"] = kernel_entry(
            results[(key[0], "float16") + key[1:]])
        if name in TRAIN_DTYPE:
            entry["train"] = dict(
                dtype=TRAIN_DTYPE[name],
                **kernel_entry(results[(name, TRAIN_DTYPE[name], "train")]))
            if (name, "float16", "train") in results:
                entry["train_float16"] = kernel_entry(
                    results[(name, "float16", "train")])
        for shape_key in shapes:
            if shape_key != "train":
                entry[shape_key] = {
                    dt: kernel_entry(results[(name, dt, shape_key)])
                    for dt in ("bfloat16", "float32", "float16")}
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
    resources = kernel_resources(
        cuda_lib, path,
        FLASH_KERNEL_NAMES + GROUPED_KERNEL_NAMES + WGMMA_KERNEL_NAMES
        + LN_KERNEL_NAMES + RAGGED_MMA_KERNEL_NAMES + VEC_KERNEL_NAMES
        + SIMT_KERNEL_NAMES)
    check_wgmma_kernels(cuda_lib, path, resources)
    check_ragged_mma_kernels(resources)
    check_vec_kernels(resources)
    wgmma_check = check_wgmma_product(cuda_lib)

    say("[2] kernels vs plain versions at the main path's shapes")
    # the serving drive's token budget: chunk 256 + 7 rows of block_q
    budgets = {"bfloat16": 256 + 7 * 16, "float32": 256 + 7 * 8,
               "float16": 256 + 7 * 16}
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
    int8_counts, int8_serving, int8_tokens = phase_serving(
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
    lora_serve_counts, lora_serving, _ = phase_multilora_serving(pt, ops)
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
    free_device_memory()

    say("[26] bf16 parity: full width, 2 layers, bf16 O1 flash + recompute, "
        "3 AdamW steps, CUDA vs CPU; bf16 greedy tokens; LoRA fine-tuning "
        "at the multilora width, 2 layers, bf16 O1")
    bf16_parity = phase_bf16_parity(pt, ops)
    free_device_memory()

    say("[27] optimizers: 14 optimizers, 17 schedulers, L1/L2 decay, "
        "parameter groups, scheduled betas, 3 clips; entry() width, 2 "
        "layers, f32, 3 steps, CUDA vs CPU; state round-trips")
    optimizer_parity = phase_optimizer_parity(pt, ops)
    free_device_memory()

    say("[28] O2 training: GPT_1P3B, bf16 O2 (decorate + auto_cast), flash "
        "attention + recompute, AdamW with a decay mask, LinearWarmup + "
        "cosine, clip 1.0, GradScaler, B=8 S=1024")
    o2_counts, o2_training = phase_o2_training(pt, ops)
    free_device_memory()

    say("[29] O2 parity: full width, 2 layers, bf16 O2, flash + recompute, "
        "3 AdamW steps, CUDA vs CPU")
    o2_parity = phase_o2_parity(pt, ops)
    free_device_memory()

    say("[30] vision parity: LeNet (B=8, 3 Adam steps) and ResNet-50 (10 "
        "classes, B=4, 3x64x64, 3 Momentum steps), f32, CUDA vs CPU")
    vision_parity_out = phase_vision_parity(pt, ops)
    free_device_memory()

    say("[31] LeNet training: bench_lenet recipe, f32, Adam(1e-3), B=64")
    lenet_counts, lenet_training = phase_lenet_training(pt, ops)
    free_device_memory()

    say("[32] ResNet-50 training: bench_resnet50 recipe, 224x224, bf16 O1, "
        f"Momentum(0.1, 0.9), B={RESNET50_BATCHES}")
    resnet50_counts, resnet50_training = phase_resnet50_training(pt, ops)
    free_device_memory()

    say("[33] vision parity II: SqueezeNet 1.1 and AlexNet in f32; "
        "MobileNetV1 0.25, ShuffleNetV2 0.5, GoogLeNet and DenseNet-121 in "
        "f64 with one f32 step (10 classes, B=4, 3x64x64, 3 Momentum steps, "
        "dropout 0), CUDA vs CPU")
    vision_parity_ii = phase_vision_parity_ii(pt, ops)
    free_device_memory()

    say("[34] vision ops parity: transposed convolutions, norms, pooling "
        "masks and unpooling, roi_align/roi_pool, box_coder, yolo_box, "
        "deform_conv2d, nms; CUDA vs CPU")
    vision_ops_parity = phase_vision_ops_parity(pt)
    free_device_memory()

    say(f"[35] GoogLeNet training: 224x224, bf16 O1, Momentum(0.1, 0.9), "
        f"B={VISION_II_B}, loss with both aux heads")
    googlenet_counts, googlenet_training = phase_vision_recipe(
        pt, ops, "googlenet", "googlenet training", "googlenet_train")
    free_device_memory()

    say(f"[36] DenseNet-121 training: 224x224, bf16 O1, Momentum(0.1, 0.9), "
        f"B={VISION_II_B}")
    densenet_counts, densenet_training = phase_vision_recipe(
        pt, ops, "densenet121", "densenet121 training", "densenet_train")
    free_device_memory()

    say("[37] detection ops at a detector's shapes: roi_align/roi_pool, "
        "yolo_box + nms (YOLOv3-608, B=8), box_coder, deform_conv2d v2")
    detection_ops = phase_detection_ops(pt)
    free_device_memory()

    say("[38] captured serving: phase 4's drive in turns eager, captured, "
        "captured, eager (the step through jit.to_static on a CUDA graph); "
        "phase 13's int8 engine eager, captured")
    captured_serving = phase_captured_serving(pt, ops, serve_tokens,
                                              int8_tokens)
    free_device_memory()

    say("[39] captured GPT-1.3B training: phase 8's recipe under phase "
        "28's schedule, 10 steps a turn, turns eager, captured, captured, "
        "eager")
    captured_gpt = phase_captured_gpt_training(pt, ops)
    free_device_memory()

    say(f"[40] captured ResNet-50 training: phase 32's recipe at "
        f"B={RESNET50_BATCHES[0]}, 10 steps a turn, turns eager, captured, "
        f"captured, eager")
    captured_resnet50 = phase_captured_resnet50_training(pt, ops)
    free_device_memory()

    say("[41] fp16 parity: full width, 2 layers, auto_cast() and "
        "GradScaler() with their defaults (f16 O1), 3 AdamW steps, CUDA vs "
        "CPU; the scaler's decisions")
    fp16_parity = phase_fp16_parity(pt, ops)
    free_device_memory()

    say("[42] fp16 at full depth: GPT_1P3B f16 served on phase 4's trace "
        "(greedy tokens vs the plain f16 run); phase 6's recipe under "
        "auto_cast() and GradScaler()")
    fp16_serve_counts, fp16_serving, fp16_train_counts, fp16_training = \
        phase_fp16_drives(pt, ops, serving, training, training_flash)
    free_device_memory()

    say("[43] nn breadth: every activation and loss, functions and layers, "
        "forward and input gradients, f32 and bf16, CUDA vs CPU")
    nn_breadth = phase_nn_breadth(pt, ops)
    free_device_memory()

    say("[44] nn breadth II: every common functional and layer, "
        "flash_attn_unpadded and nn.utils, forward and input gradients, "
        "f32 and bf16, CUDA vs CPU; the random ones by structure")
    nn_common = phase_nn_common(pt)
    free_device_memory()

    say("[45] Transformer-base: 6 + 6 layers, d_model 512, shared [37000, "
        "512] embedding; training bf16 O1, AdamW, B=32 x 128 + 128 tokens; "
        "parity at 2 + 2 layers, f32; incremental decoding, f32, B=8, 32 "
        "greedy steps")
    transformer_counts, transformer = phase_transformer(pt, ops)
    free_device_memory()

    say("[46] recurrent nets: PTB medium LSTM (2 x 650, vocab 10000, 35 "
        "steps, B=20), SGD 1.0 + clip 5; parity; GRU, SimpleRNN, RNN, BiRNN "
        "and beam search CUDA vs CPU")
    ptb_counts, recurrent = phase_recurrent(pt, ops)

    counts = dict(serve=serve_counts, train=train_counts,
                  train_flash=flash_counts, generate=gen_counts,
                  llama_train=llama_train_counts,
                  llama_gen=llama_gen_counts, serve_int8=int8_counts,
                  bert_train=bert_counts, ernie_eval=ernie_counts,
                  serve_moe=moe_serve_counts, moe_train=moe_train_counts,
                  serve_lora=lora_serve_counts, lora_train=lora_train_counts,
                  paged_decode=paged_counts, train_o2=o2_counts,
                  lenet_train=lenet_counts, resnet50_train=resnet50_counts,
                  googlenet_train=googlenet_counts,
                  densenet_train=densenet_counts,
                  serve_f16=fp16_serve_counts, train_f16=fp16_train_counts,
                  transformer_train=transformer_counts, ptb_train=ptb_counts)
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
                    "bf16_parity": bf16_parity,
                    "optimizer_parity": optimizer_parity,
                    "o2_training": o2_training, "o2_parity": o2_parity,
                    "vision_parity": vision_parity_out,
                    "lenet_training": lenet_training,
                    "resnet50_training": resnet50_training,
                    "vision_parity_ii": vision_parity_ii,
                    "vision_ops_parity": vision_ops_parity,
                    "googlenet_training": googlenet_training,
                    "densenet121_training": densenet_training,
                    "detection_ops": detection_ops,
                    "captured_serving": captured_serving,
                    "captured_gpt_training": captured_gpt,
                    "captured_resnet50_training": captured_resnet50,
                    "fp16_parity": fp16_parity,
                    "fp16_serving": fp16_serving,
                    "fp16_training": fp16_training,
                    "nn_breadth": nn_breadth,
                    "nn_breadth_ii": nn_common,
                    "transformer": transformer, "recurrent": recurrent,
                    "wgmma_check": wgmma_check,
                    "grouped_repeats": results["grouped_repeats"],
                    "resources": resources}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
