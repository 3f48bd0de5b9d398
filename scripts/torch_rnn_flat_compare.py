#!/usr/bin/env python3
"""Time the PTB "medium" LSTM's training step (``chip_smoke.py`` phase
46) with the LSTM's weights as views into one cuDNN flat buffer, as the
port keeps them, and with each weight a tensor of its own, which makes
cuDNN copy every weight into a fresh buffer on each call.

    python3 scripts/torch_rnn_flat_compare.py

One process, turns in the order separate, flat, flat, separate: each
builds the model from the same seed, takes phase 46's 2 warm-up and 20
timed steps on the same Zipf windows (SGD at lr 1.0, ``clip_grad_norm_``
at 5; ms/step on the host clock, synchronised) and one profiled step
(device busy ms and the idle share).  TF32 is off, as in
``chip_smoke.py``.  Prints the card's ``nvidia-smi`` line first and one
JSON object last.  Needs one CUDA device and ``nvcc``.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def turn(pt, cs, flat):
    import numpy as np
    import torch
    from paddle_tpu_torch.nn.layer.rnn import _RNNBase
    real = _RNNBase._flatten
    if not flat:
        _RNNBase._flatten = lambda self: None
    try:
        model = cs.ptb_model(pt, "cuda", 0.5)
        opt = pt.optimizer.SGD(learning_rate=cs.PTB_LR,
                               parameters=model.parameters())
        rng = np.random.default_rng(cs.SEED + 46)
        windows = [tuple(torch.from_numpy(a).cuda() for a in w)
                   for w in cs.ptb_stream(rng, cs.PTB_STEPS + 3)]
        carry = {"state": None, "i": 0}

        def step():
            x, y = windows[carry["i"] % len(windows)]
            carry["i"] += 1
            logits, state = model(x, carry["state"])
            carry["state"] = tuple(s.detach() for s in state)
            loss = cs.ptb_loss(pt, logits, y)
            loss.backward()
            pt.nn.clip_grad_norm_(model.parameters(), cs.PTB_CLIP)
            opt.step()
            opt.clear_grad()
            return loss.detach()

        for _ in range(cs.TRAIN_WARMUP):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [step() for _ in range(cs.PTB_STEPS)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / cs.PTB_STEPS * 1e3
        prof = cs.split_profile(cs.profile_device(step), 1, "PTB step")
        buffers = len({p.untyped_storage().data_ptr()
                       for p in model.lstm.parameters()})
    finally:
        _RNNBase._flatten = real
    return dict(flat=flat, ms_per_step=ms, lstm_buffers=buffers,
                last_loss=float(losses[-1]),
                device_busy_ms=prof and prof["device_busy_ms"],
                idle_share=prof and prof["device_idle_share"])


def main():
    import torch
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import cuda_lib
    cuda_lib.build()
    cuda_lib.library()
    runs = []
    for flat in (False, True, True, False):
        r = turn(pt, cs, flat)
        print(f"{'flat' if flat else 'separate'}: {r['ms_per_step']:.2f} "
              f"ms/step, device busy {r['device_busy_ms']:.2f} ms, idle "
              f"{r['idle_share']:.3f}, {r['lstm_buffers']} LSTM buffers, "
              f"last loss {r['last_loss']:.4f}", flush=True)
        runs.append(r)
        cs.free_device_memory()
    print(json.dumps(dict(card=cs.card_line(), runs=runs)))


if __name__ == "__main__":
    main()
