#!/usr/bin/env python3
"""The capture slice's card checks alone, in one process: build the
kernels, then the serving phases whose engine step now runs through
``jit.to_static`` (3, 4, 13, 17, 18, 21, 22) and phases 38-40 (captured
serving, captured GPT-1.3B training, captured ResNet-50 training), then
the card tests of ``jit.to_static``.

    python3 scripts/torch_capture_check.py [PHASE ...]

With phase numbers only those phases run (38 runs 4 and 13 first, for
their tokens), and no card tests.  Needs one CUDA device.  Prints what
``chip_smoke.py`` prints for those phases (the card's ``nvidia-smi`` name
and power limit first) and writes the results to
``chiprun_out/capture_check.json``; exits non-zero when a phase or a test
fails; the JSON is written again after each phase.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main():
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import cuda_lib
    if not torch.cuda.is_available():
        cs.fail("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.say(cs.card_line())
    t0 = time.perf_counter()
    cuda_lib.build()
    cuda_lib.library()
    cs.say(f"build {time.perf_counter() - t0:.1f} s")
    cs.warm_up(ops)
    cs.reset_routes(ops)
    out, keep = {}, {}

    def serve():
        counts, summary, tokens = cs.phase_serving(pt, ops)
        keep["serve"], keep["serve_tokens"] = summary, tokens
        return summary

    def serve_int8():
        if "serve" not in keep:
            serve()
            cs.free_device_memory()
        _, summary, keep["int8_tokens"] = cs.phase_serving(
            pt, ops, int8=True,
            base=dict(keep["serve"], generated=keep["serve_tokens"]))
        return summary

    def captured_serving():
        if "int8_tokens" not in keep:
            serve_int8()
            cs.free_device_memory()
        return cs.phase_captured_serving(pt, ops, keep["serve_tokens"],
                                         keep["int8_tokens"])

    phases = {
        3: ("parity", lambda: (cs.phase_parity(pt, ops),
                               cs.phase_parity(pt, ops, int8=True))),
        4: ("serving", serve),
        13: ("int8_serving", serve_int8),
        17: ("moe_parity", lambda: cs.phase_moe_parity(pt, ops)),
        18: ("moe_serving", lambda: cs.phase_serving(
            pt, ops, moe=True, base=keep.get("serve") or serve())[1]),
        21: ("lora_parity", lambda: cs.phase_lora_parity(pt, ops)),
        22: ("multi_lora_serving",
             lambda: cs.phase_multilora_serving(pt, ops)[1]),
        38: ("captured_serving", captured_serving),
        39: ("captured_gpt_training",
             lambda: cs.phase_captured_gpt_training(pt, ops)),
        40: ("captured_resnet50_training",
             lambda: cs.phase_captured_resnet50_training(pt, ops))}
    chosen = [int(a) for a in sys.argv[1:]] or sorted(phases)
    for number in chosen:
        key, phase = phases[number]
        t0 = time.perf_counter()
        cs.say(f"[{number}] {key}")
        out[key] = phase()
        cs.say(f"[{number}] {key}: {time.perf_counter() - t0:.1f} s")
        cs.free_device_memory()
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "capture_check.json").write_text(
            json.dumps(out, indent=1, default=str))
    if sys.argv[1:]:
        return
    rc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "cuda",
         "tests/test_torch_cuda.py", "-k",
         "to_static or engine_captured or grad_scaler"],
        cwd=ROOT).returncode
    cs.say(f"card tests rc {rc}")
    sys.exit(rc)


if __name__ == "__main__":
    main()
