#!/usr/bin/env python3
"""The vision slices' card checks alone, in one process: build the
kernels, run phase 2's softmax cross-entropy rows at the vision logits
(`chip_smoke.XENT_VISION_CASES`), phases 30-32 (vision parity, LeNet and
ResNet-50 training) and 33-37 (vision parity II, the vision ops' parity,
GoogLeNet and DenseNet-121 training, the detection ops), then the card
tests of the vision slices.

    python3 scripts/torch_vision_check.py [PHASE ...]

With phase numbers (30-37) only those phases run, and no card tests.

Needs one CUDA device.  Prints what ``chip_smoke.py`` prints for those
phases (the card's ``nvidia-smi`` name and power limit first) and writes
the results to ``chiprun_out/vision_check.json``; exits non-zero when a
phase or a test fails.
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
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 30)
    rows = {}
    for dtype, dn in ((torch.bfloat16, "bfloat16"),
                      (torch.float32, "float32")):
        for case, (n, vocab) in cs.XENT_VISION_CASES.items():
            for name, check in (("softmax_xent_fwd",
                                 cs.check_softmax_xent_fwd),
                                ("softmax_xent_bwd",
                                 cs.check_softmax_xent_bwd)):
                r = check(ops, n, dtype, dn, gen, vocab)
                cs.report(name, dn, r)
                rows[f"{name}/{dn}/{case}"] = cs.kernel_entry(r)
    cs.reset_routes(ops)
    out = dict(xent=rows)
    phases = {
        30: ("vision_parity", lambda: cs.phase_vision_parity(pt, ops)),
        31: ("lenet", lambda: cs.phase_lenet_training(pt, ops)[1]),
        32: ("resnet50", lambda: cs.phase_resnet50_training(pt, ops)[1]),
        33: ("vision_parity_ii",
             lambda: cs.phase_vision_parity_ii(pt, ops)),
        34: ("vision_ops_parity", lambda: cs.phase_vision_ops_parity(pt)),
        35: ("googlenet", lambda: cs.phase_vision_recipe(
            pt, ops, "googlenet", "googlenet training",
            "googlenet_train")[1]),
        36: ("densenet121", lambda: cs.phase_vision_recipe(
            pt, ops, "densenet121", "densenet121 training",
            "densenet_train")[1]),
        37: ("detection_ops", lambda: cs.phase_detection_ops(pt))}
    chosen = [int(a) for a in sys.argv[1:]] or sorted(phases)
    for number in chosen:
        key, phase = phases[number]
        t0 = time.perf_counter()
        out[key] = phase()
        cs.say(f"[{number}] {key}: {time.perf_counter() - t0:.1f} s")
        cs.free_device_memory()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "vision_check.json").write_text(
        json.dumps(out, indent=1, default=str))
    if sys.argv[1:]:
        return
    rc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "cuda",
         "tests/test_torch_cuda.py", "-k",
         "vision or resnet18 or softmax_xent or small_net"],
        cwd=ROOT).returncode
    cs.say(f"card tests rc {rc}")
    sys.exit(rc)


if __name__ == "__main__":
    main()
