"""The parent/change/change/parent harness that the ``torch_*_compare.py``
scripts share.

A script names the checkouts (``{"parent": dir, "change": ROOT}``) and
the order of its runs; `run_order` prints the card's ``nvidia-smi``
line, builds every checkout's kernels in parallel, then runs the script
once a label, one process after another, as

    python3 SCRIPT --worker CHECKOUT_DIR LABEL OUT_JSON [ARGS...]

and returns the card's line and the JSON each process wrote.  The
script's worker starts with `start_worker`, which puts its checkout's
package first on ``sys.path`` and loads that checkout's ``chip_smoke.py``.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ORDER = ("parent", "change", "change", "parent")


def load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def buckets(summary, names):
    """The device ms a step of the profile groups ``names`` in a drive's
    summary, or None where the profiler saw no device time."""
    prof = summary.get("profile")
    if not prof:
        return None
    per = prof["device_ms_per_step"]
    return {b: per.get(b, 0.0) for b in names}


def start_worker(root):
    """A worker's set-up in checkout ``root``: its package first on
    ``sys.path``, TF32 off, its kernels built.  Returns ``(torch, cs, pt,
    ops, cuda_lib)``, ``cs`` being the checkout's own ``chip_smoke.py``."""
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = load_module("chip_smoke", root / "chip_smoke.py")
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import cuda_lib
    cuda_lib.library()
    return torch, cs, pt, ops, cuda_lib


def this_tree():
    """This tree's ``chip_smoke.py``, for checks that both sides should
    run with the same inputs and bounds."""
    return load_module("chip_smoke_here", ROOT / "chip_smoke.py")


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def run_order(script, trees, order, out_dir, args=lambda label: (),
              after=None):
    """Build every checkout of ``trees`` (label -> dir) in parallel, then
    run ``script``'s worker for each label of ``order`` in turn with
    ``args(label)`` appended, calling ``after(label, result)`` as each
    ends.  Exits on a missing checkout, a failed build or a failed
    process.  Returns ``(card line, [result, ...])``."""
    for label, d in trees.items():
        if not (Path(d) / "chip_smoke.py").exists():
            sys.exit(f"{d}: no chip_smoke.py, not a checkout ({label})")
    card = card_line()
    print(card, flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from paddle_tpu_torch.ops import cuda_lib; "
         "cuda_lib.library()"], cwd=str(d)) for d in trees.values()]
    if any(b.wait() for b in builds):
        sys.exit("a build failed")
    runs = []
    for i, label in enumerate(order):
        path = out_dir / f"{i}_{label}.json"
        rc = subprocess.run([sys.executable, str(script), "--worker",
                             str(trees[label]), label, str(path),
                             *args(label)]).returncode
        if rc:
            sys.exit(f"the {label} process failed ({rc})")
        runs.append(json.loads(path.read_text()))
        if after is not None:
            after(label, runs[-1])
    return card, runs


def write_out(out_dir, out):
    """The comparison's JSON to ``out_dir/compare.json``, and printed as
    the last line."""
    text = json.dumps(out)
    (out_dir / "compare.json").write_text(text)
    print(text)
