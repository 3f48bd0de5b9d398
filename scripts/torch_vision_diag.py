#!/usr/bin/env python3
"""How far f32 carries ResNet-50's training step from f64, on the card
and on the CPU: the numbers behind phase 30's design (``chip_smoke.
F32_FLOOR_FACTOR``).

    python3 scripts/torch_vision_diag.py               # on the card
    python3 scripts/torch_vision_diag.py --cpu B:HW:LR:BAND ...

On the card (one CUDA device): the TF32 and cuDNN settings in force;
ResNet-50's convolution shapes (B=4, 64 x 64) forward, dgrad and wgrad
in f32 on the card against f64 on the CPU (largest error over the
largest magnitude) under the default settings, ``cudnn.deterministic``,
``cudnn.conv.fp32_precision="ieee"`` and cuDNN off; the whole model's
step-1 loss and worst gradient (10 classes, B=4, 64 x 64, f32, relus
not held) against the CPU's f64 run under each setting, the CPU's f32
run the same way, and the card's f64 run; each leaf layer's output error
against f64 in one forward, on the CPU and on the card; batch norm alone
on inputs with a mean of 0, 10 and 100.

``--cpu``: for each ``B:HW:LR:BAND``, ResNet-50 (10 classes) at batch
B, HW x HW, 3 Momentum(LR, 0.9) steps on the CPU in f64 (recording relu
kinks within BAND of 0) and in f32 (holding them): phase 30's readings
of the f32 run against f64 (`chip_smoke.vision_parity_run`,
`chip_smoke.excess`).
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def model_step(pt, device, dtype):
    """ResNet-50's step-1 loss and gradients (f64, on the CPU) from the
    model's own seeded initial state and phase 30's batch."""
    import torch
    rng = np.random.default_rng(cs.SEED + 30)
    x = rng.standard_normal((4, 3, 64, 64)).astype(np.float32)
    y = rng.integers(0, 10, 4)
    m = pt.vision.models.resnet50(num_classes=10, device="cpu")
    m = m.to(device, dtype)
    loss = pt.nn.functional.cross_entropy(
        m(torch.from_numpy(x).to(device, dtype)),
        torch.from_numpy(y).to(device))
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().double().cpu()
                                  for n, p in m.named_parameters()}


def card(pt):
    import torch
    import torch.nn.functional as TF
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), torch.__version__, torch.version.cuda,
          torch.backends.cudnn.version())
    for mod in ("torch.backends.cudnn", "torch.backends.cudnn.conv",
                "torch.backends.cuda.matmul"):
        try:
            print(mod, "fp32_precision", eval(mod + ".fp32_precision"))
        except AttributeError:
            print(mod, "fp32_precision: not in this torch")
    gen = torch.Generator().manual_seed(0)
    shapes = [((4, 3, 64, 64), (64, 3, 7, 7), 2, 3),
              ((4, 64, 16, 16), (64, 64, 3, 3), 1, 1),
              ((4, 256, 8, 8), (128, 256, 1, 1), 1, 0),
              ((4, 512, 2, 2), (512, 512, 3, 3), 1, 1),
              ((4, 128, 16, 16), (128, 128, 3, 3), 2, 1)]

    def rel(a, b):
        return float((a.detach().double().cpu() - b).abs().max()
                     / b.abs().max())

    def convs(tag):
        out = []
        for xs, ws, st, pd in shapes:
            x = torch.randn(xs, generator=gen, dtype=torch.float64)
            w = torch.randn(ws, generator=gen, dtype=torch.float64) \
                / ws[1] ** 0.5
            up = torch.randn(TF.conv2d(x, w, None, st, pd).shape,
                             generator=gen, dtype=torch.float64)
            xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
            (TF.conv2d(xr, wr, None, st, pd) * up).sum().backward()
            xc = x.float().cuda().requires_grad_()
            wc = w.float().cuda().requires_grad_()
            yc = TF.conv2d(xc, wc, None, st, pd)
            (yc * up.float().cuda()).sum().backward()
            yr = TF.conv2d(x, w, None, st, pd)
            out.append(f"{ws}: {rel(yc, yr):.1e} {rel(xc.grad, xr.grad):.1e} "
                       f"{rel(wc.grad, wr.grad):.1e}")
        print(f"{tag}: conv f32 card vs f64 (fwd dgrad wgrad):",
              "; ".join(out))

    l64, g64 = model_step(pt, "cpu", torch.float64)

    def vs64(tag, l, g):
        worst = max((float((g[n] - g64[n]).abs().max()
                           / g64[n].abs().max()), n) for n in g64)
        print(f"{tag}: step-1 loss vs f64 {abs(l - l64) / l64:.3e}, worst "
              f"gradient {worst[0]:.3e} at {worst[1]}")

    vs64("CPU f32", *model_step(pt, "cpu", torch.float32))
    convs("default")
    vs64("card f32 default", *model_step(pt, "cuda", torch.float32))
    torch.backends.cudnn.deterministic = True
    convs("deterministic")
    vs64("card f32 deterministic", *model_step(pt, "cuda", torch.float32))
    torch.backends.cudnn.deterministic = False
    if hasattr(torch.backends.cudnn, "conv"):
        torch.backends.cudnn.conv.fp32_precision = "ieee"
        convs("fp32_precision ieee")
        vs64("card f32 ieee", *model_step(pt, "cuda", torch.float32))
    torch.backends.cudnn.enabled = False
    convs("cuDNN off")
    vs64("card f32 cuDNN off", *model_step(pt, "cuda", torch.float32))
    torch.backends.cudnn.enabled = True
    vs64("card f64", *model_step(pt, "cuda", torch.float64))
    layers(pt)
    for mean in (0.0, 10.0, 100.0):
        v = torch.randn(4, 64, 2, 2, generator=gen,
                        dtype=torch.float64) + mean
        stats = [torch.zeros(64, dtype=torch.float64),
                 torch.ones(64, dtype=torch.float64)]
        ref = TF.batch_norm(v, *stats, None, None, True, 0.1, 1e-5)
        errs = [float((TF.batch_norm(v.float().to(d), *(t.float().to(d)
                                                          for t in stats),
                                     None, None, True, 0.1,
                                     1e-5).double().cpu() - ref).abs().max())
                for d in ("cuda", "cpu")]
        print(f"batch norm, mean {mean:g}: card f32 {errs[0]:.2e}, CPU f32 "
              f"{errs[1]:.2e} from f64")


def layers(pt):
    """Each leaf layer's output error against f64 in one forward."""
    import torch
    rng = np.random.default_rng(cs.SEED + 30)
    x = rng.standard_normal((4, 3, 64, 64)).astype(np.float32)
    base = pt.vision.models.resnet50(num_classes=10,
                                     device="cpu").state_dict()

    def trace(device, dtype):
        m = pt.vision.models.resnet50(num_classes=10, device="cpu")
        m.load_state_dict(base)
        m = m.to(device, dtype)
        outs = []
        for name, mod in m.named_modules():
            if not list(mod.children()):
                mod.register_forward_hook(
                    lambda _, i, o, name=name: outs.append(
                        (name, o.detach().double().cpu())))
        with torch.no_grad():
            m(torch.from_numpy(x).to(device, dtype))
        return outs
    ref = trace("cpu", torch.float64)
    for device in ("cpu", "cuda"):
        got = trace(device, torch.float32)
        errs = [(n, float((o - r).abs().max() / r.abs().max()))
                for (n, r), (_, o) in zip(ref, got)]
        picks = [e for e in errs if e[0] in (
            "bn1", "layer1.0.bn3", "layer2.0.bn3", "layer3.0.bn3",
            "layer4.0.bn3", "layer4.2.bn3", "fc")]
        print(f"{device} f32 forward, output error against f64 by layer:",
              ", ".join(f"{n} {e:.2e}" for n, e in picks))


def cpu_scan(pt, specs):
    import torch
    from paddle_tpu_torch import ops
    cs.say = lambda msg: None
    for spec in specs:
        b, hw, lr, band = spec.split(":")
        b, hw, lr, band = int(b), int(hw), float(lr), float(band)
        rng = np.random.default_rng(cs.SEED + 30)
        x = rng.standard_normal((b, 3, hw, hw)).astype(np.float32)
        y = rng.integers(0, 10, b)

        def make(device):
            return pt.vision.models.resnet50(num_classes=10, device=device)

        def make_opt(m):
            return pt.optimizer.Momentum(learning_rate=lr, momentum=0.9,
                                         parameters=m.parameters())
        params = {k: v.numpy() for k, v in make("cpu").state_dict().items()}
        kinks = cs.ReluKinks(band)
        runs = [cs.vision_parity_run(pt, ops, make, params, x, y, make_opt,
                                     "cpu", kinks, rec, dt)
                for rec, dt in ((True, torch.float64),
                                (False, torch.float32))]
        (r64, e64), (r32, e32) = runs
        step1 = cs.step1_readings(runs[1], runs[0])
        loss3 = abs(r32[0][-1] - r64[0][-1]) / abs(r64[0][-1])
        print(f"B={b} HW={hw} lr={lr:g} band={band:g}: step-1 logits "
              f"{step1['logits'][0]:.2e}, gradients {step1['grad'][0]:.2e} "
              f"at {step1['grad'][1]}; after 3 steps loss {loss3:.2e}, "
              f"parameters {cs.excess(r32[2], r64[2])[0]:.2e}, buffers "
              f"{cs.excess(e32['buffers'][-1], e64['buffers'][-1])[0]:.2e}; "
              f"f64 losses {[round(v, 5) for v in r64[0]]}, f32 "
              f"{[round(v, 5) for v in r32[0]]}", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", nargs="+", metavar="B:HW:LR:BAND")
    args = parser.parse_args()
    import paddle_tpu_torch as pt
    if args.cpu:
        cpu_scan(pt, args.cpu)
    else:
        card(pt)


if __name__ == "__main__":
    main()
