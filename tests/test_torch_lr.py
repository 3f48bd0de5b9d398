"""The port's learning-rate schedulers against the reference's.

Each of the 17 schedulers of ``paddle_tpu.optimizer.lr`` (and
``LinearWarmup`` wrapping a scheduler) is built with the same arguments
in both packages and stepped 60 times: the two learning-rate sequences
must be equal, float for float (the same host formulas).
``ReduceOnPlateau`` steps on a fixed metric sequence that plateaus,
improves and plateaus again.  Then the state round-trip: after 20 steps
a scheduler's ``state_dict`` is loaded into a fresh one, in the port and
from the reference into the port, and the next 40 rates must equal the
uninterrupted run's.
"""
import math

import pytest

import paddle_tpu as paddle

import paddle_tpu_torch as pt

STEPS = 60

#: name -> (constructor arguments, a builder given the lr module)
CASES = {
    "NoamDecay": lambda lr: lr.NoamDecay(d_model=64, warmup_steps=10,
                                         learning_rate=2.0),
    "PiecewiseDecay": lambda lr: lr.PiecewiseDecay([10, 25, 40],
                                                   [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda lr: lr.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda lr: lr.InverseTimeDecay(0.5, gamma=0.2),
    "PolynomialDecay": lambda lr: lr.PolynomialDecay(0.1, decay_steps=20,
                                                     end_lr=0.001, power=2.0),
    "PolynomialDecay_cycle": lambda lr: lr.PolynomialDecay(
        0.1, decay_steps=15, end_lr=0.001, power=1.5, cycle=True),
    "LinearWarmup": lambda lr: lr.LinearWarmup(0.1, warmup_steps=10,
                                               start_lr=0.0, end_lr=0.1),
    "LinearWarmup_cosine": lambda lr: lr.LinearWarmup(
        lr.CosineAnnealingDecay(0.1, T_max=30, eta_min=0.001),
        warmup_steps=8, start_lr=0.001, end_lr=0.1),
    "ExponentialDecay": lambda lr: lr.ExponentialDecay(0.1, gamma=0.95),
    "MultiStepDecay": lambda lr: lr.MultiStepDecay(0.1, [12, 30, 45],
                                                   gamma=0.3),
    "StepDecay": lambda lr: lr.StepDecay(0.1, step_size=7, gamma=0.5),
    "LambdaDecay": lambda lr: lr.LambdaDecay(0.1, lambda e: 0.97 ** e),
    "MultiplicativeDecay": lambda lr: lr.MultiplicativeDecay(
        0.1, lambda e: 0.9 if e % 3 else 1.0),
    "ReduceOnPlateau": lambda lr: lr.ReduceOnPlateau(
        0.1, mode="min", factor=0.5, patience=3, threshold=1e-3,
        cooldown=2, min_lr=1e-3),
    "CosineAnnealingDecay": lambda lr: lr.CosineAnnealingDecay(
        0.1, T_max=25, eta_min=0.002),
    "CosineAnnealingWarmRestarts": lambda lr:
        lr.CosineAnnealingWarmRestarts(0.1, T_0=7, T_mult=2, eta_min=0.001),
    "LinearLR": lambda lr: lr.LinearLR(0.1, total_steps=40,
                                       start_factor=0.25, end_factor=1.0),
    "OneCycleLR_cos": lambda lr: lr.OneCycleLR(0.1, total_steps=50),
    "OneCycleLR_linear": lambda lr: lr.OneCycleLR(
        0.1, total_steps=50, divide_factor=10.0, phase_pct=0.4,
        anneal_strategy="linear"),
    "CyclicLR_triangular": lambda lr: lr.CyclicLR(0.01, 0.1,
                                                  step_size_up=6),
    "CyclicLR_triangular2": lambda lr: lr.CyclicLR(
        0.01, 0.1, step_size_up=5, step_size_down=9, mode="triangular2"),
    "CyclicLR_exp_range": lambda lr: lr.CyclicLR(
        0.01, 0.1, step_size_up=4, mode="exp_range", exp_gamma=0.97),
}

#: a metric that plateaus, improves, and plateaus again
METRICS = [1.0, 0.9, 0.9, 0.9, 0.9, 0.9, 0.8, 0.7, 0.7, 0.7, 0.7, 0.7,
           0.7, 0.7, 0.7, 0.6995, 0.7, 0.7, 0.7] * 4


def _advance(sched, i):
    if isinstance(sched, (paddle.optimizer.lr.ReduceOnPlateau,
                          pt.optimizer.lr.ReduceOnPlateau)):
        sched.step(METRICS[i])
    else:
        sched.step()


def _sequence(sched, start=0, stop=STEPS):
    out = []
    for i in range(start, stop):
        out.append(sched())
        _advance(sched, i)
    return out


def test_every_scheduler_has_a_case():
    names = {n.split("_")[0] for n in CASES}
    want = set(paddle.optimizer.lr.__all__) - {"LRScheduler"}
    assert names == want == set(pt.optimizer.lr.__all__) - {"LRScheduler"}
    assert len(want) == 17


@pytest.mark.parametrize("case", sorted(CASES))
def test_lr_sequence_equals_reference(case):
    ref = _sequence(CASES[case](paddle.optimizer.lr))
    got = _sequence(CASES[case](pt.optimizer.lr))
    assert all(math.isfinite(v) for v in got)
    assert got == ref
    assert len(set(got)) > 1, "the case must move the rate"


@pytest.mark.parametrize("case", sorted(CASES))
def test_lr_state_round_trip(case):
    """20 steps, then ``state_dict`` into a fresh scheduler: the port's
    own and the reference's, loaded into the port; the next 40 rates
    equal the uninterrupted run's."""
    whole = _sequence(CASES[case](pt.optimizer.lr))
    for lib in (pt.optimizer.lr, paddle.optimizer.lr):
        first = CASES[case](lib)
        _sequence(first, 0, 20)
        fresh = CASES[case](pt.optimizer.lr)
        fresh.set_state_dict(dict(first.state_dict()))
        assert _sequence(fresh, 20, STEPS) == whole[20:], lib.__name__
