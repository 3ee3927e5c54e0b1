"""Learning-rate schedules (counterpart of
`deeplearning4j_tpu/ops/schedules.py`, the reference's
`LayerUpdater.java:134-158` policies).

A schedule is fn(iteration) -> lr, evaluated on the host: the iteration
count lives there, so the step needs no device scalar. The arithmetic is
float32, as the reference evaluates it inside its jitted step on an f32
iteration.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np

POLICIES = ("none", "exponential", "inverse", "poly", "sigmoid", "step",
            "torchstep", "schedule", "score")

_F = np.float32


def make_schedule(base_lr: float, policy=None, decay_rate: float = 0.0,
                  power: float = 0.0, steps: float = 1.0,
                  max_iterations: int = 1,
                  schedule_map: Optional[Mapping[int, float]] = None
                  ) -> Callable[[int], float]:
    """fn(iteration) -> learning rate (a float holding an f32 value)."""
    p = "none" if policy is None else str(policy).lower()
    if p not in POLICIES:
        raise ValueError(f"Unknown LR policy: {policy!r}")
    b, d, pw, st = _F(base_lr), _F(decay_rate), _F(power), _F(steps)
    one = _F(1.0)

    if p in ("none", "score") or (p == "schedule" and not schedule_map):
        # Score-based decay is driven host-side from the score; the step's
        # rate is constant, as in the reference.
        def fn(it):
            return b
    elif p == "exponential":
        def fn(it):
            return b * d ** _F(it)
    elif p == "inverse":
        def fn(it):
            return b / (one + d * _F(it)) ** pw
    elif p == "poly":
        def fn(it):
            return b * (one - min(_F(it) / _F(max_iterations), one)) ** pw
    elif p == "sigmoid":
        def fn(it):
            return b / (one + np.exp(-d * (_F(it) - st)))
    elif p in ("step", "torchstep"):
        def fn(it):
            return b * d ** np.floor(_F(it) / st)
    else:
        # Piecewise-constant: the value of the largest key <= iteration.
        keys = sorted(int(k) for k in schedule_map)
        values = [b] + [_F(schedule_map[k]) for k in keys]

        def fn(it):
            return values[sum(1 for k in keys if _F(k) <= _F(it))]

    return lambda it: float(fn(it))
