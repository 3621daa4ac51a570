"""Annealing and learning-rate schedules (port of the trainer's part of
``l2hmc_tpu/train/schedules.py``).

Both are host functions of the integer step, evaluated in float32 as the
reference's jitted versions are; optax's schedule semantics are written out
(``exponential_decay`` without staircase, ``linear_schedule``,
``join_schedules``).  The temperature schedules wait for the sampler slice.
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32


def beta_schedule(step: int, train_steps: int, beta_init: float,
                  beta_final: float) -> float:
    """Inverse-beta-linear annealing::

        1/beta(t) = (1 - t/T) / beta_init + (t/T) / beta_final
    """
    frac = np.clip(_F32(step) / _F32(max(train_steps, 1)), _F32(0), _F32(1))
    inv = (_F32(1) - frac) / _F32(beta_init) + frac / _F32(beta_final)
    return float(_F32(1) / inv)


def make_lr_schedule(lr_init: float, decay_steps: int, decay_rate: float,
                     warmup_steps: int = 0):
    """``count -> lr``: exponential decay ``lr * rate^(t/steps)``, after an
    optional linear warmup from 0 over ``warmup_steps``; the decay then sees
    ``count - warmup_steps`` (optax ``join_schedules``)."""

    def decay(count: int) -> float:
        if decay_steps <= 0 or decay_rate == 0:
            return float(_F32(lr_init))
        if count <= 0:
            return float(_F32(lr_init))
        p = _F32(count) / _F32(decay_steps)
        return float(_F32(lr_init) * np.power(_F32(decay_rate), p))

    if warmup_steps <= 0:
        return decay

    def schedule(count: int) -> float:
        if count >= warmup_steps:
            return decay(count - warmup_steps)
        c = _F32(min(max(count, 0), warmup_steps))
        frac = _F32(1) - c / _F32(warmup_steps)
        return float((_F32(0) - _F32(lr_init)) * frac + _F32(lr_init))

    return schedule
