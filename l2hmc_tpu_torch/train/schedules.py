"""Annealing and learning-rate schedules (port of
``l2hmc_tpu/train/schedules.py``).

Host functions of the integer step, evaluated in float32 as the
reference's jitted versions are; optax's schedule semantics are written out
(``exponential_decay`` without staircase, ``linear_schedule``,
``join_schedules``).  The temperature annealer of the sampler workload is a
small state of float32 scalars, advanced by pure functions.
"""

from __future__ import annotations

from typing import NamedTuple

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


class TemperatureSchedule(NamedTuple):
    """State of the mixture-target temperature annealer: ``temperature``
    ``T >= 1`` is multiplied by ``annealing_factor`` every
    ``annealing_steps`` steps until it reaches 1; the adaptation slows the
    factor when the measured tunneling rate collapses and speeds it up when
    the rate is healthy.  Scalars are float32, the counter an int."""

    temperature: np.float32
    annealing_factor: np.float32
    steps_since_update: int


def init_temperature(t_init: float = 10.0,
                     factor: float = 0.98) -> TemperatureSchedule:
    return TemperatureSchedule(_F32(t_init), _F32(factor), 0)


def temperature_step(sched: TemperatureSchedule,
                     annealing_steps: int) -> TemperatureSchedule:
    """Advance one training step: every ``annealing_steps`` steps
    ``T <- max(T * factor, 1)``."""
    count = sched.steps_since_update + 1
    if count < annealing_steps:
        return sched._replace(steps_since_update=count)
    new_t = max(_F32(sched.temperature) * _F32(sched.annealing_factor),
                _F32(1))
    return TemperatureSchedule(_F32(new_t), sched.annealing_factor, 0)


def adapt_temperature_schedule(sched: TemperatureSchedule,
                               tunneling_rate: float,
                               target_rate: float = 0.2,
                               slow_factor: float = 0.5,
                               fast_factor: float = 1.05
                               ) -> TemperatureSchedule:
    """Adapt the annealer to a measured tunneling rate.  Below
    ``target_rate`` (collapsed): the factor moves toward 1 by
    ``slow_factor`` (anneal slower) and ``T <- max(T / factor, 1)``, one
    factor back up; otherwise the factor moves away from 1 by
    ``fast_factor``, clipped to [0.5, 0.9999]."""
    af = _F32(sched.annealing_factor)
    if _F32(tunneling_rate) < _F32(target_rate):
        return TemperatureSchedule(
            _F32(max(_F32(sched.temperature) / af, _F32(1))),
            _F32(_F32(1) - (_F32(1) - af) * _F32(slow_factor)),
            sched.steps_since_update)
    af_fast = np.clip(_F32(1) - (_F32(1) - af) * _F32(fast_factor),
                      _F32(0.5), _F32(0.9999))
    return sched._replace(annealing_factor=_F32(af_fast))
