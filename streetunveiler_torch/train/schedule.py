"""Learning-rate schedules (counterpart of ``streetunveiler_tpu/train/
schedule.py``)."""

from __future__ import annotations

import math

import numpy as np


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1_000_000) -> float:
    """Log-linear interpolation from ``lr_init`` to ``lr_final`` over
    ``max_steps`` with an optional sine delay ramp (the reference's
    ``get_expon_lr_func``). Host-side floats: the step number is known on
    the host, and the rates must be positive. Evaluated in float32 like
    the JAX package's."""
    f32 = np.float32
    step = f32(step)
    if lr_delay_steps > 0:
        delay_rate = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
            f32(0.5 * math.pi) * np.clip(step / f32(lr_delay_steps), 0, 1))
    else:
        delay_rate = f32(1.0)
    t = np.clip(step / f32(max_steps), f32(0), f32(1))
    log_lerp = np.exp(np.log(f32(lr_init)) * (f32(1) - t)
                      + np.log(f32(lr_final)) * t)
    return float(f32(delay_rate * log_lerp))
