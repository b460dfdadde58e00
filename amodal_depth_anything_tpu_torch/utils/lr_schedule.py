"""LR schedules as functions of the update count.

`iter_exponential`: linear warmup then exponential decay to final_ratio
at total_iter_length, constant after (reference
`src/util/lr_scheduler.py:6-31`; configured 50k/0.01/100 warmup in
`config/train_discriminative_vitl.yaml:54-61`). The count starts at 0, so
with `warmup_steps > 0` the first update has learning rate 0, as in the JAX
package (whose optax count starts at 0 too).
"""

from __future__ import annotations

import numpy as np

__all__ = ["iter_exponential"]


def iter_exponential(base_lr: float, total_iter_length: int,
                     final_ratio: float, warmup_steps: int = 0):
    """schedule(step) -> learning rate, in float32 arithmetic like the JAX
    package's schedule."""
    f32 = np.float32
    effective = max(total_iter_length - warmup_steps, 1)
    log_ratio = np.log(f32(final_ratio))

    def schedule(step: int) -> float:
        step = f32(step)
        if step < warmup_steps:
            alpha = step / f32(max(warmup_steps, 1))
        elif step >= total_iter_length:
            alpha = f32(final_ratio)
        else:
            alpha = np.exp((step - f32(warmup_steps)) / f32(effective)
                           * log_ratio)
        return float(f32(base_lr) * f32(alpha))

    return schedule
