"""Per-step schedules of the training loop (the port's own copy of the part
of ssl_audio_tpu/utils/schedules.py it needs)."""
from __future__ import annotations

import numpy as np


def sine_scheduler_increase(final_value, epochs, niter_per_ep, warmup_epochs=0,
                            warmup_value=0) -> np.ndarray:
    """Increasing quarter-sine schedule of the mask ratio, one value per
    iteration (reference utils.py:81-91): warmup_value for the warm-up
    epochs, then (final - warmup) * sin(pi/2 * i / n)."""
    warmup_schedule = np.array([])
    warmup_iters = warmup_epochs * niter_per_ep
    if warmup_epochs > 0:
        warmup_schedule = np.linspace(warmup_value, warmup_value, warmup_iters)
    iters = np.arange(epochs * niter_per_ep - warmup_iters)
    schedule = (final_value - warmup_value) * np.sin((np.pi / 2) * (iters / len(iters)))
    return np.concatenate((warmup_schedule, schedule))


def cosine_scheduler(base_value, final_value, epochs, niter_per_ep, warmup_epochs=0,
                     start_warmup_value=0) -> np.ndarray:
    """Per-iteration cosine schedule with a linear warm-up, one value per
    iteration (reference utils.py:68-78): np.linspace(start, base) over the
    warm-up iterations, then final + (base - final) / 2 * (1 + cos(pi i / n))."""
    warmup_schedule = np.array([])
    warmup_iters = warmup_epochs * niter_per_ep
    if warmup_epochs > 0:
        warmup_schedule = np.linspace(start_warmup_value, base_value, warmup_iters)
    iters = np.arange(epochs * niter_per_ep - warmup_iters)
    schedule = final_value + 0.5 * (base_value - final_value) * (
        1 + np.cos(np.pi * iters / len(iters)))
    return np.concatenate((warmup_schedule, schedule))
