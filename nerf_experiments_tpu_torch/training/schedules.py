"""Training schedules: LeNice LR decay, BARF blur sigma, the GARF/GaborF
exponential LRs and the Mip-BARF sigma schedule.

Every schedule is a pure function of the step (or epoch fraction) returning a
Python float, computed on the host and handed to the step as a scalar:

  * `le_nice`: the closed-form exponential decay of `SchedulerLeNice`
    (`barf/model_interpolation.py:30-67`): lr(step) =
    start * exp(log(stop/start)/n * min(step, n)); no decay when n <= 0 or
    start == 0.
  * `garf_exponential`: garf's per-step ExponentialLR, unclamped
    (`garf/model_garf.py:356-362`).
  * `quantized_exponential`: gaborf's staircase of the same decay, one LR
    update per `steps_per_period` steps (`gaborf/model_gaborf.py:284-303`).
  * `barf_sigma_alpha`: sigma_max * 2^(-alpha), zeroed below 1/4
    (`barf/model_barf.py:14-23`).
  * `mip_sigma_schedule`: 1 before decay-start, exponential decay to
    0.25/start_sigma at decay-end, 0 after (`barf/model_mip.py:170-204`).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

Schedule = Callable[[int], float]


def _constant(value: float) -> Schedule:
    return lambda step: float(value)


def le_nice(start_lr: float, stop_lr: float, number_of_steps: Optional[int]) -> Schedule:
    """Closed-form per-group exponential decay schedule (SchedulerLeNice)."""
    if not number_of_steps or number_of_steps <= 0 or start_lr == 0:
        return _constant(start_lr)
    log_decay = (math.log(stop_lr) - math.log(start_lr)) / number_of_steps
    return lambda step: start_lr * math.exp(log_decay * min(float(step), number_of_steps))


def garf_exponential(start_lr: float, stop_lr: float,
                     number_of_steps: Optional[int]) -> Schedule:
    """garf's ExponentialLR: gamma^step with gamma = 2^(log2(stop/start)/n),
    NOT clamped at n (the torch scheduler keeps decaying)."""
    if not number_of_steps or number_of_steps <= 0 or start_lr == 0:
        return _constant(start_lr)
    log_gamma = (math.log(stop_lr) - math.log(start_lr)) / number_of_steps
    return lambda step: start_lr * math.exp(log_gamma * float(step))


def quantized_exponential(start_lr: float, stop_lr: float, number_of_steps: Optional[int],
                          steps_per_period: int) -> Schedule:
    """gamma^(floor(step / steps_per_period)), with gamma chosen per period
    so the endpoints match `garf_exponential`'s."""
    if not number_of_steps or number_of_steps <= 0 or start_lr == 0:
        return _constant(start_lr)
    n_periods = max(number_of_steps // max(steps_per_period, 1), 1)
    log_gamma = (math.log(stop_lr) - math.log(start_lr)) / n_periods
    return lambda step: start_lr * math.exp(log_gamma * math.floor(step / steps_per_period))


def barf_sigma_alpha(alpha: float, sigma_max: float) -> float:
    """Blur sigma coupled to the BARF annealing alpha (`get_sigma_alpha`)."""
    sigma = sigma_max * 2.0 ** (-float(alpha))
    return 0.0 if sigma < 0.25 else sigma


def mip_sigma_schedule(current_step: int, decay_start_step: int, decay_end_step: int,
                       start_blur_sigma: float, start_pixel_width_sigma: float) -> float:
    """Mip-BARF sigma_schedule multiplier (`update_sigma_schedule:170-204`)."""
    start_sigma = max(start_blur_sigma, start_pixel_width_sigma, 1e-8)
    step = float(current_step)
    if step > decay_end_step:
        return 0.0
    if step < decay_start_step:
        return 1.0
    frac = (step - decay_start_step) / max(decay_end_step - decay_start_step, 1)
    return (0.25 / start_sigma) ** frac


def sigma_floor(sigma: float) -> float:
    """Sigmas below 1/4 are treated as no blur (`model_mip.py:207-225`)."""
    return 0.0 if sigma < 0.25 else float(sigma)


def epoch_fraction(step: int, batch_size: int, dataset_size_rays: int) -> float:
    """iterations -> fractional epochs (`run_barf.py:19-20` inverted)."""
    return step * batch_size / dataset_size_rays
