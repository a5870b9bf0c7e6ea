"""Learning-rate and scalar schedules (dualmessagepassing_tpu/train/
schedules.py, all of it: pure Python, copied).

Reference semantics:
  * the LR lambda family (utils/scheduler.py:12-201): constant / linear /
    cosine x warmup x restart, as a step -> multiplier function;
  * anneal_fn (utils/anneal.py:11-49) and cyclical_fn
    (utils/cyclical.py:11-45) for loss-weight and leaky-slope schedules,
    with the reversed warm-in for steps < num_init_steps and the spec
    strings "anneal_cosine$v1$v2" / "cyclical_linear$v1$v2"
    (train.py:501-604);
  * derive_schedule_config, the reference's warmup and cycle counts
    (train.py:1231-1254).
"""

from __future__ import annotations

import math
from typing import Callable, Union

from ..constants import (EPS, INIT_STEPS, MIN_PERCENT, NUM_CYCLES, PI,
                         SCHEDULE_STEPS)


# =============================================================================
# scalar schedules
# =============================================================================

def anneal_fn(fn, current_step, num_init_steps=INIT_STEPS,
              num_anneal_steps=SCHEDULE_STEPS, num_cycles=NUM_CYCLES,
              value1=0.0, value2=1.0) -> float:
    if current_step < num_init_steps:
        return anneal_fn(fn, current_step, 0, num_init_steps * 2, 1,
                         value2, value1)
    if current_step > num_anneal_steps:
        return value2
    if not fn or fn in ("none", "constant"):
        return value2
    progress = float(num_cycles * (current_step - num_init_steps)) / max(
        1, num_anneal_steps - num_init_steps) % 1
    if fn == "linear":
        if progress < 0.5:
            return float(value1 + (value2 - value1) * progress * 2)
        return value2
    if fn == "cosine":
        if progress < 0.5:
            return float(
                value1 + (value2 - value1) * (1 - math.cos(PI * progress * 2)) / 2
            )
        return value2
    raise NotImplementedError(fn)


def cyclical_fn(fn, current_step, num_init_steps=INIT_STEPS,
                num_cyclical_steps=SCHEDULE_STEPS, num_cycles=NUM_CYCLES,
                value1=0.0, value2=1.0) -> float:
    if current_step < num_init_steps:
        return cyclical_fn(fn, current_step, 0, num_init_steps * 2, 1,
                           value2, value1)
    if current_step > num_cyclical_steps:
        return value2
    if not fn or fn in ("none", "constant"):
        return value2
    progress = float(num_cycles * (current_step - num_init_steps)) / max(
        1, num_cyclical_steps - num_init_steps) % 1
    if fn == "linear":
        if progress < 0.5:
            return float(value1 + (value2 - value1) * progress * 2)
        return float(value2 + (value1 - value2) * (progress * 2 - 1))
    if fn == "cosine":
        return float(
            value1 + (value2 - value1) * (1 - math.cos(PI * progress * 2)) / 2
        )
    raise NotImplementedError(fn)


def scalar_schedule(spec: Union[str, float, int], total_steps: int) -> Callable[[int], float]:
    """Parse "anneal_cosine$1.0$0.01"-style specs (train.py:501-604) into
    step -> value functions; numbers become constants."""
    if isinstance(spec, (int, float)):
        v = float(spec)
        return lambda step: v
    if spec.startswith("anneal_"):
        fn, v1, v2 = spec.rsplit("$", 3)
        fn = fn[len("anneal_"):]
        return lambda step: anneal_fn(
            fn, step, num_init_steps=0, num_anneal_steps=total_steps,
            num_cycles=NUM_CYCLES, value1=float(v1), value2=float(v2))
    if spec.startswith("cyclical_"):
        fn, v1, v2 = spec.rsplit("$", 3)
        fn = fn[len("cyclical_"):]
        return lambda step: cyclical_fn(
            fn, step, num_init_steps=0, num_cyclical_steps=total_steps,
            num_cycles=NUM_CYCLES, value1=float(v1), value2=float(v2))
    try:
        v = float(spec)
        return lambda step: v
    except ValueError:
        raise ValueError(f"bad scalar schedule spec: {spec!r}") from None


def derive_schedule_config(num_train: int, config: dict) -> dict:
    """Reference-derived warmup/cycle parameters (train.py:1231-1254).

      num_warmup_steps  = int(N/bsz * 0.5 * min(0.06*epochs, early_stop))
      num_schedule_steps = int(N/bsz * epochs) [- warmup if min_percent>EPS]
      min_percent       = max(1e-3, weight_decay)
      num_cycles        = max(1, num_schedule_steps / 20000)

    Returns the four keys; callers merge them into the train config so the
    default recipe runs with the reference's warmup instead of zero.
    """
    steps = num_train / config["train_batch_size"]
    warmup = int(steps * 0.5 * min(config["train_epochs"] * 0.06,
                                   config["early_stop_rounds"]))
    schedule = int(steps * config["train_epochs"])
    min_percent = max(1e-3, config["weight_decay"])
    if min_percent > EPS:
        schedule -= warmup
    return {
        "num_warmup_steps": warmup,
        "num_schedule_steps": schedule,
        "min_percent": min_percent,
        "num_cycles": max(1, schedule / 20000),
    }


# =============================================================================
# LR schedules (multiplier form; multiply by base lr for optax)
# =============================================================================

def lr_schedule(
    name: str,
    num_warmup_steps: int = INIT_STEPS,
    num_schedule_steps: int = SCHEDULE_STEPS,
    num_cycles: int = NUM_CYCLES,
    min_percent: float = MIN_PERCENT,
) -> Callable[[int], float]:
    """LambdaLR-family multiplier (utils/scheduler.py:12-201)."""

    def warmup(step):
        return float(step) / float(max(1, num_warmup_steps))

    if name == "constant":
        return lambda step: 1.0
    if name == "constant_with_warmup":
        return lambda step: warmup(step) if step < num_warmup_steps else 1.0
    if name == "linear":
        return lambda step: max(
            min_percent,
            float(num_schedule_steps - step) / float(max(1, num_schedule_steps)),
        )
    if name == "linear_with_warmup":
        def f(step):
            if step < num_warmup_steps:
                return warmup(step)
            return max(
                min_percent,
                float(num_schedule_steps - step)
                / float(max(1, num_schedule_steps - num_warmup_steps)),
            )
        return f
    if name == "linear_with_warmup_and_restart":
        def f(step):
            if step < num_warmup_steps:
                return warmup(step)
            progress = float(step - num_warmup_steps) / float(
                max(1, num_schedule_steps - num_warmup_steps))
            if progress >= 1.0:
                return min_percent
            return max(min_percent, 1 - (float(num_cycles) * progress) % 1.0)
        return f
    if name == "cosine":
        def f(step):
            progress = float(step) / float(max(1, num_schedule_steps))
            return max(
                min_percent,
                0.5 * (1.0 + math.cos(PI * float(num_cycles) * 2.0 * progress)),
            )
        return f
    if name == "cosine_with_warmup":
        def f(step):
            if step < num_warmup_steps:
                return warmup(step)
            progress = float(step - num_warmup_steps) / float(
                max(1, num_schedule_steps - num_warmup_steps))
            return max(
                min_percent,
                0.5 * (1.0 + math.cos(PI * float(num_cycles) * 2.0 * progress)),
            )
        return f
    if name == "cosine_with_warmup_and_restart":
        def f(step):
            if step < num_warmup_steps:
                return warmup(step)
            progress = float(step - num_warmup_steps) / float(
                max(1, num_schedule_steps - num_warmup_steps))
            if progress >= 1.0:
                return min_percent
            return max(
                min_percent,
                0.5 * (1.0 + math.cos(PI * ((float(num_cycles) * progress) % 1.0))),
            )
        return f
    raise NotImplementedError(f"scheduler '{name}'")
