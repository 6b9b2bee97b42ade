"""LR schedules (mirrors seq2seq_vc_tpu/train/schedulers.py).

``warmup_lr_schedule`` is the reference ``WarmupLR``: Noam-style warmup
whose peak equals the configured lr,

    lr(s) = base_lr * warmup_steps^0.5 * min(s^-0.5, s * warmup_steps^-1.5).

Indexing: the schedule is called with ``count``, the number of updates
already applied (0 for the first), and evaluates ``f(count + 1)``, as the
reference's ``WarmupLR`` applies ``f(last_epoch + 1)`` = f(1) on the first
step and as the JAX package does under optax.
"""

from __future__ import annotations


def warmup_lr_schedule(base_lr: float, warmup_steps: int = 25000):
    def schedule(count: int) -> float:
        s = float(count) + 1.0
        return base_lr * warmup_steps ** 0.5 * min(s ** -0.5, s * warmup_steps ** -1.5)

    return schedule


def get_scheduler(name: str, base_lr: float, **params):
    if name in ("warmuplr", "WarmupLR"):
        return warmup_lr_schedule(base_lr, **params)
    raise ValueError(f"unknown scheduler: {name}")
