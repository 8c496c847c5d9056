"""Learning-rate schedules, as functions ``step -> lr`` on the host.

* multistep_restart: gamma decay at milestones, optional restarts that reset
  the rate to base*weight at given steps.
* cosine_restart: cosine annealing with restart periods and weights.
Both apply a linear warm-up over the first ``warmup_iter`` steps when it is
positive.
"""

from __future__ import annotations

import math


def _last_restart(step, restarts, restart_weights):
    """(index past the last restart reached, its step, its weight)."""
    idx, last, weight = 0, 0, 1.0
    for i, (r, w) in enumerate(zip(restarts, restart_weights)):
        if step >= r:
            idx, last, weight = i + 1, r, w
    return idx, last, weight


def _warm(lr, step, warmup_iter):
    if 0 < warmup_iter and step < warmup_iter:
        return lr * step / max(1, warmup_iter)
    return lr


def multistep_restart(base_lr: float, milestones, gamma: float = 0.5,
                      restarts=None, restart_weights=None,
                      warmup_iter: int = -1):
    milestones = sorted(milestones or [])
    restarts = list(restarts or [])
    restart_weights = list(restart_weights or [1] * len(restarts))

    def schedule(step):
        step = int(step)
        # a restart also restarts the chain of decays
        _, last, weight = _last_restart(step, restarts, restart_weights)
        n_decay = sum(1 for m in milestones if last < m <= step)
        return _warm(base_lr * weight * (gamma ** n_decay), step, warmup_iter)

    return schedule


def cosine_restart(base_lr: float, t_period, eta_min: float = 1e-7,
                   restarts=None, restart_weights=None,
                   warmup_iter: int = -1):
    t_period = list(t_period)
    restarts = list(restarts or [])
    restart_weights = list(restart_weights or [1] * len(restarts))

    def schedule(step):
        step = int(step)
        idx, last, weight = _last_restart(step, restarts, restart_weights)
        period = t_period[min(idx, len(t_period) - 1)]
        t = step - last
        lr = eta_min + 0.5 * (base_lr * weight - eta_min) * (
            1 + math.cos(math.pi * (t % period) / period))
        return float(_warm(lr, step, warmup_iter))

    return schedule
