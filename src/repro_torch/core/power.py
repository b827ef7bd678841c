"""Per-iteration transmit-power schedules P_t (paper §III Remark 1, eq. 45).

All schedules satisfy the average-power constraint (1/T) sum_t P_t <= P_bar.
The port computes them on the host in numpy, as the reference does when it
precomputes a scheme's schedule array, and the schemes move the array to
their device once.
"""
from __future__ import annotations

import numpy as np

SCHEDULES = ("constant", "lh_stair", "lh_steps", "hl_steps")


def power_at(t, total_steps: int, p_avg: float, schedule: str = "constant"):
    """P_t for iteration t (0-based), in float32 as the reference computes it."""
    T = total_steps
    if schedule == "constant":
        return np.full_like(np.asarray(t, np.float32), p_avg) * 1.0
    if schedule == "lh_stair":
        # linear 0.5*P .. 1.5*P  (paper eq. 45a with P=200: 100 -> 300)
        frac = np.asarray(t, np.float32) / max(T - 1, 1)
        return p_avg * (0.5 + frac)
    third = max(T // 3, 1)
    idx = np.minimum(np.asarray(t) // third, 2)
    if schedule == "lh_steps":
        levels = np.asarray([0.5, 1.0, 1.5], np.float32) * p_avg
    elif schedule == "hl_steps":
        levels = np.asarray([1.5, 1.0, 0.5], np.float32) * p_avg
    else:
        raise ValueError(f"unknown power schedule {schedule!r}")
    return levels[idx]


def schedule_array(total_steps: int, p_avg: float, schedule: str) -> np.ndarray:
    """Host-side P_t for t = 0..T-1."""
    ps = [float(power_at(np.int64(t), total_steps, p_avg, schedule))
          for t in range(total_steps)]
    return np.asarray(ps, np.float64)
