"""Arithmetic the per-layer metric readers share (`metrics/*.py`).

Each reader takes a run's facts and returns its metric or None where the
run has nothing to read; a share of a peak or a roofline is never 0 for
want of a reading.
"""

from __future__ import annotations

from typing import Optional

from portbench.flops import PEAK_BF16, least_s


def mfu(facts: dict, flops_key: str, seconds_key: str) -> Optional[float]:
    """Analytic FLOPs over seconds times the bf16 peak, in %."""
    work, secs = facts.get(flops_key), facts.get(seconds_key)
    if not work or not secs:
        return None
    return 100.0 * work / (secs * PEAK_BF16)


def idle(facts: dict) -> Optional[float]:
    """The traced window's time with no device activity, in %."""
    tr = facts.get("trace")
    if not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline(facts: dict, layer: str) -> Optional[float]:
    """The layer's analytic least time, summed over its calls, over the
    device time of the activities launched inside its ranges, in %."""
    calls = (facts.get("layer_calls") or {}).get(layer)
    device_s = ((facts.get("trace") or {}).get("layer_device_s") or {}).get(
        layer)
    if not calls or not device_s:
        return None
    return 100.0 * sum(least_s(f, b) for f, b in calls) / device_s
