"""Host clocks: the process's age (set-up is timed from the process's start)
and the percentile the tails take."""

from __future__ import annotations

import os
import time

_T0 = time.monotonic()


def process_age() -> float:
    """Seconds since this process started, from /proc (to a clock tick);
    where /proc cannot say, since this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T0


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
