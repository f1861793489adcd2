"""What the per-layer metrics share: kernel time by name from the trace,
and the device's idle share."""

from __future__ import annotations

import re


def kernel_time(info, pattern: str) -> tuple:
    """(seconds, launches) of the traced kernels whose name matches ``pattern``."""
    rx = re.compile(pattern)
    rows = [v for name, v in info.kernels.items() if rx.search(name)]
    return sum(r[0] for r in rows), sum(r[1] for r in rows)


def other_time(info, pattern: str) -> float:
    """Seconds of the traced device operations whose name does not match."""
    rx = re.compile(pattern)
    return sum(v[0] for name, v in info.kernels.items() if not rx.search(name))


def idle_pct(info):
    """The traced window's share in which no operation ran on the device."""
    if not info.traced_s or info.busy_s is None or info.busy_s <= 0:
        return None
    return 100.0 * (1.0 - info.busy_s / info.traced_s)
