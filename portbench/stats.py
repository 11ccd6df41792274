"""The benchmark's arithmetic of latencies and spreads."""

from __future__ import annotations

import math


def percentile(values: list, q: float) -> float:
    """Nearest-rank percentile (the smallest value with at least q % of
    the sample at or below it).  A failed request enters as +inf, so it
    misses every limit; a censored one (no audio by the window's end)
    enters as the time it had waited, a lower bound of its latency."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def ttfa_values(records: list, start: float, end: float) -> list:
    """Time to first audio of every request due in [start, end): from its
    due time to its first callback with samples; +inf where it failed; at
    least end - due where it had no audio when the window closed."""
    out = []
    for r in records:
        if not start <= r.due < end:
            continue
        if r.failed:
            out.append(math.inf)
        elif r.first_audio is not None and r.first_audio < end:
            out.append(r.first_audio - r.due)
        else:
            out.append(end - r.due)
    return out
