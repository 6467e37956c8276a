"""Step-table bucketing (twin of `repro.core.cost.bucket`/`bucket_ladder`).

The rest of the reference's cost model (counts, calibration, autotuner) is
not ported yet (ROADMAP queue A).
"""
from __future__ import annotations


def bucket(n: int, minimum: int = 16) -> int:
    """Pad a step count to a power-of-two bucket of at least `minimum`, so
    step tables take one of O(log n) lengths."""
    return max(minimum, 1 << max(n - 1, 0).bit_length())


def bucket_ladder(n_max: int, minimum: int = 16) -> list:
    """Every bucket `bucket(n, minimum)` can return for n in [1, n_max]."""
    lo = bucket(1, minimum)
    hi = bucket(max(int(n_max), 1), minimum)
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * 2)
    return out
