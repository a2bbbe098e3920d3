"""The one monotonic clock every serve-stack latency stamp reads (the
port's copy of the reference's ``obs/clock.py``): routing every stamp
through :func:`now` keeps all stamps mutually subtractable."""

from __future__ import annotations

import time


def now() -> float:
    """Current monotonic time, seconds (``time.perf_counter``)."""
    return time.perf_counter()
