"""Phase timers (wall clock and RSS), without a device-trace hook."""

from __future__ import annotations

import contextlib
import logging
import time

log = logging.getLogger("strainscan_tpu_torch")

# last elapsed seconds per phase name (accumulated for phase_acc)
PHASE_TIMES: dict = {}


def _rss_gb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024 / 1024
    except OSError:
        pass
    return float("nan")


@contextlib.contextmanager
def phase(name: str):
    """Log the elapsed wall time and RSS of a pipeline phase."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    PHASE_TIMES[name] = dt
    log.info("phase %-28s %8.2fs  rss %.2f GB", name, dt, _rss_gb())


@contextlib.contextmanager
def phase_acc(name: str):
    """Silent, accumulating :func:`phase` for hot spots called many times."""
    t0 = time.perf_counter()
    yield
    PHASE_TIMES[name] = PHASE_TIMES.get(name, 0.0) + (time.perf_counter() - t0)
