"""Phase timers (wall clock and RSS) and the opt-in ``torch.profiler`` trace.

The counterpart of ``strainscan_tpu/utils/profiling.py``.  With
``STRAINSCAN_TRACE_DIR`` set, :func:`phase` also traces the phase with
``torch.profiler`` (CPU activity, plus CUDA activity when a GPU is available)
and writes one Chrome trace per phase name, ``<dir>/<name>.pt.trace.json``
(a name such as ``identify/count`` makes a subdirectory).  Two profilers
cannot run at once in a process, so a phase that opens while a trace is
running only times (the build's ``tree_build/hierarchy`` inside
``tree_build``).  A failing export raises.
"""

from __future__ import annotations

import contextlib
import logging
import os
import resource
import time

log = logging.getLogger("strainscan_tpu_torch")

TRACE_ENV = "STRAINSCAN_TRACE_DIR"

# last elapsed seconds per phase name (accumulated for phase_acc)
PHASE_TIMES: dict = {}

# True while a phase's profiler runs in this process
_tracing = False


def rss_gb() -> float:
    """This process's resident set in GiB (NaN where /proc has none)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024 / 1024
    except OSError:
        pass
    return float("nan")


def peak_rss_gb() -> float:
    """This process's peak resident set in GiB (``getrusage``; Linux
    counts ``ru_maxrss`` in KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def trace_path(trace_dir: str, name: str) -> str:
    """Where the trace of phase ``name`` goes."""
    return os.path.join(trace_dir, name + ".pt.trace.json")


@contextlib.contextmanager
def _trace(path: str):
    """Profile the body with torch.profiler; write its Chrome trace."""
    global _tracing
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _tracing = True
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        _tracing = False
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def phase(name: str):
    """Log the elapsed wall time and RSS of a pipeline phase; trace it when
    ``STRAINSCAN_TRACE_DIR`` is set and no trace is running."""
    trace_dir = os.environ.get(TRACE_ENV)
    ctx = (_trace(trace_path(trace_dir, name)) if trace_dir and not _tracing
           else contextlib.nullcontext())
    t0 = time.perf_counter()
    with ctx:
        yield
    dt = time.perf_counter() - t0
    PHASE_TIMES[name] = dt
    log.info("phase %-28s %8.2fs  rss %.2f GB", name, dt, rss_gb())


@contextlib.contextmanager
def phase_acc(name: str):
    """Silent, accumulating :func:`phase` for hot spots called many times."""
    t0 = time.perf_counter()
    yield
    PHASE_TIMES[name] = PHASE_TIMES.get(name, 0.0) + (time.perf_counter() - t0)
