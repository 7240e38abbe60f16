"""The port's spans: phase timers (wall clock and RSS), the span ring and
the opt-in ``torch.profiler`` trace.

The counterpart of ``strainscan_tpu/utils/profiling.py``.  One primitive,
:class:`Span` (opened by :func:`span`), times a stretch of work on
``time.perf_counter_ns()`` and, on closing, appends itself to the bounded
ring :data:`SPANS`.  A span's parent is the span open in its context (a
``contextvars.ContextVar``: a producer thread started in a copy of the
context, as ``utils.prefetch`` starts it, sees its caller's span); a span
with no parent takes a new sample id, which its descendants share.  While
a ``torch.profiler`` profile runs (``_is_profiler_enabled``, which every
thread sees), a span also opens a trace range of its name
(:func:`_trace_range`), so it appears in the trace under its own name;
with none running it costs two clock reads, a context-variable set and
reset and one append.

:func:`phase` is a span that also logs and keeps its seconds in
:data:`PHASE_TIMES`; :func:`phase_acc`, for hot spots called many times,
only adds its seconds there: no ring entry, no trace range.

With ``STRAINSCAN_TRACE_DIR`` set, :func:`phase` also traces the phase with
``torch.profiler`` (CPU activity, plus CUDA activity when a GPU is
available; every thread where the installed torch has
``profile_all_threads``, so the producer's spans show) and writes one
Chrome trace per phase name, ``<dir>/<name>.pt.trace.json`` (a name such
as ``identify/count`` makes a subdirectory).  Two profilers cannot run at
once in a process, so a phase that opens while any profile is running only
times (the build's ``tree_build/hierarchy`` inside ``tree_build``, or every
phase under a caller's own profile).  A failing export raises.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import logging
import os
import resource
import sys
import threading
import time
from typing import Optional

log = logging.getLogger("strainscan_tpu_torch")

TRACE_ENV = "STRAINSCAN_TRACE_DIR"

# last elapsed seconds per phase name (accumulated for phase_acc)
PHASE_TIMES: dict = {}

# every closed span, oldest first; bounded, so a long batch-identify keeps
# only its latest (65,536 hold a 51 s benchmark window of any cell)
SPANS: collections.deque = collections.deque(maxlen=65536)

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "strainscan_span", default=None)
_span_ids = itertools.count(1)
_sample_ids = itertools.count(1)


def _profiling() -> bool:
    """Whether a ``torch.profiler`` profile runs in this process (no torch
    imported, none can)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class Span:
    """One timed stretch of work, a context manager.

    ``id`` only grows; ``parent`` is the enclosing span's id (None for a
    root) and ``sample`` the root's sample id; ``thread`` the thread's
    name; ``t0``, ``t1`` ``perf_counter_ns()`` readings; ``attrs`` the few
    attributes a reader needs.  ``ring=False`` (:func:`phase_acc`) makes
    a span that opens no context, takes no id, opens no trace range and,
    on closing, adds its seconds to ``PHASE_TIMES[name]`` instead of
    entering the ring."""

    __slots__ = ("name", "attrs", "ring", "id", "parent", "sample",
                 "thread", "t0", "t1", "up", "_token", "_rf")

    def __init__(self, name: str, attrs: Optional[dict] = None,
                 ring: bool = True):
        self.name, self.attrs, self.ring = name, attrs or {}, ring
        self.id = self.parent = self.sample = self.thread = None
        self.up = self._rf = None
        self.t0 = self.t1 = 0

    def __enter__(self) -> "Span":
        if self.ring:
            up = _CURRENT.get()
            self.id, self.up = next(_span_ids), up
            if up is None:
                self.sample = next(_sample_ids)
            else:
                self.parent, self.sample = up.id, up.sample
            self.thread = threading.current_thread().name
            self._token = _CURRENT.set(self)
            if _profiling():
                self._rf = _trace_range(self.name)
        self.t0 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if self.ring:
            _CURRENT.reset(self._token)
            self._token = self.up = None
            SPANS.append(self)
        else:
            add_seconds(self.name, self.seconds)

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


def _trace_range(name: str):
    """A context manager that makes a range ``name`` in the running
    profile: the profiler's own C++ record function (category ``cpu_op``)
    where torch has it, which keeps the GIL; else ``record_function``
    (``user_annotation``), whose op lets the GIL go, so that a busy
    producer thread can hold the range's start back by milliseconds from
    the ring's."""
    try:
        from torch._C._profiler import _RecordFunctionFast
    except ImportError:
        from torch.profiler import record_function

        return record_function(name)
    return _RecordFunctionFast(name)


def span(name: str, **attrs) -> Span:
    """A ring span named ``name`` with attributes ``attrs``."""
    return Span(name, attrs)


def current() -> Optional[Span]:
    """The innermost span open in this context, or None."""
    return _CURRENT.get()


def note(**attrs) -> None:
    """Set attributes on the innermost span open in this context (none
    open: nothing)."""
    s = _CURRENT.get()
    if s is not None:
        s.attrs.update(attrs)


def timed_iter(it, name: str):
    """Yield from ``it``, each ``next()`` (the last, which ends it, too)
    in a span ``name``."""
    it = iter(it)
    while True:
        with span(name):
            try:
                x = next(it)
            except StopIteration:
                return
        yield x


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


def _all_threads():
    """The profiler's ``profile_all_threads`` setting, where the installed
    torch has it (else None: the caller's thread only)."""
    from torch.profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


@contextlib.contextmanager
def _trace(path: str):
    """Profile the body with torch.profiler; write its Chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 experimental_config=_all_threads()) as prof:
        yield
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def phase(name: str, acc: bool = False):
    """A span that logs the elapsed wall time and RSS of a pipeline phase
    and keeps its seconds in ``PHASE_TIMES[name]`` (with ``acc``, adds
    them there: a phase run once per cluster of a sample); traced when
    ``STRAINSCAN_TRACE_DIR`` is set and no profile runs.  Yields the
    span."""
    trace_dir = os.environ.get(TRACE_ENV)
    ctx = (_trace(trace_path(trace_dir, name))
           if trace_dir and not _profiling() else contextlib.nullcontext())
    with ctx, span(name) as s:
        yield s
    if acc:
        add_seconds(name, s.seconds)
    else:
        PHASE_TIMES[name] = s.seconds
    log.info("phase %-28s %8.2fs  rss %.2f GB", name, s.seconds, rss_gb())


def phase_acc(name: str) -> Span:
    """Silent, accumulating :func:`phase` for hot spots called many times:
    adds the body's seconds to ``PHASE_TIMES[name]``; no ring entry."""
    return Span(name, ring=False)


def add_seconds(name: str, seconds: float) -> None:
    """Add ``seconds`` to ``PHASE_TIMES[name]``, as :func:`phase_acc` does
    on closing: for a loop that sums its own ``perf_counter_ns()`` deltas
    where even a ``phase_acc`` per call costs too much."""
    PHASE_TIMES[name] = PHASE_TIMES.get(name, 0.0) + seconds
