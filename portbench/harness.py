"""One run of one cell: registry, set-up, the measured window, the trace,
the judgement and the result line.

Names in ``BENCHMARK.json`` lead to files, found under each of the
registry's roots in turn (the package directory last):

* a configuration ``<c>``: ``configs/<c>.json``;
* a traffic mix ``<t>``: ``traffic/<t>.json``, whose ``driver`` key names
  the loop ``drivers/<driver>.py`` that serves it;
* a per-layer metric ``<m>``: ``metrics/<m>.py``, whose ``read(obs)``
  returns the value or None when it finds nothing to read.

A driver module has ``prepare(run)`` (set-up: data, the program's state,
warm-up), ``step(run, i)`` (sample ``i`` through the program; returns the
sample's record), ``end_to_end(run, records, wall_s)`` (its end-to-end
metrics) and ``judge(run, records)`` (the reference and the comparisons:
a list of :class:`Check`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from typing import List, Optional

PACKAGE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(PACKAGE)
CACHE = os.path.join(PACKAGE, "cache")
BLOCKED = ("jax", "jaxlib", "flax", "strainscan_tpu")


class NoCard(RuntimeError):
    """The host has fewer CUDA devices than the cell asks for."""


class JaxLoaded(RuntimeError):
    """JAX or the JAX package was loaded in the measuring process."""


class BadInput(RuntimeError):
    """An input the run reads is not the one its configuration states."""


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


class Registry:
    """The benchmark's entries and the files they name."""

    def __init__(self, bench_path: str, roots: Optional[List[str]] = None):
        with open(bench_path) as f:
            self.bench = json.load(f)
        self.roots = list(roots or []) + [PACKAGE]

    def find(self, kind: str, name: str, ext: str) -> str:
        for root in self.roots:
            p = os.path.join(root, kind, name + ext)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"no {kind}/{name}{ext} under {self.roots}")

    def json(self, kind: str, name: str) -> dict:
        with open(self.find(kind, name, ".json")) as f:
            return json.load(f)

    def module(self, kind: str, name: str):
        path = self.find(kind, name, ".py")
        spec = importlib.util.spec_from_file_location(
            f"portbench.{kind}.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> List[dict]:
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


class Run:
    """What a driver sees of its run."""

    def __init__(self, reg: Registry, cell: str, seed: int, seconds: float,
                 trace: bool, devices: list, tmp: str, cache: str = CACHE):
        self.registry = reg
        self.cell = reg.cell(cell)
        self.name = cell
        self.config = reg.json("configs", self.cell["config"])
        self.traffic = reg.json("traffic", self.cell["traffic"])
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.devices = devices
        self.tmp = tmp
        self.cache = cache
        self.state: dict = {}

    @property
    def device(self):
        """The program's device argument: one device, or the mesh's list."""
        return self.devices[0] if len(self.devices) == 1 else self.devices

    def log(self, msg: str) -> None:
        print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def cuda_devices(chips: int) -> list:
    """The first ``chips`` CUDA devices; raises :class:`NoCard` when the
    host has fewer (a run measures on the card, never on the CPU)."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: no result")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} GPUs, the host has "
                     f"{torch.cuda.device_count()}: no result")
    return [f"cuda:{i}" for i in range(chips)]


def blocked_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in BLOCKED)


def device_record(devices: list) -> dict:
    import torch

    if devices[0].startswith("cuda"):
        peak = max(torch.cuda.max_memory_allocated(d) for d in devices)
        kind = torch.cuda.get_device_name(devices[0])
        platform = "gpu"
    else:
        peak, kind, platform = 0, "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": len(devices),
            "memory_peak_bytes": int(peak)}


def sync(devices: list) -> None:
    import torch

    for d in devices:
        if d.startswith("cuda"):
            torch.cuda.synchronize(d)


def measure(run: Run, driver) -> tuple:
    """The window: samples in a closed loop until ``run.seconds`` have
    passed; the last one started finishes.  Returns ``(records, wall_s,
    attempted, failed, trace)``."""
    import torch

    records, failed = [], 0
    holder: dict = {}
    ctx = contextlib.nullcontext()
    if run.trace:
        from portbench.trace import profiled

        ctx = profiled(os.path.join(run.tmp, "window.pt.trace.json"),
                       holder)
    with ctx, torch.profiler.record_function("bench/window"):
        sync(run.devices)
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < run.seconds:
            t1 = time.perf_counter()
            with torch.profiler.record_function("bench/sample"):
                try:
                    records.append(driver.step(run, i))
                    records[-1]["wall_s"] = time.perf_counter() - t1
                except Exception as e:   # counted, reported, not correct
                    failed += 1
                    run.log(f"sample {i} failed: {e!r}")
            i += 1
        sync(run.devices)
        wall = time.perf_counter() - t0
    return records, wall, i, failed, holder.get("events")


def observe(run: Run, records: list, events) -> dict:
    """What per-layer readers read: the samples' records, the run's state
    and, with a trace, its summary and events."""
    obs = {"records": records, "run": run, "events": events}
    if events is not None:
        from portbench import trace

        span = trace.window(events, "bench/window")
        obs["span"] = span
        obs["trace"] = trace.summary(events, span, len(run.devices))
    return obs


def execute(reg: Registry, cell: str, seed: int, seconds: float,
            trace: bool, devices: list, t_start: float,
            cache: str = CACHE) -> dict:
    """Set up, measure, judge; returns the result object."""
    driver = reg.module("drivers", reg.json(
        "traffic", reg.cell(cell)["traffic"])["driver"])
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        run = Run(reg, cell, seed, seconds, trace, devices, tmp, cache)
        driver.prepare(run)
        sync(devices)
        # less a one-time build a driver caches for the checkout (its log
        # line gives the seconds)
        setup_s = (time.perf_counter() - t_start
                   - run.state.get("setup_excluded_s", 0.0))
        records, wall, attempted, failed, events = measure(run, driver)
        run.log("window: %d samples in %.3f s; seconds per sample %s" % (
            len(records), wall,
            " ".join("%.3f" % r["wall_s"] for r in records)))
        dev = device_record(devices)
        if run.trace:
            obs = observe(run, records, events)
        gc.collect()
        checks = driver.judge(run, records)
        if run.trace:
            metrics = {}
            for m in reg.per_layer(cell):
                value = reg.module("metrics", m["name"]).read(obs)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            t = obs["trace"]
            dev.update(busy_s=sum(t["busy_s"]) / len(t["busy_s"]),
                       window_s=t["window_s"])
            breakdown = {"device_ops": t["device_ops"],
                         "idle_gaps": t["idle_gaps"]}
        else:
            values = driver.end_to_end(run, records, wall)
            values["setup_s"] = setup_s
            metrics = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in reg.end_to_end(cell)}
            breakdown = None
    bad = blocked_modules()
    if bad:
        raise JaxLoaded(f"JAX or the JAX package was loaded: {bad}")
    correct = failed == 0 and all(c.ok for c in checks)
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    return out
