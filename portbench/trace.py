"""The traced window: ``torch.profiler`` over the measured samples, and the
arithmetic that turns its Chrome trace into per-device busy time, the top
device operations and the longest idle gaps.

``merge_intervals`` is a copy of ``strainscan_tpu_torch/bench/
scale_parity.py``'s; the per-device split follows ``bench/
mesh_scaling.py::device_shares`` (a device event names its GPU in
``args.device``, else in ``pid``).  A gap is named by the innermost range
of the harness's own (``record_function`` around each sample and around
each call into the program) that holds its middle.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def merge_intervals(spans) -> list:
    out: list = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@contextlib.contextmanager
def profiled(path: str, holder: dict):
    """Profile the body (host ranges and CUDA activity); write its Chrome
    trace to ``path`` and put its events in ``holder["events"]``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield
    prof.export_chrome_trace(path)
    holder["events"] = load_events(path)
    os.remove(path)


def load_events(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _xs(events: list) -> list:
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def device_events(events: list) -> Dict[str, list]:
    """Device events by GPU."""
    per: Dict[str, list] = {}
    for e in _xs(events):
        if e.get("cat") in DEVICE_CATS:
            gpu = e.get("args", {}).get("device", e.get("pid"))
            per.setdefault(str(gpu), []).append(e)
    return per


def window(events: list, name: str) -> Optional[tuple]:
    """(start, end) in microseconds of the harness range ``name``."""
    for e in _xs(events):
        if e.get("cat") == "user_annotation" and e["name"] == name:
            return e["ts"], e["ts"] + e["dur"]
    return None


def busy_us(evs: list, span: tuple) -> float:
    t0, t1 = span
    merged = merge_intervals((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                             for e in evs
                             if e["ts"] < t1 and e["ts"] + e["dur"] > t0)
    return sum(e - s for s, e in merged)


def summary(events: list, span: tuple, n_devices: int) -> dict:
    """Busy seconds per device over ``span`` (devices with no event count
    as idle), the top device operations and the longest idle gaps of the
    devices' merged activity."""
    per = device_events(events)
    busy = {g: busy_us(evs, span) / 1e6 for g, evs in per.items()}
    busy_all = sorted(busy.values(), reverse=True)[:n_devices]
    busy_all += [0.0] * (n_devices - len(busy_all))
    ops: Dict[str, float] = {}
    for evs in per.values():
        for e in evs:
            if e["ts"] < span[1] and e["ts"] + e["dur"] > span[0]:
                ops[e["name"][:100]] = ops.get(e["name"][:100], 0.0) + \
                    e["dur"] / 1e6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_all, "window_s": (span[1] - span[0]) / 1e6,
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": idle_gaps(events, per, span)}


def idle_gaps(events: list, per: Dict[str, list], span: tuple) -> list:
    """The longest stretches of ``span`` with no device operation on any
    device, each named by the innermost harness range holding its middle."""
    t0, t1 = span
    merged = merge_intervals(
        (max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
        for evs in per.values() for e in evs
        if e["ts"] < t1 and e["ts"] + e["dur"] > t0)
    edges = [t0] + [t for s, e in merged for t in (s, e)] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    ranges = [e for e in _xs(events) if e.get("cat") == "user_annotation"
              and e["name"].startswith("bench/")]
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = (s + e) / 2
        holders = [r for r in ranges if r["ts"] <= mid < r["ts"] + r["dur"]]
        name = min(holders, key=lambda r: r["dur"])["name"] if holders \
            else "outside"
        out.append([name, (e - s) / 1e6])
    return out


def kernel_seconds(events: list, names, span: tuple) -> float:
    """Σ seconds of the kernels whose name holds one of ``names``."""
    total = 0.0
    for evs in device_events(events).values():
        for e in evs:
            if (e.get("cat") == "kernel" and e["ts"] < span[1]
                    and e["ts"] + e["dur"] > span[0]
                    and any(n in e["name"] for n in names)):
                total += e["dur"] / 1e6
    return total
