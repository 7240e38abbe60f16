"""The program's own spans (``strainscan_tpu_torch.timing.SPANS``, the
ring every span of the program enters on closing) laid over the harness's
``torch.profiler`` trace of the window.

* **The clock.**  The ring times on ``time.perf_counter_ns()``, the trace
  on the profiler's clock.  A span of the main thread opened while the
  profile ran is also a range of its own name in the trace (``cpu_op``,
  the profiler's C++ record function; ``user_annotation`` where the
  program's torch lacks it).
  A first offset, taken between ranges and ring spans of the rarest such
  name (seen twice or more in the trace), is the one that pairs the most
  ring spans with ranges of their name; each
  main-thread ring span then pairs with the range of its name that starts
  nearest it on that clock, within ``PAIR_US``, and the offset is the
  median of the trace's start minus the ring's over every pair
  (:func:`offsets`, :func:`offset`).  Pairing by time, not by order,
  leaves out spans outside the profile at either end.
* **The window's samples.**  The top-level roots (``identify/sample``,
  ``count/sample`` with no parent) whose start, on the trace's clock, lies
  inside ``bench/window``; each names its sample id, which every span under
  it carries, the producer thread's too (:func:`window_samples`).
* **Per sample.**  :func:`per_sample` is the mean over the window's samples
  of the seconds of one span name summed per sample; None where it finds
  no roots or no such span (a program without the ring, or without that
  span).
* **Idle by span.**  :func:`idle_by_span` splits the window's device-idle
  time by the innermost main-thread span that holds it and by what the
  producer thread was in (``count/parse``, ``count/pack`` or nothing).

``python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>``
makes one traced run of the cell (as ``portbench.run --trace 1``, the
per-layer metrics in its result line) and prints its result line, then one
JSON object: the alignment's offsets (count and spread), the window's
samples, the ring spans of those samples found outside the window, the
payload paths of the packs, whether the spans nest as the layers do and
the idle table.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional

MAIN = "MainThread"
ROOTS = ("identify/sample", "count/sample")
RANGE_CATS = ("cpu_op", "user_annotation")
# a ring span and a trace range pair only if their starts, on the first
# offset's clock, lie this close (microseconds); the pairs found on the
# card spread by under 1 ms
PAIR_US = 5000.0


def ring(obs: dict) -> Optional[list]:
    """The program's closed spans: ``obs["spans"]`` where given, else a
    copy of the program's ring; None where the program has none."""
    if "spans" in obs:
        return obs["spans"]
    try:
        from strainscan_tpu_torch import timing
    except ImportError:
        return None
    spans = getattr(timing, "SPANS", None)
    return None if spans is None else list(spans)


def _ranges(events: list) -> Dict[str, list]:
    """The trace's range starts by name, sorted."""
    out: Dict[str, list] = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in RANGE_CATS
                and "dur" in e):
            out.setdefault(e["name"], []).append(e["ts"])
    for ts in out.values():
        ts.sort()
    return out


def _nearest(ts: list, t: float) -> float:
    """The element of the sorted, non-empty ``ts`` nearest ``t``."""
    i = bisect.bisect_left(ts, t)
    return min(ts[max(i - 1, 0):i + 1], key=lambda x: abs(x - t))


def _paired(ann: Dict[str, list], mine: Dict[str, list],
            off: float) -> int:
    """How many of the ring starts ``mine`` (by name) have a trace start
    of their name within ``PAIR_US`` at offset ``off``."""
    return sum(abs(_nearest(ann[n], r + off) - r - off) <= PAIR_US
               for n, starts in mine.items() for r in starts)


def offsets(obs: dict) -> List[float]:
    """Trace start minus ring start, in microseconds, of every main-thread
    ring span paired with the trace range of its name that starts nearest
    it (within ``PAIR_US``) on the clock of the first offset: of the
    offsets between the rarest name's first, middle and last range and its
    ring spans, the one that pairs the most ring spans of every name."""
    spans, events = ring(obs), obs.get("events")
    if not spans or events is None:
        return []
    ann = _ranges(events)
    mine: Dict[str, list] = {}
    for s in spans:
        if s.thread == MAIN and s.name in ann:
            mine.setdefault(s.name, []).append(s.t0 / 1e3)
    if not mine:
        return []
    name = min(mine, key=lambda n: (len(ann[n]) < 2, len(ann[n])))
    ts = ann[name]
    first = max((t - r for t in (ts[0], ts[len(ts) // 2], ts[-1])
                 for r in mine[name]),
                key=lambda off: _paired(ann, mine, off))
    out: List[float] = []
    for n, starts in mine.items():
        for r in starts:
            t = _nearest(ann[n], r + first)
            if abs(t - r - first) <= PAIR_US:
                out.append(t - r)
    return out


def offset(obs: dict) -> Optional[float]:
    """The median of :func:`offsets` (microseconds), None with no pair."""
    got = offsets(obs)
    return statistics.median(got) if got else None


def window_samples(obs: dict) -> set:
    """Sample ids of the roots that start inside ``bench/window``."""
    spans, off, win = ring(obs), offset(obs), obs.get("span")
    if not spans or off is None or win is None:
        return set()
    return {s.sample for s in spans
            if s.parent is None and s.name in ROOTS
            and win[0] <= s.t0 / 1e3 + off <= win[1]}


def per_sample(obs: dict, name: str) -> Optional[float]:
    """Seconds of the spans ``name`` summed per window sample, averaged
    over the window's samples; None with no sample or no such span."""
    samples = window_samples(obs)
    if not samples:
        return None
    sums = dict.fromkeys(samples, 0.0)
    found = False
    for s in ring(obs):
        if s.name == name and s.sample in sums:
            sums[s.sample] += (s.t1 - s.t0) / 1e9
            found = True
    return sum(sums.values()) / len(sums) if found else None


def idle_by_span(obs: dict) -> List[list]:
    """``[main-thread span, producer span, seconds]`` rows, the largest
    first: the window's time with no device operation on any device,
    split by the innermost main-thread span open (``outside`` where none
    is) and the producer's span open (``-`` where none is)."""
    from portbench import trace

    spans, off, win = ring(obs), offset(obs), obs.get("span")
    events = obs.get("events")
    if not spans or off is None or win is None or events is None:
        return []
    t0, t1 = win
    busy = trace.merge_intervals(
        (max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
        for evs in trace.device_events(events).values() for e in evs
        if e["ts"] < t1 and e["ts"] + e["dur"] > t0)
    edges = [t0] + [t for s, e in busy for t in (s, e)] + [t1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    marks = []   # (time, +1 open / -1 close, kind, key)
    for i, (a, b) in enumerate(idle):
        marks += [(a, 1, "idle", i), (b, -1, "idle", i)]
    for i, s in enumerate(spans):
        a, b = s.t0 / 1e3 + off, s.t1 / 1e3 + off
        if b <= t0 or a >= t1:
            continue
        kind = "main" if s.thread == MAIN else "producer"
        marks += [(max(a, t0), 1, kind, i), (min(b, t1), -1, kind, i)]
    marks.sort(key=lambda m: (m[0], m[1]))
    # open items by kind, each span by its start: the innermost of one
    # thread's nested spans is the latest started
    open_: Dict[str, dict] = {"idle": {}, "main": {}, "producer": {}}
    acc: Dict[tuple, float] = {}
    prev = t0
    for t, d, kind, i in marks:
        if t > prev and open_["idle"]:
            m, p = open_["main"], open_["producer"]
            where = (spans[max(m, key=m.get)].name if m else "outside",
                     spans[max(p, key=p.get)].name if p else "-")
            acc[where] = acc.get(where, 0.0) + (t - prev) / 1e6
        prev = max(prev, t)
        if d < 0:
            open_[kind].pop(i, None)
        else:
            open_[kind][i] = t if kind == "idle" else spans[i].t0
    return [[m, p, s] for (m, p), s in
            sorted(acc.items(), key=lambda kv: -kv[1])]


def report(obs: dict) -> dict:
    """What ``main`` prints of a traced run's ``obs`` beside its result
    line: the offsets' count and spread (whole, and 5th to 95th
    percentile), the window's samples, their ring spans that lie outside
    the window, the payload paths of the packs, whether the spans nest as
    the layers do in every sample, and the idle table."""
    spans, off, win = ring(obs) or [], offset(obs), obs.get("span")
    got = sorted(offsets(obs))
    samples = window_samples(obs)
    mine = [s for s in spans if s.sample in samples]
    outside = [s.name for s in mine
               if not (win[0] <= s.t0 / 1e3 + off
                       and s.t1 / 1e3 + off <= win[1])]
    paths: Dict[str, int] = {}
    waits: Dict[int, float] = {}
    counts: Dict[int, float] = {}
    for s in mine:
        if s.name == "count/pack":
            paths[s.attrs.get("pack")] = paths.get(s.attrs.get("pack"), 0) + 1
        for name, acc in (("count/wait", waits), ("count/sample", counts)):
            if s.name == name:
                acc[s.sample] = acc.get(s.sample, 0) + s.t1 - s.t0
    ph = [r.get("phases", {}) for r in obs["records"]]
    nest = {"union_count_in_l2_vote": all(
                p["identify/l2_vote/union_count"] <= p["identify/l2_vote"]
                for p in ph if "identify/l2_vote/union_count" in p),
            "match_in_cst_search": all(
                p["identify/cst_search/match"] <= p["identify/cst_search"]
                for p in ph if "identify/cst_search/match" in p),
            "waits_in_counts": all(w <= counts.get(k, 0)
                                   for k, w in waits.items())}
    q = statistics.quantiles(got, n=20) if len(got) > 1 else None
    return {"offsets": {"n": len(got),
                        "spread_us": got[-1] - got[0] if got else None,
                        "p5_p95_us": q[-1] - q[0] if q else None},
            "window_samples": len(samples), "ring_spans": len(spans),
            "outside_window": outside[:20], "n_outside_window": len(outside),
            "pack_paths": paths, "nest": nest,
            "idle_by_span": idle_by_span(obs)[:20]}


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import time

    t_start = time.perf_counter()
    import portbench.run  # noqa: F401  (sets the build caches' paths)
    from portbench import harness

    ap = argparse.ArgumentParser(description="one traced run of a cell "
                                 "and its program spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    reg = harness.Registry(os.path.join(os.getcwd(), "BENCHMARK.json"))
    devices = harness.cuda_devices(reg.cell(args.workload)["chips"])
    kept: dict = {}
    observe = harness.observe

    def keep(*a):
        kept["obs"] = observe(*a)
        return kept["obs"]

    harness.observe = keep
    try:
        out = harness.execute(reg, args.workload, args.seed, args.seconds,
                              True, devices, t_start)
    finally:
        harness.observe = observe
    print(json.dumps(out), flush=True)
    print(json.dumps(report(kept["obs"])), flush=True)
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
