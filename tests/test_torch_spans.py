"""The port's spans (``timing.span``, the ring ``timing.SPANS``), on the
CPU, on the e2e fixture, read in several batches a sample:

* one ``run_identify`` writes one root, ``identify/sample``, and every
  span it wrote carries that root's sample id; the ring holds the phases
  and the count's spans only, nested as the layers are, with the
  attributes a reader reads (the pack's payload path, each count's source,
  the union count's kept bytes); the union count reads the main count's
  kept payloads, so only the main count parses and packs;
* the producer's parse and pack spans run in the producer thread, each
  with a ``count/sample`` parent; the waits in the main thread;
* under a ``torch.profiler`` profile every main-thread span is a range
  of its name (``cpu_op``, the profiler's C++ record function, or
  ``user_annotation`` where torch lacks it), all at one offset from the
  ring's clock (within 1 ms), and the reports equal an unprofiled run's;
* with no profiler running no trace range is opened, and the ring stays
  at its bound after more spans than it holds;
* ``STRAINSCAN_TRACE_DIR`` under an outer profile only times; the
  per-phase trace carries the producer's spans where torch can profile
  every thread;
* each build's ``tree_build/*`` seconds are its own, also where every
  cluster merges into one and the build starts again.
"""

import json
import statistics
import sys
import threading
import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from strainscan_tpu_torch import timing
from strainscan_tpu_torch.build import tree_build
from strainscan_tpu_torch.config import BuildConfig, IdentifyConfig
from strainscan_tpu_torch.identify.pipeline import run_identify

from _torch_sim import (assert_reports_identical, e2e_fixture,  # noqa: F401
                        mutate, one_torch_thread, rand_genome, write_fa)

CFG = IdentifyConfig(read_batch=256)   # several batches a sample
MAIN, PRODUCER = "MainThread", "strainscan-prefetch"
RANGE_CATS = ("cpu_op", "user_annotation")
RING_NAMES = {"identify/sample", "identify/load_db", "identify/count",
              "count/sample", "count/parse", "count/pack", "count/wait",
              "identify/cst_search", "identify/l2_vote",
              "identify/l2_vote/union_count", "identify/l2_vote/prescan",
              "identify/l2_vote/prescan/dominant", "identify/l2_vote/enet"}


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_spans")
    return (d, *e2e_fixture(d))


def identify(fixture, out, sample="intra"):
    """``run_identify`` of one sample (the intra-cluster one reaches the
    Enet vote); returns its result and the ring spans it wrote."""
    _, db_dir, paths = fixture
    t0 = time.perf_counter_ns()
    res = run_identify(paths[sample], "", db_dir, str(out), "cpu", CFG)
    assert res
    return res, [s for s in timing.SPANS if s.t0 >= t0]


@pytest.fixture(scope="module")
def plain(fixture):
    d = fixture[0]
    timing.PHASE_TIMES.clear()
    _, spans = identify(fixture, d / "plain")
    return spans, dict(timing.PHASE_TIMES)


@pytest.fixture(scope="module")
def profiled(fixture):
    """A run under a CPU profile, inside a range of the profile's own as
    the benchmark's window is (the profile's first range pays a one-time
    start-up): its spans, the trace's events."""
    d = fixture[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            record_function("test/window"):
        _, spans = identify(fixture, d / "profiled")
    path = d / "profiled.pt.trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return spans, json.load(f)["traceEvents"]


def test_one_identify_writes_one_sample_root(plain):
    spans, phases = plain
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["identify/sample"]
    assert {s.sample for s in spans} == {roots[0].sample}
    assert {s.name for s in spans} == RING_NAMES
    by_id = {s.id: s for s in spans}
    for s in spans:        # inside its parent, on the parent's clock
        if s.parent is not None:
            up = by_id[s.parent]
            assert up.t0 <= s.t0 <= s.t1 <= up.t1, (s.name, up.name)
    # the two counts: the main one and the L2 union's
    counts = sorted((s for s in spans if s.name == "count/sample"),
                    key=lambda s: s.t0)
    assert [by_id[c.parent].name for c in counts] == [
        "identify/count", "identify/l2_vote/union_count"]
    (union,) = [s for s in spans if s.name == "identify/l2_vote/union_count"]
    assert by_id[union.parent].name == "identify/l2_vote"
    assert counts[0].attrs == {"source": "stream"}
    assert counts[1].attrs["source"] == "kept"
    assert counts[1].attrs["kept_bytes"] > 0
    for c, streamed in zip(counts, (True, False)):
        # a parse per batch and the one that ends the file; the union
        # count reads the kept payloads: no parse, pack or wait
        parses, packs, waits = ([s for s in spans if s.name == name
                                 and s.parent == c.id] for name in (
                                     "count/parse", "count/pack",
                                     "count/wait"))
        if streamed:
            assert len(parses) == len(packs) + 1 == len(waits) >= 3
        else:
            assert parses == packs == waits == []
    attrs = {"count/pack": {"pack"}, "count/sample": {"source"}}
    for s in spans:
        if s is not counts[1]:
            assert set(s.attrs) == attrs.get(s.name, set()), s.name
    assert set(counts[1].attrs) == {"source", "kept_bytes"}
    assert {s.attrs["pack"] for s in spans if s.name == "count/pack"} <= {
        "vlen/fused", "vbytes/fused", "vlen/prefix", "vbytes", "codes"}
    # the Pre-Scan, its dominant search and the Enet, once per voted
    # cluster (one here) inside the L2 vote
    up = {s.name: by_id[s.parent].name for s in spans if s.name in (
        "identify/l2_vote/prescan", "identify/l2_vote/prescan/dominant",
        "identify/l2_vote/enet")}
    assert up == {"identify/l2_vote/prescan": "identify/l2_vote",
                  "identify/l2_vote/prescan/dominant":
                  "identify/l2_vote/prescan",
                  "identify/l2_vote/enet": "identify/l2_vote"}
    # the phase seconds are the spans' own; the match only accumulates
    assert phases["identify/l2_vote/union_count"] == union.seconds
    for name in up:
        (one,) = [s for s in spans if s.name == name]
        assert phases[name] == one.seconds
    assert 0 < phases["identify/cst_search/match"] \
        <= phases["identify/cst_search"]


def test_producer_spans_run_in_the_producer_thread(plain):
    spans, _ = plain
    by_id = {s.id: s for s in spans}
    producer = [s for s in spans if s.name in ("count/parse", "count/pack")]
    assert len(producer) >= 4
    for s in producer:
        assert s.thread == PRODUCER
        assert by_id[s.parent].name == "count/sample"
    waits = [s for s in spans if s.name == "count/wait"]
    assert waits and all(s.thread == MAIN and by_id[s.parent].name ==
                         "count/sample" for s in waits)
    assert all(s.thread == MAIN for s in spans if s not in producer)


def test_main_thread_spans_are_trace_ranges_at_one_offset(profiled):
    spans, events = profiled
    ann = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in RANGE_CATS:
            ann.setdefault(e["name"], []).append(e)
    offsets = []
    main = [s for s in spans if s.thread == MAIN]
    for name in {s.name for s in main}:
        mine = sorted((s for s in main if s.name == name),
                      key=lambda s: s.t0)
        theirs = sorted(ann.get(name, []), key=lambda e: e["ts"])
        assert len(theirs) == len(mine), name
        offsets += [e["ts"] - s.t0 / 1e3 for s, e in zip(mine, theirs)]
    mid = statistics.median(offsets)
    assert max(abs(o - mid) for o in offsets) <= 1e3   # microseconds


def test_reports_equal_with_and_without_a_profiler(fixture, plain,
                                                   profiled):
    d = fixture[0]
    assert_reports_identical(str(d / "profiled"), str(d / "plain"))


def test_no_record_function_without_a_profiler(fixture, tmp_path,
                                               monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    monkeypatch.setattr(timing, "_trace_range", Counting)
    _, spans = identify(fixture, tmp_path / "out", "single")
    assert spans and entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("x/profiled"):
            pass
    assert entered == ["x/profiled"]


def test_the_ring_stays_at_its_bound():
    bound = timing.SPANS.maxlen
    with timing.span("x/first") as first:
        pass
    for _ in range(bound + 100):
        with timing.span("x/fill"):
            pass
    assert len(timing.SPANS) == bound
    ids = [s.id for s in timing.SPANS]
    assert ids == sorted(ids) and ids[0] == first.id + 101
    # a root takes a new sample id each time, a child its parent's
    with timing.span("x/a") as a, timing.span("x/b") as b:
        pass
    assert b.parent == a.id and b.sample == a.sample
    assert a.sample == timing.SPANS[-3].sample + 1


def test_trace_dir_under_an_outer_profile_only_times(tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv(timing.TRACE_ENV, str(tmp_path / "trace"))
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.phase("x/outer"):
            with timing.phase("x/inner"):
                sum(range(1000))
    assert not (tmp_path / "trace").exists()
    assert timing.PHASE_TIMES["x/outer"] >= timing.PHASE_TIMES["x/inner"]
    with timing.phase("x/alone"):     # no outer profile: traced
        pass
    assert (tmp_path / "trace" / "x" / "alone.pt.trace.json").exists()


def test_the_count_phase_trace_carries_the_producer(fixture, tmp_path,
                                                    monkeypatch):
    if timing._all_threads() is None:
        pytest.skip("this torch cannot profile every thread")
    monkeypatch.setenv(timing.TRACE_ENV, str(tmp_path / "trace"))
    identify(fixture, tmp_path / "out", "single")
    path = tmp_path / "trace" / "identify" / "count.pt.trace.json"
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") in RANGE_CATS}
    assert {"count/sample", "count/wait", "count/parse",
            "count/pack"} <= names


def test_spans_from_many_threads_keep_their_own_parents():
    """Threads open spans at once under a short switch interval: every id
    is taken once, and each span's parent and sample are its own thread's
    root's (the context is per thread)."""
    per, n_threads = 500, 16
    roots = {}

    def work(k):
        with timing.span("x/thread") as root:
            roots[k] = root
            for _ in range(per):
                with timing.span("x/child"):
                    pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter_ns()
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    got = [s for s in timing.SPANS if s.t0 >= t0 and s.name.startswith("x/")]
    assert len(got) == n_threads * (per + 1)
    assert len({s.id for s in got}) == len(got)
    by_root = {r.id: r for r in roots.values()}
    assert len({r.sample for r in roots.values()}) == n_threads
    for s in got:
        if s.name == "x/child":
            root = by_root[s.parent]
            assert s.sample == root.sample and s.thread == root.thread


def test_build_phases_are_each_builds_own(tmp_path):
    """``tree_build/*`` (``phase_acc``) keep this build's seconds, not a
    sum with the last build's; where every leaf is weak, all merge into
    one cluster and the build starts again as one leaf, which times none
    of them."""
    rng = np.random.default_rng(3)
    base = rand_genome(rng, 20_000)
    seqs = {"A1": base, "A2": mutate(rng, base, 40),
            "B1": rand_genome(rng, 20_000)}
    genome_of = {}
    for name, seq in seqs.items():
        genome_of[name] = str(tmp_path / f"{name}.fa")
        write_fa(genome_of[name], name, seq)
    names = list(seqs)
    dist = np.array([[0.0, 0.01, 0.9], [0.01, 0.0, 0.9], [0.9, 0.9, 0.0]])
    recls = {1: ["A1"], 2: ["A2"], 3: ["B1"]}
    stale = dict.fromkeys(tree_build.ACC_PHASES, 1e6)

    timing.PHASE_TIMES.update(stale)
    cst = tree_build.build_cst(names, dist, recls, genome_of,
                               BuildConfig(min_kmer=1, max_kmer=30000))
    assert len(cst.tree.leaves()) == 3
    assert all(0 <= timing.PHASE_TIMES[n] < 1e3
               for n in tree_build.ACC_PHASES)

    timing.PHASE_TIMES.update(stale)
    cst = tree_build.build_cst(names, dist, recls, genome_of,
                               BuildConfig(min_kmer=10**9, max_kmer=30000))
    assert cst.tree.leaves() == [cst.tree.root]
    assert sorted(cst.recls[cst.tree.root]) == names
    assert not set(tree_build.ACC_PHASES) & set(timing.PHASE_TIMES)
