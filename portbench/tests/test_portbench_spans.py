"""``portbench/spans.py`` and the readers of the program's spans, on a
synthetic ``obs``: ring entries of two identify samples (a warm-up one
before the profile, one inside the window) and the trace events a profile
of the window would hold, on a clock 5 s off the ring's."""

import collections

import pytest

from portbench import harness, spans

from conftest import CHECKOUT

Span = collections.namedtuple(
    "Span", "id parent sample name thread t0 t1 attrs")
OFF_US = 5e6          # the trace's clock minus the ring's
MS = 1_000_000        # ns
MAIN, PRODUCER = "MainThread", "strainscan-prefetch"


def identify_sample(first_id, sample, t, scale=1.0):
    """The spans of one identify sample starting at ``t`` ms on the
    ring's clock: 100 ms long, a main count (parse 10 ms, pack 5 ms, wait
    12 ms) and an L2 union count (parse 4 ms, pack 2 ms, wait 5 ms); at
    ``scale`` times those lengths (no two real samples take the same)."""
    i = iter(range(first_id, first_id + 100))

    def sp(parent, name, a, b, thread=MAIN, **attrs):
        return Span(next(i), parent, sample, name, thread,
                    (t + a * scale) * MS, (t + b * scale) * MS, attrs)

    root = sp(None, "identify/sample", 0, 100)
    cnt = sp(root.id, "identify/count", 1, 40)
    c1 = sp(cnt.id, "count/sample", 2, 39)
    vote = sp(root.id, "identify/l2_vote", 50, 90)
    union = sp(vote.id, "identify/l2_vote/union_count", 51, 70)
    c2 = sp(union.id, "count/sample", 52, 69)
    return [root, cnt, c1,
            sp(c1.id, "count/parse", 3, 13, PRODUCER),
            sp(c1.id, "count/pack", 13, 18, PRODUCER, pack="vlen/fused"),
            sp(c1.id, "count/wait", 4, 16),
            vote, union, c2,
            sp(c2.id, "count/parse", 53, 57, PRODUCER),
            sp(c2.id, "count/pack", 57, 59, PRODUCER, pack="vlen/fused"),
            sp(c2.id, "count/wait", 53, 58)]


def annotation(name, a_us, b_us):
    return {"ph": "X", "cat": "user_annotation", "name": name,
            "ts": a_us, "dur": b_us - a_us}


def kernel(a_us, b_us):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": a_us,
            "dur": b_us - a_us, "pid": 0}


@pytest.fixture
def obs():
    """Sample 1 warms up before the profile; sample 2 runs in the window
    (1,000-1,200 ms); the device is busy 30-35 ms into sample 2."""
    warm = identify_sample(1, 1, 0, scale=1.3)
    run = identify_sample(101, 2, 1050)
    events = [annotation("bench/window", 1000e3 + OFF_US, 1200e3 + OFF_US)]
    for s in run:
        if s.thread == MAIN:   # the profile sees the main thread only
            events.append(annotation(s.name, s.t0 / 1e3 + OFF_US + 3,
                                     s.t1 / 1e3 + OFF_US + 8))
    events.append(kernel(1080e3 + OFF_US, 1085e3 + OFF_US))
    phases = {"identify/l2_vote/union_count": 0.019,
              "identify/cst_search/match": 0.004,
              "identify/l2_vote": 0.04}
    return {"spans": warm + run, "events": events,
            "span": (1000e3 + OFF_US, 1200e3 + OFF_US),
            "records": [{"sample": 0, "phases": phases}]}


def test_the_ring_is_laid_on_the_trace_clock(obs):
    got = spans.offsets(obs)
    assert len(got) == 8                   # the window's main-thread spans
    assert spans.offset(obs) == pytest.approx(OFF_US + 3)
    assert max(got) - min(got) == pytest.approx(0.0, abs=1e-3)


def test_pairs_by_time_not_by_order(obs):
    """A sample whose spans close after the profile ended (in the ring,
    not in the trace) and jitter of a few hundred microseconds leave the
    offset and the window's sample as they were; pairing from the last
    would have shifted every pair by a sample."""
    late = identify_sample(201, 3, 1300, scale=0.8)
    jitter = [0.0, 400.0, -300.0, 250.0]
    events = []
    for k, e in enumerate(obs["events"]):
        if e["name"] != "bench/window" and e["cat"] == "user_annotation":
            e = dict(e, ts=e["ts"] + jitter[k % len(jitter)])
        events.append(e)
    obs = dict(obs, spans=obs["spans"] + late, events=events)
    got = spans.offsets(obs)
    assert len(got) == 8
    assert max(got) - min(got) <= 700.0
    assert abs(spans.offset(obs) - (OFF_US + 3)) <= 400.0
    assert spans.window_samples(obs) == {2}
    assert spans.per_sample(obs, "count/parse") == pytest.approx(0.014)


def test_the_window_holds_the_sample_inside_it(obs):
    assert spans.window_samples(obs) == {2}
    # both counts of the sample, summed; the warm-up sample left out
    assert spans.per_sample(obs, "count/parse") == pytest.approx(0.014)
    assert spans.per_sample(obs, "count/pack") == pytest.approx(0.007)
    assert spans.per_sample(obs, "count/wait") == pytest.approx(0.017)
    assert spans.per_sample(obs, "count/nothing") is None
    del obs["span"]
    assert spans.per_sample(obs, "count/parse") is None


def test_a_program_without_spans_gives_nothing(obs):
    assert spans.per_sample(dict(obs, spans=None), "count/parse") is None
    assert spans.per_sample(dict(obs, events=[]), "count/parse") is None
    assert spans.idle_by_span(dict(obs, spans=None)) == []


def test_idle_by_span_splits_the_idle_window(obs):
    """The window's 200 ms less the kernel's 5 ms (30-35 ms into the
    sample, inside the main count's ``count/sample``), by the innermost
    main-thread span and the producer's span at each moment."""
    ms = 1e-3
    want = {("outside", "-"): 100 * ms,           # before and after
            ("identify/sample", "-"): 21 * ms,    # 0-1, 40-50, 90-100
            ("identify/count", "-"): 2 * ms,      # 1-2, 39-40
            ("count/sample", "-"): 28 * ms,       # 2-3, 18-39 less 5;
                                                  # 52-53, 59-69
            ("count/sample", "count/parse"): 1 * ms,   # 3-4
            ("count/sample", "count/pack"): 3 * ms,    # 16-18, 58-59
            ("count/wait", "count/parse"): 13 * ms,    # 4-13, 53-57
            ("count/wait", "count/pack"): 4 * ms,      # 13-16, 57-58
            ("identify/l2_vote", "-"): 21 * ms,        # 50-51, 70-90
            ("identify/l2_vote/union_count", "-"): 2 * ms}  # 51-52, 69-70
    rows = spans.idle_by_span(obs)
    got = {(m, p): v for m, p, v in rows if v > 1e-5}
    assert got == {k: pytest.approx(v, abs=1e-5) for k, v in want.items()}
    assert [r[2] for r in rows] == sorted((r[2] for r in rows),
                                          reverse=True)


def test_the_readers_read_spans_and_phases(obs):
    reg = harness.Registry(f"{CHECKOUT}/BENCHMARK.json")
    want = {"producer_parse_s.identify": 0.014,
            "producer_parse_s.count": 0.014,
            "producer_pack_s.identify": 0.007,
            "producer_pack_s.count": 0.007,
            "count_wait_s.identify": 0.017,
            "count_wait_s.count": 0.017,
            "union_count_s": 0.019,
            "cst_match_s": 0.004}
    for name, value in want.items():
        read = reg.module("metrics", name).read
        assert read(obs) == pytest.approx(value), name
        assert read({"records": [], "events": None, "spans": None}) is None
