"""The harness: files found by name, the trace arithmetic, the card and
JAX checks, and faults in the timed path that ``correct`` must catch."""

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import harness, peaks, roofline, trace
from portbench.reference import fptable

from conftest import CHECKOUT, PACKAGE


def run_cell(tiny, cell, seconds=1.0, trace_on=False, devices=("cpu",)):
    reg, cache = tiny
    return harness.execute(reg, cell, 2**31 + 99, seconds, trace_on,
                           list(devices), time.perf_counter(), cache)


def tree_digest(top):
    h = hashlib.sha256()
    for root, dirs, names in os.walk(top):
        dirs[:] = sorted(d for d in dirs if d not in ("cache", "__pycache__"))
        for n in sorted(names):
            with open(os.path.join(root, n), "rb") as f:
                h.update(n.encode() + f.read())
    return h.hexdigest()


def test_new_config_mix_and_metric_are_found_by_name(tiny, tmp_path):
    """A cell added from new files alone: a configuration, a traffic mix
    and a per-layer metric under a new root, named in BENCHMARK.json."""
    reg, cache = tiny
    before = tree_digest(PACKAGE)
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    cfg = reg.json("configs", "tiny-table")
    cfg["genome_len"] = 8000
    (tmp_path / "configs" / "other-table.json").write_text(json.dumps(cfg))
    mix = reg.json("traffic", "tiny-count")
    mix.update(reads=700, distinct=3)
    (tmp_path / "traffic" / "other-mix.json").write_text(json.dumps(mix))
    (tmp_path / "metrics" / "reads_per_sample.other.py").write_text(
        "def read(obs):\n"
        "    r = obs['records']\n"
        "    return sum(x['reads'] for x in r) / len(r) if r else None\n")
    bench = dict(reg.bench)
    bench["workloads"] = reg.bench["workloads"] + [
        {"name": "other", "config": "other-table", "traffic": "other-mix",
         "chips": 1, "why": "test"}]
    bench["per_layer"] = reg.bench["per_layer"] + [
        {"name": "reads_per_sample.other", "unit": "reads",
         "better": "higher", "source": "program_counter", "layer": "count",
         "moves": "count_reads_per_s", "workloads": ["other"]}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("count_reads_per_s", "device_idle_pct.count"):
            m["workloads"] = m["workloads"] + ["other"]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    reg2 = harness.Registry(str(path), [str(tmp_path)] + reg.roots[:-1])
    assert [m["name"] for m in reg2.per_layer("other")] == [
        "device_idle_pct.count", "reads_per_sample.other"]
    out = harness.execute(reg2, "other", 5, 1.0, True, ["cpu"],
                          time.perf_counter(), cache)
    assert out["correct"], out
    assert out["metrics"]["reads_per_sample.other"]["value"] == 700
    assert set(out["metrics"]) == {"device_idle_pct.count",
                                   "reads_per_sample.other"}
    out = harness.execute(reg2, "other", 5, 1.0, False, ["cpu"],
                          time.perf_counter(), cache)
    assert set(out["metrics"]) == {"setup_s", "count_reads_per_s"}
    assert list(out)[-1] == "checks"
    assert tree_digest(PACKAGE) == before


def test_trace_arithmetic_on_synthetic_events():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench/window",
         "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "bench/sample",
         "ts": 0, "dur": 600},
        {"ph": "X", "cat": "user_annotation", "name": "bench/sample",
         "ts": 600, "dur": 400},
        {"ph": "X", "cat": "kernel", "name": "fp_bin_probe_kernel",
         "ts": 100, "dur": 100, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "fp_coarse_count_kernel",
         "ts": 150, "dur": 100, "args": {"device": 0}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 700, "dur": 50, "args": {"device": 1}},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 2000,
         "dur": 10, "args": {"device": 0}}]
    span = trace.window(ev, "bench/window")
    assert span == (0, 1000)
    s = trace.summary(ev, span, 2)
    assert s["busy_s"] == [150e-6, 50e-6]
    assert s["window_s"] == 1e-3
    assert s["idle_gaps"][0] == ["bench/sample", 450e-6]   # 250 to 700
    assert [g[1] for g in s["idle_gaps"]] == [450e-6, 250e-6, 100e-6]
    assert s["device_ops"][0] == ["fp_bin_probe_kernel", 100e-6]
    assert trace.kernel_seconds(ev, ("fp_",), span) == 200e-6
    assert trace.merge_intervals([(3, 4), (1, 2), (2, 3)]) == [[1, 4]]


def test_roofline_counts_a_batch():
    keys = torch.tensor([5, 6, 7], dtype=torch.int64)
    t = fptable.build(keys)
    codes = np.zeros((2, 40), np.uint8)
    wk, valid = fptable.window_keys(torch.from_numpy(codes), 31)
    p = fptable.probe(t, wk[valid])
    n_bytes, n_ops = roofline.batch_work(codes, 256, t.bucket, p)
    # 20 windows of key 0, which misses: one row, no sector
    assert n_bytes == 2 * 16 * 4 + 2 * 2 + 1 * 64 * 4 + 0 + 8
    assert n_ops == 20 * roofline.HASH_OPS + 64 * 20
    assert peaks.least_s(3.35e12) == 1.0
    assert peaks.least_s(0, 67e12 * 2) == 2.0


def test_the_harness_never_loads_jax_nor_reads_benchmarks(tmp_path):
    """Under an import block of ``jax`` and ``strainscan_tpu`` (whole
    top-level names; the port's own name begins with the latter), every
    module of the harness imports and a tiny cell runs, and no file under
    ``benchmarks/`` is opened."""
    code = f"""
import builtins, importlib, io, os, sys, time
sys.path.insert(0, {CHECKOUT!r})
sys.path.insert(0, {os.path.dirname(__file__)!r})
BLOCK = ("jax", "jaxlib", "flax", "strainscan_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
opened = []
real_open, real_io_open = builtins.open, io.open
def spy(f, *a, **k):
    opened.append(os.path.abspath(str(f)) if isinstance(f, (str, bytes, os.PathLike)) else f)
    return real_open(f, *a, **k)
builtins.open = io.open = spy
from portbench import harness, control, run
for m in ("synth", "trace", "peaks", "roofline", "reference.fptable",
          "reference.cst", "reference.l2vote", "reference.treedb"):
    importlib.import_module("portbench." + m)
from conftest import write_tiny
reg = harness.Registry(write_tiny({str(tmp_path)!r}), [{str(tmp_path)!r}])
for cell in ("tiny-count", "tiny-small"):
    out = harness.execute(reg, cell, 3, 0.5, False, ["cpu"], time.perf_counter(), {str(tmp_path / "cache")!r})
    assert out["correct"], out
for name in ("count", "identify"):
    reg.module("drivers", name)
assert not harness.blocked_modules(), harness.blocked_modules()
bad = [p for p in opened if isinstance(p, str) and os.sep + "benchmarks" + os.sep in p]
assert not bad, bad
print("clean")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr[-3000:]


def test_blocked_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "strainscan_tpu_torch_x", sys)
    assert "strainscan_tpu_torch_x" not in harness.blocked_modules()
    monkeypatch.setitem(sys.modules, "strainscan_tpu.ops", sys)
    assert harness.blocked_modules() == ["strainscan_tpu.ops"]


def test_without_a_card_the_run_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    r = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "count-ecoli",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=CHECKOUT,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 3
    assert r.stdout == ""
    with pytest.raises(harness.NoCard):
        harness.cuda_devices(1)


def test_outside_a_checkout_of_the_program_the_run_fails(tmp_path):
    import shutil

    shutil.copy(os.path.join(CHECKOUT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PACKAGE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    r = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "count-ecoli",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""


# ------------------------------------------------------------ faults
def _zeros(real):
    def f(*a, **k):
        return np.zeros_like(real(*a, **k))
    return f


def _altered(real):
    # one count one lower: a count one higher is what a stray makes, within
    # the count cell's allowance
    def f(*a, **k):
        out = real(*a, **k)
        out[int(np.argmax(out))] -= 1
        return out
    return f


def _half_batches(real):
    def f(*a, **k):
        for b in real(*a, **k):
            yield b[: b.shape[0] // 2]
    return f


FAULTS = {
    "state_unchanged": ("strainscan_tpu_torch.identify.count",
                        "count_sample", _zeros),
    "half_batch": ("strainscan_tpu_torch.io.fastx", "read_batches",
                   _half_batches),
    "answer_altered": ("strainscan_tpu_torch.identify.count",
                       "count_sample", _altered),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["tiny-count", "tiny-deep"])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    import importlib

    sound = run_cell(tiny, cell)
    assert sound["correct"], sound["checks"]
    mod, name, wrap = FAULTS[fault]
    m = importlib.import_module(mod)
    # identify imports count_sample by name: patch it there too, after
    # those modules have imported the real one
    users = [importlib.import_module(u) for u in (
        "strainscan_tpu_torch.identify.pipeline",
        "strainscan_tpu_torch.identify.vote")] if name == "count_sample" \
        else []
    monkeypatch.setattr(m, name, wrap(getattr(m, name)))
    for u in users:
        monkeypatch.setattr(u, name, getattr(m, name))
    out = run_cell(tiny, cell)
    assert not out["correct"], out["checks"]


def test_the_mesh_without_its_cross_device_sum_is_not_correct(tiny,
                                                            monkeypatch):
    from strainscan_tpu_torch.parallel import sharded

    out = run_cell(tiny, "tiny-count-2x2", devices=["cpu"] * 4)
    assert out["correct"], out["checks"]
    monkeypatch.setattr(sharded, "_sum", lambda parts, dev: parts[0].to(dev))
    out = run_cell(tiny, "tiny-count-2x2", devices=["cpu"] * 4)
    assert not out["correct"]
    assert out["checks"]["ids_under"]["value"] > 0


def test_a_db_of_another_digest_gives_no_result(tiny, tmp_path):
    """The identify reference reads the DB that the program's build made:
    a run whose DB is not the one the configuration pins by its digest
    stops before the reference, with no result."""
    import shutil

    reg, cache = tiny
    assert run_cell(tiny, "tiny-small", seconds=0.2)["correct"]
    (top,) = [d for d in os.listdir(cache) if d.startswith("tiny-db-")
              and not d.endswith(".partial")]
    shutil.copytree(os.path.join(cache, top), tmp_path / top)
    with open(tmp_path / top / "DB" / "manifest.json", "ab") as f:
        f.write(b"\n")                 # still loads: only the digest sees it
    with pytest.raises(harness.BadInput, match="digest"):
        harness.execute(reg, "tiny-small", 5, 0.2, False, ["cpu"],
                        time.perf_counter(), str(tmp_path))


@pytest.mark.cuda
def test_on_the_card_the_reference_equals_the_programs_count(card, tiny):
    out = run_cell(tiny, "tiny-count", devices=[card])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"


def test_a_run_that_loads_jax_gives_no_result(tiny, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys)
    with pytest.raises(harness.JaxLoaded, match="jax"):
        run_cell(tiny, "tiny-count", seconds=0.2)
