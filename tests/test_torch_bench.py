"""The port's benchmarks (``strainscan_tpu_torch.bench``) on the CPU.

Both benchmarks measure on a CUDA device and refuse any other.  To run
them end to end here at a toy size, the tests replace the benchmark's
device check, CUDA-event timer and card line with CPU stand-ins (the
numbers they give are not device numbers; only the counts, the checks and
the JSON layout are tested):

* ``bench.count``'s inputs are bench.py's byte for byte, its counts equal
  the JAX ``CountPipeline(KmerTable.build(db))`` on the same FASTQ, and its
  JSON line carries bench.py's keys; a stand-in jellyfish binary drives
  the baseline branch;
* ``bench.probe_study`` runs both sections at a small size, its row gather
  equal to the NumPy oracle and its compressed scatter equal to the plain
  scatter (each raises otherwise), with PROBE_STUDY3.json's keys;
* ``bench.exact_study`` runs its three studies at a small size, every
  window of its batch a hit.

Tolerance: none; counts are integers and must be equal.
"""

import ast
import json
import os
import stat
import sys
import time

import numpy as np
import pytest
import torch

from strainscan_tpu.index.hashtable import KmerTable
from strainscan_tpu.io import fastx
from strainscan_tpu.ops.count import CountPipeline as JaxCountPipeline
from strainscan_tpu_torch.bench import count as bc
from strainscan_tpu_torch.bench import exact_study as es
from strainscan_tpu_torch.bench import probe_study as ps

from _torch_sim import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench  # noqa: E402  (the JAX package's bench.py)


def _host_ms(fn, iters):
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


@pytest.fixture
def on_cpu(monkeypatch):
    """CPU stand-ins for the benchmarks' device check, timer and card."""
    for mod in (bc, ps):
        monkeypatch.setattr(mod, "cuda_device", lambda d: torch.device("cpu"))
        monkeypatch.setattr(mod, "cuda_ms", _host_ms)
        monkeypatch.setattr(mod, "card_line", lambda: "cpu stand-in")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "cpu")
    monkeypatch.setattr(bc, "BATCH", 1024)     # several batches per pass


def _dict_keys(path, func, having=None):
    """String keys of the dict literals in ``func`` of the file (those
    with the key ``having``, when given)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    keys = [{k.value for k in n.keys if isinstance(k, ast.Constant)}
            for n in ast.walk(fn) if isinstance(n, ast.Dict)]
    return set().union(*(k for k in keys if having is None or having in k))


def test_synthesize_matches_bench_py(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    db_want, fq_want = bench.synthesize(str(a), "toy", 20_000, 3_000)
    db, fq = bc.synthesize(str(b), "toy", 20_000, 3_000)
    assert db.dtype == db_want.dtype and np.array_equal(db, db_want)
    with open(fq, "rb") as f1, open(fq_want, "rb") as f2:
        assert f1.read() == f2.read()


def test_bench_counts_equal_jax(tmp_path, on_cpu):
    db, fq = bc.synthesize(str(tmp_path), "toy", 20_000, 3_000)
    rps, counts, times, bd = bc.bench_ours(db, fq, 3_000,
                                           torch.device("cpu"), reps=2,
                                           passes=3)
    jpipe = JaxCountPipeline(KmerTable.build(db, k=bc.K))
    for batch in fastx.read_batches(fq, batch=bc.BATCH, maxlen=bc.MAXLEN,
                                    k=bc.K):
        jpipe.add_batch(batch)
    want = np.asarray(jpipe.finish())
    assert np.array_equal(counts, want)
    assert want.sum() == 3_000 * (bc.READ_LEN - bc.K + 1)
    assert len(times) == 2 and rps > 0
    assert set(bd) == _dict_keys(bench.__file__, "breakdown") | {
        "finish_s", "finish_routes", "finish_d2h_bytes"}
    assert len(bd["finish_routes"]) == len(bd["finish_d2h_bytes"]) == 2


def test_bench_json_carries_bench_py_keys(on_cpu):
    res = bc.run("cpu", tiers=[("toy", 20_000, 2_000)], reps=1, passes=3)
    assert set(res) == _dict_keys(bench.__file__, "main", "metric")
    assert res["metric"] == "kmer_match_reads_per_s_ecoli_scale"
    toy = res["detail"]["toy"]
    assert res["value"] == toy["ours_reads_s"]
    assert res["vs_baseline"] is None and toy["vs_baseline"] is None
    assert set(toy) == _dict_keys(bench.__file__, "run_tier") | {
        "vs_baseline"}
    assert res["detail"]["card"] == "cpu stand-in"
    json.loads(json.dumps(res, allow_nan=False))   # valid JSON, no NaN


FAKE_JELLYFISH = """#!{python}
# stand-in jellyfish: 'count -m K ... --if KMER_FA -o OUT FASTQ' counts the
# listed k-mers in the reads' forward windows; 'dump -c OUT' prints them
import sys
args = sys.argv[1:]
if args[0] == "dump":
    sys.stdout.write(open(args[-1]).read())
    sys.exit(0)
k = int(args[args.index("-m") + 1])
listed = [l.strip() for l in open(args[args.index("--if") + 1])
          if not l.startswith(">")]
counts = dict.fromkeys(listed, 0)
lines = open(args[-1]).read().split("\\n")
for seq in lines[1::4]:
    for i in range(len(seq) - k + 1):
        if seq[i:i + k] in counts:
            counts[seq[i:i + k]] += 1
with open(args[args.index("-o") + 1], "w") as f:
    for km, c in counts.items():
        if c:
            f.write(f"{{km}} {{c}}\\n")
"""


def test_bench_jellyfish_baseline(tmp_path, on_cpu):
    jf = tmp_path / "jellyfish"
    jf.write_text(FAKE_JELLYFISH.format(python=sys.executable))
    jf.chmod(jf.stat().st_mode | stat.S_IEXEC)
    res = bc.run("cpu", tiers=[("toy", 5_000, 400)], reps=1, passes=3,
                 jellyfish=str(jf))
    toy = res["detail"]["toy"]
    assert res["vs_baseline"] == toy["vs_baseline"] > 0
    assert len(toy["jellyfish_times_s"]) == bc.REPS_JF


def test_benchmarks_refuse_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bc.run("cpu", tiers=[("toy", 5_000, 100)])
    with pytest.raises(RuntimeError, match="CUDA"):
        ps.run("cpu", n_keys=1_000, windows=1 << 12)


def test_probe_study_small(on_cpu):
    res = ps.run("cpu", n_keys=20_000, windows=1 << 15, reps=1)
    with open(os.path.join(ROOT, "benchmarks", "PROBE_STUDY3.json")) as f:
        tpu = json.load(f)
    assert set(tpu) <= set(res)
    assert res["table_MB"] == ps.n_buckets_for(20_000) * ps.BUCKET * 4 / 1e6
    for name in ("dma_gather_Mrows_s_512B", "dma_gather_Mrows_s_256B"):
        assert set(res[name]) == set(tpu["dma_gather_Mrows_s_512B"])
        assert all(r["bit_exact"] and r["ms"] > 0 and r["plain_ms"] > 0
                   for r in res[name].values())
    assert set(res["compressed_scatter_Mwin_s"]) == {"mult8", "mult64"}


def test_probe_study_geometry_and_scatters():
    assert ps.n_buckets_for(ps.N_KEYS) == 1 << 20     # 256 MiB at 64 words
    rng = np.random.default_rng(2)
    pool = rng.integers(0, 500, size=40)
    slots = torch.from_numpy(rng.choice(pool, size=5_000).astype(np.int32))
    plain = ps.plain_scatter(torch.zeros(501, dtype=torch.int32), slots)
    comp = ps.compressed_scatter(torch.zeros(501, dtype=torch.int32), slots)
    assert torch.equal(plain, comp)
    assert torch.equal(plain, torch.bincount(slots, minlength=501)
                       .to(torch.int32))


def test_exact_study_small(monkeypatch):
    monkeypatch.setattr(es, "cuda_ms", lambda fn, iters=1: _host_ms(fn, 1))
    monkeypatch.setattr(es, "GENOME_LEN", 3_000)
    monkeypatch.setattr(es, "BATCH", 64)
    fx = es.fixture(torch.device("cpu"))
    assert fx["kt"].n_keys > 5_000
    designs = es.designs(torch.device("cpu"), fx)
    assert set(designs) == {f"{name}_ms_L{length}" for length in es.LENGTHS
                            for name in ("count_exact", "probe_prep")}
    assert all(len(v) == 2 and min(v) > 0 for v in designs.values())
    assert set(es.slices(torch.device("cpu"), fx)) == set(es.SLICE_MIB)
    parts = es.parts(torch.device("cpu"), fx)
    assert parts["windows"] == parts["hits"] == 64 * (es.READ_LEN - es.K + 1)
    assert parts["rows_ms"] > 0 and parts["count_exact_ms"] > 0
