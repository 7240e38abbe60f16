"""The layer-2 vote at a clonal complex's width: the device dominant search
against the JAX package's host loop, ``detect_strains`` on wide matrices,
the strain matrix checked and uploaded once per loaded cluster, and whole
``run_identify`` reports on a small L2-heavy DB against the JAX package's
and against the benchmark's frozen reference.

Tolerance: none.  The dominant scores are exact sums of integer counts,
the column sums and Grams are exact, and every report must be
byte-identical.
"""

import numpy as np
import pytest
import torch

from strainscan_tpu.config import IdentifyConfig as JaxConfig
from strainscan_tpu.identify import prescan as jprescan
from strainscan_tpu.identify.pipeline import run_identify as run_identify_jax
from strainscan_tpu_torch import timing
from strainscan_tpu_torch.build import db as tdb
from strainscan_tpu_torch.build.pipeline import build_database
from strainscan_tpu_torch.config import BuildConfig, IdentifyConfig
from strainscan_tpu_torch.identify import prescan
from strainscan_tpu_torch.identify.pipeline import run_identify

from _torch_sim import (assert_reports_identical,  # noqa: F401
                        one_torch_thread, report_tree)

CPU = torch.device("cpu")


def loop_scores(X, y):
    """optimize_dominat_y's per-column scores, as the JAX package's host
    loop computes them (identify/prescan.py::_optimize_dominant)."""
    res = np.zeros(X.shape[1])
    for c in range(X.shape[1]):
        da = X[:, c].astype(np.float64) * y
        da_noz = da[da != 0]
        if da_noz.size < 1 or np.sum(da_noz) == 0:
            continue
        f25 = np.percentile(da_noz, 5, method="nearest")
        f75 = np.percentile(da_noz, 95, method="nearest")
        tem = y.copy().astype(np.float64)
        tem[tem < f25] = 0
        tem[tem > f75] = 0
        res[c] = float(X[:, c] @ tem)
    return res


def counts_and_overlap(rng, n):
    """(py, py_u) of ``detect_strains``: Poisson counts with the 1s zeroed,
    and the same with the rows shared with a second detected cluster
    zeroed."""
    py = rng.poisson(4.0, n).astype(np.float64)
    py[py == 1] = 0
    om = np.stack([np.ones(n), rng.random(n) < 0.2], axis=1)
    ln = om.sum(axis=1)
    ln[ln > 1] = 0
    return py, py * ln


def wide_case(case, seed=0, n=3000, s=128):
    rng = np.random.default_rng(seed)
    X = (rng.random((n, s)) < 0.4).astype(np.int8)
    py, py_u = counts_and_overlap(rng, n)
    y = py
    if case == "py_u":
        y = py_u
    elif case == "ties":
        X[:, 3] = (rng.random(n) < 0.9).astype(np.int8)
        X[:, 70] = X[:, 3]
        X[:, 101] = X[:, 3]
    elif case == "half_ranks":
        # (nnz - 1) * 0.05 and * 0.95 fall on .5 for nnz = 20 j + 11
        y = rng.integers(2, 1000, n).astype(np.float64)
        y[rng.random(n) < 0.3] = 0
        nz = np.flatnonzero(y)
        X[:] = 0
        for c in range(s):
            X[rng.choice(nz, 20 * (c % 12) + 11, replace=False), c] = 1
            X[rng.choice(np.flatnonzero(y == 0), 5, replace=False), c] = 1
    elif case == "empty_columns":
        X[:, ::3] = 0
        X[:, 1::3] *= (y == 0)[:, None].astype(np.int8)
    return X, y


@pytest.mark.parametrize("q", [5, 95])
def test_nearest_rank_is_numpys(q):
    n = np.arange(1, 2501)
    got = prescan._nearest_rank(torch.from_numpy(n), q).numpy()
    want = [int(np.percentile(np.arange(m), q, method="nearest"))
            for m in n]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["random", "ties", "half_ranks",
                                  "empty_columns", "py_u"])
def test_device_dominant_equals_the_host_loop(case):
    X, y = wide_case(case)
    scores = prescan._dominant_scores(torch.from_numpy(X), y)
    np.testing.assert_array_equal(scores, loop_scores(X, y))
    got = prescan._optimize_dominant(torch.from_numpy(X), y)
    assert got == jprescan._optimize_dominant(X, y)
    if case == "ties":
        assert scores[3] == scores[70] == scores[101] == scores.max()
        assert got == 3
    if case == "empty_columns":
        assert not scores[::3].any() and not scores[1::3].any()
    if case == "half_ranks":
        nnz = (X * (y != 0)[:, None]).sum(axis=0)
        assert set(((nnz - 1) * 0.05) % 1) == {0.5}


def test_dominant_with_no_positive_column_is_the_first():
    X = np.zeros((50, 7), dtype=np.int8)
    y = np.arange(50, dtype=np.float64)
    assert prescan._optimize_dominant(X, y) == \
        jprescan._optimize_dominant(X, y) == 0


def l2_matrix(rng, s=32, unique=300, shared=120):
    """An L2-build-shaped 0/1 matrix: ``unique`` rows per strain that only
    it holds, and ``shared`` rows per strain that every other strain
    holds."""
    rows = []
    for c in range(s):
        u = np.zeros((unique, s), np.int8)
        u[:, c] = 1
        sh = np.ones((shared, s), np.int8)
        sh[:, c] = 0
        rows += [u, sh]
    X = np.concatenate(rows)
    return X[rng.permutation(X.shape[0])]


@pytest.mark.parametrize("route", ["cached", "fresh", "mesh"])
def test_wide_detect_strains_matches_jax(route):
    rng = np.random.default_rng(9)
    X = l2_matrix(rng)
    present = {4: 9.0, 17: 6.0, 30: 8.0}
    lam = sum(d * X[:, c] for c, d in present.items()) + 0.05
    py = rng.poisson(lam).astype(np.float64)
    py[py == 1] = 0
    om = np.ones((X.shape[0], 1))
    sid = [f"S{i}" for i in range(X.shape[1])]
    npp_out = float(np.median(py[py != 0])) * 1000
    args = (X, py, sid, 31, 0.0, npp_out, npp_out, 0.9, om, 0, 1, 0, 0)
    device, cfg = CPU, IdentifyConfig()
    if route == "mesh":
        device, cfg = ["cpu"] * 4, IdentifyConfig(shard_min_l2_rows=1)
    kern = None
    if route != "fresh":
        kern = prescan._L2Kernels(X, device, cfg.shard_min_l2_rows)
        assert (kern.mesh is not None) == (route == "mesh")
    got = prescan.detect_strains(*args, device, cfg, kern)
    want = jprescan.detect_strains(*args, JaxConfig())
    assert repr(got) == repr(want)
    assert set(got[0]) == {f"S{c}" for c in present}


# ------------------------------------------- a small L2-heavy DB, end to end
FAMILIES = [[24, 1], [1, 3]]


@pytest.fixture(scope="module")
def clonal(tmp_path_factory):
    """A DB of one 24-strain family and three singletons (the generator of
    the benchmark's ``saureus-db``), and two samples: three strains of the
    family; two of them with a singleton."""
    from portbench import synth, synth_clonal

    d = tmp_path_factory.mktemp("clonal")
    gdir = d / "genomes"
    gdir.mkdir()
    names = synth_clonal.synth_clonal(str(gdir), FAMILIES, 32, 100_000,
                                      np.random.default_rng(11))
    db_dir = str(d / "DB")
    build_database(str(gdir), db_dir, BuildConfig(threads=2))
    rng = np.random.default_rng(12)
    mixes = {"cc3": [(names[2], 9.0), (names[11], 8.0), (names[20], 9.0)],
             "cross": [(names[5], 9.0), (names[17], 8.0), (names[25], 6.0)]}
    samples = {}
    for name, parts in mixes.items():
        codes = np.concatenate([synth.genome_reads(
            rng, synth.genome_codes(str(gdir / f"{s}.fa")),
            synth.depth_reads(dep, 100_000, 100), 100) for s, dep in parts])
        codes = codes[rng.permutation(len(codes))]
        path = str(d / f"{name}.fq")
        synth.write_fastq(path, codes)
        samples[name] = (path, parts, codes)
    return d, db_dir, samples


def test_the_clonal_family_is_one_wide_cluster(clonal):
    d, db_dir, _ = clonal
    man = tdb.load_manifest(db_dir)
    assert man["n_clusters"] == 4
    shapes = [tdb.load_l2_db(db_dir, c).matrix.shape
              for c in man["cluster_ids"]
              if tdb.load_l2_db(db_dir, c) is not None]
    assert len(shapes) == 1 and shapes[0][1] == 24
    assert shapes[0][0] > 24 * 3000


@pytest.mark.parametrize("sample", ["cc3", "cross"])
def test_clonal_reports_equal_jax_and_the_frozen_reference(clonal, sample):
    from types import SimpleNamespace

    from portbench.drivers import identify as idriver

    d, db_dir, samples = clonal
    path, parts, codes = samples[sample]
    out, out_jax = str(d / f"torch_{sample}"), str(d / f"jax_{sample}")
    res = run_identify(path, "", db_dir, out, "cpu", IdentifyConfig())
    res_jax = run_identify_jax(path, "", db_dir, out_jax, JaxConfig())
    assert sorted(res) == sorted(res_jax)
    got = assert_reports_identical(out, out_jax,
                                   {s for s, _ in parts})
    assert any(n.endswith("StrainVote.report") for n in got)
    assert prescan.L2STATS["clusters"] == 1
    # a round accepts each strain of the family after the dominant, and
    # the last one ends the scan
    assert prescan.L2STATS["rounds"] >= sum(s.startswith("F0") for s, _ in
                                            parts)
    run = SimpleNamespace(devices=["cpu"], tmp=str(d / f"ref_{sample}"),
                          state={"db": db_dir,
                                 "samples": [("clonal", parts, codes)]})
    (want,) = idriver.reference(run)
    assert idriver.compare_one((res, idriver.reports(out)), want) == \
        (0, 0, 0.0)


def test_the_matrix_is_checked_and_uploaded_once_per_loaded_cluster(clonal):
    d, db_dir, samples = clonal
    tdb._L2_CACHE.clear()
    stats, trees = [], []
    for i in range(2):
        timing.PHASE_TIMES.clear()
        out = str(d / f"once_{i}")
        run_identify(samples["cc3"][0], "", db_dir, out, "cpu",
                     IdentifyConfig())
        stats.append(dict(prescan.L2STATS))
        trees.append(report_tree(out))
        for ph in ("identify/l2_vote/prescan",
                   "identify/l2_vote/prescan/dominant",
                   "identify/l2_vote/enet"):
            assert timing.PHASE_TIMES[ph] > 0, ph
        assert timing.PHASE_TIMES["identify/l2_vote/prescan"] >= \
            timing.PHASE_TIMES["identify/l2_vote/prescan/dominant"]
    assert [(s["uploads"], s["checks"], s["clusters"]) for s in stats] == \
        [(1, 1, 1), (0, 0, 1)]
    assert stats[0]["shapes"] == stats[1]["shapes"]
    assert stats[0]["shapes"][0][1] == 24
    assert trees[0] == trees[1]
    # each phase is a span of the ring, inside the sample's L2 vote
    by_id = {s.id: s for s in timing.SPANS}
    last = [s for s in timing.SPANS
            if s.name == "identify/l2_vote/prescan/dominant"][-1]
    chain = []
    s = last
    while s is not None:
        chain.append(s.name)
        s = by_id.get(s.parent)
    assert chain[:4] == ["identify/l2_vote/prescan/dominant",
                         "identify/l2_vote/prescan", "identify/l2_vote",
                         "identify/sample"]


def test_a_fresh_matrix_that_is_not_0_1_is_refused():
    before = dict(prescan.L2STATS)
    with pytest.raises(ValueError, match="0/1"):
        prescan._L2Kernels(np.full((4, 3), 2, np.int8), CPU)
    assert prescan.L2STATS["checks"] == before["checks"] + 1
    assert prescan.L2STATS["uploads"] == before["uploads"]
