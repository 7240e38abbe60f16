"""Sharded identify in the port, byte-identical to the JAX package's
single-device identify (the fixtures of tests/test_sharded_e2e.py).

The port runs on an 8-entry ``cpu`` mesh with ``shard_min_kmers=1`` (the
tree table and the per-sample L2 union both count through
``ShardedCountPipeline``) or ``shard_min_l2_rows=1`` (the Pre-Scan column
sums and Enet fold Grams split their rows over the mesh).  JAX's own tests
prove its sharded run equal to its single-device run, so the single-device
JAX run is the oracle.

Tolerance: none; every report file must be byte-identical.
"""

import dataclasses

import numpy as np
import pytest

from strainscan_tpu.build.pipeline import build_database
from strainscan_tpu.config import BuildConfig, IdentifyConfig
from strainscan_tpu.identify.pipeline import run_identify as run_identify_jax
from strainscan_tpu_torch.identify.pipeline import run_identify
from strainscan_tpu_torch.parallel import sharded as psh

from _torch_sim import (assert_reports_identical, mutate,  # noqa: F401
                        one_torch_thread, rand_genome, sim_reads, write_fa,
                        write_fq)

CPU8 = ["cpu"] * 8
GLEN = 30_000


def _db(d, n_snps, seed):
    """A1, its mutant A2 (``n_snps`` SNPs) and an unrelated B1."""
    rng = np.random.default_rng(seed)
    gdir = d / "genomes"
    gdir.mkdir()
    base = rand_genome(rng, GLEN)
    strains = {"A1": base, "A2": mutate(rng, base, n_snps),
               "B1": rand_genome(rng, GLEN)}
    for name, seq in strains.items():
        write_fa(gdir / f"{name}.fa", name, seq)
    db_dir = str(d / "DB")
    build_database(str(gdir), db_dir, BuildConfig())
    return db_dir, strains


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """40 SNPs: A1 and A2 in separate clusters; 15 SNPs: one 2-strain
    cluster, so identify runs the Pre-Scan + Elastic-Net route."""
    d40 = tmp_path_factory.mktemp("sharded_e2e")
    d15 = tmp_path_factory.mktemp("sharded_l2")
    return {"40": (d40, *_db(d40, 40, 33)), "15": (d15, *_db(d15, 15, 34))}


def _sample(fixtures, which, parts):
    d, db_dir, strains = fixtures[which]
    rng = np.random.default_rng(len(parts))
    reads = []
    for name, depth in parts:
        reads += sim_reads(rng, strains[name], depth)
    fq = str(d / f"{'_'.join(n for n, _ in parts)}.fq")
    write_fq(fq, reads)
    return d, db_dir, fq


SAMPLES = {
    "single": ("40", [("B1", 8.0)]),
    "mix": ("40", [("A1", 6.0), ("A2", 6.0)]),
    "enet_mix": ("15", [("A1", 6.0), ("A2", 6.0)]),
}


@pytest.fixture
def spy(monkeypatch):
    """Counts calls of the port's sharded count and L2 mesh functions."""
    calls = {"pipeline": 0, "colsum": 0, "colsum_unused": 0, "or_col": 0,
             "grams": 0}

    def counted(name, fn):
        def wrap(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrap

    monkeypatch.setattr(psh.ShardedCountPipeline, "add_prepared", counted(
        "pipeline", psh.ShardedCountPipeline.add_prepared))
    for name, attr in (("colsum", "sharded_colsum"),
                       ("colsum_unused", "sharded_colsum_unused"),
                       ("or_col", "sharded_or_col"),
                       ("grams", "sharded_fold_grams")):
        monkeypatch.setattr(psh, attr, counted(name, getattr(psh, attr)))
    return calls


@pytest.mark.parametrize("case", sorted(SAMPLES))
def test_sharded_count_reports_equal_jax_single(fixtures, spy, case):
    which, parts = SAMPLES[case]
    d, db_dir, fq = _sample(fixtures, which, parts)
    out_jax, out = str(d / f"jax_{case}"), str(d / f"torch_{case}")
    res_jax = run_identify_jax(fq, "", db_dir, out_jax, dataclasses.replace(
        IdentifyConfig(), shard_min_kmers=10**12))
    res = run_identify(fq, "", db_dir, out, CPU8, dataclasses.replace(
        IdentifyConfig(), shard_min_kmers=1))
    assert res is not None and res_jax is not None
    assert sorted(res) == sorted(res_jax)
    got = assert_reports_identical(out, out_jax)
    assert "final_report.txt" in got
    assert spy["pipeline"] > 0, "the sharded count pipeline never ran"
    if case == "enet_mix":
        assert any(n.endswith("StrainVote.report") for n in got)


def test_l2_mesh_route_taken_and_reports_equal(fixtures, spy):
    """min_snv_num lowered so the 15-SNP mutant clears the Pre-Scan
    accept gate and the Elastic-Net runs on the mesh route."""
    d, db_dir, fq = _sample(fixtures, "15", [("A1", 6.0), ("A2", 6.0)])
    out_jax, out = str(d / "jax_l2mesh"), str(d / "torch_l2mesh")
    run_identify_jax(fq, "", db_dir, out_jax, dataclasses.replace(
        IdentifyConfig(), shard_min_kmers=10**12, shard_min_l2_rows=10**12,
        min_snv_num=10))
    res = run_identify(fq, "", db_dir, out, CPU8, dataclasses.replace(
        IdentifyConfig(), shard_min_kmers=10**12, shard_min_l2_rows=1,
        min_snv_num=10))
    assert res is not None
    got = assert_reports_identical(out, out_jax)
    assert got["C1/StrainVote.report"].count(b"\tC1\t") == 2, \
        "both strains must be called, so the Enet runs"
    assert spy["colsum"] > 0, "Pre-Scan colsum never routed via the mesh"
    assert spy["colsum_unused"] > 0 and spy["or_col"] > 0
    assert spy["grams"] > 0, "Enet fold Grams never routed via the mesh"
    assert spy["pipeline"] == 0
