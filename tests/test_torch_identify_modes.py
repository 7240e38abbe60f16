"""Identify modes of the PyTorch port (device="cpu") against the JAX package:
memory-efficient DB, plasmid mode (-p 1), paired-end gzip input and
degenerate samples, on the fixture layout of test_modes.  In plasmid mode
the plasmid DB's count and its L2 union count read the main count's kept
payloads.

Tolerance: none; every text output is byte-identical (the plasmid-mode
DB's binary archives are left out of the comparison).
"""

import gzip
import os

import numpy as np
import pytest

from strainscan_tpu.build.pipeline import build_database
from strainscan_tpu.config import BuildConfig, IdentifyConfig
from strainscan_tpu.identify.pipeline import run_identify as run_identify_jax
from strainscan_tpu_torch import timing
from strainscan_tpu_torch.identify.pipeline import run_identify

from _torch_sim import (assert_reports_identical, mutate,  # noqa: F401
                        one_torch_thread, rand_genome, sim_reads, write_fq)

GLEN = 60_000


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(41)
    d = tmp_path_factory.mktemp("torch_modes")
    gdir = d / "genomes"
    gdir.mkdir()
    base = rand_genome(rng, GLEN)
    strains = {"X1": base, "X2": mutate(rng, base, 40),
               "Y1": rand_genome(rng, GLEN)}
    for n, s in strains.items():
        with open(gdir / f"{n}.fa", "w") as f:
            f.write(f">{n}\n{s}\n")
    dbs = {"std": str(d / "DB_std"), "mem": str(d / "DB_mem")}
    build_database(str(gdir), dbs["std"], BuildConfig())
    build_database(str(gdir), dbs["mem"], BuildConfig(memory_efficient=True))
    reads = sim_reads(rng, strains["X1"], 8) + sim_reads(rng, strains["X2"], 8)
    rng.shuffle(reads)
    fqs = {"mix": str(d / "mix.fq"), "r1": str(d / "mix_R1.fq.gz"),
           "r2": str(d / "mix_R2.fq.gz"), "empty": str(d / "empty.fq"),
           "weird": str(d / "weird.fq")}
    write_fq(fqs["mix"], reads)
    write_fq(fqs["r1"], reads[::2], opener=gzip.open)
    write_fq(fqs["r2"], reads[1::2], opener=gzip.open)
    open(fqs["empty"], "w").close()
    with open(fqs["weird"], "w") as f:
        f.write("@r0\n" + "N" * 36 + "\n+\n" + "I" * 36 + "\n"
                "@r1\nACGT\n+\nIIII\n")
    return d, str(gdir), dbs, fqs


# case: (db, fq, fq2, cfg, rgenome?, expect a result)
CASES = {
    "memory_efficient": ("mem", "mix", "", IdentifyConfig(), False, True),
    "plasmid_1": ("std", "mix", "", IdentifyConfig(plasmid_mode=1), True,
                  True),
    "paired_gz": ("std", "r1", "r2", IdentifyConfig(), False, True),
    "empty": ("std", "empty", "", IdentifyConfig(), False, False),
    "all_n_and_sub_k": ("std", "weird", "", IdentifyConfig(), False, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mode_reports_byte_identical_to_jax(setup, case):
    d, gdir, dbs, fqs = setup
    db, fq, fq2, cfg, plasmid, found = CASES[case]
    fq2 = fqs[fq2] if fq2 else ""
    rgenome = gdir if plasmid else ""
    out_jax, out_torch = str(d / f"jax_{case}"), str(d / f"torch_{case}")
    res_jax = run_identify_jax(fqs[fq], fq2, dbs[db], out_jax, cfg,
                               rgenome=rgenome)
    with timing.span("test/sample") as root:
        res = run_identify(fqs[fq], fq2, dbs[db], out_torch, "cpu", cfg,
                           rgenome=rgenome)
    assert (res is not None) == (res_jax is not None) == found
    if found:
        assert sorted(res) == sorted(res_jax)
    got = assert_reports_identical(out_torch, out_jax)
    if found:
        assert b"X1" in got["final_report.txt"]
    if plasmid:
        assert os.path.exists(os.path.join(out_torch, "DB_plasmid",
                                           "manifest.json"))
        # the plasmid DB is built at the main DB's k: its count and its
        # union count read the main count's kept payloads
        counts = sorted((s for s in timing.SPANS if s.sample == root.sample
                         and s.name == "count/sample"), key=lambda s: s.t0)
        assert [s.attrs["source"] for s in counts] == [
            "stream", "kept", "kept"]
