"""Simulation helpers shared by the PyTorch port's end-to-end tests."""

import os

import numpy as np
import pytest
import torch

from strainscan_tpu_torch.build.pipeline import build_database
from strainscan_tpu_torch.config import BuildConfig
from strainscan_tpu_torch.index.hashtable import FpTable, KmerTable

COMP = str.maketrans("ACGT", "TGCA")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test module: the suite runs several worker
    processes at once, and torch's default of one thread per core in each
    of them oversubscribes the cores (the tests' work is small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_kmer_table(t):
    """The port's KmerTable holding the arrays of ``t``, a KmerTable of the
    JAX package: the two classes are copies, and neither takes the other."""
    return KmerTable(key_hi=t.key_hi, key_lo=t.key_lo, val=t.val,
                     n_buckets=t.n_buckets, max_probe=t.max_probe,
                     n_keys=t.n_keys, k=t.k)


def port_fp_table(t):
    """The port's FpTable holding the arrays of ``t``, an FpTable of the JAX
    package."""
    return FpTable(fp=t.fp, val=t.val, n_buckets=t.n_buckets,
                   bucket=t.bucket, seed=t.seed, n_keys=t.n_keys, k=t.k)


def write_fa(path, name, seq):
    with open(path, "w") as f:
        f.write(f">{name}\n")
        for i in range(0, len(seq), 80):
            f.write(seq[i:i + 80] + "\n")


def rand_genome(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def mutate(rng, seq, n_snps):
    s = np.array(list(seq))
    for p in rng.choice(len(s), size=n_snps, replace=False):
        s[p] = rng.choice([b for b in "ACGT" if b != s[p]])
    return "".join(s)


def sim_reads(rng, seq, depth, read_len=100):
    reads = []
    for _ in range(int(len(seq) * depth / read_len)):
        s = int(rng.integers(0, len(seq) - read_len))
        r = seq[s:s + read_len]
        if rng.random() < 0.5:
            r = r.translate(COMP)[::-1]
        reads.append(r)
    return reads


def write_fq(path, reads, opener=open):
    with opener(path, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


def report_tree(out_dir):
    """{relative path: bytes} of the text outputs under out_dir (the
    plasmid-mode DB's binary archives are left out)."""
    files = {}
    for root, dirs, names in os.walk(out_dir):
        dirs[:] = [d for d in dirs if d != "DB_plasmid"]
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                files[os.path.relpath(p, out_dir)] = f.read()
    return files


def e2e_fixture(d):
    """The 5-genome DB of test_identify_e2e's layout under ``d`` (A1/A2 and
    D1/D2 multi-strain clusters, B1 alone) and three samples: single-strain
    (B1), cross-cluster (B1 + D1) and intra-cluster (A1 + A2, the Enet).
    Returns ``(db_dir, {sample: fastq path})``."""
    rng = np.random.default_rng(31)
    glen = 100_000
    gdir = d / "genomes"
    gdir.mkdir()
    base_a, base_d = rand_genome(rng, glen), rand_genome(rng, glen)
    strains = {"A1": base_a, "A2": mutate(rng, base_a, 60),
               "B1": rand_genome(rng, glen), "D1": base_d,
               "D2": mutate(rng, base_d, 70)}
    for name, seq in strains.items():
        write_fa(gdir / f"{name}.fa", name, seq)
    db_dir = str(d / "DB")
    build_database(str(gdir), db_dir, BuildConfig())
    samples = {
        "single": sim_reads(rng, strains["B1"], 5),
        "cross": sim_reads(rng, strains["B1"], 8)
        + sim_reads(rng, strains["D1"], 8),
        "intra": sim_reads(rng, strains["A1"], 10)
        + sim_reads(rng, strains["A2"], 10),
    }
    paths = {}
    for name, reads in samples.items():
        rng.shuffle(reads)
        paths[name] = str(d / f"{name}.fq")
        write_fq(paths[name], reads)
    return db_dir, paths


def assert_reports_identical(out_torch, out_jax, truth=None):
    """Byte-identical text outputs; ``truth`` is the expected strain set
    of final_report.txt (None: parity only).  Returns the outputs."""
    got, want = report_tree(out_torch), report_tree(out_jax)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    if truth is not None:
        rows = got["final_report.txt"].decode().splitlines()[1:]
        assert {row.split("\t")[1] for row in rows} == truth
    return got
