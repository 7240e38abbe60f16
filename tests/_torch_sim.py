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


# ------------------------------------------------ exact-count edge batches
EXACT_EDGES = ("padded", "mid_read_n", "all_invalid", "vlen_zero",
               "shorter_than_k", "wrap", "load_0_9", "shard", "few_rows",
               "unaligned", "long_reads")


def decode_kmer(key, k: int = 31) -> np.ndarray:
    """uint8 codes of a packed k-mer, 5'-first."""
    return np.array([(int(key) >> (2 * (k - 1 - i))) & 3 for i in range(k)],
                    dtype=np.uint8)


def exact_edge(case: str):
    """One edge batch of the exact count, ``(table, codes)``: a port
    KmerTable and uint8 codes ``[B, L]``, reads padded with code 4 to
    L = 256 (150 for "unaligned", whose payload rows end off 16 B).

    padded: 67 reads of 150 bp (a block of 64 and a partial one), three
    of them random (misses); mid_read_n: an N in every third read;
    all_invalid; vlen_zero: every other row empty; shorter_than_k: every
    other read 20 bp; wrap: a 64-bucket table whose last bucket overflows
    into bucket 0, read by 31 bp reads; load_0_9: misses read every one of
    max_probe > 1 rows; shard: the second shard of a ShardedTable, rebuilt
    at a lowered load factor; few_rows: 5 reads, fewer than one block;
    long_reads: 11 reads of L = 5,000 (the whole genome, every other one
    reverse-complemented, then random bases and padding), so long that a
    block of the kernel takes fewer reads."""
    from strainscan_tpu_torch.index.hashtable import BUCKET, mix_np
    from strainscan_tpu_torch.kmer import pack
    from strainscan_tpu_torch.parallel import ShardedTable

    k = 31
    rng = np.random.default_rng(EXACT_EDGES.index(case))
    length = 150 if case == "unaligned" else 256
    genome = rng.integers(0, 4, size=3000).astype(np.uint8)
    km, _ = pack.pack_kmers(genome, k)
    keys = np.unique(np.concatenate([km, pack.revcomp_packed(km, k)]))
    n = 5 if case == "few_rows" else 67
    codes = np.full((n, length), 4, np.uint8)
    for i in range(n):
        s = int(rng.integers(0, genome.size - 150))
        r = genome[s:s + 150]
        codes[i, :150] = (3 - r)[::-1] if i % 2 else r
    codes[-3:, :150] = rng.integers(0, 4, size=(3, 150))   # misses
    table = KmerTable.build(keys, k=k)
    if case == "mid_read_n":
        codes[::3, 40] = 4
    elif case == "all_invalid":
        codes[:] = 4
    elif case == "vlen_zero":
        codes[::2] = 4
    elif case == "shorter_than_k":
        codes[::2, 20:] = 4
    elif case == "load_0_9":
        table = KmerTable.build(keys, k=k, load_factor=0.9)
        assert table.max_probe > 1
    elif case == "wrap":
        rand = np.unique(rng.integers(0, 1 << 62, size=4000,
                                      dtype=np.uint64))
        home = mix_np((rand >> np.uint64(32)).astype(np.uint32),
                      (rand & np.uint64(0xFFFFFFFF)).astype(np.uint32)) & 63
        last, others = rand[home == 63][:12], rand[home != 63][:388]
        table = KmerTable.build(np.concatenate([last, others]), k=k,
                                load_factor=0.9)
        assert table.n_buckets == 64
        assert np.isin(table.val[:BUCKET], np.arange(12)).any()  # wrapped
        codes = np.full((40, length), 4, np.uint8)
        for i, key in enumerate(np.concatenate([last, others[:28]])):
            codes[i, :k] = decode_kmer(key)
    elif case == "shard":
        # 257 keys in 2 shards: the second holds 128 and is rebuilt at a
        # lowered load factor to the first's 128 buckets
        st = ShardedTable.build(keys[:257], k=k, n_shards=2)
        chunk = np.sort(keys[:257])[st.shard_cap:]
        table = KmerTable.build(chunk, k=k, load_factor=chunk.size / (
            st.n_buckets * BUCKET))
        assert table.n_buckets == st.n_buckets == 128
        assert np.array_equal(table.interleaved(), st.table[1])
        codes = np.full((chunk.size + 3, length), 4, np.uint8)
        for i, key in enumerate(chunk):
            codes[i, :k] = decode_kmer(key)
        codes[-3:, :150] = rng.integers(0, 4, size=(3, 150))
    elif case == "long_reads":
        codes = np.full((11, 5000), 4, np.uint8)
        for i in range(codes.shape[0]):
            codes[i, :genome.size] = (3 - genome)[::-1] if i % 2 else genome
            codes[i, genome.size:4900] = rng.integers(
                0, 4, size=4900 - genome.size)
    return table, codes


def exact_forms(codes: np.ndarray) -> dict:
    """``{form: (reads, {validity kwarg})}`` of a code batch as CPU
    tensors: vbytes, raw codes, and vlen where every row's validity is a
    prefix."""
    from strainscan_tpu_torch.kmer import pack
    from strainscan_tpu_torch.kmer.device import from_u32

    words, vbytes = pack.bitpack_codes(codes)
    out = {"vbytes": (from_u32(words), {"vbytes": torch.from_numpy(vbytes)}),
           "codes": (torch.from_numpy(codes), {})}
    vlen = pack.valid_prefix_lens(codes)
    if vlen is not None:
        out["vlen"] = (from_u32(words), {"vlen": torch.from_numpy(vlen)})
    return out
