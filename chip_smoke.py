#!/usr/bin/env python3
"""Smoke run of the PyTorch port (strainscan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is passed over):

1. Environment: card name and power limit, torch/CUDA/nvcc versions; build
   the CUDA kernels from csrc/*.cu and time the build.
2. Kernel parity on the card, bit-exact against the plain twins:
   probe_prep_kernel on random codes with ~5 % N (B = 65,536, L in
   {150, 256}, k in {31, 21, 16, 15}, canonical on and off); count_fp_kernel
   on a random table with vlen, vbytes and raw codes payloads;
   count_exact_kernel on a random KmerTable at load 0.9 (so windows probe
   past their home row) with vbytes and codes payloads, canonical on and
   off.
3. E. coli-scale count (the geometry of bench.py): a seeded 14.3 Mb random
   genome, both strands (28.6 M keys, fingerprint table 1,048,576 x 64),
   1.2 M reads of 150 bp (half reverse-complemented, 5 % random misses,
   5 % with a mid-read N) streamed through the port's count_sample.  The
   id-space counts must equal the plain PyTorch path's; one batch is also
   held against the host NumPy oracle (FpTable.lookup_host + bincount).
   Then the exact probe mode (CountPipeline(probe_mode="exact")) over the
   same reads against the 28.6 M-key KmerTable (2^24 buckets x 96 B on the
   card): equal to count_exact_plain over the stream and to
   KmerTable.lookup_host + bincount on one batch; the ids where it differs
   from the fp counts (fingerprint strays) are counted.  Times: end-to-end
   reads/s of both modes, and each kernel against its plain twin at
   B = 65,536 x L = 150 (CUDA events, plain-kernel-kernel-plain).
4. End-to-end identify through the CLI entry point on a synthetic DB:
   single-strain, cross-cluster and intra-cluster (Enet) samples with
   ``identify`` and then ``batch-identify`` on the GPU, once more in a
   fresh ``python -m strainscan_tpu_torch.cli`` process, and all again with
   ``--device cpu``.  Every report must be byte-identical between GPU and
   CPU, the truth strains must be found, and the kernels' launch counters
   (reset just before the GPU runs) must show the runs went through them.
5. Scale-out: a mesh over every visible GPU, or on a card that is alone a
   2 x 2 mesh whose four positions are all that card.  The sharded exact
   count (sharded_count) and the sharded fp pipeline (count_sample with
   shard_min_kmers=1) over phase 3's reads must equal phase 3's
   single-device counts; phase 4's samples identified on the mesh with
   shard_min_kmers=1, shard_min_l2_rows=1 must give reports byte-identical
   to phase 4's GPU reports, with count_fp_kernel launched once per mesh
   position per batch; and a 2-process gloo run of ``batch-identify`` on
   the same card (torchrun's variables set by hand) must give
   byte-identical reports too.

Each path's launch counters are set to 0 just before it and read just
after: the main path (phase 4's GPU identify) for count_fp_kernel, the
exact-mode count of phase 3 for count_exact_kernel.  probe_prep_kernel is
the standalone parity seam of the Pallas probe_prep, on no path (its hash
runs fused inside the count kernels), so its main-path count is 0 and the
kernels line also gives its phase-2 launches.

Reduced for time: phase 4's DB is 40 families x up to 3 variants x 100 kb
(80 genomes), not the 823 clusters of the reference's E. coli DB; phases 3
and 5 keep the count at the full 28.6 M-key table.

Prints progress with the card's name and power limit beside every number,
then the card line, a JSON line of the kernels, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero with no result when
``torch.cuda.is_available()`` is false or the port is not beside the script.
Writes its fixtures under .smoke/ and removes them at the end.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, ".smoke")

K = 31
BATCH = 65_536
# phase 2
PARITY_LENGTHS = (150, 256)
PARITY_KS = (31, 21, 16, 15)
# phase 3 (bench.py's ecoli tier)
GENOME_LEN = 14_300_000
N_READS = 1_200_000
READ_LEN = 150
MISS_SHARE = 0.05
N_SHARE = 0.05
COUNT_REPS = 3
MAXLEN = 256   # IdentifyConfig.max_read_len: identify pads batches to it
# phase 4
FAMILIES, VARIANTS, GLEN = 40, 3, 100_000
GPU = "cuda"   # the --device of the GPU runs



def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ----------------------------------------------------------- synthesis
def write_fastq(path: str, reads: np.ndarray) -> None:
    """Fixed-width FASTQ of code rows (0..3 bases, 4 = N), vectorized."""
    n, length = reads.shape
    ascii_map = np.frombuffer(b"ACGTN", dtype=np.uint8)
    head = np.frombuffer(b"@r\n", dtype=np.uint8)
    mid = np.frombuffer(b"\n+\n", dtype=np.uint8)
    row = head.size + length + mid.size + length + 1
    out = np.empty((n, row), dtype=np.uint8)
    out[:, :head.size] = head
    out[:, head.size:head.size + length] = ascii_map[reads]
    out[:, head.size + length:head.size + length + mid.size] = mid
    out[:, head.size + length + mid.size:-1] = ord("I")
    out[:, -1] = ord("\n")
    out.tofile(path)


def sample_reads(rng, genome: np.ndarray, n: int,
                 read_len: int = READ_LEN) -> np.ndarray:
    """n reads drawn from a code genome, half reverse-complemented."""
    starts = rng.integers(0, genome.size - read_len, size=n)
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
    flips = rng.random(n) < 0.5
    reads[flips] = (3 - reads[flips])[:, ::-1]
    return reads


def genome_keys(genome: np.ndarray, dev) -> np.ndarray:
    """Sorted unique packed k-mers of both strands, via the port."""
    import torch

    from strainscan_tpu_torch.kmer import device as kdev

    codes = torch.from_numpy(genome[None]).to(dev)
    hi, lo, _ = kdev.extract_kmers(codes, K)
    rhi, rlo = kdev.revcomp(hi, lo, K)
    keys = torch.cat([(hi << 32 | lo).ravel(), (rhi << 32 | rlo).ravel()])
    return torch.unique(keys).cpu().numpy().view(np.uint64)


def host_window_keys(codes: np.ndarray):
    """NumPy oracle of the window keys and their validity."""
    m = codes.shape[1] - K + 1
    c = codes.astype(np.uint64)
    key = np.zeros((codes.shape[0], m), dtype=np.uint64)
    for i in range(K):
        key = (key << np.uint64(2)) | (c[:, i:i + m] & np.uint64(3))
    bad = np.cumsum(np.pad(codes >= 4, ((0, 0), (1, 0))), axis=1)
    return key, (bad[:, K:] - bad[:, :-K]) == 0


# -------------------------------------------------------------- timing
def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of fn over iters launches, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# -------------------------------------------------------------- phases
def phase_env(tag: str) -> None:
    import torch

    from strainscan_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    nvcc_ver = nvcc.stdout.strip().splitlines()[-1]
    log(f"[env] card: {tag}")
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch CUDA {torch.version.cuda}, nvcc: {nvcc_ver}")
    t0 = time.perf_counter()
    so = _build.lib()
    dt = time.perf_counter() - t0
    log(f"[env] kernels built from csrc/ in {dt} s ({so._name}) [{tag}]")


def phase_parity(dev, tag: str) -> dict:
    """Kernels vs plain twins on the card: {kernel: (max |kernel - plain|,
    launches)}."""
    import torch

    from strainscan_tpu_torch.index.hashtable import (KmerTable,
                                                      fp_table_to_device,
                                                      kmer_table_to_device)
    from strainscan_tpu_torch.ops import probe
    from strainscan_tpu_torch.ops.count import CountPipeline

    def err(a, b) -> int:
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    rng = np.random.default_rng(11)
    errs = {name: 0 for name in probe.LAUNCHES}
    probe.reset_launches()
    n_probe = 0
    for length in PARITY_LENGTHS:
        codes = rng.integers(0, 4, size=(BATCH, length)).astype(np.uint8)
        codes[rng.random(codes.shape) < 0.05] = 4
        cd = torch.from_numpy(codes).to(dev)
        for k in PARITY_KS:
            for canonical in (False, True):
                kw = dict(k=k, n_buckets=1 << 20, seed=7, canonical=canonical)
                b, f = probe.probe_prep(cd, **kw)
                pb, pf = probe.probe_prep_plain(cd, **kw)
                sync(dev)
                check(torch.equal(b, pb) and torch.equal(f, pf),
                      f"probe_prep L={length} k={k} canonical={canonical}")
                errs["probe_prep_kernel"] = max(
                    errs["probe_prep_kernel"], err(b, pb), err(f, pf))
                n_probe += 1
    log(f"[parity] probe_prep_kernel bit-exact in {n_probe} cases "
        f"(B={BATCH}, L in {PARITY_LENGTHS}, k in {PARITY_KS}, canonical "
        f"on/off) [{tag}]")

    genome = rng.integers(0, 4, size=400_000).astype(np.uint8)
    keys = genome_keys(genome, dev)
    fpt = fp_table(keys)
    table = fp_table_to_device(fpt, dev)
    reads = np.full((BATCH, 156), 4, np.uint8)
    reads[:, :READ_LEN] = sample_reads(rng, genome, BATCH)
    reads[: BATCH // 8] = rng.integers(0, 4, size=(BATCH // 8, 156))
    dirty = reads.copy()
    dirty[::9, 60] = 4
    for name, codes, packed in (("vlen", reads, True),
                                ("vbytes", dirty, True),
                                ("codes", dirty, False)):
        (payload,) = CountPipeline(fpt, dev, packed_transfer=packed) \
            .prepare_batch(codes)
        check(payload[0] == name, f"payload form {payload[0]} != {name}")
        words = payload[1].to(dev)
        valid = {} if payload[2] is None else {name: payload[2].to(dev)}
        c1 = torch.zeros(fpt.n_slots + 1, dtype=torch.int32, device=dev)
        c2 = c1.clone()
        kw = dict(length=156, k=K, seed=fpt.seed, **valid)
        probe.count_fp(c1, words, table.fp, **kw)
        probe.count_fp_plain(c2, words, table.fp, **kw)
        sync(dev)
        check(torch.equal(c1, c2), f"count_fp {name} != plain")
        errs["count_fp_kernel"] = max(errs["count_fp_kernel"], err(c1, c2))
        log(f"[parity] count_fp_kernel {name}: bit-exact, "
            f"{int(c1[:-1].sum())} hits, {int(c1[-1])} trash "
            f"(table {fpt.n_keys} keys) [{tag}]")

    kt = KmerTable.build(keys, k=K, load_factor=0.9)
    ktab = kmer_table_to_device(kt, dev)
    check(kt.max_probe > 1, "the load-0.9 table must overflow buckets")
    for name, codes, packed in (("vbytes", dirty, True),
                                ("codes", dirty, False)):
        (payload,) = CountPipeline(kt, dev, packed_transfer=packed,
                                   probe_mode="exact").prepare_batch(codes)
        check(payload[0] == name, f"payload form {payload[0]} != {name}")
        words = payload[1].to(dev)
        valid = {} if payload[2] is None else {name: payload[2].to(dev)}
        for canonical in (False, True):
            c1 = torch.zeros(kt.n_keys + 1, dtype=torch.int32, device=dev)
            c2 = c1.clone()
            kw = dict(length=156, k=K, max_probe=kt.max_probe,
                      canonical=canonical, **valid)
            probe.count_exact(c1, words, ktab.table, **kw)
            probe.count_exact_plain(c2, words, ktab.table, **kw)
            sync(dev)
            check(torch.equal(c1, c2),
                  f"count_exact {name} canonical={canonical} != plain")
            errs["count_exact_kernel"] = max(errs["count_exact_kernel"],
                                             err(c1, c2))
            log(f"[parity] count_exact_kernel {name} canonical={canonical}: "
                f"bit-exact, {int(c1[:-1].sum())} hits, {int(c1[-1])} trash "
                f"(table {kt.n_keys} keys, max_probe {kt.max_probe}) [{tag}]")
    launches = dict(probe.LAUNCHES)
    check(launches == {"probe_prep_kernel": n_probe, "count_fp_kernel": 3,
                       "count_exact_kernel": 4},
          f"parity launches {launches}")
    log(f"[parity] kernel launches {launches}")
    return {name: (errs[name], launches[name]) for name in errs}


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def fp_table(keys: np.ndarray):
    """``FpTable.build`` of the shared host code (ids = key order)."""
    from strainscan_tpu_torch.index.hashtable import FpTable

    return FpTable.build(keys, k=K)


def phase_count(dev, tag: str) -> dict:
    """E. coli-scale count in fp mode; returns the fixture (keys, fpt, fq,
    reads), the id-space counts and the kernel and plain timings in ms."""
    import torch

    from strainscan_tpu_torch.identify.count import (count_sample,
                                                     iter_payloads)
    from strainscan_tpu_torch.ops import probe
    from strainscan_tpu_torch.ops.count import CountPipeline

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    genome = rng.integers(0, 4, size=GENOME_LEN).astype(np.uint8)
    keys = genome_keys(genome, dev)
    fpt = fp_table(keys)
    log(f"[count] table: {keys.size} keys, fp geometry {fpt.n_buckets} x "
        f"{fpt.bucket}, seed {fpt.seed}, built in "
        f"{time.perf_counter() - t0} s (host)")
    check(keys.size > 1.99 * GENOME_LEN, "both-strand key count")

    n_miss, n_n = int(N_READS * MISS_SHARE), int(N_READS * N_SHARE)
    n_hit = N_READS - n_miss - n_n
    reads = np.concatenate([
        sample_reads(rng, genome, n_hit),
        rng.integers(0, 4, size=(n_miss, READ_LEN)).astype(np.uint8),
        sample_reads(rng, genome, n_n)])
    pos = rng.integers(10, READ_LEN - 10, size=n_n)
    reads[np.arange(n_hit + n_miss, N_READS), pos] = 4   # mid-read N
    fq = os.path.join(FIXTURE, "ecoli_reads.fq")
    write_fastq(fq, reads)

    times = []
    ids = None
    for rep in range(COUNT_REPS):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = count_sample(fpt, fq, dev)
        times.append(time.perf_counter() - t0)
        check(ids is None or np.array_equal(got, ids), "repeat count differs")
        ids = got
        log(f"[count] rep {rep}: {times[-1]} s, "
            f"{N_READS / times[-1]} reads/s end to end "
            f"({'cold: includes the table upload' if rep == 0 else 'warm'}) "
            f"[{tag}]")
    check(ids.sum() > 0.8 * n_hit * (READ_LEN - K + 1), "too few hits")

    # the plain PyTorch path on the same payloads, on the same device
    pipe = CountPipeline(fpt, dev)
    table = pipe.table
    plain = torch.zeros_like(pipe.counts)
    forms = set()
    for payloads in iter_payloads(pipe, fq):
        for form, a, b in payloads:
            forms.add(form)
            kw = dict(length=MAXLEN, k=K, seed=fpt.seed, **{form: b.to(dev)})
            probe.count_fp(pipe.counts, a.to(dev), table.fp, **kw)
            probe.count_fp_plain(plain, a.to(dev), table.fp, **kw)
    check(forms == {"vlen", "vbytes"}, f"payload forms seen: {forms}")
    check(torch.equal(pipe.counts, plain), "slot counts != plain path")
    plain_ids = plain.index_select(0, table.slot_of_id).cpu().numpy()
    check(np.array_equal(ids, plain_ids), "id-space counts != plain path")
    log(f"[count] id-space counts equal the plain path's over all "
        f"{N_READS} reads ({int(ids.sum())} hits, forms {sorted(forms)})")

    # one batch against the host NumPy oracle: the last batch (random
    # misses and mid-read Ns)
    batch = reads[-BATCH:]
    one = CountPipeline(fpt, dev)
    one.add_batch(batch)
    got_slots = one.counts.cpu().numpy()
    wkeys, valid = host_window_keys(batch)
    q = wkeys[valid]
    slots = np.concatenate([fpt.lookup_host(q[i:i + 1_000_000])
                            for i in range(0, q.size, 1_000_000)])
    want = np.bincount(slots[slots >= 0], minlength=fpt.n_slots)
    check(np.array_equal(got_slots[:-1], want), "slot counts != host oracle")
    check(int(got_slots[-1]) == wkeys.size - int((slots >= 0).sum()),
          "trash slot != non-hit windows")
    log(f"[count] one batch equals the host oracle ({wkeys.size} windows, "
        f"{int((slots >= 0).sum())} hits)")

    # kernel against the plain twin at B = 65,536 x L = 150
    (payload,) = CountPipeline(fpt, dev).prepare_batch(reads[:BATCH])
    words, valid_t = payload[1].to(dev), payload[2].to(dev)
    kw = dict(length=READ_LEN, k=K, seed=fpt.seed, **{payload[0]: valid_t})
    scratch = torch.zeros_like(pipe.counts)
    codes = torch.from_numpy(np.ascontiguousarray(reads[:BATCH])).to(dev)
    pkw = dict(k=K, n_buckets=fpt.n_buckets, seed=fpt.seed)
    ms = {"count_fp": [], "count_plain": [], "prep": [], "prep_plain": []}
    for order in ("plain", "kernel", "kernel", "plain"):
        if order == "kernel":
            ms["count_fp"].append(cuda_ms(
                lambda: probe.count_fp(scratch, words, table.fp, **kw), 20))
            ms["prep"].append(cuda_ms(
                lambda: probe.probe_prep(codes, **pkw), 20))
        else:
            ms["count_plain"].append(cuda_ms(
                lambda: probe.count_fp_plain(scratch, words, table.fp, **kw),
                3))
            ms["prep_plain"].append(cuda_ms(
                lambda: probe.probe_prep_plain(codes, **pkw), 3))
    windows = BATCH * (READ_LEN - K + 1)
    k_ms = min(ms["count_fp"])
    log(f"[count] count_fp_kernel {ms['count_fp']} ms vs plain "
        f"{ms['count_plain']} ms per batch of {BATCH} x {READ_LEN} "
        f"({payload[0]}); kernel {windows / (k_ms / 1e3)} windows/s "
        f"[{tag}]")
    log(f"[count] probe_prep_kernel {ms['prep']} ms vs plain "
        f"{ms['prep_plain']} ms per batch of {BATCH} x {READ_LEN} [{tag}]")
    return dict(keys=keys, fpt=fpt, fq=fq, reads=reads, ids=ids, ms=ms)


def phase_exact(dev, tag: str, ctx: dict) -> dict:
    """The exact probe mode over phase 3's reads: its id-space counts, the
    exact path's launches and the kernel and plain timings in ms."""
    import torch

    from strainscan_tpu_torch.identify.count import iter_payloads
    from strainscan_tpu_torch.index.hashtable import KmerTable
    from strainscan_tpu_torch.ops import probe
    from strainscan_tpu_torch.ops.count import CountPipeline

    keys, fq, reads = ctx["keys"], ctx["fq"], ctx["reads"]
    t0 = time.perf_counter()
    kt = KmerTable.build(keys, k=K)
    log(f"[exact] table: {kt.n_keys} keys, {kt.n_buckets} buckets x 96 B = "
        f"{kt.n_buckets * 96 / 2**30} GiB, max_probe {kt.max_probe}, built "
        f"in {time.perf_counter() - t0} s (host)")

    probe.reset_launches()
    ids = None
    for rep in range(COUNT_REPS):
        sync(dev)
        t0 = time.perf_counter()
        pipe = CountPipeline(kt, dev, probe_mode="exact")
        for payloads in iter_payloads(pipe, fq):
            pipe.add_prepared(payloads)
        got = pipe.finish()
        dt = time.perf_counter() - t0
        check(ids is None or np.array_equal(got, ids), "repeat count differs")
        ids = got
        log(f"[exact] rep {rep}: {dt} s, {N_READS / dt} reads/s end to end "
            f"({'cold: includes the table upload' if rep == 0 else 'warm'}) "
            f"[{tag}]")
    launches = probe.LAUNCHES["count_exact_kernel"]
    check(launches > 0 and probe.LAUNCHES["count_fp_kernel"] == 0,
          f"exact path launches {dict(probe.LAUNCHES)}")
    log(f"[exact] exact-path kernel launches {dict(probe.LAUNCHES)}")

    # the plain PyTorch path on the same payloads, on the same device
    pipe = CountPipeline(kt, dev, probe_mode="exact")
    table = pipe.table
    plain = torch.zeros_like(pipe.counts)
    forms = set()
    for payloads in iter_payloads(pipe, fq):
        for form, a, b in payloads:
            forms.add(form)
            kw = dict(length=MAXLEN, k=K, max_probe=kt.max_probe,
                      **{form: b.to(dev)})
            probe.count_exact(pipe.counts, a.to(dev), table.table, **kw)
            probe.count_exact_plain(plain, a.to(dev), table.table, **kw)
    check(forms == {"vbytes"}, f"exact payload forms seen: {forms}")
    check(torch.equal(pipe.counts, plain), "exact counts != plain path")
    check(np.array_equal(ids, plain[:-1].cpu().numpy()),
          "exact id-space counts != plain path")
    strays = np.nonzero(ids != ctx["ids"])[0]
    log(f"[exact] id-space counts equal the plain path's over all {N_READS} "
        f"reads ({int(ids.sum())} hits); ids whose fp-mode count differs "
        f"(fingerprint strays): {strays.size}, fp minus exact "
        f"{int(ctx['ids'][strays].sum()) - int(ids[strays].sum())} counts")

    # one batch against the host NumPy oracle
    batch = reads[-BATCH:]
    one = CountPipeline(kt, dev, probe_mode="exact")
    one.add_batch(batch)
    got = one.counts.cpu().numpy()
    wkeys, valid = host_window_keys(batch)
    q = wkeys[valid]
    hits = np.concatenate([kt.lookup_host(q[i:i + 1_000_000])
                           for i in range(0, q.size, 1_000_000)])
    want = np.bincount(hits[hits >= 0], minlength=kt.n_keys)
    check(np.array_equal(got[:-1], want), "exact counts != host oracle")
    check(int(got[-1]) == wkeys.size - int((hits >= 0).sum()),
          "exact trash != non-hit windows")
    log(f"[exact] one batch equals KmerTable.lookup_host + bincount "
        f"({wkeys.size} windows, {int((hits >= 0).sum())} hits)")

    # kernel against the plain twin at B = 65,536 x L = 150 (vbytes, the
    # form the exact mode ships)
    (payload,) = CountPipeline(kt, dev, probe_mode="exact").prepare_batch(
        reads[:BATCH])
    words, valid_t = payload[1].to(dev), payload[2].to(dev)
    kw = dict(length=READ_LEN, k=K, max_probe=kt.max_probe,
              **{payload[0]: valid_t})
    scratch = torch.zeros_like(pipe.counts)
    ms = {"count_exact": [], "count_exact_plain": []}
    for order in ("plain", "kernel", "kernel", "plain"):
        if order == "kernel":
            ms["count_exact"].append(cuda_ms(lambda: probe.count_exact(
                scratch, words, table.table, **kw), 20))
        else:
            ms["count_exact_plain"].append(cuda_ms(
                lambda: probe.count_exact_plain(scratch, words, table.table,
                                                **kw), 3))
    windows = BATCH * (READ_LEN - K + 1)
    log(f"[exact] count_exact_kernel {ms['count_exact']} ms vs plain "
        f"{ms['count_exact_plain']} ms per batch of {BATCH} x {READ_LEN} "
        f"({payload[0]}); kernel {windows / (min(ms['count_exact']) / 1e3)} "
        f"windows/s [{tag}]")
    return dict(ids=ids, launches=launches, ms=ms)


def synth_db_inputs(rng):
    """40 families x up to 3 variants x 100 kb (even families carry
    variants 30 * (v + 1) SNPs from the base), plus three samples."""
    gdir = os.path.join(FIXTURE, "genomes")
    os.makedirs(gdir)
    seqs = {}
    for f in range(FAMILIES):
        base = rng.integers(0, 4, size=GLEN).astype(np.uint8)
        for v in range(VARIANTS if f % 2 == 0 else 1):
            s = base.copy()
            if v:
                p = rng.choice(GLEN, size=30 * (v + 1), replace=False)
                s[p] = (s[p] + rng.integers(1, 4, size=p.size)) % 4
            name = f"F{f:03d}V{v}"
            seqs[name] = s
            with open(os.path.join(gdir, name + ".fa"), "w") as fh:
                fh.write(f">{name}\n{np.frombuffer(b'ACGT', np.uint8)[s].tobytes().decode()}\n")
    mixes = {"single": [("F001V0", 10)],
             "cross": [("F001V0", 8), ("F002V0", 8)],
             "intra": [("F000V0", 10), ("F000V2", 10)]}
    samples = {}
    for name, parts in mixes.items():
        reads = np.concatenate([sample_reads(rng, seqs[s], GLEN * d // READ_LEN)
                                for s, d in parts])
        reads = reads[rng.permutation(reads.shape[0])]
        samples[name] = os.path.join(FIXTURE, f"{name}.fq")
        write_fastq(samples[name], reads)
    truth = {name: {s for s, _ in parts} for name, parts in mixes.items()}
    return gdir, samples, truth


def tree_bytes(out_dir: str) -> dict:
    files = {}
    for root, _, names in os.walk(out_dir):
        for n in names:
            if n == "final_report.txt" or n == "StrainVote.report" \
                    or n == "strain_prob.txt":
                p = os.path.join(root, n)
                with open(p, "rb") as fh:
                    files[os.path.relpath(p, out_dir)] = fh.read()
    return files


def phase_identify(tag: str):
    """identify / batch-identify on GPU and CPU; main-path kernel launches
    and the fixture (DB, samples, report directory)."""
    from strainscan_tpu_torch import cli
    from strainscan_tpu_torch.ops import probe

    rng = np.random.default_rng(5)
    gdir, samples, truth = synth_db_inputs(rng)
    db = os.path.join(FIXTURE, "DB")
    t0 = time.perf_counter()
    check(cli.main(["build", "-i", gdir, "-o", db, "-t", "8"]) == 0, "build")
    log(f"[identify] DB of {FAMILIES} families ({len(os.listdir(gdir))} "
        f"genomes x {GLEN} bp) built in {time.perf_counter() - t0} s "
        f"(host)")
    names = sorted(samples)
    out = os.path.join(FIXTURE, "out")
    secs: dict = {}

    def run(device: str) -> None:
        for name in names:
            t = time.perf_counter()
            rc = cli.main(["identify", "-i", samples[name], "-d", db, "-o",
                           os.path.join(out, device, name),
                           "--device", device])
            secs[f"{device}/{name}"] = time.perf_counter() - t
            check(rc == 0, f"identify {name} on {device}")
        t = time.perf_counter()
        rc = cli.main(["batch-identify", "-i", *(samples[n] for n in names),
                       "-d", db, "-o", os.path.join(out, device, "batch"),
                       "--device", device])
        secs[f"{device}/batch"] = time.perf_counter() - t
        check(rc == 0, f"batch-identify on {device}")

    probe.reset_launches()
    run(GPU)
    launches = dict(probe.LAUNCHES)
    check(launches["count_fp_kernel"] > 0, f"main path launches {launches}")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "strainscan_tpu_torch.cli", "identify", "-i",
         samples["single"], "-d", db, "-o",
         os.path.join(out, "process", "single"), "--device", GPU],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    secs["process/single"] = time.perf_counter() - t
    check(proc.returncode == 0, f"python -m strainscan_tpu_torch.cli "
          f"identify failed:\n{proc.stderr[-4000:]}")
    run("cpu")

    pairs = [(os.path.join(out, GPU, n), os.path.join(out, "cpu", n))
             for n in names]
    pairs += [(os.path.join(out, GPU, "batch", n),
               os.path.join(out, "cpu", "batch", n)) for n in names]
    pairs.append((os.path.join(out, "process", "single"),
                  os.path.join(out, "cpu", "single")))
    n_files = 0
    for gpu_dir, cpu_dir in pairs:
        a, b = tree_bytes(gpu_dir), tree_bytes(cpu_dir)
        check(sorted(a) == sorted(b) and "final_report.txt" in a,
              f"report sets differ: {gpu_dir}")
        for f in a:
            check(a[f] == b[f], f"{gpu_dir}/{f} differs from the CPU run")
        n_files += len(a)
    found = {}
    for n in names:
        with open(os.path.join(out, GPU, n, "final_report.txt")) as fh:
            rows = fh.read().splitlines()[1:]
        found[n] = sorted({r.split("\t")[1] for r in rows})
        check(truth[n] <= set(found[n]),
              f"{n}: truth {sorted(truth[n])} not in {found[n]}")
    enet = os.path.join(out, GPU, "intra")
    check(any(f.endswith("StrainVote.report") for f in tree_bytes(enet)),
          "intra-cluster sample did not reach the L2 vote")
    log(f"[identify] {n_files} report files byte-identical between GPU and "
        f"CPU runs; found {found}")
    warm = secs[GPU + "/batch"] / len(names)
    log(f"[identify] GPU s/sample: cold (first in process) "
        f"{secs[GPU + '/' + names[0]]}, warm (batch-identify) {warm}, "
        f"fresh process {secs['process/single']}; CPU warm "
        f"{secs['cpu/batch'] / len(names)} [{tag}]")
    log(f"[identify] main-path kernel launches {launches}")
    return launches, dict(db=db, samples=samples, out=out)


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def same_reports(got_dir: str, want_dir: str, what: str) -> int:
    """Check two report trees byte-identical; return the file count."""
    a, b = tree_bytes(got_dir), tree_bytes(want_dir)
    check(sorted(a) == sorted(b) and "final_report.txt" in a,
          f"{what}: report sets differ ({sorted(a)} vs {sorted(b)})")
    for f in a:
        check(a[f] == b[f], f"{what}: {f} differs from the single-device "
              f"GPU run")
    return len(a)


def phase_scale(dev, tag: str, count: dict, exact: dict,
                ident: dict) -> None:
    """Sharded counts and identify on a mesh, and a 2-process run."""
    import dataclasses

    import torch

    from strainscan_tpu_torch.identify import count as icount
    from strainscan_tpu_torch.identify.count import IdentifyConfig
    from strainscan_tpu_torch.identify.pipeline import run_identify
    from strainscan_tpu_torch.ops import probe
    from strainscan_tpu_torch.parallel import (ShardedTable, make_mesh,
                                               sharded_count)

    n_gpu = torch.cuda.device_count()
    mesh = make_mesh() if n_gpu > 1 else make_mesh([dev] * 4)
    n_dev = len({str(d) for d in mesh.devices})
    log(f"[scale] {mesh}: {mesh.shape['data']} x {mesh.shape['index']} "
        f"(data x index) positions on {n_dev} distinct device(s)"
        + (" -- one card: all four positions are cuda:0" if n_gpu == 1
           else ""))
    keys, reads = count["keys"], count["reads"]

    t0 = time.perf_counter()
    st = ShardedTable.build(keys, k=K, n_shards=mesh.shape["index"])
    log(f"[scale] ShardedTable of {keys.size} keys in "
        f"{mesh.shape['index']} shards ({st.n_buckets} buckets each, "
        f"max_probe {st.max_probe}) built in {time.perf_counter() - t0} s "
        f"(host)")
    probe.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    got = sharded_count(mesh, st, reads)
    sync(dev)
    dt = time.perf_counter() - t0
    check(probe.LAUNCHES["count_exact_kernel"] == mesh.size,
          f"sharded_count launches {dict(probe.LAUNCHES)}")
    check(np.array_equal(got[:keys.size].cpu().numpy(), exact["ids"]),
          "sharded_count != the single-device exact counts")
    log(f"[scale] sharded_count (exact, one count_exact_kernel per "
        f"position) equals the single-device exact counts over {N_READS} "
        f"reads; {dt} s including the shard and read uploads [{tag}]")

    cfg = dataclasses.replace(IdentifyConfig(), shard_min_kmers=1)
    icount._SHARDED_CACHE.clear()
    for rep in range(2):
        probe.reset_launches()
        sync(dev)
        t0 = time.perf_counter()
        ids = icount.count_sample(count["fpt"], count["fq"], mesh, cfg,
                                  keys=keys)
        dt = time.perf_counter() - t0
        launched = probe.LAUNCHES["count_fp_kernel"]
        check(launched > 0 and launched % mesh.size == 0,
              f"sharded pipeline launches {dict(probe.LAUNCHES)}")
        check(np.array_equal(ids, count["ids"]),
              "sharded count_sample != the single-device fp counts")
        log(f"[scale] sharded count_sample rep {rep}: equal to the "
            f"single-device counts, {dt} s, {N_READS / dt} reads/s end to "
            f"end ({'cold: includes the sharded fp build and uploads' if rep == 0 else 'warm: cached pipeline'}), "
            f"{launched} count_fp_kernel launches [{tag}]")
    icount._SHARDED_CACHE.clear()

    db, samples, out = ident["db"], ident["samples"], ident["out"]
    names = sorted(samples)
    cfg = dataclasses.replace(IdentifyConfig(), shard_min_kmers=1,
                              shard_min_l2_rows=1)
    probe.reset_launches()
    secs = []
    for name in names:
        t0 = time.perf_counter()
        check(run_identify(samples[name], "", db,
                           os.path.join(out, "mesh", name), mesh, cfg)
              is not None, f"mesh identify {name}")
        secs.append(time.perf_counter() - t0)
    launched = probe.LAUNCHES["count_fp_kernel"]
    check(launched > 0 and launched % mesh.size == 0
          and all(p.mesh is mesh for _, _, p in icount._SHARDED_CACHE),
          f"mesh identify did not run the sharded pipeline: "
          f"{dict(probe.LAUNCHES)}")
    n_files = sum(same_reports(os.path.join(out, "mesh", n),
                               os.path.join(out, GPU, n), f"mesh {n}")
                  for n in names)
    log(f"[scale] sharded identify (shard_min_kmers=1, shard_min_l2_rows=1) "
        f"of {names}: {n_files} report files byte-identical to the "
        f"single-device GPU run; {launched} count_fp_kernel launches; "
        f"s/sample {secs} [{tag}]")
    icount._SHARDED_CACHE.clear()

    port = free_port()
    procs = []
    try:
        for rank in range(2):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "strainscan_tpu_torch.cli",
                 "batch-identify", "-i", *(samples[n] for n in names), "-d",
                 db, "-o", os.path.join(out, f"rank{rank}"), "--device",
                 GPU], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        t0 = time.perf_counter()
        errs = [p.communicate(timeout=600)[1] for p in procs]
        dt = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, err) in enumerate(zip(procs, errs)):
        check(p.returncode == 0, f"2-process batch-identify rank {rank} "
              f"failed:\n{err[-4000:]}")
        check("multi-host run: process %d/2" % rank in err,
              f"rank {rank} did not join the process group")
    n_files = sum(same_reports(os.path.join(out, f"rank{rank}", n),
                               os.path.join(out, GPU, "batch", n),
                               f"rank {rank} {n}")
                  for rank in range(2) for n in names)
    log(f"[scale] 2-process gloo batch-identify of {names} on one card: "
        f"{n_files} report files byte-identical to the single-device GPU "
        f"run; {dt} s for both processes, start-up included [{tag}]")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this smoke run needs a "
              "CUDA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "strainscan_tpu_torch")):
        print("strainscan_tpu_torch/ is not beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = card_line()
    dev = torch.device("cuda", 0)
    shutil.rmtree(FIXTURE, ignore_errors=True)
    os.makedirs(FIXTURE)

    phase_env(tag)
    parity = phase_parity(dev, tag)
    count = phase_count(dev, tag)
    exact = phase_exact(dev, tag, count)
    launches, ident = phase_identify(tag)
    phase_scale(dev, tag, count, exact, ident)
    shutil.rmtree(FIXTURE, ignore_errors=True)

    ms = {**count["ms"], **exact["ms"]}
    src = "strainscan_tpu_torch/csrc/"
    kernels = [{
        "name": "probe_prep_kernel", "route": "cuda",
        "source": src + "probe_count.cu",
        "replaces": "strainscan_tpu/ops/pallas_probe.py:168",
        "launches": launches["probe_prep_kernel"],
        "parity_launches": parity["probe_prep_kernel"][1],
        "max_abs_err": parity["probe_prep_kernel"][0],
        "ms": min(ms["prep"]), "plain_ms": min(ms["prep_plain"]),
    }, {
        "name": "count_fp_kernel", "route": "cuda",
        "source": src + "probe_count.cu",
        "replaces": "strainscan_tpu/ops/pallas_probe.py:168",
        "launches": launches["count_fp_kernel"],
        "max_abs_err": parity["count_fp_kernel"][0],
        "ms": min(ms["count_fp"]), "plain_ms": min(ms["count_plain"]),
    }, {
        "name": "count_exact_kernel", "route": "cuda",
        "source": src + "count_exact.cu",
        "replaces": "strainscan_tpu/ops/count.py:32",
        "launches": exact["launches"],
        "max_abs_err": parity["count_exact_kernel"][0],
        "ms": min(ms["count_exact"]), "plain_ms": min(ms["count_exact_plain"]),
    }]
    print(tag)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
