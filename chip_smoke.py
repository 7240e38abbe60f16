#!/usr/bin/env python3
"""Smoke run of the PyTorch port (strainscan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Before the first phase the process refuses every import of jax and of the
JAX package (strainscan_tpu), so the run proves the port stands alone.

Phases (any failure raises and exits non-zero; nothing is passed over):

1. Environment: card name and power limit, torch/CUDA/nvcc versions; build
   the CUDA kernels from csrc/*.cu and time the build.
2. Kernel parity on the card, bit-exact against the plain twins:
   probe_prep_kernel on random codes with ~5 % N (B = 65,536, L in
   {150, 256}, k in {31, 21, 16, 15}, canonical on and off); count_fp, and
   each of its four binned kernels (fp_coarse_count_kernel,
   fp_coarse_scatter_kernel, fp_fine_split_kernel, fp_bin_probe_kernel;
   ops.probe.fp_bin_parity), on a random table of 128 bins with vlen,
   vbytes and raw codes payloads, on one of 16 bins and at the L2 union
   count's shape (a 7,400-key table of 256 x 64, one bin, and 65,536 reads
   of 100 bp padded to L = 256; count_fp launches no fine split for a
   table whose coarse bins are each one fine bin, and spreads a bin's
   windows over the card's blocks);
   count_exact, and each of its two kernels (count_exact_kernel,
   exact_apply_kernel; ops.probe.exact_parity), on a random KmerTable at
   load 0.9 (so windows probe past their home row) with vbytes, vlen and
   codes payloads at L = 150 and padded to L = 256, canonical on and off.
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
   from the fp counts (fingerprint strays) are counted.  Each count's
   stream-end fetch (ops.count.FETCHES) is logged (route, nnz, d2h bytes,
   slot_of_id upload) and must take the route the JAX package's rule gives
   for its stats; ops.count.fetch_counts is run on device vectors of
   28,588,812 ids forced onto each route (sparse and dense at one, two and
   four bytes a value, and all zeros), each bit-exact against .cpu() of
   the same tensor, and timed beside that copy.  Times (CUDA
   events, in turns): end-to-end reads/s of both modes; probe_prep_kernel
   against its plain twin at B = 65,536 x L = 150 and padded to L = 256;
   count_exact where the exact stream runs it (65,536 reads padded to
   L = 256, vbytes) and at L = 150 against its plain twin, and each of its
   kernels alone; count_fp at identify's shape (65,536 reads of 150 bp padded to
   L = 256, vlen) and at L = 150 against its plain twin, each binned kernel
   held against its twin there and timed alone (the fine split beside
   torch.sort of the pairs as int64 keys), and the bin sort of its first
   three kernels as a whole.  At the L2 union count's shape: count_fp
   against its plain twin (no fine split launched), the coarse passes and
   the probe alone, and the fine split called alone beside torch.sort.
   Every kernel's bound (bytes each read or
   written once over 3.35 TB/s, or integer operations over 67 T/s) comes
   from this run's data: the distinct table rows and count sectors the
   windows touch; the bin sort's bound is the payload read once and the
   pairs and bin starts written once, whatever the design.  The launches of
   each kernel per 1.2 M-read sample are counted.
4. End-to-end identify through the CLI entry point on a synthetic DB:
   single-strain, cross-cluster and intra-cluster (Enet) samples with
   ``identify`` and then ``batch-identify`` on the GPU, once more in a
   fresh ``python -m strainscan_tpu_torch.cli`` process, and all again with
   ``--device cpu``.  Every report must be byte-identical between GPU and
   CPU, the truth strains must be found, and the kernels' launch counters
   (reset just before the GPU runs) must show the runs went through them;
   the L2 union counts' share of them must hold no fine split.
5. Scale-out: a mesh over every visible GPU, or on a card that is alone a
   2 x 2 mesh whose four positions are all that card.  The sharded exact
   count (sharded_count) and the sharded fp pipeline (count_sample with
   shard_min_kmers=1) over phase 3's reads must equal phase 3's
   single-device counts (the sharded exact count three times over);
   phase 4's samples identified on the mesh with
   shard_min_kmers=1, shard_min_l2_rows=1 must give reports byte-identical
   to phase 4's GPU reports, with fp_bin_probe_kernel launched once per
   mesh position per batch; and a 2-process gloo run of ``batch-identify`` on
   the same card (torchrun's variables set by hand) must give
   byte-identical reports too.
6. The measurement path.  row_gather_kernel (the port of the Pallas
   dma_gather_kernel of benchmarks/probe_bench3.py) bit-exact against its
   plain twin at row widths 64, 128 and 24 and (tile, nbuf) in {(2048, 8),
   (2048, 16), (8192, 16)}, with indices past the last whole tile, at the
   plan's chunks and (widths 128 and 24) at chunks forced small, each plan
   logged; the gather section of bench.probe_study at full size (a 256 MiB
   table, 2^23 indices; every tile of every configuration equal to the
   NumPy oracle, the kernel timed against its plain twin, and again on a
   16 MiB table, its L2-served floor); entry("cuda") equal to
   entry("cpu"); bench.count's ecoli tier with one rep (its
   triple-stream and host-oracle checks held); and the trace hook: a build
   and a GPU identify through the CLI with STRAINSCAN_TRACE_DIR set write
   one torch.profiler trace per phase, the count's with
   fp_bin_probe_kernel's device events, and reports byte-identical to an
   untraced run.
7. Identify at E. coli scale: bench.scale_fixture builds its fixture
   from nothing (823 synthetic families, 1,647 genomes of 100 kb, a DB of
   1,181 clusters over 28,588,812 keys; no reference-layout export) and its
   samples single, crossmix, intramix and deep (1.2 M reads of 100 bp);
   bench.scale_parity identifies the four cold and then warm on the GPU,
   and the first three on the CPU.  Every report must be byte-identical
   between them, the truth strains found, intramix must reach the Enet
   vote, the DB's table must be uploaded once, every GPU sample must
   launch each of count_fp's kernels, and every finish (each sample's main
   count and L2 union count) is logged and must take the JAX rule's fetch
   route for its stats.

Each path's launch counters are set to 0 just before it and read just
after: the main path, each sample of phase 7's E. coli-scale identify
(summed), for count_fp's kernels (its 28.6 M-key table has 4,096 fine bins,
so the fine split runs in its count; the L2 union counts' tables, one bin
each, launch none: at_union); phase 4's GPU identify for them again
(launches_synth: a table of at most 256 fine bins, each its own coarse
bin, as its DB's may be, launches no fine split); the
exact-mode count of phase 3 for count_exact's two kernels, the study's gather
section of phase 6 for row_gather_kernel.  probe_prep_kernel is
the standalone parity seam of the Pallas probe_prep, on no path (its hash
runs fused inside the count kernels), so its main-path count is 0 and the
kernels line also gives its phase-2 launches.

Reduced for time: phase 4's DB is 40 families x up to 3 variants x 100 kb
(80 genomes); phase 7 runs identify at the E. coli DB's size, without
batch-identify, the fresh process and the deep sample on the CPU (the full
set is ``python -m strainscan_tpu_torch.bench.scale_parity``); phases 3
and 5 keep the count at the full 28.6 M-key table; phase 6 runs bench.count's
ecoli tier with one rep of its three passes (bench.count runs five).

Prints progress with the card's name and power limit beside every number,
then the card line, a JSON line of the kernels (each with its launches on
its path and per sample, max_abs_err, ms, plain_ms, bound_ms, bound_by and
library_ms: index_add_ for exact_apply_kernel, torch.sort for
fp_fine_split_kernel, else null, as no single PyTorch call computes the
others; fp_bin_probe_kernel and fp_fine_split_kernel also at_union: ms,
bound_ms and their launches in phase 4's L2 union counts; row_gather_kernel
also l2_floor_ms, its time on a 16 MiB table), and as the last line
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
# phase 6: the row gather's parity shapes (a tail past the last whole tile)
# and the study configuration the kernels line reports
GATHER_ROWS, GATHER_W = 1 << 18, (1 << 20) + 1000
# a chunk forced small: 27 chunks of the parity table, the last ragged
GATHER_SMALL_CHUNK = 10_000
STUDY_CONFIG = "tile2048_nbuf16"
# the binned count_fp: its kernels in launch order
FP_KERNELS = ("fp_coarse_count_kernel", "fp_coarse_scatter_kernel",
              "fp_fine_split_kernel", "fp_bin_probe_kernel")
# ms of the bin sort that the three kernels before fp_bin_probe_kernel
# replaced (fp_bin_count_kernel + bin_scan_kernel + fp_bin_scatter_kernel),
# per batch of 65,536 reads of 150 bp (L = 150, vlen) on an H100 80GB HBM3
# at 700 W (PERF.md, section 6)
PARENT_FRONT_MS = 0.3885
# the kernels of count_exact, in launch order
EXACT_KERNELS = ("count_exact_kernel", "exact_apply_kernel")
# runs of phase 5's sharded exact count, each held against phase 3's counts
SHARDED_REPS = 3
# phase 7: the E. coli-scale samples also identified on the CPU
ECOLI_CPU = ("single", "crossmix", "intramix")
# integer operations per hashed window: four fmix32 of 8 operations, the
# seed and constant XORs, and the rolling forward and reverse keys
HASH_OPS = 44



def block_jax_package() -> None:
    """Refuse every import of jax and of the JAX package (strainscan_tpu,
    not the port, and its scripts in benchmarks/) in this process, so the
    run proves the port stands alone."""
    import importlib.abc

    def blocked(name: str) -> bool:
        return (name in ("jax", "jaxlib", "strainscan_tpu", "benchmarks")
                or name.startswith(("jax.", "jaxlib.", "strainscan_tpu.",
                                    "benchmarks.")))

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"{name} is blocked: the port stands alone")
            return None

    for name in [m for m in sys.modules if blocked(m)]:
        del sys.modules[name]
    sys.meta_path.insert(0, Block())


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def jax_fetch_route(f: dict) -> tuple:
    """(route, bytes per value) that the JAX package's fetch rule gives for
    a fetch's stats: strainscan_tpu/ops/count.py:256-266 for an id-space
    vector, :433-438 for the fp finish's slot-space test."""
    vb = 1 if f["maxc"] < 1 << 8 else 2 if f["maxc"] < 1 << 16 else 4
    fits = 0 < f["nnz"] <= f["cap"] and (
        f["space"] == "slot" or f["cap"] < f["n"])
    small = f["nnz"] * (4 + vb) < (f["n"] * vb) // 2
    return ("sparse" if fits and small else "dense"), vb


def check_fetches(what: str, fetches: list, tag: str) -> None:
    """Log each stream-end fetch (an ops.count.Fetch as a dict) and check
    that it took the JAX rule's route for its stats."""
    for f in fetches:
        want = jax_fetch_route(f)
        log(f"[fetch] {what}: {f.get('count', 'main')} count, {f['route']} "
            f"in {f['space']} space, u{8 * f['vb']}, nnz {f['nnz']} of "
            f"{f['n']}, max {f['maxc']}, {f['d2h_bytes']} B d2h, "
            f"slot_of_id uploaded {f['soi_uploaded']}, {f['s']} s [{tag}]")
        check((f["route"], f["vb"]) == want,
              f"{what}: fetch {f} took ({f['route']}, {f['vb']}), the JAX "
              f"rule {want}")


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
    from strainscan_tpu_torch.bench.count import host_window_keys as keys

    return keys(codes, K)


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of fn over iters launches, by CUDA events."""
    from strainscan_tpu_torch.bench import cuda_ms as timed

    return timed(fn, iters)


def bound_ms(n_bytes: float, n_ops: float = 0.0) -> tuple:
    """(least ms the card could take, "bytes" or "operations")."""
    from strainscan_tpu_torch.bench import bound_ms as bound

    return bound(n_bytes, n_ops)


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
    errs = {name: 0 for name in probe.LAUNCHES
            if name != "row_gather_kernel"}   # phase 6 holds that one
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
    # identify's shape: 150 bases then code-4 padding to L = MAXLEN, and a
    # B x M that is not a multiple of 4 (the outputs' scalar tail)
    padded = np.full((BATCH - 3, MAXLEN), 4, np.uint8)
    padded[:, :READ_LEN] = rng.integers(0, 4, size=(BATCH - 3, READ_LEN))
    cd = torch.from_numpy(padded).to(dev)
    for k in PARITY_KS:
        for canonical in (False, True):
            kw = dict(k=k, n_buckets=1 << 20, seed=7, canonical=canonical)
            b, f = probe.probe_prep(cd, **kw)
            pb, pf = probe.probe_prep_plain(cd, **kw)
            sync(dev)
            check(torch.equal(b, pb) and torch.equal(f, pf),
                  f"probe_prep padded L={MAXLEN} k={k} canonical={canonical}")
            errs["probe_prep_kernel"] = max(
                errs["probe_prep_kernel"], err(b, pb), err(f, pf))
            n_probe += 1
    log(f"[parity] probe_prep_kernel bit-exact in {n_probe} cases "
        f"(B={BATCH}, L in {PARITY_LENGTHS}, k in {PARITY_KS}, canonical "
        f"on/off; and {BATCH - 3} reads of {READ_LEN} padded to {MAXLEN}) "
        f"[{tag}]")

    genome = rng.integers(0, 4, size=400_000).astype(np.uint8)
    keys = genome_keys(genome, dev)
    fpt = fp_table(keys)
    reads = np.full((BATCH, 156), 4, np.uint8)
    reads[:, :READ_LEN] = sample_reads(rng, genome, BATCH)
    reads[: BATCH // 8] = rng.integers(0, 4, size=(BATCH // 8, 156))
    dirty = reads.copy()
    dirty[::9, 60] = 4
    # 128 bins (each its own coarse bin) in every payload form; 16 bins
    # (100,000 of the keys: 4,096 x 64); the L2 union count's shape (one
    # bin of 256 x 64, 65,536 reads of 100 bp at L = MAXLEN)
    fp_cases = [(name, fpt, codes, packed) for name, codes, packed in (
        ("vlen", reads, True), ("vbytes", dirty, True),
        ("codes", dirty, False))]
    fp_cases.append(("vlen, 16 bins", fp_table(np.sort(rng.choice(
        keys, 100_000, replace=False))), reads, True))
    union = union_fixture(dev)
    fp_cases.append(("vlen, union shape", union["fpt"], union["codes"], True))
    n_split = 0
    for name, tab, codes, packed in fp_cases:
        form = name.split(",")[0]
        table = fp_table_to_device(tab, dev)
        (payload,) = CountPipeline(tab, dev, packed_transfer=packed) \
            .prepare_batch(codes)
        check(payload[0] == form, f"payload form {payload[0]} != {form}")
        words = payload[1].to(dev)
        valid = {} if payload[2] is None else {form: payload[2].to(dev)}
        c1 = torch.zeros(tab.n_slots + 1, dtype=torch.int32, device=dev)
        c2 = c1.clone()
        length = codes.shape[1]
        kw = dict(length=length, k=K, seed=tab.seed, **valid)
        g = probe.fp_bin_geometry(tab.n_buckets, tab.bucket, codes.shape[0],
                                  length - K + 1, dev)
        n_split += 1 + probe.fp_split_needed(g)   # the parity's, count_fp's
        probe.count_fp(c1, words, table.fp, **kw)
        probe.count_fp_plain(c2, words, table.fp, **kw)
        stage = probe.fp_bin_parity(words, table.fp, **kw)
        sync(dev)
        check(torch.equal(c1, c2), f"count_fp {name} != plain")
        check(not any(stage.values()), f"binned kernels {name}: {stage}")
        for kname, e in stage.items():
            errs[kname] = max(errs[kname], e, err(c1, c2))
        log(f"[parity] count_fp ({', '.join(FP_KERNELS)}) {name}: each "
            f"kernel and the whole bit-exact, {int(c1[:-1].sum())} hits, "
            f"{int(c1[-1])} trash (table {tab.n_keys} keys, "
            f"{tab.n_buckets} x {tab.bucket} in {g.n_bins} bins and "
            f"{g.n_coarse} coarse bins; {codes.shape[0]} x {length}) [{tag}]")

    kt = KmerTable.build(keys, k=K, load_factor=0.9)
    ktab = kmer_table_to_device(kt, dev)
    check(kt.max_probe > 1, "the load-0.9 table must overflow buckets")
    n_exact = 0
    for length in (READ_LEN, MAXLEN):
        batch = np.full((BATCH, length), 4, np.uint8)
        batch[:, :READ_LEN] = reads[:, :READ_LEN]
        dirty = batch.copy()
        dirty[::9, 60] = 4
        cases = exact_payloads(batch, dirty, dev)
        for (name, words, valid), canonical in (
                (c, canon) for c in cases for canon in (False, True)):
            c1 = torch.zeros(kt.n_keys + 1, dtype=torch.int32, device=dev)
            c2 = torch.zeros_like(c1)
            kw = dict(length=length, k=K, max_probe=kt.max_probe,
                      canonical=canonical, **valid)
            probe.count_exact(c1, words, ktab.table, **kw)
            probe.count_exact_plain(c2, words, ktab.table, **kw)
            stage = probe.exact_parity(words, ktab.table, kt.n_keys, **kw)
            sync(dev)
            n_exact += 2
            check(torch.equal(c1, c2), f"count_exact {name} L={length} "
                  f"canonical={canonical} != plain")
            check(not any(stage.values()), f"exact kernels {name}: {stage}")
            for kname, e in stage.items():
                errs[kname] = max(errs[kname], e, err(c1, c2))
            log(f"[parity] count_exact ({', '.join(EXACT_KERNELS)}) {name} "
                f"L={length} canonical={canonical}: each kernel and the "
                f"whole bit-exact, {int(c1[:-1].sum())} hits, {int(c1[-1])} "
                f"trash (table {kt.n_keys} keys, max_probe {kt.max_probe}) "
                f"[{tag}]")
    launches = dict(probe.LAUNCHES)
    want = dict.fromkeys(launches, 0)
    want.update({"probe_prep_kernel": n_probe,
                 **dict.fromkeys(EXACT_KERNELS, n_exact),
                 # count_fp + the parity; the split where count_fp needs it
                 **dict.fromkeys(FP_KERNELS, 2 * len(fp_cases)),
                 "fp_fine_split_kernel": n_split})
    check(launches == want, f"parity launches {launches}")
    log(f"[parity] kernel launches {launches}")
    return {name: (errs[name], launches[name]) for name in errs}


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def exact_payloads(clean: np.ndarray, dirty: np.ndarray, dev) -> list:
    """A batch of uint8 code rows in the three payload forms the exact
    count takes, ``[(form, reads, {validity kwarg}), ...]`` on ``dev``:
    vlen of ``clean`` (every row's validity a prefix), vbytes and raw codes
    of ``dirty`` (mid-read Ns)."""
    import torch

    from strainscan_tpu_torch.kmer import pack
    from strainscan_tpu_torch.kmer.device import from_u32

    words, vbytes = pack.bitpack_codes(dirty)
    cwords, _ = pack.bitpack_codes(clean)
    vlen = pack.valid_prefix_lens(clean)
    check(vlen is not None, "clean rows have prefix validity")
    return [("vbytes", from_u32(words).to(dev),
             {"vbytes": torch.from_numpy(vbytes).to(dev)}),
            ("vlen", from_u32(cwords).to(dev),
             {"vlen": torch.from_numpy(vlen).to(dev)}),
            ("codes", torch.from_numpy(dirty).to(dev), {})]


def union_fixture(dev) -> dict:
    """The L2 union count's shape (bench.fp_bin_study's union study): a
    7,400-key table of 256 x 64 and 65,536 reads of 100 bp at L = 256."""
    from strainscan_tpu_torch.bench.fp_bin_study import union_fixture as fx

    return fx(dev)


def fp_table(keys: np.ndarray):
    """``FpTable.build`` of the shared host code (ids = key order)."""
    from strainscan_tpu_torch.index.hashtable import FpTable

    return FpTable.build(keys, k=K)


def phase_count(dev, tag: str) -> dict:
    """E. coli-scale count in fp mode; returns the fixture (keys, fpt, fq,
    reads), the id-space counts and the kernel and plain timings in ms."""
    import torch

    from strainscan_tpu_torch.config import IdentifyConfig
    from strainscan_tpu_torch.identify.count import (count_sample,
                                                     iter_payloads)
    from strainscan_tpu_torch.ops import count as ops_count
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
        sync(dev)
        probe.reset_launches()
        ops_count.reset_fetches()
        t0 = time.perf_counter()
        got = count_sample(fpt, fq, dev)
        times.append(time.perf_counter() - t0)
        launches_per_sample = dict(probe.LAUNCHES)
        check(len(ops_count.FETCHES) == 1, "one fetch per count")
        check_fetches(f"count-ecoli rep {rep}",
                      [f._asdict() for f in ops_count.FETCHES], tag)
        check(ids is None or np.array_equal(got, ids), "repeat count differs")
        ids = got
        log(f"[count] rep {rep}: {times[-1]} s, "
            f"{N_READS / times[-1]} reads/s end to end "
            f"({'cold: includes the table upload' if rep == 0 else 'warm'}) "
            f"[{tag}]")
    check(ids.sum() > 0.8 * n_hit * (READ_LEN - K + 1), "too few hits")
    n_batches = -(-N_READS // IdentifyConfig().read_batch)
    check(all(launches_per_sample[n] == n_batches for n in FP_KERNELS),
          f"launches per sample {launches_per_sample}")
    log(f"[count] kernel launches per {N_READS}-read sample "
        f"{launches_per_sample}")

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

    # probe_prep_kernel against its plain twin at B = 65,536 x L = 150 and
    # with the reads padded to L = MAXLEN
    pkw = dict(k=K, n_buckets=fpt.n_buckets, seed=fpt.seed)
    prep = {}
    for length in (READ_LEN, MAXLEN):
        padded = np.full((BATCH, length), 4, np.uint8)
        padded[:, :READ_LEN] = reads[:BATCH]
        codes = torch.from_numpy(padded).to(dev)
        got, want = probe.probe_prep(codes, **pkw), probe.probe_prep_plain(
            codes, **pkw)
        sync(dev)
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"probe_prep_kernel != plain at L={length}")
        fns = {"kernel": (lambda: probe.probe_prep(codes, **pkw), 20),
               "plain": (lambda: probe.probe_prep_plain(codes, **pkw), 3)}
        ms = {name: [] for name in fns}
        for name in ("plain", "kernel", "kernel", "plain"):
            fn, iters = fns[name]
            ms[name].append(cuda_ms(fn, iters))
        m = length - K + 1
        bound = bound_ms(BATCH * length + BATCH * m * 8,
                         BATCH * m * HASH_OPS)
        log(f"[count] probe_prep_kernel at {BATCH} x {length}: {ms['kernel']} "
            f"ms, plain {ms['plain']} ms; "
            f"bound {bound[0]} ms by {bound[1]} = "
            f"{bound[0] / min(ms['kernel'])} of the kernel's time [{tag}]")
        prep[length] = dict(ms=ms, bound=bound)
    fp = time_count_fp(dev, tag, fpt, table, reads[:BATCH])
    time_fetch(dev, tag)
    return dict(keys=keys, fpt=fpt, fq=fq, reads=reads, ids=ids, prep=prep,
                fp=fp, union=time_union(dev, tag),
                launches_per_sample=launches_per_sample)


def time_fetch(dev, tag: str) -> None:
    """fetch_counts on the card at identify-ecoli's 28,588,812 ids, each
    route forced (bench.fetch_study.routes: sparse and dense at one, two and
    four bytes a value, and all zeros), each bit-exact against .cpu() of
    the same tensor and timed beside it, and the host floor under them."""
    from strainscan_tpu_torch.bench import fetch_study

    res = fetch_study.routes(dev)
    floor = res.pop("host_floor")
    log(f"[fetch] host floor at {fetch_study.N_IDS} int32: first write of "
        f"fresh host memory {floor['first_touch_s']} s, a rewrite "
        f"{floor['rewrite_s']} s, the pinned copy of the vector "
        f"{floor['pinned_copy_s']} s [{tag}]")
    for case, r in res.items():
        log(f"[fetch] {case}: {r['route']} u{8 * r['vb']}, nnz {r['nnz']}, "
            f"{r['d2h_bytes']} B d2h, bit-exact against .cpu(); "
            f"fetch_counts {r['fetch_ms']} ms (CUDA events), "
            f"{r['fetch_s']} s (host); .cpu() of {r['plain_bytes']} B "
            f"{r['plain_ms']} ms, {r['plain_s']} s [{tag}]")


def time_count_fp(dev, tag: str, fpt, table, reads: np.ndarray) -> dict:
    """count_fp at identify's shape (the reads padded to L = MAXLEN, vlen)
    and at L = 150: each binned kernel against its plain twin, then the
    whole count against its plain twin, in turns; each kernel's time alone
    and its bound at identify's shape.  Returns the numbers."""
    import torch

    from strainscan_tpu_torch.index.hashtable import lookup_fp_from_prep
    from strainscan_tpu_torch.ops import probe
    from strainscan_tpu_torch.ops.count import CountPipeline

    out = {}
    n_buckets, bucket = table.fp.shape
    # identify's shape last: the kernels below are timed on its batch
    for length in (READ_LEN, MAXLEN):
        padded = np.full((reads.shape[0], length), 4, np.uint8)
        padded[:, :READ_LEN] = reads
        (payload,) = CountPipeline(fpt, dev).prepare_batch(padded)
        check(payload[0] == "vlen", f"payload form {payload[0]}")
        words, vlen = payload[1].to(dev), payload[2].to(dev)
        kw = dict(length=length, k=K, seed=fpt.seed, vlen=vlen)
        errs = probe.fp_bin_parity(words, table.fp, **kw)
        check(not any(errs.values()), f"binned kernels at L={length}: "
              f"{errs}")
        counts = torch.zeros(fpt.n_slots + 1, dtype=torch.int32, device=dev)
        scratch = probe.FpScratch()
        outs = []
        for fn in (probe.count_fp_plain, probe.count_fp):
            counts.zero_()
            fn(counts, words, table.fp, **kw)
            outs.append(counts.clone())
        check(torch.equal(outs[0], outs[1]), f"count_fp != plain at "
              f"L={length}")
        fns = {
            "plain": (lambda: probe.count_fp_plain(counts, words, table.fp,
                                                   **kw), 3),
            "binned": (lambda: probe.count_fp(
                counts, words, table.fp, scratch=scratch, **kw), 20)}
        ms = {name: [] for name in fns}
        for name in ("plain", "binned", "binned", "plain"):
            fn, iters = fns[name]
            ms[name].append(cuda_ms(fn, iters))
        log(f"[count] count_fp at {reads.shape[0]} x {length} (vlen, "
            f"{READ_LEN} bp reads): binned {ms['binned']} ms, plain "
            f"{ms['plain']} ms [{tag}]")
        # the bin sort of count_fp's first three kernels as a whole, against
        # a bound that holds for any design: the payload read once, the
        # pairs and the bin starts written once
        g = probe.fp_bin_geometry(n_buckets, bucket, reads.shape[0],
                                  length - K + 1, dev)
        buf = scratch.buffers(dev, g, reads.shape[0] * (length - K + 1))
        front_kw = dict(length=length, k=K, seed=fpt.seed,
                        n_buckets=n_buckets, vlen=vlen)
        probe.fp_bin_front(counts, words, buf, g, **front_kw)
        n_valid = int(buf.bin_start[-1])
        payload_b = words.numel() * 4 + vlen.numel() * 2
        front_b = payload_b + n_valid * 8 + (g.n_bins + 1) * 4 + 8
        front_bound = bound_ms(front_b, n_valid * HASH_OPS)
        front_ms = [cuda_ms(lambda: probe.fp_bin_front(
            counts, words, buf, g, **front_kw), 20) for _ in range(2)]
        log(f"[count] count_fp's bin sort (fp_coarse_count_kernel, "
            f"fp_coarse_scatter_kernel, fp_fine_split_kernel) at "
            f"{reads.shape[0]} x {length}: {front_ms} ms; bound "
            f"{front_bound[0]} ms by {front_bound[1]} ({front_b} B) [{tag}]")
        out[length] = dict(ms=ms, errs=errs, front=dict(
            ms=min(front_ms), bound_ms=front_bound[0], bytes=front_b))

    # each kernel alone at identify's shape (the last batch of the loop),
    # and the bounds from this batch's data: the valid windows, the distinct
    # rows they probe and the distinct 32 B count sectors their hits touch
    p = buf.pairs[:n_valid]
    slots = lookup_fp_from_prep(table.fp, p[:, 1], p[:, 0], bucket)
    hit = slots >= 0
    rows = int(torch.unique(p[:, 1]).numel())
    sectors = int(torch.unique(slots[hit] // 8).numel())
    lanes = (slots[hit] % bucket + 1).sum()
    compares = int(lanes) + bucket * int((~hit).sum())
    rows_b, cnt_b = rows * bucket * 4, sectors * 32 * 2 + 8
    bins_b, coarse_b, pairs_b = g.n_bins * 4, g.n_coarse * 4, n_valid * 8
    base_b = g.n_blocks * 2 * coarse_b
    skw = dict(kw, n_buckets=n_buckets, coarse_shift=g.coarse_shift,
               rows_per_block=g.rows_per_block)
    split_kw = dict(shift=g.shift, coarse_shift=g.coarse_shift)
    keys = buf.coarse_pairs[:n_valid].view(torch.int64)   # (bucket, fp)
    stages = {  # wrapper, plain twin, library call, bytes, operations
        "fp_coarse_count_kernel": (   # coarse totals zeroed after each
            lambda: (probe.fp_coarse_count(buf.coarse_count, buf.block_base,
                                           counts, words, **skw),
                     buf.coarse_count.zero_()),
            lambda: (probe.fp_coarse_count_plain(
                buf.coarse_count, buf.block_base, counts, words, **skw),
                buf.coarse_count.zero_()),
            None, payload_b + 2 * coarse_b + base_b + 8, n_valid * HASH_OPS),
        "fp_coarse_scatter_kernel": (
            lambda: probe.fp_coarse_scatter(
                buf.coarse_pairs, buf.coarse_start, buf.coarse_count,
                buf.block_base, words, stage_cap=g.stage_cap, **skw),
            lambda: probe.fp_coarse_scatter_plain(
                buf.coarse_pairs, buf.coarse_start, buf.coarse_count,
                buf.block_base, words, **skw),
            None, payload_b + 2 * coarse_b + 4 + base_b + pairs_b,
            n_valid * HASH_OPS),
        "fp_fine_split_kernel": (     # reads no coarse total, zeroes them
            lambda: probe.fp_fine_split(buf.pairs, buf.bin_start,
                                        buf.coarse_count, buf.coarse_pairs,
                                        buf.coarse_start, **split_kw),
            lambda: probe.fp_fine_split_plain(
                buf.pairs, buf.bin_start, buf.coarse_count, buf.coarse_pairs,
                buf.coarse_start, shift=g.shift),
            lambda: torch.sort(keys, dim=0),
            2 * pairs_b + 2 * coarse_b + 4 + bins_b + 4, 0),
        "fp_bin_probe_kernel": (
            lambda: probe.fp_bin_probe(counts, buf.pairs, buf.bin_start,
                                       table.fp, shift=g.shift),
            lambda: probe.fp_bin_probe_plain(counts, buf.pairs,
                                             buf.bin_start, table.fp,
                                             shift=g.shift),
            None, pairs_b + bins_b + 4 + rows_b + cnt_b, compares)}
    stage_ms = {}
    for name, (fn, plain, library, n_bytes, n_ops) in stages.items():
        if name == "fp_coarse_scatter_kernel":   # the totals it scans
            probe.fp_coarse_count(buf.coarse_count, buf.block_base, counts,
                                  words, **skw)
        k_ms = [cuda_ms(fn, 20)]
        p_ms = cuda_ms(plain, 3)
        k_ms.append(cuda_ms(fn, 20))
        lib_ms = None if library is None else cuda_ms(library, 20)
        b_ms, by = bound_ms(n_bytes, n_ops)
        stage_ms[name] = dict(ms=min(k_ms), plain_ms=p_ms, library_ms=lib_ms,
                              bound_ms=b_ms, bound_by=by, bytes=n_bytes)
        log(f"[count] {name} alone at {reads.shape[0]} x {length}: "
            f"{k_ms} ms vs plain {p_ms} ms, library {lib_ms} ms"
            f"{' (torch.sort of the pairs as int64 keys)' if library else ''}"
            f", bound {b_ms} ms by {by} ({n_bytes} B) [{tag}]")
    whole_b = payload_b + rows_b + cnt_b
    whole_ms, whole_by = bound_ms(whole_b, n_valid * HASH_OPS + compares)
    binned = min(out[length]["ms"]["binned"])
    log(f"[count] count_fp bound at {reads.shape[0]} x {length}: "
        f"{whole_ms} ms by {whole_by} ({whole_b} B: payload {payload_b}, "
        f"{rows} distinct rows of {bucket * 4} B, {sectors} count sectors "
        f"read and written; {n_valid} valid windows); binned "
        f"{binned} ms = {whole_ms / binned} of the bound [{tag}]")
    return dict(designs=out, stages=stage_ms, bound_ms=whole_ms,
                bound_by=whole_by, bytes=whole_b)


def time_union(dev, tag: str) -> dict:
    """count_fp at the L2 union count's shape (one bin of 256 x 64,
    65,536 reads of 100 bp at L = MAXLEN, vlen) against its plain twin, in
    turns, with the launches of one call (no fine split); the coarse passes
    and the probe alone, each with its bound from this batch's data; the
    fine split called alone (count_fp does not launch it here) beside
    torch.sort of the pairs as int64 keys.  Returns the numbers."""
    import torch

    from strainscan_tpu_torch.bench.fp_bin_study import probe_bytes
    from strainscan_tpu_torch.index.hashtable import lookup_fp_from_prep
    from strainscan_tpu_torch.ops import probe

    fx = union_fixture(dev)
    fpt, table, words, vlen = fx["fpt"], fx["table"], fx["words"], fx["vlen"]
    n_buckets, bucket = table.shape
    rows, length = fx["codes"].shape
    kw = dict(length=length, k=K, seed=fpt.seed, vlen=vlen)
    g = probe.fp_bin_geometry(n_buckets, bucket, rows, length - K + 1, dev)
    check(g.n_bins == g.n_coarse == 1 and not probe.fp_split_needed(g),
          f"the union shape's geometry {g}")
    counts = torch.zeros(fpt.n_slots + 1, dtype=torch.int32, device=dev)
    scratch = probe.FpScratch()
    probe.reset_launches()
    probe.count_fp(counts, words, table, scratch=scratch, **kw)
    launches = {n: probe.LAUNCHES[n] for n in FP_KERNELS}
    want = probe.count_fp_plain(torch.zeros_like(counts), words, table, **kw)
    sync(dev)
    check(torch.equal(counts, want), "count_fp != plain at the union shape")
    check(launches == {**dict.fromkeys(FP_KERNELS, 1),
                       "fp_fine_split_kernel": 0},
          f"count_fp launches at the union shape {launches}")
    fns = {"plain": (lambda: probe.count_fp_plain(counts, words, table, **kw),
                     3),
           "binned": (lambda: probe.count_fp(counts, words, table,
                                             scratch=scratch, **kw), 20)}
    ms = {name: [] for name in fns}
    for name in ("plain", "binned", "binned", "plain"):
        counts.zero_()
        fn, iters = fns[name]
        ms[name].append(cuda_ms(fn, iters))
    buf = scratch.buffers(dev, g, rows * (length - K + 1))
    front = probe.fp_bin_front(counts, words, buf, g, n_buckets=n_buckets,
                               **kw)
    n_valid = int(front.bin_start[-1])
    pairs = front.pairs[:n_valid]
    slots = lookup_fp_from_prep(table, pairs[:, 1], pairs[:, 0], bucket)
    hit = slots >= 0
    compares = int((slots[hit] % bucket + 1).sum()) + bucket * int(
        (~hit).sum())
    payload_b = words.numel() * 4 + vlen.numel() * 2
    coarse_b, pairs_b = g.n_coarse * 4, n_valid * 8
    base_b = g.n_blocks * 2 * coarse_b
    probe_b = probe_bytes(table, pairs, g.n_bins)
    skw = dict(kw, n_buckets=n_buckets, coarse_shift=g.coarse_shift,
               rows_per_block=g.rows_per_block)
    keys = buf.coarse_pairs[:n_valid].view(torch.int64)   # (bucket, fp)
    stages = {  # call, bytes, operations
        "fp_coarse_count_kernel": (
            lambda: (probe.fp_coarse_count(buf.coarse_count, buf.block_base,
                                           counts, words, **skw),
                     buf.coarse_count.zero_()),
            payload_b + 2 * coarse_b + base_b + 8, n_valid * HASH_OPS),
        "fp_coarse_scatter_kernel": (
            lambda: probe.fp_coarse_scatter(
                buf.coarse_pairs, buf.coarse_start, buf.coarse_count,
                buf.block_base, words, stage_cap=g.stage_cap, **skw),
            payload_b + 2 * coarse_b + 4 + base_b + pairs_b,
            n_valid * HASH_OPS),
        "fp_fine_split_kernel": (     # reads no coarse total, zeroes them
            lambda: probe.fp_fine_split(
                buf.pairs, buf.bin_start, buf.coarse_count, buf.coarse_pairs,
                buf.coarse_start, shift=g.shift, coarse_shift=g.coarse_shift),
            2 * pairs_b + 2 * coarse_b + 4 + (g.n_bins + 1) * 4, 0),
        "fp_bin_probe_kernel": (
            lambda: probe.fp_bin_probe(counts, front.pairs, front.bin_start,
                                       table, shift=g.shift),
            probe_b, compares),
        "torch_sort": (lambda: torch.sort(keys, dim=0), 2 * pairs_b, 0)}
    out = dict(count_fp=dict(ms=min(ms["binned"]), plain_ms=min(ms["plain"])),
               launches=launches, n_valid=n_valid, hits=int(hit.sum()))
    for name, (fn, n_bytes, n_ops) in stages.items():
        if name == "fp_coarse_scatter_kernel":   # the totals it scans
            probe.fp_coarse_count(buf.coarse_count, buf.block_base, counts,
                                  words, **skw)
        counts.zero_()
        k_ms = [cuda_ms(fn, 20) for _ in range(2)]
        b_ms, by = bound_ms(n_bytes, n_ops)
        out[name] = dict(ms=min(k_ms), bound_ms=b_ms, bound_by=by,
                         bytes=n_bytes)
        log(f"[count] {name} alone at the union shape ({rows} x {length}, "
            f"{n_buckets} x {bucket} table, {n_valid} valid windows): {k_ms}"
            f" ms, bound {b_ms} ms by {by} ({n_bytes} B) [{tag}]")
    whole_b = payload_b + probe_b - pairs_b - (g.n_bins + 1) * 4
    out["count_fp"]["bound_ms"], out["count_fp"]["bound_by"] = bound_ms(
        whole_b, n_valid * HASH_OPS + compares)
    log(f"[count] count_fp at the union shape: {ms['binned']} ms (plain "
        f"{ms['plain']} ms), bound {out['count_fp']['bound_ms']} ms by "
        f"{out['count_fp']['bound_by']} ({whole_b} B; {out['hits']} of "
        f"{n_valid} valid windows hit); launches {launches}; "
        f"the fine split, not launched here, would take "
        f"{out['fp_fine_split_kernel']['ms']} ms against torch.sort's "
        f"{out['torch_sort']['ms']} ms [{tag}]")
    return out


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
    launches = {name: probe.LAUNCHES[name] for name in EXACT_KERNELS}
    check(all(launches.values()) and len(set(launches.values())) == 1
          and not any(probe.LAUNCHES[n] for n in FP_KERNELS),
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

    # the count against its plain twin where the exact stream runs it (the
    # reads padded to L = MAXLEN, vbytes: what iter_payloads ships) and at
    # L = 150; each one's bound from this batch's data
    timing = {}
    for length in (MAXLEN, READ_LEN):
        padded = np.full((BATCH, length), 4, np.uint8)
        padded[:, :READ_LEN] = reads[:BATCH]
        (payload,) = CountPipeline(kt, dev, probe_mode="exact") \
            .prepare_batch(padded)
        check(payload[0] == "vbytes", f"exact payload form {payload[0]}")
        words, valid_t = payload[1].to(dev), payload[2].to(dev)
        kw = dict(length=length, k=K, max_probe=kt.max_probe,
                  vbytes=valid_t)
        outs = [torch.zeros_like(pipe.counts) for _ in range(2)]
        for fn, c in zip((probe.count_exact, probe.count_exact_plain), outs):
            fn(c, words, table.table, **kw)
        sync(dev)
        check(torch.equal(outs[0], outs[1]),
              f"count_exact at L={length}: kernels and plain differ")
        scratch = outs[0]
        fns = {
            "kernel": (lambda: probe.count_exact(scratch, words, table.table,
                                                 **kw), 20),
            "plain": (lambda: probe.count_exact_plain(scratch, words,
                                                      table.table, **kw), 3)}
        ms = {name: [] for name in fns}
        for name in ("plain", "kernel", "kernel", "plain"):
            fn, iters = fns[name]
            ms[name].append(cuda_ms(fn, iters))
        win = exact_windows(kt, padded)
        bound = exact_bound(kt, win, words.numel() * 4 + valid_t.numel())
        windows = BATCH * (length - K + 1)
        log(f"[exact] count_exact at {BATCH} x {length} (vbytes; both "
            f"kernels): {ms['kernel']} ms, plain {ms['plain']} ms; {windows / (min(ms['kernel']) / 1e3)} "
            f"windows/s; bound {bound['whole'][0]} ms by {bound['whole'][1]} "
            f"({bound['whole'][2]} B) = {bound['whole'][0] / min(ms['kernel'])}"
            f" of the time [{tag}]")
        # each kernel alone against its plain twin
        hits, n_hits = probe.exact_probe(scratch, words, table.table, **kw)
        stage = {
            "count_exact_kernel": cuda_ms(lambda: probe.exact_probe(
                scratch, words, table.table, **kw), 20),
            "count_exact_plain": cuda_ms(lambda: probe.exact_probe_plain(
                scratch, words, table.table, **kw), 2),
            "exact_apply_kernel": cuda_ms(lambda: probe.exact_apply(
                scratch, hits, n_hits), 20),
            "exact_apply_plain": cuda_ms(lambda: probe.exact_apply_plain(
                scratch, hits, n_hits), 3)}
        # the library call that adds the same ids: index_add_ over the
        # listed ids, gathered out of the hit list beforehand
        listed = probe.listed_ids(hits, n_hits)
        ones = torch.ones_like(listed, dtype=torch.int32)
        stage["exact_apply_library"] = cuda_ms(
            lambda: scratch.index_add_(0, listed, ones), 20)
        for name in ("count_exact_kernel", "exact_apply_kernel"):
            log(f"[exact] {name} alone at {BATCH} x {length}: {stage[name]} "
                f"ms, plain {stage[name.replace('_kernel', '_plain')]} ms, "
                f"library {stage.get(name.replace('_kernel', '_library'))} "
                f"ms (index_add_ of the listed ids); "
                f"bound {bound[name][0]} ms by {bound[name][1]} "
                f"({bound[name][2]} B) [{tag}]")
        timing[length] = dict(ms=ms, bound=bound, stage=stage)
    return dict(ids=ids, launches=launches, timing=timing,
                per_sample={name: n // COUNT_REPS
                            for name, n in launches.items()})


def exact_windows(kt, codes: np.ndarray) -> dict:
    """The valid windows of a batch against the exact table (NumPy): their
    keys, home rows, ids (-1 miss) and the rows each must read (home row on
    to the row that holds the key; all max_probe rows for a miss)."""
    from strainscan_tpu_torch.index.hashtable import mix_np

    keys, valid = host_window_keys(codes)
    q = keys[valid]
    hi = (q >> np.uint64(32)).astype(np.uint32)
    lo = (q & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    home = mix_np(hi, lo).astype(np.int64) & (kt.n_buckets - 1)
    ids = kt.lookup_host(q)
    occ = np.nonzero(kt.val >= 0)[0]
    row_of_id = np.empty(kt.n_keys, np.int64)
    row_of_id[kt.val[occ]] = occ // 8
    need = np.where(ids >= 0, (row_of_id[np.maximum(ids, 0)] - home)
                    % kt.n_buckets + 1, kt.max_probe)
    return dict(q=q, home=home, ids=ids, need=need)


def exact_bound(kt, win: dict, payload_b: int) -> dict:
    """(ms, bound_by, bytes) of count_exact on one batch ("whole") and of
    each of its kernels: the payload, each 96 B table row its windows must
    read, each 32 B id-count sector its hits touch, read and written, and
    between the kernels the list of hit ids (4 B each), written and read."""
    home, ids, need = win["home"], win["ids"], win["need"]
    rows = np.unique(np.concatenate([(home[need > p] + p) % kt.n_buckets
                                     for p in range(kt.max_probe)]))
    n_hits = int((ids >= 0).sum())
    sectors = np.unique(ids[ids >= 0] // 8).size
    ops = win["q"].size * HASH_OPS
    parts = {"whole": (payload_b + rows.size * 96 + sectors * 64 + 8, ops),
             "count_exact_kernel": (payload_b + rows.size * 96 + n_hits * 4
                                    + 8, ops),
             "exact_apply_kernel": (n_hits * 4 + sectors * 64, 0)}
    return {name: (*bound_ms(b, o), b) for name, (b, o) in parts.items()}


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
    from strainscan_tpu_torch.identify import vote
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

    # the L2 union counts' share of the main path's launches: their tables
    # hold few bins, so no fine split
    union = dict.fromkeys(FP_KERNELS, 0)
    count_union = vote._count_union

    def counted_union(*args, **kw):
        before = dict(probe.LAUNCHES)
        try:
            return count_union(*args, **kw)
        finally:
            for n in FP_KERNELS:
                union[n] += probe.LAUNCHES[n] - before[n]

    probe.reset_launches()
    vote._count_union = counted_union
    try:
        run(GPU)
    finally:
        vote._count_union = count_union
    launches = dict(probe.LAUNCHES)
    # the fine split only where a coarse bin holds several fine bins, which
    # this DB's table may not have (phase 7's launches it)
    check(all(launches[n] > 0 for n in FP_KERNELS
              if n != "fp_fine_split_kernel"),
          f"main path launches {launches}")
    check(union["fp_bin_probe_kernel"] > 0
          and union["fp_fine_split_kernel"] == 0,
          f"the L2 union counts' launches {union}")
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
    log(f"[identify] main-path kernel launches {launches}, of them in the "
        f"L2 union counts {union}")
    return launches, dict(db=db, samples=samples, out=out,
                          union_launches=union)


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
    secs = []
    for rep in range(SHARDED_REPS):
        probe.reset_launches()
        sync(dev)
        t0 = time.perf_counter()
        got = sharded_count(mesh, st, reads)
        sync(dev)
        secs.append(time.perf_counter() - t0)
        check(all(probe.LAUNCHES[n] == mesh.size for n in EXACT_KERNELS),
              f"sharded_count launches {dict(probe.LAUNCHES)}")
        diff = np.nonzero(got[:keys.size].cpu().numpy() != exact["ids"])[0]
        check(diff.size == 0,
              f"sharded_count run {rep} != the single-device exact counts "
              f"at {diff.size} ids (per shard "
              f"{np.bincount(diff // st.shard_cap).tolist()}, first "
              f"{diff[:8].tolist()})")
    log(f"[scale] sharded_count (exact, one count_exact_kernel and one "
        f"exact_apply_kernel per position) equals the single-device exact "
        f"counts over {N_READS} reads in each of {SHARDED_REPS} runs; s "
        f"{secs} including the shard and read uploads [{tag}]")

    cfg = dataclasses.replace(IdentifyConfig(), shard_min_kmers=1)
    icount._SHARDED_CACHE.clear()
    for rep in range(2):
        probe.reset_launches()
        sync(dev)
        t0 = time.perf_counter()
        ids = icount.count_sample(count["fpt"], count["fq"], mesh, cfg,
                                  keys=keys)
        dt = time.perf_counter() - t0
        launched = probe.LAUNCHES["fp_bin_probe_kernel"]
        check(launched > 0 and launched % mesh.size == 0,
              f"sharded pipeline launches {dict(probe.LAUNCHES)}")
        check(np.array_equal(ids, count["ids"]),
              "sharded count_sample != the single-device fp counts")
        log(f"[scale] sharded count_sample rep {rep}: equal to the "
            f"single-device counts, {dt} s, {N_READS / dt} reads/s end to "
            f"end ({'cold: includes the sharded fp build and uploads' if rep == 0 else 'warm: cached pipeline'}), "
            f"{launched} fp_bin_probe_kernel launches [{tag}]")
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
    launched = probe.LAUNCHES["fp_bin_probe_kernel"]
    check(launched > 0 and launched % mesh.size == 0
          and all(p.mesh is mesh for _, _, p in icount._SHARDED_CACHE),
          f"mesh identify did not run the sharded pipeline: "
          f"{dict(probe.LAUNCHES)}")
    n_files = sum(same_reports(os.path.join(out, "mesh", n),
                               os.path.join(out, GPU, n), f"mesh {n}")
                  for n in names)
    log(f"[scale] sharded identify (shard_min_kmers=1, shard_min_l2_rows=1) "
        f"of {names}: {n_files} report files byte-identical to the "
        f"single-device GPU run; {launched} fp_bin_probe_kernel launches; "
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


def phase_measure(dev, tag: str) -> dict:
    """The measurement path: row_gather_kernel against its plain twin, the
    study's gather section at full size (its launches counted), entry() on
    the card against the CPU, and bench.count's ecoli tier."""
    import torch

    from strainscan_tpu_torch import entry
    from strainscan_tpu_torch.bench import count as bench_count
    from strainscan_tpu_torch.bench import probe_study
    from strainscan_tpu_torch.ops import gather, probe

    secs = {}
    t0 = time.perf_counter()
    rng = np.random.default_rng(13)
    err = 0
    # the study's widths and configurations at the plan's chunks, the exact
    # study's 96 B rows, and chunks forced small (many, the last ragged)
    cases = [(roww, cfg, None) for roww in (64, 128, 24)
             for cfg in probe_study.CONFIGS] + [
        (roww, cfg, GATHER_SMALL_CHUNK) for roww in (128, 24)
        for cfg in probe_study.CONFIGS]
    tables = {}
    for roww, (tile, nbuf), chunk_rows in cases:
        if roww not in tables:
            tables[roww] = (
                torch.from_numpy(rng.integers(
                    0, 1 << 32, size=(GATHER_ROWS, roww), dtype=np.uint32)
                    .view(np.int32)).to(dev),
                torch.from_numpy(rng.integers(0, GATHER_ROWS, size=GATHER_W,
                                              dtype=np.int32)).to(dev))
        table, idx = tables[roww]
        plan = gather.plan_for(table, idx, tile=tile, nbuf=nbuf,
                               chunk_rows=chunk_rows)
        got = gather.row_gather_xor(table, idx, tile=tile, nbuf=nbuf,
                                    chunk_rows=chunk_rows)
        want = gather.row_gather_xor_plain(table, idx, tile=tile, nbuf=nbuf)
        sync(dev)
        check(torch.equal(got, want), f"row_gather_kernel != plain "
              f"(roww={roww}, tile={tile}, nbuf={nbuf}, plan {plan})")
        err = max(err, int((got.to(torch.int64) - want.to(torch.int64))
                           .abs().max()))
        log(f"[measure] row_gather_kernel plan at roww={roww}, tile={tile}, "
            f"nbuf={nbuf}: {plan.n_chunks} chunks of {plan.chunk_rows} rows, "
            f"k={plan.k}, grid {plan.grid}, {plan.smem} B shared, "
            f"{plan.rounds(GATHER_W // tile)} rounds, no barrier")
    secs["parity"] = time.perf_counter() - t0
    log(f"[measure] row_gather_kernel bit-exact against its plain twin at "
        f"row widths 64, 128 and 24, (tile, nbuf) in {probe_study.CONFIGS}, "
        f"{GATHER_W} indices into {GATHER_ROWS} rows, at the plan's chunks "
        f"and at {GATHER_SMALL_CHUNK} rows a chunk [{tag}]")

    probe.reset_launches()
    t0 = time.perf_counter()
    study, _, _ = probe_study.gather_section(dev)
    launches = probe.LAUNCHES["row_gather_kernel"]
    secs["study"] = time.perf_counter() - t0
    check(launches > 0, f"study path launches {dict(probe.LAUNCHES)}")
    log(f"[measure] probe_study gather section ({study['windows']} indices, "
        f"{study['table_MB']} MB table) in {secs['study']} s, "
        f"{launches} row_gather_kernel launches; torch gather-and-reduce "
        f"{study['xla_gather_Mrows_s_256B']} M rows/s (256 B), "
        f"{study['xla_gather_Mrows_s_512B']} (512 B) [{tag}]")
    for width in ("512B", "256B"):
        for cfg, r in study[f"dma_gather_Mrows_s_{width}"].items():
            log(f"[measure] row_gather_kernel {width} {cfg}: {r['ms']} ms vs "
                f"plain {r['plain_ms']} ms per call, {r['Mrows_s']} M rows/s; "
                f"every tile equal to the NumPy oracle; on a 16 MiB table "
                f"{study['l2_floor'][width][cfg]} ms; plan {r['plan']}, "
                f"{r['rounds']} rounds [{tag}]")

    t0 = time.perf_counter()
    fn, args = entry.entry(dev)
    got = fn(*args)
    want_fn, want_args = entry.entry("cpu")
    want = want_fn(*want_args)
    sync(dev)
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
          "entry(cuda) != entry(cpu)")
    secs["entry"] = time.perf_counter() - t0
    log(f"[measure] entry(cuda) equals entry(cpu): {int(got[0].sum())} hits, "
        f"moments and Gram exact")

    t0 = time.perf_counter()
    res = bench_count.run(dev, tiers=[t for t in bench_count.TIERS
                                      if t[0] == "ecoli"], reps=1)
    secs["bench.count"] = time.perf_counter() - t0
    check(res["metric"] == "kmer_match_reads_per_s_ecoli_scale"
          and res["value"] > 0, "bench.count result")
    log(f"[measure] bench.count ecoli tier, one rep: {json.dumps(res)}")
    log(f"[measure] wall s per step {secs} [{tag}]")
    main512 = study["dma_gather_Mrows_s_512B"][STUDY_CONFIG]
    tile, nbuf = (int(x) for x in STUDY_CONFIG[4:].split("_nbuf"))
    n = study["windows"]
    n_bytes = (study["rows_touched_512B"] * 512 + n * 4
               + (n // tile) * nbuf * 512)
    bound = bound_ms(n_bytes, n * 128)
    log(f"[measure] row_gather_kernel bound {bound[0]} ms by {bound[1]} "
        f"({n_bytes} B: {study['rows_touched_512B']} distinct 512 B rows, "
        f"the indices, the folds) [{tag}]")
    return dict(launches=launches, err=err, ms=main512["ms"],
                plain_ms=main512["plain_ms"], bound=bound,
                l2_floor_ms=study["l2_floor"]["512B"][STUDY_CONFIG])


def phase_trace(tag: str, ident: dict) -> None:
    """The trace hook on the card: a build and a GPU identify through the
    CLI with STRAINSCAN_TRACE_DIR set write one torch.profiler trace per
    phase (identify/count's holding fp_bin_probe_kernel's device events), with
    reports byte-identical to an untraced run."""
    from strainscan_tpu_torch import cli
    from strainscan_tpu_torch.timing import TRACE_ENV, trace_path

    trace_dir = os.path.join(FIXTURE, "trace")
    gdir = os.path.join(FIXTURE, "genomes2")
    os.makedirs(gdir)
    for name in ("F001V0", "F002V0"):
        shutil.copy(os.path.join(FIXTURE, "genomes", name + ".fa"), gdir)
    out = ident["out"]
    secs = {}
    for run in ("untraced", "traced"):
        if run == "traced":
            os.environ[TRACE_ENV] = trace_dir
        try:
            t0 = time.perf_counter()
            check(cli.main(["build", "-i", gdir, "-o", os.path.join(
                FIXTURE, f"DB_{run}")]) == 0, f"{run} build")
            secs[f"build/{run}"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            check(cli.main(["identify", "-i", ident["samples"]["single"],
                            "-d", ident["db"], "-o", os.path.join(out, run),
                            "--device", GPU]) == 0, f"{run} identify")
            secs[f"identify/{run}"] = time.perf_counter() - t0
        finally:
            os.environ.pop(TRACE_ENV, None)
    same_reports(os.path.join(out, "traced"), os.path.join(out, "untraced"),
                 "traced identify")
    sizes = {}
    for name in ("clustering", "distance_matrix", "l2_matrices",
                 "overlap_matrices", "tree_build", "identify/load_db",
                 "identify/count", "identify/cst_search", "identify/l2_vote"):
        path = trace_path(trace_dir, name)
        check(os.path.isfile(path), f"no trace {path}")
        sizes[name] = os.path.getsize(path)
    with open(trace_path(trace_dir, "identify/count")) as fh:
        check("fp_bin_probe_kernel" in fh.read(),
              "identify/count's trace holds no fp_bin_probe_kernel event")
    log(f"[trace] STRAINSCAN_TRACE_DIR: traced build and GPU identify wrote "
        f"one trace per phase (bytes {sizes}), identify/count's with "
        f"fp_bin_probe_kernel device events; reports byte-identical to the "
        f"untraced run; s {secs} [{tag}]")


def phase_ecoli(tag: str) -> dict:
    """Identify at E. coli scale: bench.scale_fixture's fixture built from
    nothing, its four samples cold and warm on the GPU and its three
    shared samples on the CPU, every report byte-identical between them;
    returns the launches of count_fp's kernels on this path."""
    from strainscan_tpu_torch.bench import scale_fixture, scale_parity

    root = os.path.join(FIXTURE, "ecoli")
    t0 = time.perf_counter()
    meta = scale_fixture.build_fixture(root, threads=os.cpu_count() or 8,
                                       export=False)
    log(f"[ecoli] fixture in {time.perf_counter() - t0} s: "
        f"{len(meta['strains'])} genomes ({meta['genomes_s']} s), DB of "
        f"{meta['n_clusters']} clusters and {meta['n_keys']} keys "
        f"({meta['build_s']} s, digest {meta['db_digest']}), samples "
        f"{ {n: v['reads'] for n, v in meta['samples'].items()} } (host)")
    db = os.path.join(root, "DB")
    fqs = scale_parity.sample_paths(root, meta)
    out = os.path.join(root, "out")
    recs = {f"{GPU}/{p}": scale_parity.identify_each(
        fqs, db, os.path.join(out, GPU, p), GPU) for p in ("cold", "warm")}
    launches = {name: sum(r["launches"].get(name, 0) for rs in recs.values()
                          for r in rs.values()) for name in FP_KERNELS}
    union = {name: sum(r["union_launches"].get(name, 0)
                       for rs in recs.values() for r in rs.values())
             for name in FP_KERNELS}
    check(union["fp_bin_probe_kernel"] > 0
          and union["fp_fine_split_kernel"] == 0,
          f"the L2 union counts' launches {union}")
    for what, rs in recs.items():
        for name, rec in rs.items():
            bad = scale_parity.faults(f"{what} {name}", rec, GPU)
            check(not bad, "; ".join(bad))
            check(all(rec["launches"].get(k) for k in FP_KERNELS),
                  f"{what} {name}: launches {rec['launches']}")
    uploads = sum(r["uploads_keys"].count(meta["n_keys"])
                  for rs in recs.values() for r in rs.values())
    check(uploads == 1, f"the E. coli DB's table uploaded {uploads} times")
    shared = {n: fqs[n] for n in ECOLI_CPU}
    recs["cpu/cold"] = scale_parity.identify_each(
        shared, db, os.path.join(out, "cpu", "cold"), "cpu")
    for what, rs in recs.items():
        for name, rec in rs.items():
            check(sum(f["count"] == "main" for f in rec["fetches"]) == 1
                  and rec["fetches"][0]["count"] == "main",
                  f"{what} {name}: fetches {rec['fetches']}")
            check_fetches(f"identify-ecoli {what} {name}", rec["fetches"],
                          tag)
    groups = {what: scale_parity.report_groups(os.path.join(out, what))
              for what in recs}
    for name in fqs:
        want = groups[f"{GPU}/cold"][name]
        check(groups[f"{GPU}/warm"][name] == want,
              f"{name}: warm GPU report differs from the cold one")
        if name in shared:
            check(groups["cpu/cold"][name] == want,
                  f"{name}: GPU report differs from the CPU run")
        found = scale_parity.strains_in(want["final_report.txt"])
        check(set(meta["samples"][name]["truth"]) <= found,
              f"{name}: truth {meta['samples'][name]['truth']} not in "
              f"{sorted(found)}")
    check(any(f.endswith("StrainVote.report")
              for f in groups[f"{GPU}/cold"]["intramix"]),
          "intramix did not reach the L2 vote")
    secs = {what: {n: r["s"] for n, r in rs.items()}
            for what, rs in recs.items()}
    log(f"[ecoli] reports byte-identical: GPU cold = GPU warm for "
        f"{len(fqs)} samples, = CPU for {len(shared)}; truth found; "
        f"intramix reached the Enet vote. s/sample {secs} [{tag}]")
    log(f"[ecoli] count_fp kernel launches on this path {launches}, of them "
        f"in the L2 union counts {union}")
    return dict(launches=launches, union=union)


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
    block_jax_package()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from strainscan_tpu_torch.bench import card_line

    tag = card_line()
    kernels = run(torch.device("cuda", 0), tag)
    print(tag)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(dev, tag: str) -> list:
    """Every phase on ``dev``; returns the kernels line's entries."""
    shutil.rmtree(FIXTURE, ignore_errors=True)
    os.makedirs(FIXTURE)

    secs = {}

    def timed(name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = time.perf_counter() - t0
        return out

    timed("env", phase_env, tag)
    parity = timed("parity", phase_parity, dev, tag)
    count = timed("count", phase_count, dev, tag)
    exact = timed("exact", phase_exact, dev, tag, count)
    launches, ident = timed("identify", phase_identify, tag)
    timed("scale", phase_scale, dev, tag, count, exact, ident)
    measure = timed("measure", phase_measure, dev, tag)
    timed("trace", phase_trace, tag, ident)
    ecoli = timed("ecoli", phase_ecoli, tag)
    shutil.rmtree(FIXTURE, ignore_errors=True)
    log(f"[time] wall s per phase {secs}, {sum(secs.values())} in all")

    src = "strainscan_tpu_torch/csrc/"
    fp = count["fp"]
    per_sample = count["launches_per_sample"]
    prep, prep256 = count["prep"][READ_LEN], count["prep"][MAXLEN]
    ex256, ex150 = exact["timing"][MAXLEN], exact["timing"][READ_LEN]
    kernels = [{
        "name": "probe_prep_kernel", "route": "cuda",
        "source": src + "probe_count.cu",
        "replaces": "strainscan_tpu/ops/pallas_probe.py:168",
        "launches": launches["probe_prep_kernel"],
        "launches_per_sample": per_sample["probe_prep_kernel"],
        "parity_launches": parity["probe_prep_kernel"][1],
        "max_abs_err": parity["probe_prep_kernel"][0],
        "ms": min(prep["ms"]["kernel"]),
        "plain_ms": min(prep["ms"]["plain"]),
        "bound_ms": prep["bound"][0],
        "bound_by": prep["bound"][1], "library_ms": None,
        "shape": f"{BATCH} x {READ_LEN}",
        "at_L256": {"ms": min(prep256["ms"]["kernel"]),
                    "plain_ms": min(prep256["ms"]["plain"]),
                    "bound_ms": prep256["bound"][0]},
    }]
    union = count["union"]
    for name in FP_KERNELS:   # the four kernels of the binned count_fp
        st = fp["stages"][name]
        at_union = {}
        if name in ("fp_fine_split_kernel", "fp_bin_probe_kernel"):
            # ms and bound of one call at the union shape (the split called
            # alone: count_fp does not launch it there), the launches in
            # the main path's L2 union counts (phase 7; phase 4's too)
            at_union = {"at_union": {
                "ms": union[name]["ms"], "bound_ms": union[name]["bound_ms"],
                "bound_by": union[name]["bound_by"],
                "launches": ecoli["union"][name],
                "launches_synth": ident["union_launches"][name],
                "launches_per_count_fp": union["launches"][name],
                "shape": f"{BATCH} x {MAXLEN} (100 bp, vlen), 256 x 64 "
                         f"table", **({"library_ms": union["torch_sort"]["ms"]}
                                      if name == "fp_fine_split_kernel"
                                      else {})}}
        kernels.append({
            "name": name, "route": "cuda", "source": src + "count_fp_bins.cu",
            "replaces": "strainscan_tpu/ops/pallas_probe.py:168",
            "part_of": "count_fp",
            "launches": ecoli["launches"][name],
            "launches_synth": launches[name],
            "launches_per_sample": per_sample[name],
            "max_abs_err": max(parity[name][0],
                               *(d["errs"][name]
                                 for d in fp["designs"].values())),
            "ms": st["ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
            "library_ms": st["library_ms"], **at_union})
    for name in EXACT_KERNELS:   # the two kernels of count_exact
        kernels.append({
            "name": name, "route": "cuda", "source": src + "count_exact.cu",
            "replaces": "strainscan_tpu/ops/count.py:32",
            "part_of": "count_exact",
            "launches": exact["launches"][name],
            "launches_per_sample": exact["per_sample"][name],
            "max_abs_err": parity[name][0],
            "ms": ex256["stage"][name],
            "plain_ms": ex256["stage"][name.replace("_kernel", "_plain")],
            "bound_ms": ex256["bound"][name][0],
            "bound_by": ex256["bound"][name][1],
            "shape": f"{BATCH} x {MAXLEN}, vbytes",
            "at_L150": {
                "ms": ex150["stage"][name],
                "plain_ms": ex150["stage"][name.replace("_kernel", "_plain")],
                "bound_ms": ex150["bound"][name][0]},
            "library_ms": ex256["stage"].get(
                name.replace("_kernel", "_library"))})
    kernels.append({
        "name": "row_gather_kernel", "route": "cuda",
        "source": src + "row_gather.cu",
        "replaces": "benchmarks/probe_bench3.py:142",
        "launches": measure["launches"], "launches_per_sample": 0,
        "max_abs_err": measure["err"],
        "ms": measure["ms"], "plain_ms": measure["plain_ms"],
        "bound_ms": measure["bound"][0], "bound_by": measure["bound"][1],
        "library_ms": None, "l2_floor_ms": measure["l2_floor_ms"]})
    designs = {length: {name: min(v) for name, v in d["ms"].items()}
               for length, d in fp["designs"].items()}
    log(f"[count] count_fp per batch of {BATCH} reads, ms by design and L: "
        f"{json.dumps(designs)}; bound at L = {MAXLEN} {fp['bound_ms']} ms "
        f"by {fp['bound_by']} ({fp['bytes']} B) [{tag}]")
    front = {length: d["front"] for length, d in fp["designs"].items()}
    log(f"[count] count_fp's bin sort per batch of {BATCH} reads: "
        f"{front[READ_LEN]['ms']} ms at L = {READ_LEN} against "
        f"{PARENT_FRONT_MS} ms of the three-kernel front it replaced at that "
        f"shape, {front[MAXLEN]['ms']} ms at L = {MAXLEN}; bounds "
        f"{front[READ_LEN]['bound_ms']} and {front[MAXLEN]['bound_ms']} ms "
        f"[{tag}]")
    return kernels


if __name__ == "__main__":
    sys.exit(main())
