"""Benchmark: restricted k-mer counting throughput (reads/s) on one GPU.

The counterpart of ``bench.py`` for the port: the identification hot path
end to end (FASTQ parse -> 2-bit pack -> h2d -> the binned ``count_fp`` ->
id-space counts on the host) at two table scales, with bench.py's tiers,
inputs and JSON keys:

    toy    ~2 M-key table (a 1 Mb genome, both strands)
    ecoli  ~28.6 M-key table (a 14.3 Mb genome; the HEADLINE metric
           ``kmer_match_reads_per_s_ecoli_scale``)

Each tier streams 1.2 M seeded 150 bp reads ``passes`` times per rep through
``CountPipeline`` (``prepare_batch`` in a producer thread, ``add_prepared``
on the device), after one warm-up batch that uploads the table and builds
the kernels.  Reads/s is the median rep's.  Checks, each of which raises:

* a ``passes``-fold stream counts every key a multiple of ``passes`` times;
* one batch equals the host oracle (``KmerTable.lookup_host`` + bincount);
* with a jellyfish binary (``--jellyfish``), the counts equal its dump.

``breakdown`` times parse and pack on the host and replays the resident
first batch through ``count_fp`` with CUDA events (the device time); it
also keeps each rep's ``finish_s`` with its fetch's route and d2h bytes
(``ops.count.FETCHES``).  The
jellyfish baseline runs only when its binary exists; otherwise
``vs_baseline`` is null.

    python -m strainscan_tpu_torch.bench.count [--jellyfish PATH]

Prints one JSON line: ``metric``, ``value``, ``unit``, ``vs_baseline``,
``device_sustained_reads_s`` and ``detail`` (both tiers, the card line and
a d2h MB/s probe).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from strainscan_tpu_torch.bench import card_line, cuda_device, cuda_ms
from strainscan_tpu_torch.index.hashtable import KmerTable
from strainscan_tpu_torch.io import fastx
from strainscan_tpu_torch.kmer import pack
from strainscan_tpu_torch.ops import count as ops_count
from strainscan_tpu_torch.ops.count import CountPipeline
from strainscan_tpu_torch.ops.probe import count_fp
from strainscan_tpu_torch.utils.prefetch import prefetch_iter

METRIC = "kmer_match_reads_per_s_ecoli_scale"
READ_LEN = 150
K = 31
BATCH = 65536
MAXLEN = READ_LEN + 6
REPS = 5          # ours
REPS_JF = 3       # jellyfish baseline
PASSES = 3        # ours streams the read file this many times per rep

# (name, genome_len, n_reads): table keys ~= 2 * genome_len (both strands)
TIERS = (
    ("toy", 1_000_000, 1_200_000),
    ("ecoli", 14_300_000, 1_200_000),
)


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def synthesize(tmp: str, tag: str, genome_len: int, n_reads: int,
               device="cpu") -> Tuple[np.ndarray, str]:
    """bench.py's inputs, byte for byte: a seeded random genome's sorted
    both-strand k-mers and a fixed-width FASTQ of ``n_reads`` reads drawn
    from it, half reverse-complemented.  Returns ``(keys, fastq path)``.

    The keys are sorted and deduplicated on ``device`` (a GPU does 28.6 M
    in well under a second; a host ``np.unique`` can take a minute).  A
    31-mer packs into 62 bits, so the int64 order is the uint64 order."""
    rng = np.random.default_rng(0)
    genome_codes = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    km, _ = pack.pack_kmers(genome_codes, K)
    both = np.concatenate([km, pack.revcomp_packed(km, K)]).view(np.int64)
    db = torch.unique(torch.from_numpy(both).to(device)).cpu().numpy() \
        .view(np.uint64)
    fq = os.path.join(tmp, f"bench_{tag}.fq")
    starts = rng.integers(0, genome_len - READ_LEN, size=n_reads)
    reads = genome_codes[starts[:, None] + np.arange(READ_LEN)[None, :]]
    flips = rng.random(n_reads) < 0.5
    reads[flips] = (3 - reads[flips])[:, ::-1]
    head = np.frombuffer(b"@r\n", dtype=np.uint8)
    mid = np.frombuffer(b"\n+\n", dtype=np.uint8)
    row = head.size + READ_LEN + mid.size + READ_LEN + 1
    out = np.empty((n_reads, row), dtype=np.uint8)
    out[:, :head.size] = head
    out[:, head.size:head.size + READ_LEN] = \
        np.frombuffer(b"ACGT", dtype=np.uint8)[reads]
    out[:, head.size + READ_LEN:head.size + READ_LEN + mid.size] = mid
    out[:, head.size + READ_LEN + mid.size:-1] = ord("I")
    out[:, -1] = ord("\n")
    out.tofile(fq)
    return db, fq


def host_window_keys(codes: np.ndarray, k: int = K):
    """NumPy oracle of a batch's window keys ``[B, L-k+1]`` (uint64) and
    their validity (no code >= 4 in the window)."""
    m = codes.shape[1] - k + 1
    c = codes.astype(np.uint64)
    key = np.zeros((codes.shape[0], m), dtype=np.uint64)
    for i in range(k):
        key = (key << np.uint64(2)) | (c[:, i:i + m] & np.uint64(3))
    bad = np.cumsum(np.pad(codes >= 4, ((0, 0), (1, 0))), axis=1)
    return key, (bad[:, k:] - bad[:, :-k]) == 0


def check_host_oracle(pipe: CountPipeline, table: KmerTable,
                      batch: np.ndarray) -> int:
    """One batch through the pipeline, reset first, equals
    ``KmerTable.lookup_host`` + bincount in id space; returns the batch's
    hits."""
    pipe.reset()
    pipe.add_batch(batch)
    got = pipe.finish()
    keys, valid = host_window_keys(batch, table.k)
    ids = table.lookup_host(keys[valid])
    want = np.bincount(ids[ids >= 0], minlength=table.n_keys)
    if not np.array_equal(got, want):
        raise RuntimeError(f"one batch differs from the host oracle at "
                           f"{int((got != want).sum())} ids")
    return int((ids >= 0).sum())


def bench_ours(db: np.ndarray, fq: str, n_reads: int, dev: torch.device,
               reps: int, passes: int):
    """Timed reps of the streaming count; returns (reads/s of the median
    rep, per-key counts of one pass, rep seconds, breakdown)."""
    t0 = time.perf_counter()
    table = KmerTable.build(db, k=K)
    pipe = CountPipeline(table, dev)
    log(f"table built in {time.perf_counter() - t0} s: {table.n_keys} keys, "
        f"fp geometry {pipe.table.n_buckets}x{pipe.table.bucket}")
    first = next(iter(fastx.read_batches(fq, batch=BATCH, maxlen=MAXLEN,
                                         k=K)))
    pipe.add_batch(first)        # warm: table upload and kernel build
    pipe.finish()
    paths = [fq] * passes
    n_streamed = n_reads * passes
    times, finish_times, fetches = [], [], []
    counts = None
    for rep in range(reps):
        pipe.reset()
        _sync(dev)
        t0 = time.perf_counter()

        def produce():
            for batch in fastx.read_batches(paths, batch=BATCH,
                                            maxlen=MAXLEN, k=K):
                yield pipe.prepare_batch(batch)

        for payloads in prefetch_iter(produce()):
            pipe.add_prepared(payloads)
        t_fin = time.perf_counter()
        counts = pipe.finish()
        finish_times.append(time.perf_counter() - t_fin)
        times.append(time.perf_counter() - t0)
        fetches.append(ops_count.FETCHES[-1])
        log(f"ours rep {rep}: {times[-1]} s ({n_streamed / times[-1]} "
            f"reads/s; finish/d2h {finish_times[-1]} s, "
            f"{fetches[-1].route}/{fetches[-1].space} u{8 * fetches[-1].vb}, "
            f"{fetches[-1].d2h_bytes} B)")
    if counts.sum() <= 0:
        raise RuntimeError("the stream counted no k-mer")
    if (counts % passes).any():
        raise RuntimeError(f"a {passes}-fold stream must count every key a "
                           f"multiple of {passes} times")
    t0 = time.perf_counter()
    hits = check_host_oracle(pipe, table, first)
    log(f"triple-stream check held; the first batch equals the host oracle "
        f"({hits} hits; checked in {time.perf_counter() - t0} s)")
    t0 = time.perf_counter()
    bd = breakdown(pipe, fq, first, n_reads)
    log(f"breakdown measured in {time.perf_counter() - t0} s")
    bd.update(finish_s=finish_times,
              finish_routes=[f"{f.route}/{f.space} u{8 * f.vb}"
                             for f in fetches],
              finish_d2h_bytes=[f.d2h_bytes for f in fetches])
    return n_streamed / float(np.median(times)), counts // passes, times, bd


def breakdown(pipe: CountPipeline, fq: str, first: np.ndarray,
              n_reads: int) -> dict:
    """Per-stage seconds for one pass of the file: parse and pack on the
    host, and the device time of ``count_fp`` replayed on the resident
    first batch (CUDA events), scaled to the file's batch count."""
    t0 = time.perf_counter()
    nb = 0
    for b in fastx.read_batches(fq, batch=BATCH, maxlen=MAXLEN, k=K):
        nb += b.shape[0]
    t_parse = time.perf_counter() - t0
    pack.bitpack_codes(first)   # warm (the first call pays page faults)
    fused = pack.bitpack_codes_vlen(first)
    t0 = time.perf_counter()
    for _ in range(4):
        if fused is not None:
            pack.bitpack_codes_vlen(first)
        else:
            pack.bitpack_codes(first)
            pack.valid_prefix_lens(first)
    t_pack = (time.perf_counter() - t0) / 4 * (nb / first.shape[0])
    (payload,) = pipe.prepare_batch(first)
    form, words, valid = payload
    words, valid = words.to(pipe.device), valid.to(pipe.device)
    counts = torch.zeros_like(pipe.counts)
    ms = cuda_ms(lambda: count_fp(counts, words, pipe.table.fp,
                                  length=first.shape[1], k=pipe.k,
                                  seed=pipe.table.seed, scratch=pipe.scratch,
                                  **{form: valid}), 8)
    t_dev = ms / 1e3 * (nb / first.shape[0])
    nw = n_reads * (MAXLEN - K + 1)
    log(f"breakdown: parse {t_parse} s | pack ~{t_pack} s | device "
        f"{t_dev} s ({nw / t_dev / 1e6} M windows/s, {form})")
    return {"parse_s": t_parse, "pack_s": t_pack, "device_s": t_dev,
            "device_Mwin_s": nw / t_dev / 1e6,
            "device_reads_s": n_reads / t_dev}


def bench_jellyfish(jellyfish: str, db: np.ndarray, fq: str, tmp: str,
                    n_reads: int):
    """The reference pipeline (jellyfish count --if kmer.fa, dump -c, the
    Python dict parse of reference library/identify.py:90-102), as
    bench.py runs it; returns (reads/s, counts of the first rep, seconds)."""
    kfa = os.path.join(tmp, "kmer.fa")
    pack.write_kmer_fa(kfa, db, K)
    times = []
    counts = None
    for rep in range(REPS_JF):
        t0 = time.perf_counter()
        out_jf = os.path.join(tmp, "out.jf")
        out_fa = os.path.join(tmp, "out.fa")
        subprocess.run([jellyfish, "count", "-m", str(K), "-s", "100M", "-t",
                        "8", "--if", kfa, "-o", out_jf, fq], check=True)
        with open(out_fa, "w") as f:
            subprocess.run([jellyfish, "dump", "-c", out_jf], check=True,
                           stdout=f)
        kmer_index = {}
        with open(kfa) as f:
            lines = f.readlines()
        for i in range(len(lines) // 2):
            kmer_index[lines[i * 2 + 1].rstrip().upper()] = i
        match = {}
        with open(out_fa) as f:
            for line in f:
                s, c = line.rstrip().split(" ")
                match[kmer_index[s]] = int(c)
        times.append(time.perf_counter() - t0)
        log(f"jellyfish rep {rep}: {times[-1]} s "
            f"({n_reads / times[-1]} reads/s)")
        if rep == 0:
            counts = np.zeros(db.size, dtype=np.int64)
            for i, c in match.items():
                counts[i] = c
    return n_reads / float(np.median(times)), counts, times


def d2h_mbps(dev: torch.device) -> float:
    """Median MB/s of copying a freshly computed 8 MB tensor to the host
    (three probes)."""
    base = torch.arange(2 << 20, dtype=torch.int32, device=dev)
    rates = []
    for i in range(3):
        buf = base * (i + 2)
        _sync(dev)
        t0 = time.perf_counter()
        buf.cpu()
        rates.append(buf.numel() * 4 / 1e6 / (time.perf_counter() - t0))
    return float(np.median(rates))


def run_tier(tmp: str, tag: str, genome_len: int, n_reads: int,
             dev: torch.device, reps: int, passes: int,
             jellyfish: Optional[str]) -> dict:
    log(f"=== tier {tag}: synthesizing (genome {genome_len} bp, {n_reads} "
        f"reads)")
    t0 = time.perf_counter()
    db, fq = synthesize(tmp, tag, genome_len, n_reads, dev)
    log(f"tier {tag}: {db.size} table keys, synthesized in "
        f"{time.perf_counter() - t0} s")
    rps, counts, times, bd = bench_ours(db, fq, n_reads, dev, reps, passes)
    detail = {"n_keys": int(db.size), "n_reads": n_reads,
              "ours_reads_s": rps, "ours_times_s": times, "breakdown": bd,
              "vs_baseline": None}
    if jellyfish and os.path.exists(jellyfish):
        base_rps, base_counts, base_times = bench_jellyfish(
            jellyfish, db, fq, tmp, n_reads)
        if not np.array_equal(counts, base_counts):
            raise RuntimeError(f"counts differ from jellyfish at "
                               f"{int((counts != base_counts).sum())} keys")
        detail.update(jellyfish_reads_s=base_rps,
                      jellyfish_times_s=base_times,
                      vs_baseline=rps / base_rps)
    os.remove(fq)
    return detail


def run(device="cuda", tiers: Sequence[tuple] = TIERS, reps: int = REPS,
        passes: int = PASSES, jellyfish: Optional[str] = None) -> dict:
    """Every tier on one CUDA device; returns the JSON object.  The
    headline is the ``ecoli`` tier, or the last tier when it is absent."""
    dev = cuda_device(device)
    tmp = tempfile.mkdtemp(prefix="sst_bench_")
    try:
        detail = {"card": card_line(), "d2h_MBps": d2h_mbps(dev)}
        for tag, genome_len, n_reads in tiers:
            detail[tag] = run_tier(tmp, tag, genome_len, n_reads, dev, reps,
                                   passes, jellyfish)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    head = detail["ecoli" if "ecoli" in detail else tiers[-1][0]]
    return {
        "metric": METRIC,
        "value": head["ours_reads_s"],
        "unit": "reads/s",
        "vs_baseline": head["vs_baseline"],
        "device_sustained_reads_s": head["breakdown"]["device_reads_s"],
        "detail": detail,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jellyfish", help="jellyfish binary of the baseline")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, jellyfish=args.jellyfish)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
