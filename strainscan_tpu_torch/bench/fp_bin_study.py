"""Design studies of count_fp's bin sort on one GPU (``chip_smoke.py`` does
not run them).

The fixture is the smoke's count-ecoli geometry: a seeded 14.3 Mb genome,
both strands (28.6 M keys, a fingerprint table of 1,048,576 x 64 lanes in
4,096 bins of 64 KiB), and one batch of 65,536 reads of 150 bp drawn from
it, padded with invalid codes to L = 256 (identify's shape) or not
(L = 150), shipped as vlen.

* ``designs``: the whole ``count_fp`` and its front, the kernels before
  ``fp_bin_probe_kernel`` that sort the windows by bin, together and each
  alone, at 65,536 x 256 and x 150, CUDA-event means over ``REPS`` calls in
  two turns; and ``torch.cumsum`` over the batch's 4,096 bin totals, the
  library call that computes a bin scan.  It times whichever front the
  tree has: the three-kernel front (``fp_bin_count``, ``bin_scan``,
  ``fp_bin_scatter``) or the two-level bin sort (``fp_coarse_count``,
  ``fp_coarse_scatter``, ``fp_fine_split``), so it can time a parent
  commit's kernels beside this one's in one call, in separate processes:
  parent, change, change, parent (``--root`` names the tree to import).
* ``fanout``: the bin sort and the whole ``count_fp`` at both lengths by
  coarse bins (64, 128, 256) and rows per block of the coarse passes
  (16, 24, 32, 36: about 31, 21, 16 and 14 blocks per multiprocessor of
  an H100 at 65,536 reads).

    python strainscan_tpu_torch/bench/fp_bin_study.py designs [--root DIR]
    python -m strainscan_tpu_torch.bench.fp_bin_study fanout

Prints one JSON line per study, each with the card's name and power limit.
Raises without a CUDA device: no number here comes from the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

K = 31
GENOME_LEN = 14_300_000
BATCH = 65_536
READ_LEN = 150
LENGTHS = (256, 150)
REPS = 20
COARSE_BINS = (64, 128, 256)
ROWS_PER_BLOCK = (16, 24, 32, 36)
SEED = 0


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = REPS) -> float:
    """Mean ms per call of ``fn`` by CUDA events, after one warm-up call."""
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


def fixture(dev) -> dict:
    """The fingerprint table on ``dev`` and the batch at each length as a
    vlen payload."""
    import torch

    from strainscan_tpu_torch.index.hashtable import (FpTable,
                                                      fp_table_to_device)
    from strainscan_tpu_torch.kmer import device as kdev
    from strainscan_tpu_torch.kmer import pack

    rng = np.random.default_rng(SEED)
    genome = rng.integers(0, 4, size=GENOME_LEN).astype(np.uint8)
    hi, lo, _ = kdev.extract_kmers(torch.from_numpy(genome[None]).to(dev), K)
    rhi, rlo = kdev.revcomp(hi, lo, K)
    keys = torch.unique(torch.cat([(hi << 32 | lo).ravel(),
                                   (rhi << 32 | rlo).ravel()]))
    fpt = FpTable.build(keys.cpu().numpy().view(np.uint64), k=K)
    starts = rng.integers(0, GENOME_LEN - READ_LEN, size=BATCH)
    reads = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
    flips = rng.random(BATCH) < 0.5
    reads[flips] = (3 - reads[flips])[:, ::-1]
    batches = {}
    for length in LENGTHS:
        codes = np.full((BATCH, length), 4, np.uint8)
        codes[:, :READ_LEN] = reads
        words, _ = pack.bitpack_codes(codes)
        batches[length] = dict(
            words=kdev.from_u32(words).to(dev),
            vlen=torch.from_numpy(pack.valid_prefix_lens(codes)).to(dev))
    return dict(fpt=fpt, table=fp_table_to_device(fpt, dev).fp,
                batches=batches)


def three_kernel_front(probe, dev, counts, b: dict, n_buckets: int,
                       bucket: int, length: int, seed: int) -> dict:
    """The three-kernel front of a parent tree: ``{name: (set-up, call)}``
    for the front and each kernel alone, and the batch's bin totals."""
    import torch

    shift = probe.fp_bin_shift(n_buckets, bucket)
    n_blocks, per = probe.fp_bin_blocks(BATCH, dev)
    bc, bs, bb, pairs = probe.FpScratch().buffers(
        dev, n_buckets >> shift, n_blocks, BATCH * (length - K + 1))
    kw = dict(length=length, k=K, seed=seed, n_buckets=n_buckets,
              shift=shift, rows_per_block=per, vlen=b["vlen"])

    def count():
        probe.fp_bin_count(bc, bb, counts, b["words"], **kw)

    def front():
        count()
        probe.bin_scan(bc, bs)
        probe.fp_bin_scatter(pairs, bs, bb, b["words"], **kw)

    count()
    totals = bc.clone()
    probe.bin_scan(bc, bs)
    return dict(totals=totals, fns={
        "front": (None, front),
        "fp_bin_count_kernel": (None, lambda: (count(), bc.zero_())),
        # the scan zeroes the totals; its work does not depend on them
        "bin_scan_kernel": (None, lambda: probe.bin_scan(bc, bs)),
        "fp_bin_scatter_kernel": (
            lambda: (bc.copy_(totals), probe.bin_scan(bc, bs)),
            lambda: probe.fp_bin_scatter(pairs, bs, bb, b["words"], **kw))})


def bin_sort_front(probe, dev, counts, b: dict, n_buckets: int, bucket: int,
                   length: int, seed: int, **geometry) -> dict:
    """The two-level bin sort: ``{name: (set-up, call)}`` for the front and
    each kernel alone, and the batch's bin totals."""
    g = probe.fp_bin_geometry(n_buckets, bucket, BATCH, length - K + 1, dev,
                              **geometry)
    buf = probe.FpScratch().buffers(dev, g, BATCH * (length - K + 1))
    kw = dict(length=length, k=K, seed=seed, n_buckets=n_buckets,
              vlen=b["vlen"])
    ckw = dict(kw, coarse_shift=g.coarse_shift,
               rows_per_block=g.rows_per_block)

    def count():
        probe.fp_coarse_count(buf.coarse_count, buf.block_base, counts,
                              b["words"], **ckw)

    def scatter():
        probe.fp_coarse_scatter(buf.coarse_pairs, buf.coarse_start,
                                buf.coarse_count, buf.block_base, b["words"],
                                stage_cap=g.stage_cap, **ckw)

    def split():   # reads no coarse total; zeroes them
        probe.fp_fine_split(buf.pairs, buf.bin_start, buf.coarse_count,
                            buf.coarse_pairs, buf.coarse_start, shift=g.shift,
                            coarse_shift=g.coarse_shift)

    count()
    totals = buf.coarse_count.clone()
    scatter()
    split()
    return dict(totals=buf.bin_start.diff(), fns={
        "front": (None, lambda: probe.fp_bin_front(counts, b["words"], buf,
                                                   g, **kw)),
        "fp_coarse_count_kernel": (None, lambda: (
            count(), buf.coarse_count.zero_())),
        "fp_coarse_scatter_kernel": (
            lambda: buf.coarse_count.copy_(totals), scatter),
        "fp_fine_split_kernel": (None, split)})


def front_of(probe, *args, **geometry) -> dict:
    if hasattr(probe, "bin_scan"):
        return three_kernel_front(probe, *args)
    return bin_sort_front(probe, *args, **geometry)


def designs(dev, fx: dict) -> dict:
    """count_fp, its front and each front kernel at each length, in two
    turns; torch.cumsum over the bin totals."""
    import torch

    from strainscan_tpu_torch.ops import probe

    fpt, table = fx["fpt"], fx["table"]
    counts = torch.zeros(fpt.n_slots + 1, dtype=torch.int32, device=dev)
    fns = {}
    for length, b in fx["batches"].items():
        scratch = probe.FpScratch()
        fns[f"count_fp_ms_L{length}"] = (
            None, lambda b=b, length=length, s=scratch: probe.count_fp(
                counts, b["words"], table, length=length, k=K, seed=fpt.seed,
                vlen=b["vlen"], scratch=s))
        front = front_of(probe, dev, counts, b, fpt.n_buckets, fpt.bucket,
                         length, fpt.seed)
        for name, fn in front["fns"].items():
            fns[f"{name}_ms_L{length}"] = fn
        totals = front["totals"]
        fns[f"cumsum_ms_L{length}"] = (None, lambda t=totals: torch.cumsum(
            t, 0, dtype=torch.int32))
    out = {name: [] for name in fns}
    for _ in range(2):
        for name, (setup, fn) in fns.items():
            if setup is not None:
                setup()
            out[name].append(cuda_ms(fn))
    return out


def fanout(dev, fx: dict) -> dict:
    """The bin sort and count_fp by coarse bins and rows per block."""
    import torch

    from strainscan_tpu_torch.ops import probe

    fpt, table = fx["fpt"], fx["table"]
    counts = torch.zeros(fpt.n_slots + 1, dtype=torch.int32, device=dev)
    out = {}
    for length, b in fx["batches"].items():
        for coarse_bins in COARSE_BINS:
            for per in ROWS_PER_BLOCK:
                front = bin_sort_front(probe, dev, counts, b, fpt.n_buckets,
                                       fpt.bucket, length, fpt.seed,
                                       coarse_bins=coarse_bins,
                                       rows_per_block=per)
                out[f"L{length}_C{coarse_bins}_rows{per}"] = cuda_ms(
                    front["fns"]["front"][1])
        out[f"count_fp_L{length}"] = cuda_ms(lambda: probe.count_fp(
            counts, b["words"], table, length=length, k=K, seed=fpt.seed,
            vlen=b["vlen"]))
    return out


STUDIES = {"designs": designs, "fanout": fanout}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("studies", nargs="+", choices=sorted(STUDIES))
    ap.add_argument("--root", help="the tree of the port to import "
                    "(default: the one this file is in)")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path[0] = root   # run as a file: import the tree, not bench/
    else:
        sys.path.insert(0, root)
    import torch

    import strainscan_tpu_torch

    if not torch.cuda.is_available():
        raise RuntimeError("the bin-sort studies measure on a CUDA device")
    dev = torch.device("cuda", 0)
    tree = os.path.dirname(os.path.dirname(os.path.abspath(
        strainscan_tpu_torch.__file__)))
    fx = fixture(dev)
    card = card_line()
    for name in args.studies:
        out = STUDIES[name](dev, fx)
        print(json.dumps({"study": name, "tree": tree, "card": card,
                          "batch": BATCH, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
