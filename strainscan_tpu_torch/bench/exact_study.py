"""Design studies of the exact count on one GPU (``chip_smoke.py`` does not
run them).

The fixture is the smoke's count-ecoli geometry: a seeded 14.3 Mb genome,
both strands (28.6 M keys, an exact table of 2^24 rows of 96 B), and one
batch of 65,536 reads of 150 bp drawn from it, padded with invalid codes to
L = 256 (the exact stream's shape) or not (L = 150), shipped as vbytes.

* ``designs``: ``count_exact`` (both its kernels) and ``probe_prep`` at
  65,536 x 256 and x 150, CUDA-event means over ``REPS`` calls in two turns.
  It uses only what every tree of the port has, so it can time a parent
  commit's kernels beside this one's in one call, in separate processes:
  parent, change, change, parent (``--root`` names the tree to import).
* ``slices``: the whole ``count_exact`` at L = 256 with 8, 16 and 32 MiB of
  counts per slice of ``exact_apply_kernel`` (the kernel's own choice is the
  largest power of two within a third of the L2: 16 MiB on an H100).
* ``parts``: where ``count_exact``'s time goes: the batch's first-probe
  rows alone (``row_gather_kernel`` over the same 96 B rows; it reads them
  chunk by chunk of the table, not in window order) and its count updates
  alone (``index_add_`` of one into each hit
  id in window order, in id order, and grouped by quarter of the ids).

    python strainscan_tpu_torch/bench/exact_study.py designs [--root DIR]
    python -m strainscan_tpu_torch.bench.exact_study slices parts

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
SLICE_MIB = (8, 16, 32)
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
    """The exact table on ``dev`` and the batch at each length as codes
    and as a vbytes payload."""
    import torch

    from strainscan_tpu_torch.index.hashtable import (KmerTable,
                                                      kmer_table_to_device)
    from strainscan_tpu_torch.kmer import device as kdev
    from strainscan_tpu_torch.kmer import pack

    rng = np.random.default_rng(SEED)
    genome = rng.integers(0, 4, size=GENOME_LEN).astype(np.uint8)
    hi, lo, _ = kdev.extract_kmers(torch.from_numpy(genome[None]).to(dev), K)
    rhi, rlo = kdev.revcomp(hi, lo, K)
    keys = torch.unique(torch.cat([(hi << 32 | lo).ravel(),
                                   (rhi << 32 | rlo).ravel()]))
    keys = keys.cpu().numpy().view(np.uint64)
    kt = KmerTable.build(keys, k=K)
    starts = rng.integers(0, GENOME_LEN - READ_LEN, size=BATCH)
    reads = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
    flips = rng.random(BATCH) < 0.5
    reads[flips] = (3 - reads[flips])[:, ::-1]
    batches = {}
    for length in LENGTHS:
        codes = np.full((BATCH, length), 4, np.uint8)
        codes[:, :READ_LEN] = reads
        words, vbytes = pack.bitpack_codes(codes)
        batches[length] = dict(
            codes=codes, codes_d=torch.from_numpy(codes).to(dev),
            words=kdev.from_u32(words).to(dev),
            vbytes=torch.from_numpy(vbytes).to(dev))
    return dict(kt=kt, table=kmer_table_to_device(kt, dev), batches=batches)


def designs(dev, fx: dict) -> dict:
    """count_exact and probe_prep at each length, in two turns."""
    import torch

    from strainscan_tpu_torch.ops import probe

    kt, table = fx["kt"], fx["table"]
    counts = torch.zeros(kt.n_keys + 1, dtype=torch.int32, device=dev)
    fns = {}
    for length, b in fx["batches"].items():
        fns[f"count_exact_ms_L{length}"] = lambda b=b, length=length: \
            probe.count_exact(counts, b["words"], table.table, length=length,
                              k=K, max_probe=kt.max_probe, vbytes=b["vbytes"])
        fns[f"probe_prep_ms_L{length}"] = lambda b=b: probe.probe_prep(
            b["codes_d"], k=K, n_buckets=1 << 20, seed=0)
    out = {name: [] for name in fns}
    for _ in range(2):
        for name, fn in fns.items():
            out[name].append(cuda_ms(fn))
    return out


def slices(dev, fx: dict) -> dict:
    """The whole count at L = 256 by MiB of counts per slice."""
    import torch

    from strainscan_tpu_torch.ops import probe

    kt, table, b = fx["kt"], fx["table"], fx["batches"][256]
    counts = torch.zeros(kt.n_keys + 1, dtype=torch.int32, device=dev)
    kw = dict(length=256, k=K, max_probe=kt.max_probe, vbytes=b["vbytes"])
    out = {}
    for mib in SLICE_MIB:
        out[mib] = cuda_ms(lambda mib=mib: probe.exact_apply(
            counts, *probe.exact_probe(counts, b["words"], table.table, **kw),
            slice_ids=(mib << 20) // 4))
    return out


def parts(dev, fx: dict) -> dict:
    """The first-probe rows alone and the count updates alone."""
    import torch

    from strainscan_tpu_torch.bench.count import host_window_keys
    from strainscan_tpu_torch.index.hashtable import mix_np
    from strainscan_tpu_torch.ops import gather, probe

    kt, table = fx["kt"], fx["table"]
    wkeys, valid = host_window_keys(fx["batches"][256]["codes"], K)
    q = wkeys[valid]
    home = mix_np((q >> np.uint64(32)).astype(np.uint32),
                  (q & np.uint64(0xFFFFFFFF)).astype(np.uint32)).astype(
                      np.int64) & (kt.n_buckets - 1)
    ids = kt.lookup_host(q)
    home_d = torch.from_numpy(home.astype(np.int32)).to(dev)
    hit = torch.from_numpy(ids[ids >= 0].astype(np.int64)).to(dev)
    ones = torch.ones(hit.shape[0], dtype=torch.int32, device=dev)
    counts = torch.zeros(kt.n_keys + 1, dtype=torch.int32, device=dev)
    in_order = hit.sort().values
    quarter = hit[torch.sort(hit // (kt.n_keys // 4 + 1), stable=True).indices]
    b = fx["batches"][256]
    return dict(
        windows=int(home.size), hits=int(hit.shape[0]),
        rows_ms=cuda_ms(lambda: gather.row_gather_xor(
            table.table, home_d, tile=2048, nbuf=16)),
        adds_window_order_ms=cuda_ms(lambda: counts.index_add_(0, hit, ones)),
        adds_id_order_ms=cuda_ms(lambda: counts.index_add_(0, in_order, ones)),
        adds_by_quarter_ms=cuda_ms(lambda: counts.index_add_(0, quarter,
                                                             ones)),
        count_exact_ms=cuda_ms(lambda: probe.count_exact(
            counts, b["words"], table.table, length=256, k=K,
            max_probe=kt.max_probe, vbytes=b["vbytes"])))


STUDIES = {"designs": designs, "slices": slices, "parts": parts}


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
        raise RuntimeError("the exact-count studies measure on a CUDA device")
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
