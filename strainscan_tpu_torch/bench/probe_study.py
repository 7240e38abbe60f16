"""Device-wall study of the count step's row gather and scatter on one GPU.

The counterpart of ``benchmarks/probe_bench3.py`` (a study on the TPU) for
the port.  The count kernel's device work per window is one fingerprint-row
read from a table far larger than the L2 and one scatter-add; this study
measures each alone, at the E. coli scale (28.6 M keys: a 1,048,576 x 64
fingerprint table, 256 MiB) with 2^23 windows per call:

* gather: the plain torch gather-and-reduce (``index_select`` + ``sum``) at
  256 B and 512 B rows; ``row_gather_kernel`` (``ops/gather.py``, the port
  of the Pallas ``dma_gather_kernel``) at three (tile, nbuf) configurations
  at 512 B rows, the Pallas kernel's width, and at the production 256 B row,
  each checked over every tile against the NumPy XOR-fold oracle and timed
  against its plain twin;
* scatter: the plain scatter-add, the sort alone, and sort -> run-length
  compaction -> scatter at slot multiplicity 8 and 64, each compaction
  checked equal to the plain scatter.

The inputs are drawn from seed ``SEED`` in the order of the TPU study, so
both see the same table, indices and slots.  Times are CUDA-event means over
``REPS`` calls after a warm-up.  A check that fails raises; nothing is
caught.

    python -m strainscan_tpu_torch.bench.probe_study [--out FILE]

Prints one JSON line with the keys of the TPU study's PROBE_STUDY3.json (the
``xla_gather_*`` keys hold the torch gather-and-reduce baseline; the
``dma_gather_*`` entries hold ``row_gather_kernel``), plus the card line and
each kernel's ms beside its plain twin's; writes it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Tuple

import numpy as np
import torch

from strainscan_tpu_torch.bench import card_line, cuda_device, cuda_ms
from strainscan_tpu_torch.kmer.device import from_u32
from strainscan_tpu_torch.ops.gather import row_gather_xor, row_gather_xor_plain

BUCKET = 64                     # production fp row: 64 uint32 = 256 B
N_KEYS = 28_600_000             # E. coli scale
W = 1 << 23                     # windows per timed call
REPS = 5
SEED = 0
CONFIGS = ((2048, 8), (2048, 16), (8192, 16))   # (tile, nbuf)
MULTIPLICITIES = (8, 64)
# rows per chunk of the host oracle (bounds its gather to 256 MiB)
ORACLE_CHUNK_ROWS = 1 << 19


def log(msg: str) -> None:
    print(f"[probe_study] {msg}", file=sys.stderr, flush=True)


def n_buckets_for(n_keys: int, bucket: int = BUCKET) -> int:
    """The fp table's bucket count: the least power of two at which the
    table is at most half full (the TPU study's geometry)."""
    n = 1
    while n * bucket * 0.5 < n_keys:
        n *= 2
    return n


def xor_fold_oracle(table: np.ndarray, idx: np.ndarray, tile: int,
                    nbuf: int) -> np.ndarray:
    """NumPy oracle of the row gather over every whole tile: uint32
    ``[(W // tile) * nbuf, roww]``."""
    n_tiles = idx.shape[0] // tile
    roww = table.shape[1]
    out = np.empty((n_tiles * nbuf, roww), dtype=np.uint32)
    per = max(1, ORACLE_CHUNK_ROWS // tile)
    for t0 in range(0, n_tiles, per):
        t1 = min(n_tiles, t0 + per)
        rows = table[idx[t0 * tile:t1 * tile]]
        out[t0 * nbuf:t1 * nbuf] = np.bitwise_xor.reduce(
            rows.reshape(t1 - t0, tile // nbuf, nbuf, roww), axis=1
        ).reshape(-1, roww)
    return out


def gather_reduce(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain gather baseline: gather the rows, consume them in a sum
    (int32, wrapping, as the TPU study's uint32 sum)."""
    return table.index_select(0, idx).sum(dtype=torch.int32)


def plain_scatter(counts: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``counts[slot] += 1`` for every slot, in place."""
    return counts.index_add_(0, slots, torch.ones_like(slots,
                                                       dtype=counts.dtype))


def compressed_scatter(counts: torch.Tensor,
                       slots: torch.Tensor) -> torch.Tensor:
    """Sort -> run-length compaction -> scatter of (unique slot, run
    length), in place: one update per distinct slot."""
    uniq, runs = torch.unique_consecutive(torch.sort(slots).values,
                                          return_counts=True)
    return counts.index_add_(0, uniq, runs.to(counts.dtype))


def _kernel_vs_plain(table: torch.Tensor, idx: torch.Tensor, tile: int,
                     nbuf: int, reps: int) -> Tuple[float, float]:
    """Best-of-two mean ms of the kernel and of its plain twin, timed
    plain, kernel, kernel, plain."""
    ms: Dict[str, list] = {"kernel": [], "plain": []}
    for order in ("plain", "kernel", "kernel", "plain"):
        fn = row_gather_xor if order == "kernel" else row_gather_xor_plain
        ms[order].append(cuda_ms(lambda: fn(table, idx, tile=tile, nbuf=nbuf),
                                 reps))
    return min(ms["kernel"]), min(ms["plain"])


def gather_section(device, n_keys: int = N_KEYS, windows: int = W,
                   reps: int = REPS):
    """The gather half of the study.  Returns ``(results, rng, n_slots)``:
    the rng continues into :func:`scatter_section`, as in the TPU study."""
    dev = cuda_device(device)
    rng = np.random.default_rng(SEED)
    n_buckets = n_buckets_for(n_keys)
    table_np = rng.integers(0, 1 << 32, size=(n_buckets, BUCKET),
                            dtype=np.uint32)
    idx_np = rng.integers(0, n_buckets, size=windows, dtype=np.int32)
    log(f"table {n_buckets} x {BUCKET} ({table_np.nbytes} B), {windows} "
        f"windows")
    res: dict = {"device": torch.cuda.get_device_name(dev), "card": card_line(),
                 "n_keys": n_keys, "windows": windows,
                 "table_MB": table_np.nbytes / 1e6}
    table = from_u32(table_np).to(dev)
    idx = torch.from_numpy(idx_np).to(dev)
    res["xla_gather_Mrows_s_256B"] = windows / cuda_ms(
        lambda: gather_reduce(table, idx), reps) / 1e3
    # the Pallas kernel's 512 B rows: the same table as 2 x 64 words a row
    wide_np = table_np.reshape(n_buckets // 2, 2 * BUCKET)
    idx_wide_np = rng.integers(0, n_buckets // 2, size=windows,
                               dtype=np.int32)
    wide = table.view(n_buckets // 2, 2 * BUCKET)
    idx_wide = torch.from_numpy(idx_wide_np).to(dev)
    # the distinct rows each width reads (a bound reads each of them once)
    res["rows_touched_512B"] = int(np.unique(idx_wide_np).size)
    res["rows_touched_256B"] = int(np.unique(idx_np).size)
    res["xla_gather_Mrows_s_512B"] = windows / cuda_ms(
        lambda: gather_reduce(wide, idx_wide), reps) / 1e3
    log(f"torch gather-and-reduce: {res['xla_gather_Mrows_s_256B']} M rows/s "
        f"(256 B), {res['xla_gather_Mrows_s_512B']} (512 B)")

    for name, t, t_np, i, i_np in (
            ("dma_gather_Mrows_s_512B", wide, wide_np, idx_wide, idx_wide_np),
            ("dma_gather_Mrows_s_256B", table, table_np, idx, idx_np)):
        res[name] = {}
        for tile, nbuf in CONFIGS:
            got = row_gather_xor(t, i, tile=tile, nbuf=nbuf)
            want = xor_fold_oracle(t_np, i_np, tile, nbuf)
            if not np.array_equal(got.cpu().numpy().view(np.uint32), want):
                raise RuntimeError(f"row_gather_kernel != the NumPy oracle "
                                   f"({name}, tile={tile}, nbuf={nbuf})")
            ms, plain_ms = _kernel_vs_plain(t, i, tile, nbuf, reps)
            res[name][f"tile{tile}_nbuf{nbuf}"] = {
                "Mrows_s": windows / ms / 1e3, "bit_exact": True,
                "ms": ms, "plain_ms": plain_ms}
            log(f"row_gather_kernel {name[-4:]} tile={tile} nbuf={nbuf}: "
                f"{ms} ms ({windows / ms / 1e3} M rows/s) vs plain "
                f"{plain_ms} ms; equal to the oracle over every tile")
    return res, rng, n_buckets * BUCKET


def scatter_section(device, rng: np.random.Generator, n_slots: int,
                    windows: int = W, reps: int = REPS) -> dict:
    """The scatter half of the study, on slots drawn from ``rng``."""
    dev = cuda_device(device)
    res: dict = {}
    counts = torch.zeros(n_slots + 1, dtype=torch.int32, device=dev)
    slots = torch.from_numpy(rng.integers(0, n_slots, size=windows,
                                          dtype=np.int32)).to(dev)
    res["plain_scatter_Mupd_s"] = windows / cuda_ms(
        lambda: plain_scatter(counts, slots), reps) / 1e3
    res["sort_Melem_s"] = windows / cuda_ms(
        lambda: torch.sort(slots), reps) / 1e3
    log(f"plain scatter {res['plain_scatter_Mupd_s']} M upd/s, sort "
        f"{res['sort_Melem_s']} M elem/s")
    res["compressed_scatter_Mwin_s"] = {}
    for mult in MULTIPLICITIES:
        # synthetic multiplicity: windows drawn from W // mult distinct slots
        pool = rng.integers(0, n_slots, size=windows // mult, dtype=np.int32)
        slots_m = torch.from_numpy(rng.choice(pool, size=windows)).to(dev)
        want = plain_scatter(torch.zeros_like(counts), slots_m)
        got = compressed_scatter(torch.zeros_like(counts), slots_m)
        if not torch.equal(got, want):
            raise RuntimeError(f"compressed scatter != plain scatter at "
                               f"multiplicity {mult}")
        rate = windows / cuda_ms(lambda: compressed_scatter(counts, slots_m),
                                 reps) / 1e3
        plain_rate = windows / cuda_ms(lambda: plain_scatter(counts, slots_m),
                                       reps) / 1e3
        res["compressed_scatter_Mwin_s"][f"mult{mult}"] = {
            "compressed": rate, "plain": plain_rate, "bit_exact": True}
        log(f"multiplicity {mult}: compressed {rate} vs plain {plain_rate} "
            f"M win/s; equal")
    return res


def run(device="cuda", n_keys: int = N_KEYS, windows: int = W,
        reps: int = REPS) -> dict:
    """The whole study on one CUDA device."""
    res, rng, n_slots = gather_section(device, n_keys, windows, reps)
    res.update(scatter_section(device, rng, n_slots, windows, reps))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the JSON to this file")
    args = ap.parse_args(argv)
    res = run(args.device)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
