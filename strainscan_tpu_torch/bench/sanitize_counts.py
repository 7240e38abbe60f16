"""Runs the port's count kernels once each at a reduced shape and exits, for
NVIDIA's compute-sanitizer to watch (``chip_smoke.py`` does not run it):

    python3 -c 'from strainscan_tpu_torch.ops import _build; _build.lib()'
    for tool in memcheck racecheck synccheck initcheck; do
      compute-sanitizer --tool $tool --error-exitcode 9 \\
          python3 -m strainscan_tpu_torch.bench.sanitize_counts
    done

(build the kernels first, outside the sanitizer).  The shape: a seeded
3.5 Mb genome, both strands (7.0 M keys), in an exact table of 2^20 rows of
96 B at load 0.9 (so windows probe past their home row) and a fingerprint
table of 2^20 rows of 64 lanes (4,096 fine bins, 256 coarse bins); 4,096
reads of 150 bp (5 % random, every ninth with a mid-read N), padded to
L = 256, in each payload form (vlen, vbytes, raw codes).  It runs
``count_exact`` (``count_exact_kernel``, ``exact_apply_kernel``), the
binned ``count_fp`` (``fp_coarse_count_kernel``, ``fp_coarse_scatter_kernel``,
``fp_fine_split_kernel``, ``fp_bin_probe_kernel``) and ``sharded_count`` on a
2 x 2 mesh whose four positions are one card, and holds each against its
plain twin.  Prints one JSON line; exits 1 if a count differs.
"""

from __future__ import annotations

import json
import sys

import numpy as np

K = 31
GENOME_LEN = 3_500_000
N_BUCKETS = 1 << 20
N_READS = 4096
READ_LEN = 150
LENGTH = 256
SEED = 0


def main() -> int:
    import torch

    from strainscan_tpu_torch.index.hashtable import (FpTable, KmerTable,
                                                      fp_table_to_device,
                                                      kmer_table_to_device)
    from strainscan_tpu_torch.kmer import device as kdev
    from strainscan_tpu_torch.kmer import pack
    from strainscan_tpu_torch.ops import probe
    from strainscan_tpu_torch.parallel import (ShardedTable, make_mesh,
                                               sharded_count)

    if not torch.cuda.is_available():
        raise RuntimeError("the count kernels run on a CUDA device")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    genome = rng.integers(0, 4, size=GENOME_LEN).astype(np.uint8)
    hi, lo, _ = kdev.extract_kmers(torch.from_numpy(genome[None]).to(dev), K)
    rhi, rlo = kdev.revcomp(hi, lo, K)
    keys = torch.unique(torch.cat([(hi << 32 | lo).ravel(),
                                   (rhi << 32 | rlo).ravel()]))
    keys = keys.cpu().numpy().view(np.uint64)
    kt = KmerTable.build(keys, k=K, load_factor=0.9)
    fpt = FpTable.build(keys, k=K,
                        load_factor=keys.size / (N_BUCKETS * 64) * (1 + 1e-9))
    if (kt.n_buckets, fpt.n_buckets) != (N_BUCKETS, N_BUCKETS):
        raise RuntimeError(f"table rows {kt.n_buckets}, {fpt.n_buckets}: "
                           f"want {N_BUCKETS}")
    exact, fp = kmer_table_to_device(kt, dev).table, fp_table_to_device(
        fpt, dev).fp

    starts = rng.integers(0, GENOME_LEN - READ_LEN, size=N_READS)
    clean = np.full((N_READS, LENGTH), 4, np.uint8)
    clean[:, :READ_LEN] = genome[starts[:, None] + np.arange(READ_LEN)]
    clean[:N_READS // 20, :READ_LEN] = rng.integers(
        0, 4, size=(N_READS // 20, READ_LEN))
    dirty = clean.copy()
    dirty[::9, 70] = 4
    words, vbytes = pack.bitpack_codes(dirty)
    cwords, _ = pack.bitpack_codes(clean)
    forms = {
        "vlen": (kdev.from_u32(cwords).to(dev), {"vlen": torch.from_numpy(
            pack.valid_prefix_lens(clean)).to(dev)}),
        "vbytes": (kdev.from_u32(words).to(dev),
                   {"vbytes": torch.from_numpy(vbytes).to(dev)}),
        "codes": (torch.from_numpy(dirty).to(dev), {})}

    def equal(a, b) -> bool:
        return bool(torch.equal(a, b))

    out = {}
    probe.reset_launches()
    for name, (reads, valid) in forms.items():
        kw = dict(length=LENGTH, k=K, **valid)
        ekw = dict(kw, max_probe=kt.max_probe)
        got = torch.zeros(kt.n_keys + 1, dtype=torch.int32, device=dev)
        want = torch.zeros_like(got)
        probe.count_exact(got, reads, exact, **ekw)
        probe.count_exact_plain(want, reads, exact, **ekw)
        out[f"count_exact_{name}"] = equal(got, want) and not any(
            probe.exact_parity(reads, exact, kt.n_keys, **ekw).values())
        got = torch.zeros(fpt.n_slots + 1, dtype=torch.int32, device=dev)
        want = torch.zeros_like(got)
        probe.count_fp(got, reads, fp, seed=fpt.seed, **kw)
        probe.count_fp_plain(want, reads, fp, seed=fpt.seed, **kw)
        out[f"count_fp_{name}"] = equal(got, want) and not any(
            probe.fp_bin_parity(reads, fp, seed=fpt.seed, **kw).values())
    st = ShardedTable.build(keys, k=K, n_shards=2)
    got = sharded_count(make_mesh([dev] * 4), st, dirty)
    want = torch.zeros(kt.n_keys + 1, dtype=torch.int32, device=dev)
    probe.count_exact_plain(want, forms["codes"][0], exact, length=LENGTH,
                            k=K, max_probe=kt.max_probe)
    out["sharded_count"] = equal(got[:kt.n_keys], want[:-1])
    torch.cuda.synchronize()
    print(json.dumps({"equal": out, "launches": dict(probe.LAUNCHES),
                      "keys": int(keys.size), "max_probe": kt.max_probe}),
          flush=True)
    return 0 if all(out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
