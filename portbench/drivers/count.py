"""The count loop: one FASTQ sample per ``count_sample`` call, each ending
in its host count vector (``identify/count.py::count_sample``, fp mode,
``canonical=False``, as identify counts).

Set-up draws a genome from the seed, takes its both-strand k-mers as the
table's keys, lets the program build its table (``FpTable.build``; on a
mesh ``count_sample`` also builds its sharded table from the keys),
writes the mix's distinct samples and counts one of them to warm up.
The reference counts each distinct sample's code reads exactly (each
window looked up in the sorted keys); every vector the window produced is
compared with the reference's of its sample, id by id.  The guarantee is
exact counts up to the fingerprint's strays, and a stray only adds: no id
may count below the reference (``ids_under``), and the windows counted
above it in one sample (``stray_windows``) stay within an allowance.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from portbench import roofline, synth
from portbench.harness import Check, Run
from portbench.reference import exact, fptable

# a stray only adds, so no id counts under the reference; the strays'
# allowance lies between the readings of sound runs and of the control
# (16-bit fingerprints), see PERF.md
IDS_UNDER_LIMIT = 0
STRAY_WINDOWS_LIMIT = 8


def make_samples(rng, genome: np.ndarray, mix: dict) -> list:
    """The mix's distinct samples: uint8 code rows."""
    n, length = mix["reads"], mix["read_len"]
    n_miss = int(n * mix["miss_share"])
    n_n = int(n * mix["n_share"])
    n_hit = n - n_miss - n_n
    out = []
    for _ in range(mix["distinct"]):
        reads = np.concatenate([
            synth.genome_reads(rng, genome, n_hit, length),
            synth.random_reads(rng, n_miss, length),
            synth.genome_reads(rng, genome, n_n, length)])
        pos = rng.integers(10, length - 10, size=n_n)
        reads[np.arange(n_hit + n_miss, n), pos] = synth.N_CODE
        out.append(reads[rng.permutation(n)])
    return out


def make_inputs(run: Run) -> None:
    """The seed's genome, its keys and the mix's distinct samples."""
    cfg = run.config
    rng = np.random.default_rng(run.seed)
    genome = synth.random_genome(rng, cfg["genome_len"])
    keys = fptable.genome_keys(genome, run.devices[0], cfg["k"])
    run.state.update(keys=keys, samples=make_samples(rng, genome,
                                                     run.traffic))


def prepare(run: Run) -> None:
    from strainscan_tpu_torch.config import IdentifyConfig
    from strainscan_tpu_torch.identify.count import count_sample
    from strainscan_tpu_torch.index.hashtable import FpTable

    cfg = run.config
    make_inputs(run)
    paths = []
    for i, reads in enumerate(run.state["samples"]):
        paths.append(os.path.join(run.tmp, f"sample{i}.fq"))
        synth.write_fastq(paths[-1], reads)
    pcfg = IdentifyConfig(ksize=cfg["k"], read_batch=cfg["read_batch"],
                          max_read_len=cfg["max_read_len"],
                          shard_min_kmers=cfg.get(
                              "shard_min_kmers",
                              IdentifyConfig.shard_min_kmers))
    t0 = time.perf_counter()
    table = FpTable.build(run.state["keys"], k=cfg["k"])
    run.log(f"keys {run.state['keys'].size}; program table built in "
            f"{time.perf_counter() - t0} s")
    run.state.update(paths=paths, table=table, pcfg=pcfg,
                     count_sample=count_sample)
    count(run, 0)                                    # warm-up


def count(run: Run, d: int) -> np.ndarray:
    s = run.state
    return s["count_sample"](s["table"], s["paths"][d], run.device,
                             s["pcfg"], canonical=False, keys=s["keys"])


def step(run: Run, i: int) -> dict:
    from strainscan_tpu_torch.ops import count as ops_count

    d = i % len(run.state["paths"])
    ops_count.reset_fetches()
    with torch.profiler.record_function("bench/count_sample"):
        counts = count(run, d)
    return {"sample": d, "reads": run.state["samples"][d].shape[0],
            "counts": counts,
            "finish_s": sum(f.s for f in ops_count.FETCHES)}


def end_to_end(run: Run, records: list, wall_s: float) -> dict:
    return {"count_reads_per_s": sum(r["reads"] for r in records) / wall_s}


def reference(run: Run, fp_bits: int | None = None) -> list:
    """Counts per distinct sample: exact, or (the control) through the
    fingerprint table at ``fp_bits``-bit fingerprints."""
    cfg, dev = run.config, run.devices[0]
    keys = fptable.keys_tensor(run.state["keys"], dev)
    if fp_bits is None:
        return [exact.count(keys, reads, dev, cfg["read_batch"], cfg["k"])
                for reads in run.state["samples"]]
    table = fptable.narrowed(fptable.build(keys), fp_bits)
    return [fptable.count(table, reads, dev, batch=cfg["read_batch"],
                          k=cfg["k"]) for reads in run.state["samples"]]


def work(run: Run) -> list:
    """``(bytes, operations)`` per batch per distinct sample, from the
    probe of the published table (``portbench/roofline.py``)."""
    cfg, dev = run.config, run.devices[0]
    table = fptable.build(fptable.keys_tensor(run.state["keys"], dev))
    out = []
    for reads in run.state["samples"]:
        batches = []
        fptable.count(table, reads, dev, batch=cfg["read_batch"], k=cfg["k"],
                      on_batch=lambda b, keys, p: batches.append(
                          roofline.batch_work(b, cfg["max_read_len"],
                                              table.bucket, p)))
        out.append(batches)
    return out


def compare(got: list, want: list) -> list:
    """Over ``got``'s (distinct sample, vector) pairs: ``ids_under``, ids
    counted below the reference, summed; ``stray_windows``, the windows
    counted above it, in the worst sample."""
    under, stray = 0, 0
    for d, v in got:
        w = want[d]
        if v.shape != w.shape:
            under += w.size
            continue
        diff = v.astype(np.int64) - w
        under += int(np.count_nonzero(diff < 0))
        stray = max(stray, int(diff[diff > 0].sum()))
    return [Check("ids_under", under, IDS_UNDER_LIMIT),
            Check("stray_windows", stray, STRAY_WINDOWS_LIMIT)]


def judge(run: Run, records: list) -> list:
    t0 = time.perf_counter()
    want = reference(run)
    if run.trace:
        run.state["work"] = work(run)
    checks = compare([(r["sample"], r["counts"]) for r in records], want)
    run.log(f"reference: {len(want)} samples in "
            f"{time.perf_counter() - t0} s")
    return checks
