"""Reads/s of the count on meshes of GPUs: the port's counterpart of
``benchmarks/mesh_scaling.py`` and ``benchmarks/sharded_bench.py``.

``identify.count.count_sample`` end to end (FASTQ parse and pack in the
producer thread, h2d, ``count_fp`` on every mesh position, id-space counts
on the host) at bench.py's ecoli tier: a seeded 14.3 Mb genome, both
strands (a 28,588,812-key table), and 1.2 M reads of 150 bp, which the
count pads to L = 256 as identify does.  Meshes are DATAxINDEX over the
first DATA * INDEX visible GPUs (1x1, 2x2, 4x1 and 1x4; a mesh with more
positions than GPUs is left out and listed as not run).  1x1 is
the single-device pipeline, any other mesh the sharded pipeline at
``IdentifyConfig``'s defaults, built once per mesh (the pipeline cache is
widened to hold them all).

* Every mesh's counts must equal the first mesh's, else the run fails.
* The timed counts are interleaved, one of every mesh per round, for
  three rounds; reads/s is the median round's.  The first
  count of each mesh (``cold_s``: the table's build and upload, and the
  kernels' build on the first) is not timed among them.
* Each mesh's kernel launches in one count (``ops.probe.LAUNCHES``).
* One more count of each mesh under ``torch.profiler``: for every GPU its
  busy share of the count's wall time, its kernel and h2d milliseconds,
  how much of its h2d ran while a kernel of its own ran
  (``h2d_overlap_ms``), and the streams of each; with the calls of
  ``ShardedCountPipeline.ship`` and the threads that made them, where the
  tree has ``ship``.

``--root DIR`` imports another tree of the port (a parent commit unpacked
with ``git archive``) in place of this one, so trees are timed beside each
other in one call: parent, change, change, parent, each in its own process.

    python strainscan_tpu_torch/bench/mesh_scaling.py [--root DIR]

Prints one JSON line: the tree, every card's name and power limit, and per
mesh its reads/s, launches and per-GPU trace shares.  Needs a CUDA device
and raises without one: no number here comes from the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

MESHES = ("1x1", "2x2", "4x1", "1x4")
REPS = 3
GENOME_LEN = 14_300_000   # bench.py's ecoli tier
N_READS = 1_200_000


def parse_mesh(spec: str) -> tuple:
    """``"2x2"`` -> ``(2, 2)``: (data, index) positions."""
    d, i = (int(x) for x in spec.lower().split("x"))
    if d < 1 or i < 1:
        raise ValueError(f"mesh {spec!r}: both axes at least 1")
    return d, i


def overlap(a: list, b: list) -> float:
    """Total length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_shares(events: list, span: tuple) -> dict:
    """Per GPU of a Chrome trace (``torch.profiler``; a device event names
    its GPU in ``args.device``, else in ``pid``), within ``span`` (start,
    end in the trace's microseconds): busy share (kernels, copies and
    sets merged, over the span), kernel and h2d milliseconds, the h2d
    milliseconds that ran while a kernel of the same GPU ran, and the
    streams of its kernels and of its h2d."""
    from strainscan_tpu_torch.bench.scale_parity import (DEVICE_CATS,
                                                         merge_intervals)

    t0, t1 = span
    per: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            gpu = e.get("args", {}).get("device", e.get("pid"))
            per.setdefault(str(gpu), []).append(e)
    out = {}
    for gpu, evs in sorted(per.items()):
        def clipped(which):
            return merge_intervals(
                (max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                for e in which if e["ts"] < t1 and e["ts"] + e["dur"] > t0)

        kernels = [e for e in evs if e["cat"] == "kernel"]
        h2d = [e for e in evs if e["cat"] == "gpu_memcpy"
               and "HtoD" in e["name"]]
        busy, kern, copy = clipped(evs), clipped(kernels), clipped(h2d)
        h2d_us = sum(e - s for s, e in copy)
        both = overlap(copy, kern)
        out[gpu] = {
            "busy_share": sum(e - s for s, e in busy) / max(t1 - t0, 1e-9),
            "kernel_ms": sum(e - s for s, e in kern) / 1e3,
            "h2d_ms": h2d_us / 1e3, "h2d_copies": len(h2d),
            "h2d_overlap_ms": both / 1e3,
            "h2d_overlap_share": both / h2d_us if h2d_us else 0.0,
            "kernel_streams": sorted({e.get("args", {}).get("stream")
                                      for e in kernels}, key=str),
            "h2d_streams": sorted({e.get("args", {}).get("stream")
                                   for e in h2d}, key=str)}
    return out


def card_lines() -> list:
    """Every visible card's index, name and power limit (``nvidia-smi``)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()


def _sync_all() -> None:
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def traced_count(count, mesh, tmp: str) -> dict:
    """One ``count(mesh)`` under ``torch.profiler``: :func:`device_shares`
    over its wall span, and who called ``ship``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from strainscan_tpu_torch.parallel import sharded as psh

    ships: list = []
    ship = getattr(psh.ShardedCountPipeline, "ship", None)
    if ship is not None:
        def spied(self, payloads):
            ships.append(threading.current_thread().name)
            return ship(self, payloads)
        psh.ShardedCountPipeline.ship = spied
    try:
        _sync_all()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("mesh_count"):
                count(mesh)
            _sync_all()
    finally:
        if ship is not None:
            psh.ShardedCountPipeline.ship = ship
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    (mark,) = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == "mesh_count"]
    span = (mark["ts"], mark["ts"] + mark["dur"])
    return {"wall_ms": mark["dur"] / 1e3,
            "gpus": device_shares(events, span),
            "ship_calls": len(ships) if ship is not None else None,
            "ship_threads": sorted(set(ships))}


def run(meshes=MESHES, reps: int = REPS, n_reads: int = N_READS) -> dict:
    import numpy as np
    import torch

    import strainscan_tpu_torch
    from strainscan_tpu_torch.bench import count as bcount
    from strainscan_tpu_torch.bench import cuda_device
    from strainscan_tpu_torch.config import IdentifyConfig
    from strainscan_tpu_torch.identify import count as icount
    from strainscan_tpu_torch.index.hashtable import FpTable
    from strainscan_tpu_torch.ops import probe
    from strainscan_tpu_torch.parallel import sharded as psh

    dev = cuda_device("cuda")
    n_gpu = torch.cuda.device_count()
    gpus = [torch.device("cuda", i) for i in range(n_gpu)]
    shapes = {m: parse_mesh(m) for m in meshes}
    fits = [m for m in meshes if shapes[m][0] * shapes[m][1] <= n_gpu]
    res: dict = {
        "tree": os.path.dirname(os.path.dirname(os.path.abspath(
            strainscan_tpu_torch.__file__))),
        "cards": card_lines(), "torch": torch.__version__, "gpus": n_gpu,
        "n_reads": n_reads, "read_len": bcount.READ_LEN,
        "padded_to": IdentifyConfig().max_read_len,
        "tree_has_ship": hasattr(psh.ShardedCountPipeline, "ship"),
        "not_run": [m for m in meshes if m not in fits], "meshes": {}}
    tmp = tempfile.mkdtemp(prefix="sst_mesh_")
    cache_max = icount._SHARDED_CACHE_MAX
    icount._SHARDED_CACHE.clear()
    icount._SHARDED_CACHE_MAX = max(len(fits), cache_max)
    try:
        t0 = time.perf_counter()
        keys, fq = bcount.synthesize(tmp, "ecoli", GENOME_LEN, n_reads,
                                     device=dev)
        fpt = FpTable.build(keys, k=bcount.K)
        res.update(n_keys=int(keys.size),
                   inputs_s=time.perf_counter() - t0)
        mesh_of = {m: psh.make_mesh(gpus[:shapes[m][0] * shapes[m][1]],
                                    index_shards=shapes[m][1])
                   for m in fits}

        def count(mesh):
            return icount.count_sample(fpt, fq, mesh, IdentifyConfig(),
                                       keys=keys)

        want = None
        for m in fits:
            t0 = time.perf_counter()
            got = count(mesh_of[m])
            cold = time.perf_counter() - t0
            if want is None:
                want = got
            n_diff = int(np.count_nonzero(got != want))
            res["meshes"][m] = {
                "data": shapes[m][0], "index": shapes[m][1],
                "devices": [str(d) for d in mesh_of[m].devices],
                "cold_s": cold, "ids_differ": n_diff, "s": []}
            if n_diff:
                raise RuntimeError(f"mesh {m}: {n_diff} ids differ from "
                                   f"mesh {fits[0]}'s counts")
        for _ in range(reps):
            for m in fits:
                probe.reset_launches()
                _sync_all()
                t0 = time.perf_counter()
                count(mesh_of[m])
                res["meshes"][m]["s"].append(time.perf_counter() - t0)
                res["meshes"][m]["launches"] = {
                    k: v for k, v in probe.LAUNCHES.items() if v}
        for m in fits:
            rec = res["meshes"][m]
            rec["reads_s"] = [n_reads / s for s in rec["s"]]
            rec["median_reads_s"] = n_reads / statistics.median(rec["s"])
            rec["trace"] = traced_count(count, mesh_of[m], tmp)
            print(f"[mesh_scaling] {m}: {json.dumps(rec)}", file=sys.stderr,
                  flush=True)
    finally:
        icount._SHARDED_CACHE.clear()
        icount._SHARDED_CACHE_MAX = cache_max
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    t0 = time.perf_counter()
    res = run()
    res["study_s"] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
