"""Identify at E. coli scale: the ``ours`` and ``diff`` halves of
``benchmarks/scale_parity.py`` for the port, and a trace of one sample.

Runs over the fixture of :mod:`.scale_fixture` (1,647 strains, a 28.6 M-key
DB, the samples single, crossmix, intramix and deep):

    python -m strainscan_tpu_torch.bench.scale_parity ours --device cuda
    python -m strainscan_tpu_torch.bench.scale_parity ours --device cpu
    python -m strainscan_tpu_torch.bench.scale_parity ours --device cuda \\
        --index-shards 1 [--l2-rows 1]
    python -m strainscan_tpu_torch.bench.scale_parity procs 4
    python -m strainscan_tpu_torch.bench.scale_parity diff \\
        .scale_torch/parity/ours_cuda .scale_torch/parity/ours_cpu
    python -m strainscan_tpu_torch.bench.scale_parity trace --sample deep

``ours`` identifies every sample with ``identify/pipeline.py::run_identify``
in one process: a cold pass (the first sample loads the DB and uploads its
table), a warm pass over the same samples, one ``batch-identify`` over all
of them through ``cli.main``, and one ``python -m strainscan_tpu_torch.cli
identify`` of the first sample in a fresh process.  It keeps each sample's
wall seconds, its ``identify/*`` phase seconds, the seconds of each L2
union count, the count kernels' launches (``ops.probe.LAUNCHES``),
the tables uploaded, every stream-end fetch (``ops.count.FETCHES``: route,
d2h bytes, ``slot_of_id`` upload) with the main count's ``finish_s``, and
the host's resident set, in
``<root>/parity/<name>.json``, beside the report trees under
``<root>/parity/<name>/``.  It fails if a sample finds no cluster,
if the DB's table is uploaded more than once, or, on ``cuda``, if a sample
did not launch ``fp_bin_probe_kernel``.

On ``cuda`` it counts on a mesh of every visible GPU (``make_mesh`` with
``--index-shards``; ``CUDA_VISIBLE_DEVICES`` picks the GPUs), as the CLI
does.  ``<name>`` is ``ours_<device>`` for one position, else it adds the
distinct devices and the mesh shape (data x index), and ``_l2rows<R>``
with ``--l2-rows R`` (``IdentifyConfig.shard_min_l2_rows``), e.g.
``ours_cuda_4gpu_2x2``.  Every record states the mesh, the route of each
count (``sharded`` or ``single``) and each call of the L2 mesh gate
(``parallel.sharded.l2_mesh``: rows, gate, opened).  The ``batch`` and
fresh-process passes go through the CLI, which counts on its own mesh
(every visible GPU at the default index shards, the default config): a
run on another mesh or config makes only the cold and warm passes.

``procs N`` runs ``batch-identify`` of every sample in N processes under
``torchrun`` (``torch.distributed.run --standalone``), each on its own GPU
(``cuda:LOCAL_RANK``), into ``<root>/parity/ours_<device>_<N>proc/rank<r>/``;
each rank records per sample its wall seconds, its count seconds and the
seconds of each ``merge_counts`` (the gloo all-reduce of the count
vector), in ``<name>.json``.

``diff A B`` compares two such report trees file by file: byte equality per
sample directory (a directory of one tree that the other lacks is held
against the other's first directory of the same sample, so a ``procs``
tree compares with an ``ours`` tree); where bytes differ, the Enet fields
(rtol 1e-9) and any other field that differs, to explain it.  Any difference fails (exit 1), as
does a sample whose truth strains are not in its report or an ``intramix``
that did not reach the Enet vote (``StrainVote.report``).  It writes
``<root>/parity/diff_<A>_<B>.json``.

``trace`` runs one warm identify of a sample on the GPU under
``torch.profiler`` and prints the device-busy share of each ``identify/*``
phase (and of the L2 union count, ``identify/l2_vote/union_count``, inside
``identify/l2_vote``), the device operations each of them launched, the top
device operations and the longest idle gaps of the device.

The ``ref`` half of ``benchmarks/scale_parity.py`` (the reference CLI with
jellyfish, against the fixture's REFDB/) is not here: it needs the
reference's code and jellyfish, which the GPU's host does not have.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import shutil
import subprocess
import sys
import time
import weakref

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_ROOT = os.path.join(REPO, ".scale_torch")

# fields that pass through the Enet coordinate descent (the JAX script's)
ENET_FIELDS = {
    "Relative_Abundance", "Relative_Abundance_Inside_Cluster",
    "Predicted_Depth (Enet)", "Predicted_Depth (Ab*cls_depth)",
}
ENET_RTOL = 1e-9
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_meta(root: str) -> dict:
    with open(os.path.join(root, "meta.json")) as f:
        return json.load(f)


def sample_paths(root: str, meta: dict) -> dict:
    return {s: os.path.join(root, "samples", s + ".fq")
            for s in meta["samples"]}


# ---------------------------------------------------------------- ours
# the device tables seen by ``instrument``, by id (a table freed and
# another made at its address is counted again)
_RESIDENT: weakref.WeakValueDictionary = weakref.WeakValueDictionary()


UNION = "identify/l2_vote/union_count"


def _in_union() -> bool:
    """Whether the L2 union count's phase is open in this context."""
    from strainscan_tpu_torch import timing

    s = timing.current()
    while s is not None and s.name != UNION:
        s = s.up
    return s is not None


@contextlib.contextmanager
def instrument(rec: dict):
    """While the body runs, append the key count of every fp table
    uploaded to a device (a sharded pipeline's shards count as one
    upload) to ``rec["uploads_keys"]``, the pipeline of every count's
    finish (``sharded`` or ``single``, with its position in
    ``ops.count.FETCHES``) to ``rec["count_routes"]`` and every call of
    the L2 mesh gate to ``rec["l2_mesh"]``, and add the kernel launches of
    the L2 union counts (those since the last finish, at a finish inside
    the phase ``identify/l2_vote/union_count``) into
    ``rec["union_launches"]``; on leaving, the seconds of every L2 union
    count (that phase's spans, ``timing.SPANS``) go to
    ``rec["union_count_s"]``.  Yields the set of the positions in
    ``ops.count.FETCHES`` of the L2 union counts' fetches."""
    from strainscan_tpu_torch import timing
    from strainscan_tpu_torch.ops import count as ops_count
    from strainscan_tpu_torch.ops import probe
    from strainscan_tpu_torch.parallel import sharded as psh

    upload = ops_count.fp_table_to_device
    gate, sharded = psh.l2_mesh, psh.ShardedCountPipeline
    saved = {(cls, name): getattr(cls, name) for cls, name in (
        (ops_count.CountPipeline, "finish"), (sharded, "finish"),
        (sharded, "_ensure_device_state"))}
    rec.update(uploads_keys=[], union_count_s=[], union_launches={},
               count_routes=[], l2_mesh=[])
    union_at: set = set()
    launched = dict(probe.LAUNCHES)
    since = time.perf_counter_ns()

    def counted_upload(fpt, device):
        table = upload(fpt, device)
        if _RESIDENT.get(id(table)) is not table:
            _RESIDENT[id(table)] = table
            rec["uploads_keys"].append(fpt.n_keys)
        return table

    def shard_upload(self):
        if self._fp_dev is None:
            rec["uploads_keys"].append(self.st.n_keys)
        saved[sharded, "_ensure_device_state"](self)

    def routed(cls, route):
        def finish(self):
            at = len(ops_count.FETCHES)
            rec["count_routes"].append((at, route))
            out = saved[cls, "finish"](self)
            if _in_union():
                union_at.update(range(at, len(ops_count.FETCHES)))
                for name, n in probe.LAUNCHES.items():
                    if n > launched[name]:
                        rec["union_launches"][name] = (
                            rec["union_launches"].get(name, 0) + n
                            - launched[name])
            launched.update(probe.LAUNCHES)
            return out
        return finish

    def gated(device, n_rows, min_rows):
        mesh = gate(device, n_rows, min_rows)
        rec["l2_mesh"].append({"rows": n_rows, "min_rows": min_rows,
                               "opened": mesh is not None})
        return mesh

    ops_count.fp_table_to_device = counted_upload
    psh.l2_mesh = gated
    sharded._ensure_device_state = shard_upload
    ops_count.CountPipeline.finish = routed(ops_count.CountPipeline,
                                            "single")
    sharded.finish = routed(sharded, "sharded")
    try:
        yield union_at
    finally:
        ops_count.fp_table_to_device = upload
        psh.l2_mesh = gate
        for (cls, name), fn in saved.items():
            setattr(cls, name, fn)
        rec["union_count_s"] = [s.seconds for s in timing.SPANS
                                if s.name == UNION and s.t0 >= since]


def measured(fn, device: str) -> dict:
    """Run ``fn()`` (true on success) once and return its record: wall
    seconds, ``ok``, the ``identify/*`` and ``l2/*`` phase seconds, the
    kernel launches (counted from 0), the uploads, union counts and L2
    mesh gates of :func:`instrument`, every stream-end fetch
    (``ops.count.FETCHES``, each marked ``main`` or ``union``) with the
    main counts' ``finish_s``, ``d2h_bytes`` and ``routes``, the
    ``slot_of_id`` uploads of all, the pipeline of each count
    (``counts``: ``main`` or ``union``, ``sharded`` or ``single``), the
    host's resident set and, on ``cuda``, the peak device memory of the
    fullest GPU."""
    import torch

    from strainscan_tpu_torch.ops import count as ops_count
    from strainscan_tpu_torch.ops import probe
    from strainscan_tpu_torch.timing import PHASE_TIMES, rss_gb

    cuda = device == "cuda"
    rec: dict = {}
    PHASE_TIMES.clear()
    probe.reset_launches()
    ops_count.reset_fetches()
    if cuda:
        torch.cuda.init()   # the per-device stats need CUDA up
    gpus = range(torch.cuda.device_count()) if cuda else ()
    for i in gpus:
        torch.cuda.reset_peak_memory_stats(i)
    with instrument(rec) as union_at:
        t0 = time.perf_counter()
        rec["ok"] = bool(fn())
        rec["s"] = time.perf_counter() - t0
    fetches = [dict(f._asdict(), count="union" if i in union_at else "main")
               for i, f in enumerate(ops_count.FETCHES)]
    main = [f for f in fetches if f["count"] == "main"]
    rec.update(phases={k: v for k, v in PHASE_TIMES.items()
                       if k.startswith("identify/")},
               launches={k: v for k, v in probe.LAUNCHES.items() if v},
               fetches=fetches, finish_s=sum(f["s"] for f in main),
               d2h_bytes=sum(f["d2h_bytes"] for f in main),
               routes=[f"{f['route']}/{f['space']} u{8 * f['vb']}"
                       for f in main],
               soi_uploads=sum(f["soi_uploaded"] for f in fetches),
               counts=[{"count": "union" if at in union_at else "main",
                        "route": route}
                       for at, route in rec.pop("count_routes")],
               rss_gb=rss_gb())
    if cuda:
        rec["gpu_peak_gb"] = max(torch.cuda.max_memory_allocated(i)
                                 for i in gpus) / 2**30
    return rec


def identify_each(fqs: dict, db: str, out: str, device: str, mesh=None,
                  cfg=None) -> dict:
    """``run_identify`` of every sample of ``fqs`` ({name: FASTQ}) on
    ``mesh`` (default: ``device`` as ``run_identify`` resolves it) with
    ``cfg`` (default ``IdentifyConfig()``) into ``out/<name>``; returns
    {name: :func:`measured` record}."""
    from strainscan_tpu_torch.config import IdentifyConfig
    from strainscan_tpu_torch.identify.pipeline import run_identify

    mesh = device if mesh is None else mesh
    cfg = IdentifyConfig() if cfg is None else cfg
    recs = {}
    for name, fq in fqs.items():
        recs[name] = measured(lambda: run_identify(
            fq, "", db, os.path.join(out, name), mesh, cfg) is not None,
            device)
        print(f"[ours {device}] {os.path.basename(out)} {name}: "
              f"{json.dumps(recs[name])}", flush=True)
    return recs


def faults(what: str, rec: dict, device: str) -> list:
    """What is wrong with one record: no cluster found, or on ``cuda``
    no launch of ``fp_bin_probe_kernel``."""
    out = [] if rec["ok"] else [f"{what}: no cluster detected"]
    if device == "cuda" and not rec["launches"].get("fp_bin_probe_kernel"):
        out.append(f"{what}: fp_bin_probe_kernel not launched")
    return out


def run_name(device: str, mesh, l2_rows=None) -> str:
    """``ours_<device>`` for one position; else with the distinct devices
    and the mesh shape, ``ours_cuda_4gpu_2x2``; ``_l2rows<R>`` for a
    config with ``shard_min_l2_rows=R``."""
    name = f"ours_{device}"
    if mesh.size > 1:
        n_dev = len(set(mesh.devices))
        unit = "gpu" if device == "cuda" else device
        name += (f"_{n_dev}{unit}_{mesh.shape['data']}x"
                 f"{mesh.shape['index']}")
    return name + ("" if l2_rows is None else f"_l2rows{l2_rows}")


def mesh_record(mesh) -> dict:
    return {"shape": [mesh.shape["data"], mesh.shape["index"]],
            "positions": mesh.size,
            "distinct_devices": len(set(mesh.devices)),
            "devices": [str(d) for d in mesh.devices]}


def run_ours(root: str, device: str, index_shards=None, l2_rows=None,
             mesh=None) -> int:
    """The ``ours`` passes on ``mesh`` (default: every visible GPU on
    ``cuda`` at ``index_shards``, one position on ``cpu``), with
    ``shard_min_l2_rows=l2_rows`` where given."""
    import dataclasses

    import torch

    from strainscan_tpu_torch import cli
    from strainscan_tpu_torch.config import IdentifyConfig
    from strainscan_tpu_torch.parallel.sharded import make_mesh, resolve_mesh
    from strainscan_tpu_torch.timing import peak_rss_gb

    if mesh is None:
        mesh = (make_mesh(index_shards=index_shards) if device == "cuda"
                else resolve_mesh(device))
    cfg = IdentifyConfig()
    if l2_rows is not None:
        cfg = dataclasses.replace(cfg, shard_min_l2_rows=l2_rows)
    meta = load_meta(root)
    db = os.path.join(root, "DB")
    fqs = sample_paths(root, meta)
    name = run_name(device, mesh, l2_rows)
    out = os.path.join(root, "parity", name)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    res: dict = {"device": device, "name": name, "torch": torch.__version__,
                 "mesh": mesh_record(mesh),
                 "config": {"shard_min_kmers": cfg.shard_min_kmers,
                            "shard_min_l2_rows": cfg.shard_min_l2_rows},
                 "n_keys": meta["n_keys"], "db_digest": meta["db_digest"]}
    if device == "cuda":
        from strainscan_tpu_torch.bench import card_line

        res["card"] = card_line()
    for pass_ in ("cold", "warm"):
        res[pass_] = identify_each(fqs, db, os.path.join(out, pass_),
                                   device, mesh, cfg)
    records = {f"{p} {n}": r for p in ("cold", "warm")
               for n, r in res[p].items()}
    failures = []
    # the CLI counts on resolve_mesh(device) with the default config
    cli_run = (resolve_mesh(device).grid == mesh.grid
               and cfg == IdentifyConfig())
    if cli_run:
        batch = measured(lambda: cli.main(
            ["batch-identify", "-i", *fqs.values(), "-d", db, "-o",
             os.path.join(out, "batch"), "--device", device]) == 0, device)
        batch["s_per_sample"] = batch["s"] / len(fqs)
        res["batch"] = records["batch-identify"] = batch
        print(f"[ours {device}] batch: {json.dumps(batch)}", flush=True)
        first = next(iter(fqs))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "strainscan_tpu_torch.cli", "identify",
             "-i", fqs[first], "-d", db, "-o",
             os.path.join(out, "process", first), "--device", device],
            cwd=REPO, capture_output=True, text=True, timeout=1800)
        res["process"] = {"sample": first, "s": time.perf_counter() - t0,
                          "ok": proc.returncode == 0}
        if proc.returncode:
            failures.append(f"fresh-process identify: {proc.stderr[-2000:]}")
    else:
        res["batch"] = res["process"] = None
    failures += [msg for what, rec in records.items()
                 for msg in faults(what, rec, device)]
    uploads = sum(r["uploads_keys"].count(meta["n_keys"])
                  for r in records.values())
    if uploads != 1:
        failures.append(f"the DB's table was uploaded {uploads} times")
    routes = sorted({c["route"] for r in records.values()
                     for c in r["counts"] if c["count"] == "main"})
    l2_opened = any(g["opened"] for r in records.values()
                    for g in r["l2_mesh"])
    res.update(main_table_uploads=uploads, main_routes=routes,
               l2_mesh_opened=l2_opened, peak_rss_gb=peak_rss_gb(),
               failures=failures)
    with open(out + ".json", "w") as f:
        json.dump(res, f, indent=1)
    summary = {p: {n: r["s"] for n, r in res[p].items()}
               for p in ("cold", "warm")}
    batch_s = res["batch"] and res["batch"]["s_per_sample"]
    process_s = res["process"] and res["process"]["s"]
    print(f"[ours {device}] {name} on {res['mesh']['shape']} mesh "
          f"({res['mesh']['distinct_devices']} device(s)): s/sample "
          f"{json.dumps(summary)}, batch {batch_s}, fresh process "
          f"{process_s}, main count routes {routes}, L2 mesh gate opened "
          f"{l2_opened}, main-table uploads {uploads}, peak RSS "
          f"{res['peak_rss_gb']} GiB {res.get('card', '')}", flush=True)
    for msg in failures:
        print(f"[ours {device}] FAILED: {msg}", flush=True)
    return 1 if failures else 0


# ---------------------------------------------------------------- procs
def procs_name(device: str, n: int) -> str:
    return f"ours_{device}_{n}proc"


def procs_command(root: str, n: int, device: str) -> list:
    """``torchrun --standalone --nproc-per-node n`` of this module's
    ``rank`` mode: every process joins the gloo group (the CLI's
    ``maybe_initialize`` reads torchrun's variables) and counts on
    ``cuda:LOCAL_RANK``."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(n), "-m",
            "strainscan_tpu_torch.bench.scale_parity", "--root", root,
            "rank", "--device", device, "--name", procs_name(device, n)]


def run_rank(root: str, device: str, name: str) -> int:
    """One process of ``procs``: ``batch-identify`` of every sample
    through ``cli.main`` into ``<name>/rank<r>``, recording its mesh, the
    routes of its counts, whether the L2 mesh gate opened, and per sample
    the wall and count seconds and, for each ``merge_counts`` (the main
    count's, then the L2 union count's), the seconds of its all-reduce
    (``merge_s``) after a barrier and of that barrier, the wait for the
    slowest rank (``wait_s``), into ``<name>.rank<r>.json``."""
    import torch
    import torch.distributed as tdist

    from strainscan_tpu_torch import cli
    from strainscan_tpu_torch.identify import pipeline
    from strainscan_tpu_torch.parallel import distributed as dist
    from strainscan_tpu_torch.parallel.sharded import resolve_mesh
    from strainscan_tpu_torch.timing import PHASE_TIMES

    rank = int(os.environ["RANK"])
    meta = load_meta(root)
    fqs = sample_paths(root, meta)
    out = os.path.join(root, "parity", name)
    samples: dict = {}
    merges: list = []
    identify, merge = pipeline.run_identify, dist.merge_counts

    def timed_merge(counts):
        t0 = time.perf_counter()
        tdist.barrier()   # the wait for the slowest rank, timed apart
        t1 = time.perf_counter()
        got = merge(counts)
        merges.append((time.perf_counter() - t1, t1 - t0))
        return got

    def timed_identify(fq, *args, **kw):
        merges.clear()
        PHASE_TIMES.clear()
        t0 = time.perf_counter()
        res = identify(fq, *args, **kw)
        samples[os.path.basename(args[2])] = {
            "s": time.perf_counter() - t0, "ok": res is not None,
            "count_s": PHASE_TIMES.get("identify/count"),
            "merge_s": [m for m, _ in merges],
            "wait_s": [w for _, w in merges]}
        return res

    pipeline.run_identify, dist.merge_counts = timed_identify, timed_merge
    inst: dict = {}
    try:
        with instrument(inst):
            rc = cli.main(["batch-identify", "-i", *fqs.values(), "-d",
                           os.path.join(root, "DB"), "-o",
                           os.path.join(out, f"rank{rank}"), "--device",
                           device])
    finally:
        pipeline.run_identify, dist.merge_counts = identify, merge
    pidx, pcount = dist.process_info()
    rec = {"rank": rank, "process": [pidx, pcount], "rc": rc,
           "mesh": mesh_record(resolve_mesh(device)),
           "count_routes": sorted({r for _, r in inst["count_routes"]}),
           "l2_mesh_opened": any(g["opened"] for g in inst["l2_mesh"]),
           "samples": samples}
    if device == "cuda":   # the GPUs this process allocated memory on
        n_gpu = torch.cuda.device_count()
        rec["gpus"] = [i for i in range(n_gpu)
                       if torch.cuda.max_memory_allocated(i) > 0]
        rec["local_gpu"] = dist.local_device_index(n_gpu)
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(rec, f, indent=1)
    return rc


def run_procs(root: str, n: int, device: str) -> int:
    """``batch-identify`` in ``n`` processes (:func:`procs_command`);
    fails if a rank fails, did not join a group of ``n``, or found no
    cluster in a sample, or, on ``cuda``, unless each rank allocated on
    its own GPU (``LOCAL_RANK`` modulo the GPUs) alone."""
    import torch

    name = procs_name(device, n)
    out = os.path.join(root, "parity", name)
    shutil.rmtree(out, ignore_errors=True)
    for r in range(n):
        with contextlib.suppress(FileNotFoundError):
            os.remove(f"{out}.rank{r}.json")
    t0 = time.perf_counter()
    proc = subprocess.run(procs_command(root, n, device), cwd=REPO,
                          capture_output=True, text=True, timeout=3000)
    res: dict = {"device": device, "name": name, "processes": n,
                 "s": time.perf_counter() - t0, "rc": proc.returncode,
                 "torch": torch.__version__, "ranks": []}
    if device == "cuda":
        from strainscan_tpu_torch.bench import card_line

        res["card"] = card_line()
    failures = [] if proc.returncode == 0 else [
        f"torchrun exited {proc.returncode}: {proc.stderr[-3000:]}"]
    for r in range(n):
        try:
            with open(f"{out}.rank{r}.json") as f:
                rec = json.load(f)
        except FileNotFoundError:
            failures.append(f"rank {r} wrote no record")
            continue
        res["ranks"].append(rec)
        if rec["rc"] or rec["process"] != [r, n]:
            failures.append(f"rank {r}: rc {rec['rc']}, process "
                            f"{rec['process']}")
        failures += [f"rank {r} {s}: no cluster detected"
                     for s, v in rec["samples"].items() if not v["ok"]]
    failures += [f"rank {rec['rank']} allocated on GPUs {rec['gpus']}, "
                 f"not on its own GPU {rec['local_gpu']} alone"
                 for rec in res["ranks"]
                 if device == "cuda" and rec["gpus"] != [rec["local_gpu"]]]
    res["failures"] = failures
    with open(out + ".json", "w") as f:
        json.dump(res, f, indent=1)
    per_rank = {rec["rank"]: {s: {k: v[k] for k in ("count_s", "merge_s",
                                                     "wait_s")}
                              for s, v in rec["samples"].items()}
                for rec in res["ranks"]}
    print(f"[procs {device}] {name}: {res['s']} s for {n} processes, "
          f"start-up included; per rank {json.dumps(per_rank)} "
          f"{res.get('card', '')}", flush=True)
    for msg in failures:
        print(f"[procs {device}] FAILED: {msg}", flush=True)
    return 1 if failures else 0


# ---------------------------------------------------------------- diff
def report_groups(top: str) -> dict:
    """{sample directory relative to ``top``: {file: bytes}} of every
    directory under ``top`` that holds a final_report.txt."""
    groups = {}
    for root, dirs, names in os.walk(top):
        dirs.sort()
        if "final_report.txt" not in names:
            continue
        files = {}
        for sub, _, subnames in os.walk(root):
            for n in subnames:
                p = os.path.join(sub, n)
                with open(p, "rb") as f:
                    files[os.path.relpath(p, root)] = f.read()
        groups[os.path.relpath(root, top)] = files
        dirs[:] = []
    return groups


def parse_report(data: bytes) -> list:
    """Rows of a tab-separated report as {header: field}."""
    lines = [ln for ln in data.decode().splitlines() if ln.strip()]
    header = lines[0].split("\t")
    return [dict(zip(header, ln.split("\t"))) for ln in lines[1:]]


def explain(a: bytes, b: bytes) -> dict:
    """Why two reports differ: row counts, a non-Enet field, or the
    largest relative error of an Enet field (within ENET_RTOL or not)."""
    ra, rb = parse_report(a), parse_report(b)
    if len(ra) != len(rb):
        return {"error": f"row count {len(ra)} vs {len(rb)}"}
    worst = 0.0
    for x, y in zip(ra, rb):
        for fld, va in x.items():
            vb = y.get(fld)
            if va == vb:
                continue
            if fld not in ENET_FIELDS:
                return {"error": f"non-Enet field {fld}: {va!r} vs {vb!r}"}
            fa, fb = float(va), float(vb)
            worst = max(worst, abs(fa - fb) / max(abs(fb), 1e-30))
    return {"enet_rel_err": worst, "enet_within_rtol": worst <= ENET_RTOL}


def strains_in(report: bytes) -> set:
    return {row["Strain_Name"].split()[0] for row in parse_report(report)}


def counterpart(g: str, groups: dict):
    """The directory of ``groups`` that ``g`` is held against: ``g``
    itself, else the first (by path) of the same sample, else None."""
    if g in groups:
        return g
    same = sorted(h for h in groups
                  if os.path.basename(h) == os.path.basename(g))
    return same[0] if same else None


def run_diff(a: str, b: str, root: str) -> int:
    meta = load_meta(root)
    ga, gb = report_groups(a), report_groups(b)
    res = {"a": a, "b": b, "n_keys": meta.get("n_keys"),
           "db_digest": meta.get("db_digest"), "samples": {}}
    ok = bool(ga)
    for g in sorted(set(ga) | set(gb)):
        ka, kb = counterpart(g, ga), counterpart(g, gb)
        if ka is None or kb is None:
            res["samples"][g] = {"error": "only in " + (a if kb is None
                                                        else b)}
            ok = False
            continue
        fa, fb = ga[ka], gb[kb]
        d = {"files": len(fa), "byte_identical": fa == fb}
        if ka != kb:
            d["against"] = [ka, kb]
        if fa != fb:
            d["differs"] = {
                f: (explain(fa[f], fb[f]) if f in fa and f in fb
                    else {"error": "only in " + (a if f in fa else b)})
                for f in sorted(set(fa) | set(fb)) if fa.get(f) != fb.get(f)}
        name = os.path.basename(g)
        truth = meta["samples"].get(name, {}).get("truth", [])
        d["truth_found"] = set(truth) <= strains_in(fa["final_report.txt"])
        d["l2_vote"] = any(f.endswith("StrainVote.report") for f in fa)
        ok &= d["byte_identical"] and d["truth_found"]
        if name == "intramix":
            ok &= d["l2_vote"]
        res["samples"][g] = d
    res["parity"] = ok
    out = os.path.join(root, "parity", f"diff_{os.path.basename(a)}_"
                       f"{os.path.basename(b)}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    return 0 if ok else 1


# --------------------------------------------------------------- trace
def merge_intervals(spans) -> list:
    out: list = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _ops(evs, top: int) -> list:
    """Device events by name: calls and total ms, the largest first."""
    ops: dict = {}
    for e in evs:
        rec = ops.setdefault(e["name"][:100], [e["cat"], 0, 0.0])
        rec[1] += 1
        rec[2] += e["dur"] / 1e3
    return [{"name": n, "cat": c, "calls": k, "ms": ms} for n, (c, k, ms) in
            sorted(ops.items(), key=lambda kv: -kv[1][2])[:top]]


def trace_summary(events: list, top: int = 12) -> dict:
    """Per ``identify/*`` range of a Chrome trace (the phases, and the L2
    union count inside ``identify/l2_vote``): wall ms, device-busy ms and
    share, and the device operations the range launched (a device event
    belongs to every range that holds the host time of the runtime call
    that launched it, matched by its correlation id; else its own start):
    by name, calls and ms, and their total ms; over the whole trace, the
    device operations by total ms; the longest gaps with no device
    operation inside the phases."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    launch = {e["args"]["correlation"]: e["ts"] for e in xs
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    launched_at = [launch.get(e.get("args", {}).get("correlation"), e["ts"])
                   for e in dev]
    phases = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in xs
              if e.get("cat") == "user_annotation"
              and e["name"].startswith("identify/")}
    busy = merge_intervals((e["ts"], e["ts"] + e["dur"]) for e in dev)
    out: dict = {"phases": {}, "top_device_ops": [], "idle_gaps": []}
    gaps = []
    for name, (p0, p1) in sorted(phases.items(), key=lambda kv: kv[1]):
        clipped = [(max(s, p0), min(e, p1)) for s, e in busy
                   if e > p0 and s < p1]
        on = sum(e - s for s, e in clipped)
        mine = [e for e, t in zip(dev, launched_at) if p0 <= t < p1]
        out["phases"][name] = {"wall_ms": (p1 - p0) / 1e3,
                               "device_busy_ms": on / 1e3,
                               "device_busy_share": on / (p1 - p0)
                               if p1 > p0 else 0.0,
                               "device_op_ms": sum(e["dur"] for e in mine)
                               / 1e3,
                               "device_ops": _ops(mine, top)}
        edges = [p0] + [t for s, e in clipped for t in (s, e)] + [p1]
        gaps += [((edges[i + 1] - edges[i]) / 1e3, name,
                  (edges[i] - p0) / 1e3)
                 for i in range(0, len(edges) - 1, 2)]
    out["device_ms"] = sum(e["dur"] for e in dev) / 1e3
    out["top_device_ops"] = _ops(dev, top)
    out["idle_gaps"] = [{"ms": ms, "phase": p, "at_ms": at}
                        for ms, p, at in sorted(gaps, reverse=True)[:top]]
    return out


def run_trace(root: str, sample: str) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from strainscan_tpu_torch.bench import card_line
    from strainscan_tpu_torch.config import IdentifyConfig
    from strainscan_tpu_torch.identify import pipeline

    meta = load_meta(root)
    db = os.path.join(root, "DB")
    fq = sample_paths(root, meta)[sample]
    device = "cuda"
    out = os.path.join(root, "parity", f"trace_{sample}_{device}")
    shutil.rmtree(out, ignore_errors=True)
    # warm: the DB, its device table and the L2 clusters resident
    pipeline.run_identify(fq, "", db, os.path.join(out, "warmup"), device,
                          IdentifyConfig())
    # the phases' spans mark their ranges in the trace themselves
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        pipeline.run_identify(fq, "", db, os.path.join(out, "traced"),
                              device, IdentifyConfig())
        wall = time.perf_counter() - t0
    path = out + ".pt.trace.json"
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    res = {"sample": sample, "device": device, "wall_s": wall,
           "torch": torch.__version__, "card": card_line(),
           **trace_summary(events)}
    same = (report_groups(os.path.join(out, "warmup"))
            == report_groups(os.path.join(out, "traced")))
    res["reports_equal_untraced"] = same
    with open(out + ".json", "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    return 0 if same else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=DEFAULT_ROOT,
                    help="the fixture's directory (scale_fixture --root)")
    sub = ap.add_subparsers(dest="mode", required=True)
    p = sub.add_parser("ours", help="identify every sample, timed")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--index-shards", type=int,
                   help="the mesh's index axis (make_mesh's default: 2 "
                        "for an even GPU count, else 1)")
    p.add_argument("--l2-rows", type=int,
                   help="IdentifyConfig.shard_min_l2_rows (the L2 mesh "
                        "gate); 1 opens it at any matrix size")
    p = sub.add_parser("procs", help="batch-identify in N processes "
                       "under torchrun, one GPU each")
    p.add_argument("n", type=int)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p = sub.add_parser("rank", help="one process of procs (run by "
                       "torchrun)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--name", required=True)
    p = sub.add_parser("diff", help="compare two ours report trees")
    p.add_argument("a")
    p.add_argument("b")
    p = sub.add_parser("trace",
                       help="one warm identify on the GPU under the profiler")
    p.add_argument("--sample", default="deep")
    args = ap.parse_args(argv)
    logging.basicConfig(format="%(asctime)s - %(message)s",
                        level=logging.INFO)
    if args.mode == "ours":
        return run_ours(args.root, args.device, args.index_shards,
                        args.l2_rows)
    if args.mode == "procs":
        return run_procs(os.path.abspath(args.root), args.n, args.device)
    if args.mode == "rank":
        return run_rank(args.root, args.device, args.name)
    if args.mode == "diff":
        return run_diff(args.a, args.b, args.root)
    return run_trace(args.root, args.sample)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())
