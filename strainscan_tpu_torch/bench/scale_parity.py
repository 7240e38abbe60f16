"""Identify at E. coli scale: the ``ours`` and ``diff`` halves of
``benchmarks/scale_parity.py`` for the port, and a trace of one sample.

Runs over the fixture of :mod:`.scale_fixture` (1,647 strains, a 28.6 M-key
DB, the samples single, crossmix, intramix and deep):

    python -m strainscan_tpu_torch.bench.scale_parity ours --device cuda
    python -m strainscan_tpu_torch.bench.scale_parity ours --device cpu
    python -m strainscan_tpu_torch.bench.scale_parity diff \\
        .scale_torch/parity/ours_cuda .scale_torch/parity/ours_cpu
    python -m strainscan_tpu_torch.bench.scale_parity trace --sample deep

``ours`` identifies every sample with ``identify/pipeline.py::run_identify``
in one process: a cold pass (the first sample loads the DB and uploads its
table), a warm pass over the same samples, one ``batch-identify`` over all
of them through ``cli.main``, and one ``python -m strainscan_tpu_torch.cli
identify`` of the first sample in a fresh process.  It keeps each sample's
wall seconds, its ``identify/*`` and ``l2/*`` phase seconds, the seconds of
the L2 union count, the count kernels' launches (``ops.probe.LAUNCHES``),
the tables uploaded and the host's resident set, in
``<root>/parity/ours_<device>.json``, beside the report trees under
``<root>/parity/ours_<device>/``.  It fails if a sample finds no cluster,
if the DB's table is uploaded more than once, or, on ``cuda``, if a sample
did not launch ``fp_bin_probe_kernel``.

``diff A B`` compares two such report trees file by file: byte equality per
sample directory; where bytes differ, the Enet fields (rtol 1e-9) and any
other field that differs, to explain it.  Any difference fails (exit 1), as
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


@contextlib.contextmanager
def instrument(rec: dict):
    """While the body runs, append the key count of every fp table
    uploaded to a device to ``rec["uploads_keys"]`` and the seconds of
    every L2 union count to ``rec["union_count_s"]``, and add the kernel
    launches of the L2 union counts into ``rec["union_launches"]``."""
    from strainscan_tpu_torch.identify import vote
    from strainscan_tpu_torch.ops import count as ops_count
    from strainscan_tpu_torch.ops import probe

    upload, union = ops_count.fp_table_to_device, vote._count_union
    rec.update(uploads_keys=[], union_count_s=[], union_launches={})

    def counted_upload(fpt, device):
        table = upload(fpt, device)
        if _RESIDENT.get(id(table)) is not table:
            _RESIDENT[id(table)] = table
            rec["uploads_keys"].append(fpt.n_keys)
        return table

    def timed_union(*args, **kw):
        before = dict(probe.LAUNCHES)
        t0 = time.perf_counter()
        out = union(*args, **kw)
        rec["union_count_s"].append(time.perf_counter() - t0)
        for name, n in probe.LAUNCHES.items():
            if n > before[name]:
                rec["union_launches"][name] = (
                    rec["union_launches"].get(name, 0) + n - before[name])
        return out

    ops_count.fp_table_to_device = counted_upload
    vote._count_union = timed_union
    try:
        yield
    finally:
        ops_count.fp_table_to_device = upload
        vote._count_union = union


def measured(fn, device: str) -> dict:
    """Run ``fn()`` (true on success) once and return its record: wall
    seconds, ``ok``, the ``identify/*`` and ``l2/*`` phase seconds, the
    kernel launches (counted from 0), the uploads and union counts of
    :func:`instrument`, the host's resident set and, on ``cuda``, the
    peak device memory."""
    import torch

    from strainscan_tpu_torch.ops import probe
    from strainscan_tpu_torch.timing import PHASE_TIMES, rss_gb

    cuda = device == "cuda"
    rec: dict = {}
    PHASE_TIMES.clear()
    probe.reset_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with instrument(rec):
        t0 = time.perf_counter()
        rec["ok"] = bool(fn())
        rec["s"] = time.perf_counter() - t0
    rec.update(phases={k: v for k, v in PHASE_TIMES.items()
                       if k.startswith(("identify/", "l2/"))},
               launches={k: v for k, v in probe.LAUNCHES.items() if v},
               rss_gb=rss_gb())
    if cuda:
        rec["gpu_peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    return rec


def identify_each(fqs: dict, db: str, out: str, device: str) -> dict:
    """``run_identify`` of every sample of ``fqs`` ({name: FASTQ}) into
    ``out/<name>``; returns {name: :func:`measured` record}."""
    from strainscan_tpu_torch.config import IdentifyConfig
    from strainscan_tpu_torch.identify.pipeline import run_identify

    recs = {}
    for name, fq in fqs.items():
        recs[name] = measured(lambda: run_identify(
            fq, "", db, os.path.join(out, name), device,
            IdentifyConfig()) is not None, device)
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


def run_ours(root: str, device: str) -> int:
    import torch

    from strainscan_tpu_torch import cli
    from strainscan_tpu_torch.timing import peak_rss_gb

    meta = load_meta(root)
    db = os.path.join(root, "DB")
    fqs = sample_paths(root, meta)
    out = os.path.join(root, "parity", "ours_" + device)
    shutil.rmtree(out, ignore_errors=True)
    res: dict = {"device": device, "torch": torch.__version__,
                 "n_keys": meta["n_keys"], "db_digest": meta["db_digest"]}
    if device == "cuda":
        from strainscan_tpu_torch.bench import card_line

        res["card"] = card_line()
    for pass_ in ("cold", "warm"):
        res[pass_] = identify_each(fqs, db, os.path.join(out, pass_),
                                   device)
    batch = measured(lambda: cli.main(
        ["batch-identify", "-i", *fqs.values(), "-d", db, "-o",
         os.path.join(out, "batch"), "--device", device]) == 0, device)
    batch["s_per_sample"] = batch["s"] / len(fqs)
    res["batch"] = batch
    print(f"[ours {device}] batch: {json.dumps(batch)}", flush=True)
    first = next(iter(fqs))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "strainscan_tpu_torch.cli", "identify", "-i",
         fqs[first], "-d", db, "-o", os.path.join(out, "process", first),
         "--device", device], cwd=REPO, capture_output=True, text=True,
        timeout=1800)
    res["process"] = {"sample": first, "s": time.perf_counter() - t0,
                      "ok": proc.returncode == 0}
    records = {f"{p} {n}": r for p in ("cold", "warm")
               for n, r in res[p].items()}
    records["batch-identify"] = batch
    failures = [msg for what, rec in records.items()
                for msg in faults(what, rec, device)]
    if proc.returncode:
        failures.append(f"fresh-process identify: {proc.stderr[-2000:]}")
    uploads = sum(r["uploads_keys"].count(meta["n_keys"])
                  for r in records.values())
    if uploads != 1:
        failures.append(f"the DB's table was uploaded {uploads} times")
    res.update(main_table_uploads=uploads, peak_rss_gb=peak_rss_gb(),
               failures=failures)
    with open(out + ".json", "w") as f:
        json.dump(res, f, indent=1)
    summary = {p: {n: r["s"] for n, r in res[p].items()}
               for p in ("cold", "warm")}
    print(f"[ours {device}] s/sample {json.dumps(summary)}, batch "
          f"{batch['s_per_sample']}, fresh process {res['process']['s']}, "
          f"main-table uploads {uploads}, peak RSS {res['peak_rss_gb']} GiB "
          f"{res.get('card', '')}", flush=True)
    for msg in failures:
        print(f"[ours {device}] FAILED: {msg}", flush=True)
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


def run_diff(a: str, b: str, root: str) -> int:
    meta = load_meta(root)
    ga, gb = report_groups(a), report_groups(b)
    res = {"a": a, "b": b, "n_keys": meta.get("n_keys"),
           "db_digest": meta.get("db_digest"), "samples": {}}
    ok = bool(ga)
    for g in sorted(set(ga) | set(gb)):
        if g not in ga or g not in gb:
            res["samples"][g] = {"error": "only in " + (a if g in ga else b)}
            ok = False
            continue
        fa, fb = ga[g], gb[g]
        d = {"files": len(fa), "byte_identical": fa == fb}
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
    from torch.profiler import ProfilerActivity, profile, record_function

    from strainscan_tpu_torch.bench import card_line
    from strainscan_tpu_torch.config import IdentifyConfig
    from strainscan_tpu_torch.identify import pipeline, vote

    meta = load_meta(root)
    db = os.path.join(root, "DB")
    fq = sample_paths(root, meta)[sample]
    device = "cuda"
    out = os.path.join(root, "parity", f"trace_{sample}_{device}")
    shutil.rmtree(out, ignore_errors=True)
    # warm: the DB, its device table and the L2 clusters resident
    pipeline.run_identify(fq, "", db, os.path.join(out, "warmup"), device,
                          IdentifyConfig())
    phase, union = pipeline.phase, vote._count_union

    @contextlib.contextmanager
    def marked(name):
        with record_function(name), phase(name):
            yield

    def marked_union(*args, **kw):
        with record_function("identify/l2_vote/union_count"):
            return union(*args, **kw)

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    pipeline.phase, vote._count_union = marked, marked_union
    try:
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            pipeline.run_identify(fq, "", db, os.path.join(out, "traced"),
                                  device, IdentifyConfig())
            wall = time.perf_counter() - t0
    finally:
        pipeline.phase, vote._count_union = phase, union
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
        return run_ours(args.root, args.device)
    if args.mode == "diff":
        return run_diff(args.a, args.b, args.root)
    return run_trace(args.root, args.sample)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())
