"""The identify loop: ``identify/pipeline.py::run_identify`` per sample,
one at a time, as ``batch-identify`` runs, the DB resident after the first
call and the default ``IdentifyConfig``; reports under ``TMPDIR``.

The DB is built once per checkout by the port's ``build_database`` (as
``cli build``) from the fixture's genomes into ``cache/``, keyed by the
configuration and a hash of the port's build sources; later runs load it.
The build's seconds are logged and left out of ``setup_s``: the
configuration pins the DB by its digest, which every run checks before
the reference reads the DB (a run whose DB differs gives no result), so no
work can move into the build unseen.  Set-up writes the mix's distinct
samples from the seed and runs one of them to warm up.  The reference rebuilds the count table from the DB's
k-mers, counts each distinct sample's code reads, runs its frozen copies
of the CST search and the layer-2 vote on those counts, and every sample
of the window is compared with it: the CST search's clusters and fields
(``cst_off``), the reports' cells other than numbers (``report_off``) and
the widest relative gap of their numbers (``report_gap``).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import time

import numpy as np
import torch

from portbench import synth
from portbench.harness import CHECKOUT, BadInput, Check, Run
from portbench.reference import cst, fptable, l2vote, treedb
from portbench.reference.config import IdentifyConfig as RefConfig

PORT = os.path.join(CHECKOUT, "strainscan_tpu_torch")
BUILD_SOURCES = ("build", "index", "native")
KINDS = ("single", "crossmix", "intramix")
# exact comparisons; report_gap's limit is set from the readings in PERF.md
CST_OFF_LIMIT = 0
REPORT_OFF_LIMIT = 0
REPORT_GAP_LIMIT = 1e-9


def build_key(cfg: dict) -> str:
    """Hash of the configuration's DB parameters and the port's build
    sources: a DB in the cache under this key is the one they make."""
    h = hashlib.sha256(json.dumps(cfg["db"], sort_keys=True).encode())
    for sub in BUILD_SOURCES:
        top = os.path.join(PORT, sub)
        for root, dirs, names in os.walk(top):
            dirs[:] = sorted(d for d in dirs if not d.startswith(("_", ".")))
            for n in sorted(names):
                if n.endswith((".py", ".c")):
                    with open(os.path.join(root, n), "rb") as f:
                        h.update(n.encode() + f.read())
    return h.hexdigest()[:16]


def db_digest(db: str) -> str:
    """One sha256 over the ``<relative path>\t<sha256>`` lines of every
    file under ``db``, in path order (the scale fixture's DB digest)."""
    files = {}
    for root, dirs, names in os.walk(db):
        for n in names:
            p = os.path.join(root, n)
            h = hashlib.sha256()
            with open(p, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 24), b""):
                    h.update(chunk)
            files[os.path.relpath(p, db)] = h.hexdigest()
    return hashlib.sha256("".join(
        f"{p}\t{files[p]}\n" for p in sorted(files)).encode()).hexdigest()


def check_db(run: Run) -> None:
    """Raises :class:`BadInput` unless the DB's digest is the one the
    configuration states."""
    got, want = db_digest(run.state["db"]), run.config["expect"]["db_digest"]
    if got != want:
        raise BadInput(f"the DB at {run.state['db']} has the digest {got}; "
                       f"the configuration states {want}: no result")


def ensure_db(run: Run) -> str:
    """The cell's DB directory in the cache, built when it is not there;
    the seconds a build takes go to ``run.state["setup_excluded_s"]``."""
    cfg = run.config
    top = os.path.join(run.cache, f"{run.cell['config']}-{build_key(cfg)}")
    if os.path.exists(os.path.join(top, "meta.json")):
        return top
    t_build = time.perf_counter()
    from strainscan_tpu_torch.build.pipeline import build_database
    from strainscan_tpu_torch.config import BuildConfig
    from strainscan_tpu_torch.timing import PHASE_TIMES

    part = top + ".partial"
    shutil.rmtree(part, ignore_errors=True)
    gdir = os.path.join(part, "genomes")
    os.makedirs(gdir)
    db = cfg["db"]
    t0 = time.perf_counter()
    names = synth.synth(gdir, db["families"], db["variants"],
                        db["genome_len"], np.random.default_rng(
                            db["genome_seed"]))
    meta = {"strains": names, "genomes_s": time.perf_counter() - t0}
    PHASE_TIMES.clear()
    t0 = time.perf_counter()
    build_database(gdir, os.path.join(part, "DB"),
                   BuildConfig(ksize=cfg["k"], threads=os.cpu_count()))
    meta.update(build_s=time.perf_counter() - t0,
                build_phases=dict(sorted(PHASE_TIMES.items())),
                bytes=sum(os.path.getsize(os.path.join(r, n))
                          for r, _, ns in os.walk(part) for n in ns))
    with open(os.path.join(part, "meta.json"), "w") as f:
        json.dump(meta, f)
    os.replace(part, top)
    run.state["setup_excluded_s"] = time.perf_counter() - t_build
    run.log(f"DB built: {json.dumps({k: v for k, v in meta.items() if k != 'strains'})}")
    return top


def composition(rng, kind: str, strains: list, depth: dict) -> list:
    """[(strain, depth)] of one sample of ``kind``, with the fixture's
    shapes: single, a variant of an even family (a multi-strain cluster,
    so the layer-2 vote runs); crossmix, the first variants of an even and
    an odd family; intramix, two variants of one even family."""
    fams = sorted({s[:4] for s in strains})
    even = [f for f in fams if int(f[1:]) % 2 == 0]
    odd = [f for f in fams if int(f[1:]) % 2 == 1]
    if kind == "single":
        parts = [f"{even[rng.integers(len(even))]}V{rng.integers(3)}"]
    elif kind == "crossmix":
        parts = [f"{even[rng.integers(len(even))]}V0",
                 f"{odd[rng.integers(len(odd))]}V0"]
    else:
        f = even[rng.integers(len(even))]
        va, vb = rng.choice(3, size=2, replace=False)
        parts = [f"{f}V{va}", f"{f}V{vb}"]
    lo, hi = depth[kind]
    return [(s, float(rng.uniform(lo, hi))) for s in parts]


def make_samples(rng, gdir: str, strains: list, mix: dict,
                 glen: int) -> list:
    """The mix's distinct samples: ``(kind, [(strain, depth)], codes)``;
    with ``reads`` set, each is filled to that many reads with random
    background reads, which miss the DB."""
    out, cache = [], {}
    length = mix["read_len"]
    for j in range(mix["distinct"]):
        kind = mix["kinds"][j % len(mix["kinds"])]
        parts = composition(rng, kind, strains, mix["depth"])
        reads = []
        for s, dep in parts:
            if s not in cache:
                cache[s] = synth.genome_codes(os.path.join(gdir, s + ".fa"))
            reads.append(synth.genome_reads(
                rng, cache[s], synth.depth_reads(dep, glen, length), length))
        n = sum(r.shape[0] for r in reads)
        if mix.get("reads"):
            reads.append(synth.random_reads(rng, mix["reads"] - n, length))
            n = mix["reads"]
        codes = np.concatenate(reads)[rng.permutation(n)]
        out.append((kind, parts, codes))
    return out


def make_inputs(run: Run) -> None:
    """The DB (built once) and the mix's distinct samples."""
    top = ensure_db(run)
    with open(os.path.join(top, "meta.json")) as f:
        strains = json.load(f)["strains"]
    rng = np.random.default_rng(run.seed)
    samples = make_samples(rng, os.path.join(top, "genomes"), strains,
                           run.traffic, run.config["db"]["genome_len"])
    run.state.update(db=os.path.join(top, "DB"), samples=samples)


def prepare(run: Run) -> None:
    from strainscan_tpu_torch.config import IdentifyConfig
    from strainscan_tpu_torch.identify.pipeline import run_identify
    from strainscan_tpu_torch.timing import PHASE_TIMES

    make_inputs(run)
    paths = []
    for j, (_, _, codes) in enumerate(run.state["samples"]):
        paths.append(os.path.join(run.tmp, f"sample{j}.fq"))
        synth.write_fastq(paths[-1], codes)
    run.state.update(paths=paths, run_identify=run_identify,
                     cfg=IdentifyConfig(), phases=PHASE_TIMES)
    identify(run, 0, os.path.join(run.tmp, "warm"))   # warm-up


def identify(run: Run, d: int, out: str):
    s = run.state
    return s["run_identify"](s["paths"][d], "", s["db"], out, run.device,
                             s["cfg"])


def step(run: Run, i: int) -> dict:
    d = i % len(run.state["paths"])
    out = os.path.join(run.tmp, "out", str(i))
    run.state["phases"].clear()
    with torch.profiler.record_function("bench/run_identify"):
        res = identify(run, d, out)
    return {"sample": d, "out": out, "res": res,
            "phases": dict(run.state["phases"])}


def end_to_end(run: Run, records: list, wall_s: float) -> dict:
    return {"identify_s_per_sample": wall_s / len(records)}


def reports(out: str) -> dict:
    """{relative path: rows} of the reports under ``out``."""
    got = {}
    for root, _, names in os.walk(out):
        for n in names:
            if n.endswith(("report.txt", ".report")):
                p = os.path.join(root, n)
                with open(p) as f:
                    got[os.path.relpath(p, out)] = [
                        line.rstrip("\n").split("\t") for line in f]
    return got


def reference(run: Run, fp_bits: int = 32) -> list:
    """``(res, reports)`` per distinct sample from the reference at
    ``fp_bits``-bit fingerprints."""
    dev = run.devices[0]
    db = treedb.load_tree_db(run.state["db"])
    table = fptable.build(fptable.keys_tensor(db.all_kmers, dev))
    if fp_bits < 32:
        table = fptable.narrowed(table, fp_bits)
    cfg = RefConfig()
    out = []
    for j, (_, _, codes) in enumerate(run.state["samples"]):
        counts = fptable.count(table, codes, dev, k=db.k)
        res, l2 = cst.search_ladder(db, counts, cfg)
        odir = os.path.join(run.tmp, f"ref{fp_bits}", str(j))
        os.makedirs(odir, exist_ok=True)
        if res:
            l2vote.vote_strain_l2_batch(codes, run.state["db"], odir, res,
                                        l2, dev, db.k, cfg, fp_bits=fp_bits)
        out.append((res or None, reports(odir)))
    return out


def _num(x: str):
    try:
        return float(x)
    except ValueError:
        return None


def _gap(a: float, b: float) -> float:
    if a == b:
        return 0.0
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-12)


def compare_one(got: tuple, want: tuple) -> tuple:
    """``(cst_off, report_off, report_gap)`` of one sample's ``(res,
    reports)`` against the reference's."""
    (res, reps), (res_w, reps_w) = got, want
    res, res_w = res or {}, res_w or {}
    cst_off = len(set(res) ^ set(res_w))
    for c in set(res) & set(res_w):
        for field in set(res[c]) | set(res_w[c]):
            a, b = res[c].get(field), res_w[c].get(field)
            if a != b:
                cst_off += 1
    off, gap = 0, 0.0
    for path in set(reps) | set(reps_w):
        rows = {r[1]: r for r in reps.get(path, [])[1:] if len(r) > 1}
        rows_w = {r[1]: r for r in reps_w.get(path, [])[1:] if len(r) > 1}
        if reps.get(path, [[]])[0] != reps_w.get(path, [[]])[0]:
            off += 1
        off += len(set(rows) ^ set(rows_w))
        for s in set(rows) & set(rows_w):
            a, b = rows[s], rows_w[s]
            if len(a) != len(b):
                off += 1
                continue
            for x, y in zip(a, b):
                fx, fy = _num(x), _num(y)
                if fx is not None and fy is not None:
                    gap = max(gap, _gap(fx, fy))
                elif x != y:
                    off += 1
    return cst_off, off, gap


def compare(got: list, want: list) -> list:
    """The three numbers over every ``(distinct sample, (res, reports))``
    of ``got``: CST and report cells off summed, the widest gap."""
    cst_off = off = 0
    gap = 0.0
    for d, g in got:
        c, o, x = compare_one(g, want[d])
        cst_off, off, gap = cst_off + c, off + o, max(gap, x)
    return [Check("cst_off", cst_off, CST_OFF_LIMIT),
            Check("report_off", off, REPORT_OFF_LIMIT),
            Check("report_gap", gap, REPORT_GAP_LIMIT)]


def judge(run: Run, records: list) -> list:
    t0 = time.perf_counter()
    check_db(run)
    want = reference(run)
    got = [(r["sample"], (r["res"], reports(r["out"]))) for r in records]
    checks = compare(got, want)
    run.log(f"reference: {len(want)} samples in "
            f"{time.perf_counter() - t0} s")
    return checks
