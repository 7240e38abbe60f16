"""The identify loop on a clonal-complex DB: ``run_identify`` per sample,
one at a time, as ``batch-identify`` runs, with every sample's strains
drawn from one large cluster, so that the layer-2 vote (union count,
Pre-Scan, dominant search, Elastic-Net) does most of each sample's work.

The loop, the record of a sample, the end-to-end metric and the judgement
(the DB's digest, the frozen reference and its comparison) are those of
``drivers/identify.py``; this module brings the DB and the samples.  The
DB is built once per checkout by the port's ``build_database`` from the
families of ``portbench/synth_clonal.py`` into ``cache/`` (the build's
seconds are logged and left out of ``setup_s``, and the configuration pins
the DB by its digest).  Set-up writes the mix's distinct samples and runs
one sample of each distinct cluster they draw from, so that no cluster's
L2 data loads inside the window.  Each record also keeps the program's
``prescan.L2STATS`` of its sample where the program has that counter, and
the judgement logs their sums over the window.
"""

from __future__ import annotations

import copy
import glob
import json
import os
import shutil
import time

import numpy as np

from portbench import synth, synth_clonal
from portbench.drivers.identify import (build_key, compare, end_to_end,
                                        reference)
from portbench.drivers.identify import judge as judge_identify
from portbench.drivers.identify import step as step_identify
from portbench.harness import Run

__all__ = ["make_inputs", "prepare", "step", "end_to_end", "judge",
           "reference", "compare"]


def db_summary(db: str) -> dict:
    """What a built DB holds: its clusters, tree keys, fingerprint table
    shape, and its largest L2 matrix (rows, columns after the dedup)."""
    with open(os.path.join(db, "manifest.json")) as f:
        man = json.load(f)
    with np.load(os.path.join(db, "tree", "fptable.npz")) as z:
        meta = z["meta"]
    shapes = []
    for p in glob.glob(os.path.join(db, "l2", "C*", "data.npz")):
        with np.load(p) as z:
            shapes.append([int(x) for x in z["m_shape"]])
    rows, cols = max(shapes, key=lambda s: (s[1], s[0])) if shapes \
        else (0, 0)
    return {"clusters": man["n_clusters"], "keys": man["n_tree_kmers"],
            "fp_rows": int(meta[0]), "fp_bucket": int(meta[1]),
            "l2_clusters": len(shapes), "largest_l2": [rows, cols]}


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
    names = synth_clonal.synth_clonal(
        gdir, db["families"], db["snps"], db["genome_len"],
        np.random.default_rng(db["genome_seed"]))
    meta = {"strains": names, "genomes_s": time.perf_counter() - t0}
    PHASE_TIMES.clear()
    t0 = time.perf_counter()
    build_database(gdir, os.path.join(part, "DB"),
                   BuildConfig(ksize=cfg["k"], threads=os.cpu_count()))
    meta.update(build_s=time.perf_counter() - t0,
                build_phases=dict(sorted(PHASE_TIMES.items())),
                bytes=sum(os.path.getsize(os.path.join(r, n))
                          for r, _, ns in os.walk(part) for n in ns),
                **db_summary(os.path.join(part, "DB")))
    with open(os.path.join(part, "meta.json"), "w") as f:
        json.dump(meta, f)
    os.replace(part, top)
    run.state["setup_excluded_s"] = time.perf_counter() - t_build
    run.log(f"DB built: {json.dumps({k: v for k, v in meta.items() if k != 'strains'})}")
    return top


def family_members(strains: list, sizes: list, family: int) -> list:
    """The names of family ``family``'s strains (``strains`` in the order
    ``synth_clonal`` wrote them, ``sizes`` the families' sizes)."""
    start = sum(sizes[:family])
    return strains[start:start + sizes[family]]


def make_samples(rng, gdir: str, members: list, mix: dict,
                 glen: int) -> list:
    """The mix's distinct samples, ``(kind, [(strain, depth)], codes)``:
    ``mix["strains"]`` distinct strains of ``members`` each, at depths
    drawn from ``mix["depth"]``, no background reads."""
    out, cache = [], {}
    length = mix["read_len"]
    lo, hi = mix["depth"]
    for _ in range(mix["distinct"]):
        picks = rng.choice(len(members), size=mix["strains"], replace=False)
        parts = [(members[int(j)], float(rng.uniform(lo, hi)))
                 for j in picks]
        reads = []
        for s, dep in parts:
            if s not in cache:
                cache[s] = synth.genome_codes(os.path.join(gdir, s + ".fa"))
            reads.append(synth.genome_reads(
                rng, cache[s], synth.depth_reads(dep, glen, length), length))
        codes = np.concatenate(reads)
        out.append(("clonal", parts, codes[rng.permutation(len(codes))]))
    return out


def make_inputs(run: Run) -> None:
    """The DB (built once) and the mix's distinct samples."""
    top = ensure_db(run)
    with open(os.path.join(top, "meta.json")) as f:
        meta = json.load(f)
    run.log("DB: " + json.dumps({k: meta.get(k) for k in (
        "clusters", "keys", "fp_rows", "fp_bucket", "l2_clusters",
        "largest_l2")}))
    db = run.config["db"]
    sizes = synth_clonal.family_sizes(db["families"])
    members = family_members(meta["strains"], sizes, run.traffic["family"])
    samples = make_samples(np.random.default_rng(run.seed),
                           os.path.join(top, "genomes"), members,
                           run.traffic, db["genome_len"])
    run.state.update(db=os.path.join(top, "DB"), samples=samples)


def prepare(run: Run) -> None:
    from strainscan_tpu_torch.config import IdentifyConfig
    from strainscan_tpu_torch.identify import prescan
    from strainscan_tpu_torch.identify.pipeline import run_identify
    from strainscan_tpu_torch.timing import PHASE_TIMES

    make_inputs(run)
    samples = run.state["samples"]
    paths = []
    for j, (_, _, codes) in enumerate(samples):
        paths.append(os.path.join(run.tmp, f"sample{j}.fq"))
        synth.write_fastq(paths[-1], codes)
    run.state.update(paths=paths, run_identify=run_identify,
                     cfg=IdentifyConfig(), phases=PHASE_TIMES,
                     l2stats=getattr(prescan, "L2STATS", None))
    # one warm-up sample per distinct family the samples draw from: every
    # cluster the window votes in has its L2 data loaded
    first = {}
    for j, (_, parts, _) in enumerate(samples):
        first.setdefault(parts[0][0].split("V")[0], j)
    for j in first.values():
        run_identify(paths[j], "", run.state["db"],
                     os.path.join(run.tmp, "warm", str(j)), run.device,
                     run.state["cfg"])


def step(run: Run, i: int) -> dict:
    rec = step_identify(run, i)
    if run.state["l2stats"] is not None:
        rec["l2stats"] = copy.deepcopy(run.state["l2stats"])
    return rec


def judge(run: Run, records: list) -> list:
    stats = [r["l2stats"] for r in records if "l2stats" in r]
    if stats:
        run.log("L2STATS over the window: " + json.dumps({
            "samples": len(stats),
            "clusters": sum(s["clusters"] for s in stats),
            "rounds": sum(s["rounds"] for s in stats),
            "uploads": sum(s["uploads"] for s in stats),
            "checks": sum(s["checks"] for s in stats),
            "shapes": sorted({tuple(x) for s in stats
                              for x in s["shapes"]})}))
    return judge_identify(run, records)
