"""Build (once) the E. coli-scale identify fixture of the port.

The counterpart of ``benchmarks/scale_fixture.py``: 823 synthetic families
x (3 variants for even families, 1 for odd ones) x 100 kb = 1,647 strains,
which ``build_database`` clusters into 1,181 clusters over a 28.6 M-key
table, the scale of the reference's E. coli DB (1,433 strains, 823
clusters).  The generators are copies of ``synth`` and ``sim_reads`` of
``benchmarks/scale.py`` that make the same NumPy RNG calls in the same
order, so the genomes, the three shared samples and the DB are
byte-identical to those of the JAX fixture.

Artifacts land under ``--root`` (default ``<repo>/.scale_torch/``):

  genomes/        1,647 FASTA files, from default_rng(5)
  DB/             the port's database (build/pipeline.py::build_database)
  REFDB/          the same DB exported to the reference layout
  samples/*.fq    single (F000V0 x10), crossmix (F000V0 x8 + F001V0 x6),
                  intramix (F000V0 x6 + F000V1 x6), from default_rng(17);
                  deep (F000V0 x720 + F001V0 x480: 1.2 M reads of 100 bp),
                  from its own default_rng(19), made after the three
  meta.json       strains, the truth of each sample, the build's seconds
                  per phase, the table's key count and bytes, and a sha256
                  of every DB file, of the genomes and of each sample,
                  and the build's peak resident set

Usage:  python -m strainscan_tpu_torch.bench.scale_fixture [--root DIR]
            [--families 823] [--threads 2] [--deep-scale 1.0]
A rerun skips what is already on disk (delete the root to start again).
Everything here runs on the host; nothing needs a GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_ROOT = os.path.join(REPO, ".scale_torch")
READ_LEN = 100
VARIANTS, GLEN = 3, 100_000   # variants of an even family, genome length

# sample -> [(strain, depth)]: F000V0/F000V1 are variants in one
# multi-strain cluster; F001V0 is a singleton family, another cluster
SPECS = {
    "single": [("F000V0", 10.0)],
    "crossmix": [("F000V0", 8.0), ("F001V0", 6.0)],
    "intramix": [("F000V0", 6.0), ("F000V1", 6.0)],
}
SPECS_SEED = 17
# the count-ecoli stand-in's read count (1.2 M), scaled by --deep-scale
DEEP = [("F000V0", 720.0), ("F001V0", 480.0)]
DEEP_SEED = 19


def synth(gdir: str, families: int, variants: int, glen: int,
          rng) -> list:
    """Write the genomes of ``benchmarks/scale.py::synth`` under ``gdir``
    (the same RNG calls in the same order); return their names."""
    bases = np.array(list("ACGT"))
    names = []
    for f in range(families):
        # the original joins the drawn bases into a str and splits it into
        # a '<U1' array per variant; the array is kept instead (the same
        # values), and written through bytes rather than joined
        base = rng.choice(bases, size=glen)
        for v in range(variants if f % 2 == 0 else 1):
            s = base.copy()
            # 30 SNPs per variant step: far enough apart for the msn=40
            # L2 separability gate, close enough (d ~ 0.02-0.04 < 0.05)
            # that variants form one multi-strain cluster
            n_snps = 30 * (v + 1)
            if v:
                for p in rng.choice(glen, size=n_snps, replace=False):
                    s[p] = rng.choice([b for b in bases if b != s[p]])
            name = f"F{f:03d}V{v}"
            with open(os.path.join(gdir, name + ".fa"), "wb") as fh:
                # '<U1' is one UCS-4 code point per base: ASCII here
                fh.write(b">%s\n%s\n" % (
                    name.encode(),
                    s.view(np.uint32).astype(np.uint8).tobytes()))
            names.append(name)
    return names


def sim_reads(seq: str, depth: float, read_len: int, rng, out,
              start_id: int = 0) -> int:
    """Write the reads of ``benchmarks/scale.py::sim_reads`` to ``out``
    (the same RNG calls in the same order); return their number."""
    comp = str.maketrans("ACGT", "TGCA")
    n = int(len(seq) * depth / read_len)
    for i in range(n):
        s = int(rng.integers(0, len(seq) - read_len))
        r = seq[s:s + read_len]
        if rng.random() < 0.5:
            r = r.translate(comp)[::-1]
        out.write(f"@r{start_id + i}\n{r}\n+\n{'I' * read_len}\n")
    return n


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def tree_sha256(top: str) -> dict:
    """{relative path: sha256} of every file under ``top``."""
    out = {}
    for root, dirs, names in os.walk(top):
        dirs.sort()
        for n in sorted(names):
            p = os.path.join(root, n)
            out[os.path.relpath(p, top)] = sha256_file(p)
    return out


def digest(files: dict) -> str:
    """One sha256 over a {path: sha256} map, in path order."""
    return hashlib.sha256("".join(
        f"{p}\t{files[p]}\n" for p in sorted(files)).encode()).hexdigest()


def genome_seq(gdir: str, name: str) -> str:
    with open(os.path.join(gdir, name + ".fa")) as f:
        return "".join(line.strip() for line in f
                       if not line.startswith(">"))


def write_sample(path: str, gdir: str, parts, rng) -> int:
    n = 0
    with open(path, "w") as out:
        for strain, depth in parts:
            n += sim_reads(genome_seq(gdir, strain), depth, READ_LEN, rng,
                           out, n)
    return n


def build_fixture(root: str = DEFAULT_ROOT, families: int = 823,
                  threads: int = 2, deep_scale: float = 1.0,
                  export: bool = True) -> dict:
    """Make whatever of the fixture under ``root`` is not there yet (the
    reference-layout export only with ``export``); return its meta.json."""
    os.makedirs(root, exist_ok=True)
    gdir = os.path.join(root, "genomes")
    meta_path = os.path.join(root, "meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)

    def save():
        with open(meta_path, "w") as f:
            json.dump(meta, f, indent=1)

    if not os.path.isdir(gdir) or not meta.get("strains"):
        os.makedirs(gdir, exist_ok=True)
        t0 = time.perf_counter()
        names = synth(gdir, families, VARIANTS, GLEN,
                      np.random.default_rng(5))
        meta.update(strains=names, glen=GLEN, families=families,
                    genomes_s=time.perf_counter() - t0,
                    genomes_sha256=digest(tree_sha256(gdir)))
        save()
        print(f"genomes: {len(names)} strains in {meta['genomes_s']} s",
              flush=True)
    else:
        print(f"genomes: reusing {len(meta['strains'])} strains",
              flush=True)

    db = os.path.join(root, "DB")
    if not os.path.exists(os.path.join(db, "manifest.json")):
        from strainscan_tpu_torch.build.pipeline import build_database
        from strainscan_tpu_torch.config import BuildConfig
        from strainscan_tpu_torch.timing import PHASE_TIMES, peak_rss_gb

        PHASE_TIMES.clear()
        t0 = time.perf_counter()
        build_database(gdir, db, BuildConfig(threads=threads))
        meta["build_s"] = time.perf_counter() - t0
        meta["build_phases"] = dict(sorted(PHASE_TIMES.items()))
        meta["build_peak_rss_gb"] = peak_rss_gb()
        meta.pop("db_sha256", None)
        print(f"build: {meta['build_s']} s", flush=True)
        print(json.dumps(meta["build_phases"], indent=1), flush=True)
    else:
        print("DB: reusing", flush=True)
    if "db_sha256" not in meta:
        with open(os.path.join(db, "manifest.json")) as f:
            man = json.load(f)
        with np.load(os.path.join(db, "tree", "fptable.npz")) as z:
            fp_bytes = int(z["fp"].nbytes)
        files = tree_sha256(db)
        meta.update(n_clusters=man["n_clusters"],
                    n_keys=man["n_tree_kmers"], fp_table_bytes=fp_bytes,
                    db_bytes=sum(os.path.getsize(os.path.join(db, p))
                                 for p in files),
                    db_sha256=files, db_digest=digest(files))
        save()
    print(f"DB: {meta['n_clusters']} clusters, {meta['n_keys']} keys, "
          f"fp table {meta['fp_table_bytes']} B, digest "
          f"{meta['db_digest']}", flush=True)

    refdb = os.path.join(root, "REFDB")
    if export and os.path.exists(os.path.join(refdb, "Tree_database",
                                              "kmer.fa")):
        print("REFDB: reusing", flush=True)
    elif export:
        from strainscan_tpu_torch.build.convert import export_reference_db

        t0 = time.perf_counter()
        export_reference_db(db, refdb)
        meta["export_s"] = time.perf_counter() - t0
        save()
        print(f"export: {meta['export_s']} s", flush=True)

    sdir = os.path.join(root, "samples")
    os.makedirs(sdir, exist_ok=True)
    samples = meta.setdefault("samples", {})
    todo = [(SPECS_SEED, dict(SPECS)), (DEEP_SEED, {"deep": [
        (s, d * deep_scale) for s, d in DEEP]})]
    for seed, specs in todo:
        if all(name in samples for name in specs):
            continue
        rng = np.random.default_rng(seed)
        for name, parts in specs.items():
            fq = os.path.join(sdir, name + ".fq")
            t0 = time.perf_counter()
            n = write_sample(fq, gdir, parts, rng)
            samples[name] = {"truth": [s for s, _ in parts],
                             "depths": [d for _, d in parts], "reads": n,
                             "sha256": sha256_file(fq),
                             "s": time.perf_counter() - t0}
            save()
            print(f"sample {name}: {n} reads in {samples[name]['s']} s",
                  flush=True)
    print("fixture ready", flush=True)
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=DEFAULT_ROOT)
    ap.add_argument("--families", type=int, default=823)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--deep-scale", type=float, default=1.0,
                    help="scale the deep sample's depths (1.0: 1.2 M reads)")
    args = ap.parse_args(argv)
    logging.basicConfig(format="%(asctime)s - %(message)s",
                        level=logging.INFO)
    build_fixture(args.root, args.families, args.threads, args.deep_scale)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())
