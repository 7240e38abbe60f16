"""End-to-end DB build (the reference StrainScan_build.py:46-158 pipeline).

    genomes -> distance matrix -> primary clustering -> representative
    selection -> CST -> per-cluster L2 matrices -> overlap matrices -> DB

Improvements over the reference:
* host-parallel over clusters with threads (the heavy lifting is native C
  and NumPy, both GIL-releasing) — reference forks a multiprocessing pool
  (Build_kmer_sets...sp.py:621-627);
* stage-resumable: every stage persists its artifacts immediately, and
  ``resume=True`` skips stages whose outputs already exist (the reference
  restarts a crashed build from scratch — SURVEY §5);
* per-phase timing/RSS logs and optional torch.profiler traces
  (strainscan_tpu_torch/timing.py).
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
from typing import Dict, Optional

from strainscan_tpu_torch.build import cluster as cluster_mod
from strainscan_tpu_torch.build import db as db_mod
from strainscan_tpu_torch.build import distance, l2_build, select_rep, tree_build
from strainscan_tpu_torch.config import BuildConfig
from strainscan_tpu_torch.io import fastx
from strainscan_tpu_torch.timing import phase

log = logging.getLogger("strainscan_tpu_torch.build")


def build_database(
    input_fa: str,
    out_dir: str,
    cfg: BuildConfig = BuildConfig(),
    custom_cls_file: Optional[str] = None,
    use_native: bool = True,
    resume: bool = False,
) -> None:
    genomes = fastx.list_genomes(input_fa)
    if not genomes:
        raise ValueError(f"no FASTA genomes found in {input_fa}")
    genome_of = {fastx.genome_prefix(p): p for p in genomes}
    os.makedirs(out_dir, exist_ok=True)
    log.info("building DB from %d genomes", len(genomes))

    dist_path = os.path.join(out_dir, "cluster", "distance.npz")
    cls_path = os.path.join(out_dir, "cluster", "hclsMap_95.txt")
    if resume and os.path.exists(dist_path):
        log.info("resume: reusing %s", dist_path)
        names, dist = distance.load_matrix(dist_path)
    else:
        with phase("distance_matrix"):
            names, dist = distance.distance_matrix(
                genomes, k=cfg.ksize, sketch_size=cfg.sketch_size,
                exact=cfg.exact_distance, use_native=use_native)

    with phase("clustering"):
        if custom_cls_file:
            cls95 = cluster_mod.read_cls_map(custom_cls_file)
        else:
            cls95 = cluster_mod.hcls(names, dist, cfg.cls_method,
                                     cfg.cls_cutoff)
        log.info("%d primary clusters", len(cls95))
        reps, recls, moved = select_rep.pick_rep(names, dist, cls95)
        db_mod.save_cluster_stage(out_dir, names, dist, cls95, moved)

    tree_done = os.path.join(out_dir, "tree", "structure.json")
    if resume and os.path.exists(tree_done):
        log.info("resume: reusing tree stage")
        tdb = db_mod.load_tree_db(out_dir)
        cst = tree_build.CST(
            tree=tdb.tree, all_kmers=tdb.all_kmers,
            node_kmers=tdb.node_kmers, node_length=tdb.node_length,
            reconstructed=tdb.reconstructed, overlap_info=tdb.overlap_info,
            gcf=tdb.gcf, recls=tdb.recls, k=tdb.k)
    else:
        with phase("tree_build"):
            cst = tree_build.build_cst(names, dist, recls, genome_of, cfg,
                                       use_native=use_native, log=log.debug)
            db_mod.save_tree_stage(out_dir, cst)
    log.info("tree: %d nodes, %d leaves, %d k-mers, %d reconstructed",
             len(cst.node_length), len(cst.recls), cst.all_kmers.size,
             len(cst.reconstructed))

    multi = {cid: m for cid, m in cst.recls.items() if len(m) > 1}

    def l2_done(cid: int) -> bool:
        return os.path.exists(
            os.path.join(out_dir, "l2", f"C{cid}", "data.npz"))

    def build_one(cid):
        return l2_build.build_cluster_matrix(cid, multi[cid], genome_of,
                                             cfg, log.debug)

    todo = sorted((cid for cid in multi if not (resume and l2_done(cid))),
                  key=lambda c: -len(multi[c]))
    l2: Dict[int, l2_build.L2Cluster] = {}
    with phase("l2_matrices"):
        if cfg.threads > 1 and len(todo) > 1:
            with concurrent.futures.ThreadPoolExecutor(cfg.threads) as ex:
                for res in ex.map(build_one, todo):
                    l2[res.cid] = res
        else:
            for cid in todo:
                l2[cid] = build_one(cid)
    with phase("overlap_matrices"):
        l2_build.build_overlap_matrices(l2, cst.recls, genome_of, cfg,
                                        log.debug)
        for cl in l2.values():
            db_mod.save_l2_cluster(out_dir, cl, cst.k)
    db_mod.finalize_manifest(out_dir, cst, len(names),
                             cfg.memory_efficient)
    log.info("DB written to %s", out_dir)
