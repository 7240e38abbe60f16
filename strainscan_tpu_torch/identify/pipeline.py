"""End-to-end identification (port of ``strainscan_tpu/identify/pipeline.py``,
the reference StrainScan.py:113-271):

    count sample once -> (optional) low-depth probability report ->
    CST search with the cutoff ladder -> (optional) plasmid re-build ->
    per-cluster layer-2 strain voting -> final report.

The DB loads with the port's loader (``build/db.py``); its fingerprint table is uploaded
to the device once and cached on the table object, so ``batch-identify``
keeps it resident between samples.  On a mesh of several devices the
count shards its table over the mesh (``cfg.shard_min_kmers``) and the L2
statistics split their rows over it (``cfg.shard_min_l2_rows``).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

from strainscan_tpu_torch.build.db import load_tree_db
from strainscan_tpu_torch.config import BuildConfig, IdentifyConfig
from strainscan_tpu_torch.identify import low_depth, vote
from strainscan_tpu_torch.identify.count import count_sample
from strainscan_tpu_torch.identify.cst_search import identify_cluster
from strainscan_tpu_torch.index.hashtable import fp_table_of
from strainscan_tpu_torch.io import fastx
from strainscan_tpu_torch.parallel.sharded import resolve_mesh
from strainscan_tpu_torch.timing import phase, span

log = logging.getLogger("strainscan_tpu_torch.identify")


def generate_prob_report(prob, recls, out_dir: str) -> None:
    """strain_prob.txt (StrainScan.py:98-111)."""
    with open(os.path.join(out_dir, "strain_prob.txt"), "w") as o:
        o.write("Cluster_ID\tProbability\tNumber_of_strains\t"
                "Strains_in_the_cluster\n")
        for cid, p in prob:
            strains = recls.get(cid, [])
            o.write(f"C{cid}\t{p}\t{len(strains)}\t{','.join(strains)}\n")


def extract_plasmid_refs(recls: Dict[int, list], cls_dict: Dict[int, dict],
                         out_dir: str, rgenome: str) -> str:
    """Short-contig (<100 kb) reference extraction for plasmid mode
    (StrainScan.py:47-96)."""
    genome_of = {fastx.genome_prefix(p): p
                 for p in fastx.list_genomes(rgenome)}
    ref_dir = os.path.join(out_dir, "ref_plasmids")
    os.makedirs(ref_dir, exist_ok=True)
    with open(os.path.join(out_dir, "possible_plasmids.txt"), "w") as o2:
        for c in cls_dict:
            if cls_dict[c]["strain"] != 0:
                continue
            for s in recls.get(int(c), []):
                if s not in genome_of:
                    continue
                short = [(name, seq)
                         for name, seq in fastx.read_fasta(genome_of[s])
                         if len(seq) < 100_000]
                if not short:
                    continue
                with open(os.path.join(ref_dir, f"{s}.fasta"), "w") as o:
                    for name, seq in short:
                        o.write(f">{name}\n{seq}\n")
                        o2.write(f"{s}\t>{name}\n")
    return ref_dir


def _search_ladder(db, counts, cfg: IdentifyConfig):
    """Cutoff-ladder retry (StrainScan.py:192-217); returns (res, l2)."""
    ladder = cfg.ladder()
    l2 = 0 if cfg.low_dep == 0 else 1
    res = identify_cluster(db, counts, list(ladder[0]), cfg)
    if not res and len(ladder) > 1:
        res = identify_cluster(db, counts, list(ladder[1]), cfg)
        l2 = 1
    return res, l2


def run_identify(
    fq: str,
    fq2: str,
    db_dir: str,
    out_dir: str,
    device,
    cfg: IdentifyConfig = IdentifyConfig(),
    rgenome: str = "",
    use_native: bool = True,
) -> Optional[Dict[int, dict]]:
    """Identify the strains of one sample on ``device``: "cuda" (every
    visible GPU; raises without one), "cuda:N", "cpu", a device list or a
    :class:`..parallel.sharded.Mesh`.  The call is a root span
    ``identify/sample``, which gives its spans a new sample id."""
    with span("identify/sample"):
        device = resolve_mesh(device)
        os.makedirs(out_dir, exist_ok=True)
        paths = [p for p in (fq, fq2) if p]
        with phase("identify/load_db"):
            db = load_tree_db(db_dir)
        log.info("counting sample k-mers against %d DB k-mers on %s",
                 db.table.n_keys, device)
        # Reference parity: jellyfish runs WITHOUT -C in every identify path
        # (identify.py:82-87, identify_low_mem.py:74) — even against a
        # memory-efficient DB whose stored k-mers are canonical, so
        # reverse-orientation read k-mers simply don't count there.
        with phase("identify/count"):
            counts = count_sample(fp_table_of(db.table), paths, device, cfg,
                                  canonical=False, use_native=use_native,
                                  keys=db.all_kmers)
        if cfg.strain_prob:
            prob = low_depth.identify_ranks(db, counts, cfg)
            generate_prob_report(prob, db.recls, out_dir)
        with phase("identify/cst_search"):
            res, l2 = _search_ladder(db, counts, cfg)
        if not res:
            log.warning("No clusters can be detected!")
            return None
        log.info("detected clusters: %s", sorted(res))

        pmode, emode = cfg.plasmid_mode, int(cfg.extra_region)
        vote_db_dir = db_dir
        if pmode in (1, 2):
            from strainscan_tpu_torch.build.pipeline import build_database

            if pmode == 1:
                plas_ref = extract_plasmid_refs(db.recls, res, out_dir,
                                                rgenome)
            else:
                plas_ref = rgenome
            pdb = os.path.join(out_dir, "DB_plasmid")
            log.info("building plasmid DB from %s", plas_ref)
            build_database(plas_ref, pdb,
                           BuildConfig(ksize=cfg.ksize, min_kmer=500),
                           use_native=use_native)
            pdb_tree = load_tree_db(pdb)
            pcounts = count_sample(fp_table_of(pdb_tree.table), paths, device,
                                   cfg, use_native=use_native,
                                   keys=pdb_tree.all_kmers)
            res, l2 = _search_ladder(pdb_tree, pcounts, cfg)
            if not res:
                log.warning("No clusters can be detected (plasmid DB)!")
                return None
            vote_db_dir = pdb

        # canonical=False: L2 jellyfish also runs without -C
        # (Vote_Strain_L2_Lasso_new_sp.py:359-371), DB mode notwithstanding
        with phase("identify/l2_vote"):
            vote.vote_strain_l2_batch(
                paths, vote_db_dir, out_dir, res, l2, device, cfg, pmode=pmode,
                emode=emode, canonical=False, use_native=use_native,
                log=log.info)
        return res
