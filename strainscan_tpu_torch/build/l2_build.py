"""Per-cluster strain-discriminating k-mer matrices (the "L2" layer).

Redesign of the reference's sibeliaz-based pipeline
(library/Build_kmer_sets_unique_region_lasso_test_allinone_sp.py:546-627):
for every multi-strain cluster it builds a sparse 0/1 matrix of
discriminating k-mers × strains, then de-duplicates >99%-identical strains
(library/Recls_withR_new.py:16-115).

Design note (k-mer selection): the reference mines colinear blocks with
``sibeliaz`` and keeps (a) strain-unique k-mers capped at ``uk_num`` per
strain (:24-121), (b) k-mers shared by a strict subset of strains inside
partial blocks (:423-495), and (c) non-universal k-mers of global blocks
(:335-387).  The block machinery exists to anchor k-mers in syntenic
regions; the discriminative content is equivalent to presence-pattern
selection over whole-genome k-mer sets, which is what we compute here,
deterministically and without subprocesses: every k-mer present in >= 2
but < all strains is kept, and strain-unique k-mers are kept in genome
order up to ``uk_num`` per strain (both orientations, like ``resd`` at
:59-69).  K-mers present in all strains carry no intra-cluster signal and
are dropped, exactly as the reference drops universal k-mers
(:357,374-377).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from strainscan_tpu_torch.build.cluster import hcls
from strainscan_tpu_torch.config import BuildConfig
from strainscan_tpu_torch.io import fastx
from strainscan_tpu_torch.kmer import pack


@dataclasses.dataclass
class L2Cluster:
    cid: int
    kmers: np.ndarray            # sorted uint64 — row id space
    matrix: sp.csr_matrix        # k-mer x representative strain (0/1 int8)
    strains: List[str]           # representative strain names (column order)
    all_strains: List[str]       # every member strain
    recluster: Dict[int, List[str]]  # dedup subcluster -> members
    overlap: sp.csr_matrix | None = None  # k-mer x cluster (0/1 int8)


def _strain_ordered_kmers(path: str, k: int, mode: str = "both") -> np.ndarray:
    """K-mers in genome order, fwd/rc interleaved per position
    (mirrors resd insertion order, Build_kmer_sets...sp.py:59-69); in
    canonical (memory-efficient) mode, one canonical k-mer per position."""
    fwd = fastx.genome_kmers(path, k, mode="fwd", unique=False)
    if mode == "canonical":
        return pack.canonical_packed(fwd, k)
    rc = pack.revcomp_packed(fwd, k)
    inter = np.empty(fwd.size * 2, dtype=np.uint64)
    inter[0::2] = fwd
    inter[1::2] = rc
    return inter


def build_cluster_matrix(
    cid: int,
    members: Sequence[str],
    genome_of: Dict[str, str],
    cfg: BuildConfig,
    log=lambda m: None,
) -> L2Cluster:
    k = cfg.ksize
    n = len(members)
    # The reference L2 build is identical in standard and memory-efficient
    # modes — both orientations always (Build_kmer_sets...sp.py:536-539;
    # only Build_tree has a _mem canonical variant), so -e does not change
    # the L2 k-mer sets.
    kmode = "both"
    # presence sets per strain (both orientations, unique)
    presence = [
        fastx.genome_kmers(genome_of[s], k, mode=kmode, unique=True)
        for s in members
    ]
    # global presence counts (dlabel, Build_kmer_sets...sp.py:518-543)
    concat = np.concatenate(presence)
    gu, gc = np.unique(concat, return_counts=True)

    selected: List[np.ndarray] = []
    cols: List[np.ndarray] = []
    # (a) strain-unique k-mers in genome order, capped per strain (:91-98)
    for si, s in enumerate(members):
        ordered = _strain_ordered_kmers(genome_of[s], k, kmode)
        # dedup keep-first occurrence
        _, first_idx = np.unique(ordered, return_index=True)
        ordered = ordered[np.sort(first_idx)]
        cnt = gc[np.searchsorted(gu, ordered)]
        uniq_ordered = ordered[cnt == 1]
        take = uniq_ordered[: cfg.uk_num]
        selected.append(take)
        cols.append(np.full(take.size, si, dtype=np.int32))
        log(f"C{cid} strain {s}: {take.size} unique k-mers")
    # (b) shared-subset k-mers: 2 <= presence < n (:423-495, :335-387)
    shared = gu[(gc >= 2) & (gc < n)]
    memb = (np.stack([np.isin(shared, presence[si], assume_unique=True)
                      for si in range(n)], axis=1)
            if shared.size else np.zeros((0, n), dtype=bool))
    if shared.size and cfg.gk_ratio < 1.0:
        # gk_ratio (-g): the reference keeps only the first
        # int(gkratio * n_blocks) PARTIAL sibeliaz blocks, sorted by
        # ascending strain count (Build_kmer_sets...sp.py:239-251) — the
        # fewest-strain (most discriminative) blocks survive.  The
        # presence-pattern analog: group shared k-mers by their exact
        # strain subset, sort groups by (subset size, pattern bytes)
        # ascending, keep the first int(gk_ratio * n_groups) groups.
        packed = np.packbits(memb, axis=1)
        groups, inverse = np.unique(packed, axis=0, return_inverse=True)
        gsizes = np.unpackbits(groups, axis=1, count=n).sum(axis=1)
        order = np.lexsort(
            tuple(groups[:, c] for c in range(groups.shape[1] - 1, -1, -1))
            + (gsizes,))
        out_num = int(cfg.gk_ratio * groups.shape[0])
        kept_groups = order[:out_num]
        keep_mask = np.isin(inverse, kept_groups)
        log(f"C{cid}: gk_ratio={cfg.gk_ratio} keeps "
            f"{out_num}/{groups.shape[0]} presence patterns "
            f"({int(keep_mask.sum())}/{shared.size} shared k-mers)")
        shared = shared[keep_mask]
        memb = memb[keep_mask]
    for si in range(n):
        sel = shared[memb[:, si]]
        selected.append(sel)
        cols.append(np.full(sel.size, si, dtype=np.int32))
    log(f"C{cid}: {shared.size} shared k-mers")

    all_sel = np.concatenate(selected)
    all_col = np.concatenate(cols)
    kmers = np.unique(all_sel)
    rows = np.searchsorted(kmers, all_sel).astype(np.int64)
    mat = sp.csr_matrix(
        (np.ones(rows.size, dtype=np.int8), (rows, all_col)),
        shape=(kmers.size, n),
    )
    mat.data[:] = 1  # collapse duplicate entries
    mat.sum_duplicates()
    mat.data[:] = 1

    # -------- >99% dedup (Recls_withR_new.remove_1per, :16-115) --------
    dense = np.asarray(mat.todense())
    totals = dense.sum(axis=0).astype(np.int64)
    totals_safe = np.where(totals == 0, 1, totals)
    strains = list(members)
    if n > 1:
        # hamming distances normalized by the LATER strain's k-mer total:
        # R as.dist() keeps the lower triangle of dm/total[:,None]
        # (Recls_withR_new.py:29-38), i.e. d(i<j) = hamming/total[j]
        dm = np.zeros((n, n))
        for i in range(n):
            for j in range(i + 1, n):
                h = int(np.count_nonzero(dense[:, i] != dense[:, j]))
                dm[i, j] = dm[j, i] = h / totals_safe[j]
        subcls = hcls(strains, dm, "complete", cfg.recls_cutoff)
    else:
        subcls = {1: strains}
    reps: List[str] = []
    recluster: Dict[int, List[str]] = {}
    keep_cols: List[int] = []
    sidx = {s: i for i, s in enumerate(strains)}
    for scid in sorted(subcls):
        group = subcls[scid]
        # rep = member with the most k-mers (strictly greater wins,
        # first-iterated breaks ties — Recls_withR_new.py:85-92).  When
        # every member has ZERO matrix k-mers (e.g. byte-identical
        # genomes land in one cluster, so no k-mer discriminates), the
        # reference's pick_rep returns '' and crashes on the id lookup
        # (Recls_withR_new.py:92,102); keep the first member instead.
        best, best_n = group[0], 0
        for s in group:
            if totals[sidx[s]] > best_n:
                best, best_n = s, int(totals[sidx[s]])
        reps.append(best)
        keep_cols.append(sidx[best])
        recluster[scid] = group
    mat_re = sp.csr_matrix(mat[:, keep_cols])
    return L2Cluster(cid=cid, kmers=kmers, matrix=mat_re, strains=reps,
                     all_strains=strains, recluster=recluster)


def build_overlap_matrices(
    l2: Dict[int, L2Cluster],
    recls: Dict[int, List[str]],
    genome_of: Dict[str, str],
    cfg: BuildConfig,
    log=lambda m: None,
) -> None:
    """Fill each L2Cluster.overlap: k-mer x cluster presence matrix.

    Equivalent of Build_overlap_matrix_sp.py:30-101 — column ``c`` is 1
    when the k-mer occurs in any genome of cluster ``c`` (both
    orientations).  Column order follows ascending cluster id; identify
    selects columns by detected-cluster ids (identify_strains...sp.py:180-196).

    Memory profile subsumes the reference's low-RAM jellyfish variant
    (Build_overlap_matrix_sp_jellyfish.py:126-143, which exists because
    the all-genome k-mer dict blows RAM at E. coli scale): resident state
    here is ONE cluster's k-mer union at a time plus the global sorted
    L2 k-mer index (flat uint64, ~100s of MB at 1400-strain scale), never
    an all-genome map.
    """
    cluster_ids = sorted(recls)
    n_cls = len(cluster_ids)
    cols: Dict[int, List[Tuple[int, np.ndarray]]] = {c.cid: [] for c in l2.values()}
    # Global sorted index over every L2 cluster's k-mers: membership of
    # all L2 k-mers in one cluster's genome union is then ONE
    # searchsorted of the union (O(|union| log L)) instead of one per
    # (cluster, L2-cluster) pair — the difference between minutes and
    # hours at the E. coli scale (823 clusters x hundreds of L2 sets).
    if not l2:
        return
    all_l2 = np.unique(np.concatenate([cl.kmers for cl in l2.values()])) \
        if any(cl.kmers.size for cl in l2.values()) else np.empty(0, np.uint64)
    idx_of = {cl.cid: np.searchsorted(all_l2, cl.kmers)
              for cl in l2.values()}

    def scan_cluster(ci_cid):
        """(ci, [(l2_cid, rows)]) for one cluster's genome union."""
        ci, cid = ci_cid
        members = recls[cid]
        if not members:
            return ci, []
        # both orientations regardless of -e: the reference's mem-mode
        # jellyfish variant matches canonically (-C), which over raw L2
        # k-mers is equivalent to membership in the both-orientation union
        union = np.unique(np.concatenate([
            fastx.genome_kmers(genome_of[s], cfg.ksize, mode="both")
            for s in members
        ]))
        log(f"overlap: cluster {cid} union {union.size} k-mers")
        hit = np.zeros(all_l2.size, dtype=bool)
        if union.size and all_l2.size:
            pos = np.searchsorted(all_l2, union)
            inb = pos < all_l2.size
            pos = pos[inb]
            hit[pos[all_l2[pos] == union[inb]]] = True
        return ci, [(cl.cid, np.where(hit[idx_of[cl.cid]])[0])
                    for cl in l2.values()]

    work = list(enumerate(cluster_ids))
    if cfg.threads > 1 and len(work) > 1:
        # per-cluster scans are independent; the native k-merizer and
        # the numpy set ops release the GIL (same pool pattern as
        # tree_build leaf_extract / id_space)
        import concurrent.futures

        with concurrent.futures.ThreadPoolExecutor(cfg.threads) as ex:
            results = list(ex.map(scan_cluster, work))
    else:
        results = [scan_cluster(w) for w in work]
    for ci, pairs in sorted(results):
        for l2_cid, rows in pairs:
            cols[l2_cid].append((ci, rows))
    for cl in l2.values():
        r_parts, c_parts = [], []
        for ci, rows in cols[cl.cid]:
            r_parts.append(rows)
            c_parts.append(np.full(rows.size, ci, dtype=np.int64))
        if r_parts:
            rr = np.concatenate(r_parts)
            cc = np.concatenate(c_parts)
        else:
            rr = np.empty(0, dtype=np.int64)
            cc = np.empty(0, dtype=np.int64)
        cl.overlap = sp.csr_matrix(
            (np.ones(rr.size, dtype=np.int8), (rr, cc)),
            shape=(cl.kmers.size, n_cls),
        )
