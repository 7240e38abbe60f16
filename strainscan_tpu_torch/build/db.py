"""On-disk database format + full build pipeline.

The DB is the contract between build and identify (reference layer L4:
Tree_database/ text files + Kmer_Sets_L2 pickles, written at
Build_tree.py:494-698 and Build_kmer_sets...sp.py:335-419).  Here it is a
versioned directory of NumPy archives + JSON manifests:

    DB/
      manifest.json                  # version, k, mode, counts
      cluster/distance.npz           # names + distance matrix
      cluster/hclsMap_95.txt         # primary clustering (text, ref format)
      cluster/hclsMap_95_recls.txt   # final clustering (post tree build)
      cluster/Other_Strain_CN.txt    # re-assignment log
      tree/structure.json            # topology, gcf, lengths, reconstructed
      tree/kmers.npz                 # global k-mer array + per-node ids
      tree/table.npz                 # hash table over the global k-mers
      tree/overlap.npz               # reconstruction overlap positions
      l2/C<cid>/data.npz             # k-mers, strain matrix, overlap matrix
      l2/C<cid>/meta.json            # strain names, recluster info

A ``Memory_DB`` marker file selects the canonical-k-mer (half-size) DB and
the matching identify thresholds (reference StrainScan_build.py:128-134 /
StrainScan.py:188-191).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp

from strainscan_tpu_torch.build.l2_build import L2Cluster
from strainscan_tpu_torch.build.tree_build import CST
from strainscan_tpu_torch.index.hashtable import KmerTable
from strainscan_tpu_torch.utils.trees import BinTree

FORMAT_VERSION = 1
# the manifest's builder_version: the JAX package's version string, so
# that a DB built by either package is byte-identical and both load it
BUILDER_VERSION = "0.1.0"


def save_cluster_stage(out_dir: str, names: List[str], dist: np.ndarray,
                       cls95: Dict[int, List[str]], moved) -> None:
    cdir = os.path.join(out_dir, "cluster")
    os.makedirs(cdir, exist_ok=True)
    np.savez_compressed(os.path.join(cdir, "distance.npz"),
                        names=np.array(names), dist=dist)
    from strainscan_tpu_torch.build.cluster import write_cls_map

    write_cls_map(os.path.join(cdir, "hclsMap_95.txt"), cls95)
    with open(os.path.join(cdir, "Other_Strain_CN.txt"), "w") as f:
        for row in moved:
            s, old, od, new, nd = row
            f.write(f"{s}\t{old},{od}\t{new},{nd}\n")


def save_tree_stage(out_dir: str, cst: CST) -> None:
    cdir = os.path.join(out_dir, "cluster")
    tdir = os.path.join(out_dir, "tree")
    os.makedirs(cdir, exist_ok=True)
    os.makedirs(tdir, exist_ok=True)
    from strainscan_tpu_torch.build.cluster import write_cls_map

    write_cls_map(os.path.join(cdir, "hclsMap_95_recls.txt"), cst.recls)
    struct = {
        "root": cst.tree.root,
        "children": {str(n): list(c) for n, c in cst.tree.children.items()},
        "gcf": {str(n): s for n, s in cst.gcf.items()},
        "node_length": {str(n): l for n, l in cst.node_length.items()},
        "reconstructed": cst.reconstructed,
        "recls": {str(c): m for c, m in cst.recls.items()},
        "k": cst.k,
    }
    with open(os.path.join(tdir, "structure.json"), "w") as f:
        json.dump(struct, f)
    # node k-mer ids (ragged -> concat + offsets)
    node_ids = sorted(cst.node_kmers)
    offsets = np.zeros(len(node_ids) + 1, dtype=np.int64)
    chunks = []
    for i, n in enumerate(node_ids):
        chunks.append(cst.node_kmers[n])
        offsets[i + 1] = offsets[i] + cst.node_kmers[n].size
    indices = (np.concatenate(chunks) if chunks
               else np.empty(0, dtype=np.int32))
    # uncompressed: packed k-mers are near-random bits (poor zlib ratio,
    # slow inflate on the cold identify path); np.load reads either form
    np.savez(
        os.path.join(tdir, "kmers.npz"),
        all_kmers=cst.all_kmers,
        node_ids=np.array(node_ids, dtype=np.int64),
        offsets=offsets,
        indices=indices,
    )
    # all_kmers must be duplicate-free: KmerTable.build double-inserts
    # duplicates and the fp sidecar's single-probe invariant can never
    # hold for them (same bucket, same fingerprint at every seed)
    if np.unique(cst.all_kmers).size != cst.all_kmers.size:
        raise ValueError("tree stage produced duplicate k-mers in "
                         "all_kmers; refusing to build the hash table")
    table = KmerTable.build(cst.all_kmers, k=cst.k)
    table.save(os.path.join(tdir, "table.npz"))
    # fingerprint-table sidecar: pay the seed search ONCE at build so
    # cold identify loads read it instead of re-deriving it; loaders
    # fall back to deriving when absent.  The
    # shared content checksum lets the loader reject a sidecar that does
    # not belong to this table.
    from strainscan_tpu_torch.index.hashtable import FpTable, keys_checksum

    FpTable.from_kmer_table(table).save(
        os.path.join(tdir, "fptable.npz"),
        content_csum=keys_checksum(cst.all_kmers))
    # overlap info (leaf, node, ragged positions)
    ol, on, oo, op = [], [], [0], []
    for leaf in sorted(cst.overlap_info):
        for node in sorted(cst.overlap_info[leaf]):
            positions = cst.overlap_info[leaf][node]
            ol.append(leaf)
            on.append(node)
            op.append(positions)
            oo.append(oo[-1] + positions.size)
    np.savez_compressed(
        os.path.join(tdir, "overlap.npz"),
        leaf=np.array(ol, dtype=np.int64),
        node=np.array(on, dtype=np.int64),
        offsets=np.array(oo, dtype=np.int64),
        positions=(np.concatenate(op).astype(np.int32) if op
                   else np.empty(0, dtype=np.int32)),
    )


def save_l2_cluster(out_dir: str, cl: L2Cluster, k: int) -> None:
    d = os.path.join(out_dir, "l2", f"C{cl.cid}")
    os.makedirs(d, exist_ok=True)
    np.savez_compressed(
        os.path.join(d, "data.npz"),
        kmers=cl.kmers,
        m_data=cl.matrix.data, m_indices=cl.matrix.indices,
        m_indptr=cl.matrix.indptr,
        m_shape=np.array(cl.matrix.shape),
        o_data=cl.overlap.data, o_indices=cl.overlap.indices,
        o_indptr=cl.overlap.indptr,
        o_shape=np.array(cl.overlap.shape),
    )
    KmerTable.build(cl.kmers, k=k).save(os.path.join(d, "table.npz"))
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump({
            "strains": cl.strains,
            "all_strains": cl.all_strains,
            "recluster": {str(i): m for i, m in cl.recluster.items()},
        }, f)


def finalize_manifest(out_dir: str, cst: CST, n_strains: int,
                      memory_efficient: bool) -> None:
    if memory_efficient:
        open(os.path.join(out_dir, "Memory_DB"), "w").close()
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump({
            "format_version": FORMAT_VERSION,
            "builder_version": BUILDER_VERSION,
            "k": cst.k,
            "memory_efficient": memory_efficient,
            "n_strains": n_strains,
            "n_clusters": len(cst.recls),
            "cluster_ids": sorted(cst.recls),
            "n_tree_kmers": int(cst.all_kmers.size),
        }, f, indent=1)


def save_db(
    out_dir: str,
    cst: CST,
    l2: Dict[int, L2Cluster],
    names: List[str],
    dist: np.ndarray,
    cls95: Dict[int, List[str]],
    moved,
    memory_efficient: bool = False,
) -> None:
    os.makedirs(out_dir, exist_ok=True)
    save_cluster_stage(out_dir, names, dist, cls95, moved)
    save_tree_stage(out_dir, cst)
    for cl in l2.values():
        save_l2_cluster(out_dir, cl, cst.k)
    finalize_manifest(out_dir, cst, len(names), memory_efficient)


@dataclasses.dataclass
class TreeDB:
    tree: BinTree
    gcf: Dict[int, str]
    node_length: Dict[int, int]
    reconstructed: List[int]
    recls: Dict[int, List[str]]
    all_kmers: np.ndarray
    node_kmers: Dict[int, np.ndarray]
    overlap_info: Dict[int, Dict[int, np.ndarray]]
    table: KmerTable
    k: int
    memory_efficient: bool


@dataclasses.dataclass
class L2DB:
    cid: int
    kmers: np.ndarray
    matrix: sp.csr_matrix
    overlap: sp.csr_matrix
    strains: List[str]
    all_strains: List[str]
    recluster: Dict[int, List[str]]
    table: KmerTable

    def dense8(self) -> np.ndarray:
        """The k-mer x strain matrix densified to int8, cached: the
        Pre-Scan kernels consume int8 and re-densifying per sample is
        pure host memory traffic (vote_strain_l2 runs once per sample
        per multi-strain cluster).  Callers must treat it read-only."""
        cached = getattr(self, "_dense8", None)
        if cached is None:
            cached = np.asarray(self.matrix.todense(), dtype=np.int8)
            object.__setattr__(self, "_dense8", cached)
        return cached


def load_manifest(db_dir: str) -> dict:
    with open(os.path.join(db_dir, "manifest.json")) as f:
        return json.load(f)


# one-entry cache for repeat identify calls in one process (serving /
# multi-sample loops): keeps the KmerTable OBJECT identity stable so its
# derived fingerprint table and uploaded device buffers (attached as
# _fp_cache/_device_cache) are reused — at E. coli scale a cold
# run_identify would otherwise reload the npz blobs, rebuild the fp table
# and upload ~0.5 GB to the device again for every sample.  Callers must treat the
# returned TreeDB as read-only (the identify pipeline does).
_TREE_CACHE: dict = {}


def load_tree_db(db_dir: str) -> TreeDB:
    tdir = os.path.join(db_dir, "tree")
    try:
        stamp = os.path.getmtime(os.path.join(tdir, "table.npz"))
    except OSError:
        stamp = None
    key = (os.path.abspath(db_dir), stamp)
    if stamp is not None and key in _TREE_CACHE:
        return _TREE_CACHE[key]
    db = _load_tree_db_uncached(db_dir)
    if stamp is not None:
        _TREE_CACHE.clear()   # hold at most one DB alive
        _TREE_CACHE[key] = db
    return db


def _load_tree_db_uncached(db_dir: str) -> TreeDB:
    tdir = os.path.join(db_dir, "tree")
    with open(os.path.join(tdir, "structure.json")) as f:
        struct = json.load(f)
    tree = BinTree()
    tree.add_root(int(struct["root"]))
    for n, (a, b) in struct["children"].items():
        n, a, b = int(n), int(a), int(b)
        tree.children[n] = (a, b)
        tree.parent[a] = n
        tree.parent[b] = n
    z = np.load(os.path.join(tdir, "kmers.npz"))
    node_ids = z["node_ids"]
    offsets = z["offsets"]
    indices = z["indices"]
    node_kmers = {
        int(n): indices[offsets[i]: offsets[i + 1]]
        for i, n in enumerate(node_ids)
    }
    zo = np.load(os.path.join(tdir, "overlap.npz"))
    overlap_info: Dict[int, Dict[int, np.ndarray]] = {}
    for i in range(zo["leaf"].size):
        leaf, node = int(zo["leaf"][i]), int(zo["node"][i])
        s, e = zo["offsets"][i], zo["offsets"][i + 1]
        overlap_info.setdefault(leaf, {})[node] = zo["positions"][s:e]
    mem = os.path.exists(os.path.join(db_dir, "Memory_DB"))
    # With the fp sidecar present the exact table loads LAZILY — the
    # fp-mode hot path needs only its geometry, so the 572 MB (E. coli
    # scale) slot-array read is skipped entirely on the cold path.  A
    # corrupt, truncated, or foreign sidecar (content checksum mismatch)
    # falls back to the pre-round-4 eager-load + derive path.
    fp_path = os.path.join(tdir, "fptable.npz")
    table_path = os.path.join(tdir, "table.npz")
    table = None
    if os.path.exists(fp_path):          # absent in pre-round-4 DBs
        from strainscan_tpu_torch.index.hashtable import FpTable

        try:
            fpt = FpTable.load(fp_path)
        except Exception as e:
            logging.getLogger("strainscan_tpu_torch.db").warning(
                "ignoring unreadable fp sidecar %s: %s", fp_path, e)
            fpt = None
        if fpt is not None:
            table = KmerTable.load(table_path, lazy=True)
            tcsum = getattr(table, "_csum", None)
            fcsum = getattr(fpt, "_csum", None)
            if tcsum is None and fcsum is not None:
                # table.npz predates stored checksums but the sidecar
                # carries one: derive the table's content checksum from
                # the tree stage's key array (already loaded above) so a
                # foreign same-geometry sidecar cannot attach silently
                from strainscan_tpu_torch.index.hashtable import keys_checksum

                tcsum = keys_checksum(z["all_kmers"])
            if (fpt.n_keys == table.n_keys and fpt.k == table.k
                    and (tcsum is None or fcsum is None
                         or tcsum == fcsum)):
                object.__setattr__(table, "_fp_cache", fpt)
            else:
                logging.getLogger("strainscan_tpu_torch.db").warning(
                    "fp sidecar does not match table.npz "
                    "(n_keys/k/checksum); deriving instead")
                table = None
    if table is None:
        table = KmerTable.load(table_path)
    return TreeDB(
        tree=tree,
        gcf={int(n): s for n, s in struct["gcf"].items()},
        node_length={int(n): l for n, l in struct["node_length"].items()},
        reconstructed=[int(x) for x in struct["reconstructed"]],
        recls={int(c): m for c, m in struct["recls"].items()},
        all_kmers=z["all_kmers"],
        node_kmers=node_kmers,
        overlap_info=overlap_info,
        table=table,
        k=int(struct["k"]),
        memory_efficient=mem,
    )


# small LRU of L2DB objects for repeat identify calls (serving loops):
# vote re-loads every detected multi-strain cluster per sample, and at
# E. coli scale the npz read + CSR assembly is a visible slice of the
# warm L2 vote.  Keyed on (path, mtime) like _TREE_CACHE; callers treat
# the returned L2DB as read-only (the vote path does).
_L2_CACHE: dict = {}
_L2_CACHE_MAX = 8


def load_l2_db(db_dir: str, cid: int) -> Optional[L2DB]:
    d = os.path.join(db_dir, "l2", f"C{cid}")
    if not os.path.isdir(d):
        return None
    try:
        stamp = os.path.getmtime(os.path.join(d, "data.npz"))
    except OSError:
        stamp = None
    key = (os.path.abspath(d), stamp)
    if stamp is not None and key in _L2_CACHE:
        db = _L2_CACHE.pop(key)
        _L2_CACHE[key] = db          # move to MRU position
        return db
    db = _load_l2_db_uncached(d, cid)
    if db is not None and stamp is not None:
        _L2_CACHE[key] = db
        while len(_L2_CACHE) > _L2_CACHE_MAX:
            _L2_CACHE.pop(next(iter(_L2_CACHE)))
    return db


def _load_l2_db_uncached(d: str, cid: int) -> Optional[L2DB]:
    z = np.load(os.path.join(d, "data.npz"))
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    matrix = sp.csr_matrix(
        (z["m_data"], z["m_indices"], z["m_indptr"]),
        shape=tuple(z["m_shape"]))
    overlap = sp.csr_matrix(
        (z["o_data"], z["o_indices"], z["o_indptr"]),
        shape=tuple(z["o_shape"]))
    return L2DB(
        cid=cid, kmers=z["kmers"], matrix=matrix, overlap=overlap,
        strains=list(meta["strains"]),
        all_strains=list(meta["all_strains"]),
        recluster={int(i): m for i, m in meta["recluster"].items()},
        table=KmerTable.load(os.path.join(d, "table.npz")),
    )
