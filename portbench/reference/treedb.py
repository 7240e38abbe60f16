"""The DB's files read back: a frozen copy of the loaders of
``strainscan_tpu_torch/build/db.py`` without the program's hash tables
(the reference rebuilds its own table from ``all_kmers``).

The DB is the deployment's data, as weights are a model's: the benchmark
builds it once with the port's ``build_database`` and both sides read the
same files.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp

from portbench.reference.trees import BinTree


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
    k: int
    memory_efficient: bool


@dataclasses.dataclass
class L2DB:
    cid: int
    kmers: np.ndarray
    matrix: sp.csr_matrix
    overlap: sp.csr_matrix
    strains: List[str]

    def dense8(self) -> np.ndarray:
        return np.asarray(self.matrix.todense(), dtype=np.int8)


def load_manifest(db_dir: str) -> dict:
    with open(os.path.join(db_dir, "manifest.json")) as f:
        return json.load(f)


def load_tree_db(db_dir: str) -> TreeDB:
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
    node_ids, offsets, indices = z["node_ids"], z["offsets"], z["indices"]
    node_kmers = {int(n): indices[offsets[i]: offsets[i + 1]]
                  for i, n in enumerate(node_ids)}
    zo = np.load(os.path.join(tdir, "overlap.npz"))
    overlap_info: Dict[int, Dict[int, np.ndarray]] = {}
    for i in range(zo["leaf"].size):
        leaf, node = int(zo["leaf"][i]), int(zo["node"][i])
        s, e = zo["offsets"][i], zo["offsets"][i + 1]
        overlap_info.setdefault(leaf, {})[node] = zo["positions"][s:e]
    return TreeDB(
        tree=tree,
        gcf={int(n): s for n, s in struct["gcf"].items()},
        node_length={int(n): ln for n, ln in struct["node_length"].items()},
        reconstructed=[int(x) for x in struct["reconstructed"]],
        recls={int(c): m for c, m in struct["recls"].items()},
        all_kmers=z["all_kmers"],
        node_kmers=node_kmers,
        overlap_info=overlap_info,
        k=int(struct["k"]),
        memory_efficient=os.path.exists(os.path.join(db_dir, "Memory_DB")),
    )


def load_l2_db(db_dir: str, cid: int) -> Optional[L2DB]:
    d = os.path.join(db_dir, "l2", f"C{cid}")
    if not os.path.isdir(d):
        return None
    z = np.load(os.path.join(d, "data.npz"))
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    return L2DB(
        cid=cid, kmers=z["kmers"],
        matrix=sp.csr_matrix((z["m_data"], z["m_indices"], z["m_indptr"]),
                             shape=tuple(z["m_shape"])),
        overlap=sp.csr_matrix((z["o_data"], z["o_indices"], z["o_indptr"]),
                              shape=tuple(z["o_shape"])),
        strains=list(meta["strains"]))
