"""Hierarchical clustering + tree cut.

Replaces the reference's temp-R-script ``hclust`` / ``cutree`` subprocess
(library/Cluster.py:56-117): agglomerative clustering over the distance
matrix with single or complete linkage, cut at height ``h``.  Cluster ids
are numbered by first appearance in input order, matching R ``cutree``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
from scipy.cluster import hierarchy as sch
from scipy.spatial.distance import squareform


def hcls(names: Sequence[str], dist: np.ndarray, method: str,
         cutoff: float) -> Dict[int, List[str]]:
    """Flat clusters {cluster_id: [strain names]} at distance cutoff.

    method: 'single' | 'complete' (reference uses single at h=0.05 for the
    primary clustering, StrainScan_build.py:109, and complete at h=0.01 for
    the L2 dedup, Recls_withR_new.py:38).
    """
    n = len(names)
    if n == 1:
        return {1: [names[0]]}
    d = np.asarray(dist, dtype=np.float64).copy()
    np.fill_diagonal(d, 0.0)
    d = np.maximum(d, 0.0)
    # symmetrize against float asymmetry from sketch estimation
    d = (d + d.T) / 2.0
    z = sch.linkage(squareform(d, checks=False), method=method)
    labels = sch.fcluster(z, t=cutoff, criterion="distance")
    # renumber by first appearance (R cutree convention)
    remap: Dict[int, int] = {}
    out: Dict[int, List[str]] = {}
    for i, lab in enumerate(labels):
        if lab not in remap:
            remap[lab] = len(remap) + 1
        out.setdefault(remap[lab], []).append(names[i])
    return out


def write_cls_map(path: str, cls: Dict[int, List[str]]) -> None:
    """hclsMap text format: ``id\\tsize\\tname1,name2`` (Cluster.py:111-115)."""
    with open(path, "w") as f:
        for cid in sorted(cls):
            members = cls[cid]
            f.write(f"{cid}\t{len(members)}\t{','.join(members)}\n")


def read_cls_map(path: str) -> Dict[int, List[str]]:
    out: Dict[int, List[str]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ele = line.split("\t")
            out[int(ele[0])] = ele[-1].split(",") if ele[-1] else []
    return out
