"""Low-depth strain probability ranking (-b mode).

Port of library/identify_low_depth.py:113-156: per-node coverage over the
whole tree (nodes under ``lowdep_min_valid`` k-mers are skipped), then for
every root-to-leaf path the geometric mean of the transform
``log10(180*cov + 1)`` capped at 1 for cov > 0.05 (identify_low_depth.py:
105-151).
"""

from __future__ import annotations

from math import log10
from typing import Dict, List, Tuple

import numpy as np

from strainscan_tpu_torch.build.db import TreeDB
from strainscan_tpu_torch.config import IdentifyConfig


def identify_ranks(
    db: TreeDB,
    counts: np.ndarray,
    cfg: IdentifyConfig = IdentifyConfig(),
) -> List[Tuple[int, float]]:
    """[(leaf_cluster_id, probability score)] sorted descending."""
    node_frac: Dict[int, float] = {}
    for node in db.tree.nodes():
        ids = db.node_kmers.get(node, np.empty(0, np.int32))
        if ids.size < cfg.lowdep_min_valid:
            node_frac[node] = -1.0
            continue
        prof = counts[ids]
        prof = prof[prof > 0]
        if prof.size:
            cutoff = cfg.outlier_factor * np.median(prof)
            prof = prof[prof < cutoff]
        node_frac[node] = prof.size / ids.size
    scored: Dict[int, float] = {}
    for path in db.tree.paths_to_leaves():
        leaf = path[-1]
        valid = [n for n in path if node_frac[n] != -1.0]
        if not valid:
            continue
        n_valid = len(valid)
        score = 1.0
        for n in valid:
            cov = node_frac[n]
            x = 1.0 if cov > cfg.lowdep_cov_one else log10(
                cfg.lowdep_scale * cov + 1.0)
            score *= x ** (1.0 / n_valid)
        if score != 0:
            scored[leaf] = score
    return sorted(scored.items(), key=lambda kv: kv[1], reverse=True)
