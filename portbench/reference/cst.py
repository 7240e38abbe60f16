"""Frozen copy of ``strainscan_tpu_torch/identify/cst_search.py`` and the
cutoff ladder of ``identify/pipeline.py`` (the reference's CST search).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import scipy.stats as st

from portbench.reference.treedb import TreeDB
from portbench.reference.config import IdentifyConfig


class _NodeData:
    __slots__ = ("cat", "access", "cov_num", "tot_num", "ab")

    def __init__(self):
        self.cat = -1
        self.access = -1
        self.cov_num = -1.0
        self.tot_num = -1.0
        self.ab = -1.0


class CSTSearch:
    def __init__(self, db: TreeDB, counts: np.ndarray,
                 cfg: IdentifyConfig = IdentifyConfig(),
                 seed: int = 0):
        self.db = db
        self.tree = db.tree
        self.counts = counts
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.data: Dict[int, _NodeData] = {}
        self.length: Dict[int, float] = {}
        self.cov: Dict[int, float] = {}
        self.abundance: Dict[int, float] = {}
        self._label_nodes()

    # -------------------------------------------------- node categories
    def _label_nodes(self) -> None:
        """identify.py:45-70 (thresholds halved for memory-efficient DBs,
        identify_low_mem.py:50-64)."""
        weak = (self.cfg.node_weak_mem if self.db.memory_efficient
                else self.cfg.node_weak)
        small = (self.cfg.node_small_mem if self.db.memory_efficient
                 else self.cfg.node_small)
        leaves = set(self.tree.leaves())
        for n in self.tree.nodes():
            d = _NodeData()
            ln = self.db.node_length.get(n, 0)
            if ln < weak:
                d.cat = 1 if n in leaves else 0
            elif ln < small:
                d.cat = 1
            else:
                d.cat = 2
            self.data[n] = d
        for n in self.db.reconstructed:
            d = self.data[n]
            if d.cat != 0:
                d.cat = "o1" if self.db.node_length.get(n, 0) < small else "o2"
        self._small_threshold = small

    # ----------------------------------------------------- stats helpers
    def _del_outlier(self, profile: np.ndarray) -> np.ndarray:
        """Drop counts >= outlier_factor * median (identify.py:106-112)."""
        cutoff = self.cfg.outlier_factor * np.median(profile)
        return profile[profile < cutoff]

    def _match_node(self, node: int) -> Tuple[int, np.ndarray]:
        ids = self.db.node_kmers.get(node, np.empty(0, np.int32))
        prof = self.counts[ids]
        prof = prof[prof > 0]
        if prof.size:
            prof = self._del_outlier(prof)
        return ids.size, prof

    def _piecewise(self, cov_cutoff: float, cov: float, label,
                   profile: np.ndarray) -> float:
        """identify.py:130-136: halve the cutoff for small nodes."""
        if label in (1, "o1"):
            cov_cutoff = cov_cutoff / 2
        if cov >= cov_cutoff and profile.size:
            return float(np.mean(profile))
        return 0.0

    # -------------------------------------------------------- uniq path
    def _uniq_path(self, node: int) -> List[int]:
        """Climb while the sibling is unaccessed (identify.py:139-144)."""
        path = [node]
        while True:
            parent = self.tree.parent.get(path[-1])
            if parent is None:
                return path
            sib = self.tree.sibling(path[-1])
            if sib is not None and self.data[sib].access in (1, 2):
                return path
            path.append(parent)

    def _ancestor_ab(self, node: int) -> float:
        """identify.py:147-164."""
        path = self._uniq_path(node)
        kn = {N: self.length[N] * self.cov[N] for N in path}
        valid = sum(self.length[N] for N in path)
        total = sum(kn.values())
        if valid >= self.cfg.ancestor_min_kmers and total > 0:
            return float(sum((kn[N] / total) * self.abundance[N]
                             for N in path))
        return -1.0

    # --------------------------------------------------- adjust_profile
    def _adjust_profile(self, node: int, results: List[int],
                        cov_cutoff: float,
                        overlapping_info: Dict[int, Dict[int, np.ndarray]]):
        """identify.py:167-228."""
        d_ids = self.db.node_kmers[node]  # node k-mer ids in storage order
        overlap: Dict[int, np.ndarray] = {}
        delete_pos: List[np.ndarray] = []
        for r in results:
            if r in overlapping_info and node in overlapping_info[r]:
                pos = overlapping_info[r][node]
                overlap[r] = d_ids[pos]
                delete_pos.append(d_ids[pos])
        delete = (np.unique(np.concatenate(delete_pos)) if delete_pos
                  else np.empty(0, d_ids.dtype))
        if d_ids.size - delete.size >= self.cfg.adjust_min_kmers:
            remain = np.setdiff1d(d_ids, delete, assume_unique=False)
            prof = self.counts[remain]
            prof = prof[prof > 0]
            if prof.size:
                prof = self._del_outlier(prof)
            self.length[node] = remain.size
            self.cov[node] = prof.size / remain.size if remain.size else 0.0
            self.abundance[node] = self._piecewise(
                cov_cutoff, self.cov[node], self.data[node].cat, prof)
            return 1 if remain.size < self._small_threshold else 2
        # Poisson subtraction of already-identified strains
        # (identify.py:198-228)
        temp = self.counts[d_ids].astype(np.float64)
        order = sorted(results, key=lambda r: (self.data[r].ab, r),
                       reverse=True)
        for r in order:
            if r not in overlap:
                continue
            ov_ids = overlap[r]
            # positions of overlap k-mers within d_ids (storage order)
            sorter = np.argsort(d_ids, kind="stable")
            pos_in_d = sorter[np.searchsorted(d_ids, ov_ids, sorter=sorter)]
            vals = temp[pos_in_d]
            sel = vals > 0
            pos_sel = pos_in_d[sel]
            vals_sel = vals[sel]
            sample = np.sort(self.rng.poisson(
                max(self.data[r].ab, 0.0), size=pos_sel.size))
            o2 = np.lexsort((d_ids[pos_sel], vals_sel))
            temp[pos_sel[o2]] = vals_sel[o2] - sample
        prof = temp[temp > 0]
        self.length[node] = d_ids.size
        self.cov[node] = prof.size / d_ids.size if d_ids.size else 0.0
        self.abundance[node] = self._piecewise(
            cov_cutoff, self.cov[node], self.data[node].cat, prof)
        return "o1" if d_ids.size < self._small_threshold else "o2"

    # --------------------------------------------------- res_node_proc
    def _res_node_proc(self, node: int, wa_cov_cutoff: float) -> int:
        """identify.py:375-392 — including the -1 accumulator offset when
        cov_num/tot_num have not been reset to 0."""
        path = self._uniq_path(node)
        d = self.data[node]
        for j in path:
            d.cov_num += self.length[j] * self.cov[j]
            d.tot_num += self.length[j]
        d.cov_num = int(d.cov_num)
        if d.tot_num <= 0 or d.cov_num / d.tot_num < wa_cov_cutoff:
            return 0
        ab = 0.0
        for j in path:
            if d.cov_num > 0:
                ab += self.abundance[j] * (self.cov[j] * self.length[j]
                                           / d.cov_num)
        d.ab = ab
        if d.ab <= 1:
            return 0
        return 1

    def _check_access(self, node: int) -> None:
        self.data[node].access = 1
        p = self.tree.parent.get(node)
        while p is not None:
            self.data[p].access = 1
            p = self.tree.parent.get(p)

    # ------------------------------------------------------------ search
    def run(self, cutoff) -> Dict[int, dict]:
        """identify.py:402-504.  cutoff = [cov, wa_cov, ab]."""
        cfg = self.cfg
        tree = self.tree
        db = self.db
        cov_cutoff, wa_cov_cutoff, ab_cutoff = cutoff
        leaves = list(tree.leaves())
        leaf_set = set(leaves)
        pending: List[List[int]] = [[tree.nodes_bfs()[0]]]
        results: List[int] = []
        alternative: List[int] = []
        overlapping_info: Dict[int, Dict[int, np.ndarray]] = {}
        qualified_parents: List[int] = []

        def process_group() -> List[int]:
            """One step of search() (identify.py:231-372); returns res_temp."""
            res_temp: List[int] = []
            group = pending[0]
            if len(group) == 1 and self.data[group[0]].cat != 0:
                node = group[0]
                self.data[node].access = 1
                self.length[node], prof = self._match_node(node)
                self.cov[node] = (prof.size / self.length[node]
                                  if self.length[node] else 0.0)
                self.abundance[node] = self._piecewise(
                    cov_cutoff, self.cov[node], self.data[node].cat, prof)
                if self.abundance[node] >= ab_cutoff:
                    pending.append(list(tree.children.get(node, ())))
                else:
                    del pending[0]
                    return res_temp
                if pending[1] == []:
                    res_temp.append(group[0])
                    del pending[0]
                    del pending[0]
                else:
                    del pending[0]
                return res_temp
            elif len(group) == 1 and self.data[group[0]].cat == 0:
                node = group[0]
                self.data[node].access = 1
                self.length[node] = 0
                self.cov[node] = 0.0
                self.abundance[node] = 0.0
                pending.append(list(tree.children.get(node, ())))
                del pending[0]
                return res_temp
            # both-weak-and-unaccessed special branch (identify.py:264-273;
            # near-unreachable in practice, kept for parity)
            if self.data[group[0]].cat == 0 and self.data[group[0]].access == 0:
                for node in group:
                    self.data[node].access = 2
                    self.abundance[node] = 0.0
                    self.cov[node] = 0.0
                    self.length[node] = 0
                    pending.append(list(tree.children.get(node, ())))
                del pending[0]

            correction_label = 0
            group_label: List[Tuple[int, object]] = []
            weak_label = any(self.data[n].cat == 0 for n in group)
            for node in group:
                nd = self.data[node]
                if nd.cat == 0:
                    self.abundance[node] = 0.0
                    self.cov[node] = 0.0
                    self.length[node] = 0
                    nd.access = 2
                    pending.append(list(tree.children.get(node, ())))
                    group_label.append((node, 0))
                    continue
                elif nd.cat in (1, 2) or len(results) == 0:
                    if nd.cat == "o1":
                        nd.cat = 1
                    elif nd.cat == "o2":
                        nd.cat = 2
                    group_label.append((node, nd.cat))
                    self.length[node], prof = self._match_node(node)
                    if self.length[node] == 0:
                        self.abundance[node] = 0.0
                        self.cov[node] = 0.0
                        pending.append(list(tree.children.get(node, ())))
                        group_label.append((node, 0))
                    else:
                        self.cov[node] = prof.size / self.length[node]
                        self.abundance[node] = self._piecewise(
                            cov_cutoff, self.cov[node], nd.cat, prof)
                else:
                    nd.cat = self._adjust_profile(
                        node, results, cov_cutoff, overlapping_info)
                    group_label.append((node, nd.cat))
                    if weak_label == 0:
                        correction_label = 1
                if self.abundance[node] < ab_cutoff:
                    self.abundance[node] = 0.0

            if correction_label == 1:
                parent = tree.parent[group[0]]
                ancestor_ab = self._ancestor_ab(parent)
                if ancestor_ab > ab_cutoff:
                    labels = {group_label[0][1], group_label[1][1]}
                    label = 0
                    x = y = None
                    if labels in ({"o1"}, {"o2"}):
                        label = 1
                    elif 0 in labels or labels == {"o1", "o2"}:
                        label = 2
                        for nid, lb in group_label[:2]:
                            if lb == 0 or lb == "o1":
                                x = nid
                            else:
                                y = nid
                    elif labels in ({"o1", 2}, {"o2", 2}):
                        label = 2
                        for nid, lb in group_label[:2]:
                            if lb == 2:
                                y = nid
                            else:
                                x = nid
                    if label == 1:
                        a0, b0 = group_label[0][0], group_label[1][0]
                        tot = self.abundance[a0] + self.abundance[b0]
                        if tot > 0:
                            for i in (a0, b0):
                                self.abundance[i] = (
                                    ancestor_ab * self.abundance[i] / tot)
                    elif label == 2 and x is not None and y is not None:
                        self.abundance[x] = ancestor_ab - self.abundance[y]

            # binomial descent test (identify.py:345-371)
            ab_temp = {}
            for i in range(2):
                ab_temp[group[i]] = round(self.abundance[group[i]])
                if self.cov.get(group[i], 0.0) >= cfg.qualified_cov:
                    qualified_parents.append(group[i])
            if list(ab_temp.values()) == [0, 0]:
                del pending[0]
                return res_temp
            srt = sorted(ab_temp.items(), key=lambda kv: (kv[1], kv[0]))
            (a, b, x_ab, y_ab) = (srt[1][0], srt[0][0], srt[1][1], srt[0][1])
            ret = 1 - st.binom.sf(max(x_ab, y_ab), x_ab + y_ab, cfg.binom_p)
            chosen = (a, b) if ret < cfg.binom_alpha else [a]
            for i in chosen:
                self.data[i].access = 2 if self.data[i].cat == 0 else 1
                if i not in leaf_set:
                    ch = list(tree.children.get(i, ()))
                    if ch not in pending:
                        pending.append(ch)
                else:
                    res_temp.append(i)
            del pending[0]
            return res_temp

        while pending:
            res_temp = process_group()
            for j in res_temp:
                label = self._res_node_proc(j, wa_cov_cutoff)
                alternative.append(j)
                if label == 1:
                    self._check_access(j)
                    results.append(j)
                    if j in db.overlap_info:
                        overlapping_info[j] = db.overlap_info[j]
                else:
                    self.data[j].access = 0

        # -------------------------------------------------------- output
        for n in tree.nodes():
            self.data[n].access = 0
        for i in results:
            self._check_access(i)
            self.data[i].cov_num = 0.0
            self.data[i].tot_num = 0.0
        for j in results:
            self._res_node_proc(j, wa_cov_cutoff)
        total_ab = 0.0
        if results:
            total_ab = sum(self.data[i].ab for i in results)
        elif alternative:
            cov_list = {j: (self.data[j].cov_num / self.data[j].tot_num
                            if self.data[j].tot_num else 0.0)
                        for j in alternative}
            r = max(cov_list, key=cov_list.get)
            if cov_list[r] >= cfg.alt_cov_cutoff:
                self._check_access(r)
                label = self._res_node_proc(r, cfg.alt_cov_cutoff)
                if label == 1:
                    results = [r]
                    total_ab = self.data[r].ab

        # Reference parity: identify_low_mem.py has NO qualified-parent
        # fallback (it exists only in identify.py:473-487), so skip it for
        # memory-efficient DBs.
        if not results and qualified_parents and not self.db.memory_efficient:
            qp = qualified_parents[-1]
            cov_tmp = {n: self.cov[n] for n in self.cov
                       if n in leaf_set and (tree.is_ancestor(qp, n)
                                             or qp == n)}
            if cov_tmp:
                best = max(cov_tmp, key=cov_tmp.get)
                results = [best]
                self._check_access(best)
                self.data[best].cov_num = 0.0
                self.data[best].tot_num = 0.0
                self._res_node_proc(best, wa_cov_cutoff)
                total_ab = self.data[best].ab

        res: Dict[int, dict] = {}
        for i in results:
            d = self.data[i]
            res[i] = {
                "cls_ab": d.ab,
                "cls_per": d.ab / total_ab if total_ab else 0.0,
                "cls_cov": d.cov_num / d.tot_num if d.tot_num else 0.0,
                "cls_total_num": int(d.tot_num),
                "cls_covered_num": int(d.cov_num),
                "strain": db.gcf.get(i, 0),
                "s_ab": d.ab if i in db.gcf else 0,
            }
        return res


def identify_cluster(db: TreeDB, counts: np.ndarray, cutoff,
                     cfg: IdentifyConfig = IdentifyConfig()) -> Dict[int, dict]:
    """One CST search at a cutoff triple (identify.py:402).

    Degenerate single-node tree (Build_tree.py:283-374 DBs): treat the root
    as the single result when covered.
    """
    tree = db.tree
    if not tree.children:  # single-cluster DB
        root = tree.root
        ids = db.node_kmers.get(root, np.empty(0, np.int32))
        prof = counts[ids]
        prof = prof[prof > 0]
        total = ids.size
        cfg_search = CSTSearch(db, counts, cfg)
        if prof.size:
            prof = cfg_search._del_outlier(prof)
        cov = prof.size / total if total else 0.0
        ab = float(np.mean(prof)) if prof.size and cov >= cutoff[0] else 0.0
        if ab < cutoff[2] or cov < cutoff[1]:
            return {}
        return {root: {
            "cls_ab": ab, "cls_per": 1.0, "cls_cov": cov,
            "cls_total_num": int(total), "cls_covered_num": int(prof.size),
            "strain": db.gcf.get(root, 0),
            "s_ab": ab if root in db.gcf else 0,
        }}
    return CSTSearch(db, counts, cfg).run(cutoff)


def search_ladder(db: TreeDB, counts: np.ndarray,
                  cfg: IdentifyConfig = IdentifyConfig()):
    """Cutoff-ladder retry (``identify/pipeline.py::_search_ladder``)."""
    ladder = cfg.ladder()
    l2 = 0 if cfg.low_dep == 0 else 1
    res = identify_cluster(db, counts, list(ladder[0]), cfg)
    if not res and len(ladder) > 1:
        res = identify_cluster(db, counts, list(ladder[1]), cfg)
        l2 = 1
    return res, l2
