"""Cluster Search Tree search — Layer-1 identification.

Statement-faithful port of the reference search (library/identify.py:
231-504 and the memory-efficient thresholds of identify_low_mem.py:50-64)
over dense count arrays instead of k-mer string dicts:

* node categories by k-mer count — weak(0) / small(1) / large(2),
  reconstructed -> 'o1'/'o2' (identify.py:45-70);
* per-node coverage + outlier-trimmed mean depth (match_node / del_outlier,
  identify.py:106-127), with jellyfish-dump semantics where every DB k-mer
  is "valid" (the dump emits 0-count entries for --if k-mers — verified
  against the bundled binary);
* piecewise halving of the coverage cutoff for small nodes
  (identify.py:130-136);
* overlap-aware profile adjustment for reconstructed nodes including the
  Poisson subtraction of already-identified strains
  (adjust_profile, identify.py:167-228) — the reference uses the global
  unseeded NumPy RNG here; we use a seeded Generator so runs are
  reproducible;
* sibling abundance correction via ancestor abundance
  (get_ancestor_ab, identify.py:147-164, applied :316-343);
* binomial descent test p(max | x+y, 0.995) < 0.05 keeps both children,
  otherwise the best child (identify.py:345-371);
* leaf acceptance via weighted-average coverage along the unique path
  (res_node_proc, identify.py:375-392) — including the reference's -1
  initial offset of covered/total accumulators, reproduced for parity;
* fallbacks: best-coverage alternative (identify.py:459-470; the reference
  re-evaluates a stale loop variable there — we evaluate the chosen
  candidate, the evident intent) and qualified-parent best leaf
  (identify.py:473-487) — the latter only for standard DBs, because
  identify_low_mem.py has no qualified-parent fallback.

Node profiles come from one sparse table per sample (:class:`NodeTable`),
built from the count vector's positive entries and a key -> node index
(:class:`KeyIndex`, once per loaded DB, cached on the ``TreeDB``).  Per
node it holds the positives' median, the survivors under
``outlier_factor`` x that median and their int64 sum, so ``_match_node``
reads a node's total, covered count and culled mean bit-equal to the
dense gather ``counts[ids]`` -> positives -> del_outlier ->
``np.mean``: a median of integers is exact in float64, and so is a sum of
integers below 2**53 in any order.  The ladder's two rungs share one
table (``identify/pipeline.py::_search_ladder``).  Still gathered densely,
because their profile depends on results the table cannot know or the
tree has no nodes to search: ``_adjust_profile`` (the remain and Poisson
branches) and the single-node tree of :func:`identify_cluster`.
``PROFILES`` counts the profiles served by a table, those gathered
densely and the tables built (:func:`reset_profiles`).

The table's build and the node lookups (``_match_node``, ``_piecewise``)
add up in the phase ``identify/cst_search/match``: the build once per
table, the lookups through ``CSTSearch.match_ns`` once per search.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.stats as st
import torch

from strainscan_tpu_torch.build.db import TreeDB
from strainscan_tpu_torch.config import IdentifyConfig
from strainscan_tpu_torch.timing import add_seconds

MATCH = "identify/cst_search/match"

# node profiles served by a NodeTable, gathered densely, and tables built;
# callers reset it with reset_profiles
PROFILES = {"table": 0, "dense": 0, "tables": 0}


def reset_profiles() -> None:
    for name in PROFILES:
        PROFILES[name] = 0


def _stats(profile: np.ndarray) -> Tuple[int, float]:
    """(size, mean) of a densely gathered profile (mean 0.0 when empty)."""
    return profile.size, float(np.mean(profile)) if profile.size else 0.0


def _dense_profile(counts: np.ndarray, ids: np.ndarray,
                   factor: float) -> np.ndarray:
    """The positive counts of ``ids``, gathered from the whole vector, less
    those >= factor x their median (del_outlier, identify.py:106-112)."""
    PROFILES["dense"] += 1
    prof = counts[ids]
    prof = prof[prof > 0]
    return prof[prof < factor * np.median(prof)] if prof.size else prof


class KeyIndex:
    """Key id -> node of a loaded DB, from ``node_kmers``.

    ``node_of[id]`` is the position of the key's node among the sorted
    node ids (``pos`` maps a node to it, ``length`` gives its k-mers); -1
    for a key of no node and -2 for a key listed more than once (in
    several nodes, or twice in one), whose positions are
    ``multi_nodes[multi_ptr[j]:multi_ptr[j + 1]]`` for
    ``multi_keys[j] == id``.  int16 while the nodes allow it: 57 MB at
    28.6 M keys."""

    def __init__(self, db: TreeDB):
        nodes = sorted(db.node_kmers)
        self.pos = {n: i for i, n in enumerate(nodes)}
        self.length = [int(db.node_kmers[n].size) for n in nodes]
        ids = (np.concatenate([db.node_kmers[n] for n in nodes]) if nodes
               else np.empty(0, np.int64))
        dt = np.int16 if len(nodes) < np.iinfo(np.int16).max else np.int32
        self.n_keys = int(ids.max()) + 1 if ids.size else 0
        owner = np.repeat(np.arange(len(nodes), dtype=dt), self.length)
        self.node_of = np.full(self.n_keys, -1, dt)
        # torch's scatter runs on every core, in about a tenth of NumPy's
        # time at 28.6 M keys; a key listed more than once keeps any one
        # of its listings here
        torch.from_numpy(self.node_of)[torch.from_numpy(ids).long()] = \
            torch.from_numpy(owner)
        self.multi_keys = np.empty(0, np.int64)
        self.multi_nodes = np.empty(0, dt)
        self.multi_ptr = np.zeros(1, np.int64)
        if np.count_nonzero(self.node_of >= 0) < ids.size:  # a key repeats
            self.multi_keys = np.flatnonzero(
                np.bincount(ids, minlength=self.n_keys) > 1)
            self.node_of[self.multi_keys] = -2
            sel = self.node_of[ids] == -2
            mk, mo = ids[sel], owner[sel]
            order = np.argsort(mk, kind="stable")
            self.multi_nodes = mo[order]
            self.multi_ptr = np.searchsorted(
                mk[order], np.append(self.multi_keys, self.n_keys))


def key_index(db: TreeDB) -> KeyIndex:
    """The DB's :class:`KeyIndex`, built at the first call and kept on
    the (read-only) ``TreeDB``, which ``build.db._TREE_CACHE`` keeps
    between the samples of a ``batch-identify``."""
    idx = getattr(db, "_cst_key_index", None)
    if idx is None:
        idx = KeyIndex(db)
        object.__setattr__(db, "_cst_key_index", idx)
    return idx


class NodeTable:
    """One sample's node statistics, from its positive counts.

    Per node position of the :class:`KeyIndex`: ``n_kept``, the
    positives under ``factor`` x their median, and ``sum_kept``, their
    sum; both 0 for a node without positives."""

    def __init__(self, idx: KeyIndex, counts: np.ndarray, factor: float):
        if counts.dtype.kind not in "iu":
            raise TypeError(f"counts must be integers, not {counts.dtype}")
        self.idx = idx
        c = counts[:idx.n_keys]
        # torch's scan runs on every core: about half NumPy's flatnonzero
        keys = torch.from_numpy(c).gt(0).nonzero().squeeze(1).numpy()
        vals = c[keys].astype(np.int64)
        node = idx.node_of[keys]
        one = node >= 0
        nodes, v = [node[one].astype(np.int64)], [vals[one]]
        many = np.flatnonzero(node == -2)
        if many.size:   # one pair per listing of the key
            j = np.searchsorted(idx.multi_keys, keys[many])
            lo, n = idx.multi_ptr[j], np.diff(idx.multi_ptr)[j]
            first = np.repeat(np.cumsum(n) - n, n)
            at = np.repeat(lo, n) + np.arange(first.size) - first
            nodes.append(idx.multi_nodes[at].astype(np.int64))
            v.append(np.repeat(vals[many], n))
        nodes, v = np.concatenate(nodes), np.concatenate(v)
        n_kept = np.zeros(len(idx.length), np.int64)
        sum_kept = np.zeros(len(idx.length), np.int64)
        if v.size:
            # (node, count) pairs sorted by node, then count
            span = int(v.max()) + 1
            pair = nodes * span + v
            pair.sort()
            node_s = pair // span
            v = pair - node_s * span
            start = np.flatnonzero(np.diff(node_s, prepend=-1))
            n_pos = np.diff(np.append(start, v.size))
            median = (v[start + (n_pos - 1) // 2].astype(np.float64)
                      + v[start + n_pos // 2].astype(np.float64)) / 2
            keep = v < np.repeat(factor * median, n_pos)
            at = node_s[start]
            n_kept[at] = np.add.reduceat(keep.astype(np.int64), start)
            sum_kept[at] = np.add.reduceat(np.where(keep, v, 0), start)
        self.n_kept = n_kept.tolist()
        self.sum_kept = sum_kept.tolist()

    def profile(self, node: int) -> Tuple[int, int, float]:
        """(k-mers, kept positives, their mean) of ``node``: the dense
        path's ``ids.size``, ``prof.size`` and ``float(np.mean(prof))``
        (0.0 when nothing is kept)."""
        PROFILES["table"] += 1
        p = self.idx.pos.get(node)
        if p is None:
            return 0, 0, 0.0
        n = self.n_kept[p]
        return (self.idx.length[p], n,
                float(self.sum_kept[p]) / n if n else 0.0)


def node_table(db: TreeDB, counts: np.ndarray,
               cfg: IdentifyConfig = IdentifyConfig()) -> Optional[NodeTable]:
    """The sample's :class:`NodeTable` for searches of ``db`` (None for a
    single-node tree, whose search gathers densely).  Its build adds to
    the phase ``identify/cst_search/match``; the DB's index does not."""
    if not db.tree.children:
        return None
    idx = key_index(db)
    t0 = time.perf_counter_ns()
    table = NodeTable(idx, counts, cfg.outlier_factor)
    add_seconds(MATCH, (time.perf_counter_ns() - t0) / 1e9)
    PROFILES["tables"] += 1
    return table


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
                 seed: int = 0, table: Optional[NodeTable] = None):
        self.db = db
        self.tree = db.tree
        self.counts = counts
        self.cfg = cfg
        self.table = (table if table is not None
                      else node_table(db, counts, cfg))
        self.rng = np.random.default_rng(seed)
        self.data: Dict[int, _NodeData] = {}
        self.length: Dict[int, float] = {}
        self.cov: Dict[int, float] = {}
        self.abundance: Dict[int, float] = {}
        # ns spent in _match_node and _piecewise (a phase_acc per call
        # would cost more than their work on a small node)
        self.match_ns = 0
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
    def _match_node(self, node: int) -> Tuple[int, int, float]:
        """(k-mers, kept positives, their mean) of ``node`` from the
        sample's table (match_node / del_outlier, identify.py:106-127)."""
        t0 = time.perf_counter_ns()
        stats = self.table.profile(node)
        self.match_ns += time.perf_counter_ns() - t0
        return stats

    def _piecewise(self, cov_cutoff: float, cov: float, label,
                   n: int, mean: float) -> float:
        """identify.py:130-136: halve the cutoff for small nodes; ``n``
        positives kept, ``mean`` their mean."""
        t0 = time.perf_counter_ns()
        if label in (1, "o1"):
            cov_cutoff = cov_cutoff / 2
        ab = mean if cov >= cov_cutoff and n else 0.0
        self.match_ns += time.perf_counter_ns() - t0
        return ab

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
            prof = _dense_profile(self.counts, remain, self.cfg.outlier_factor)
            self.length[node] = remain.size
            self.cov[node] = prof.size / remain.size if remain.size else 0.0
            self.abundance[node] = self._piecewise(
                cov_cutoff, self.cov[node], self.data[node].cat, *_stats(prof))
            return 1 if remain.size < self._small_threshold else 2
        # Poisson subtraction of already-identified strains
        # (identify.py:198-228)
        PROFILES["dense"] += 1
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
            cov_cutoff, self.cov[node], self.data[node].cat, *_stats(prof))
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
                self.length[node], n, mean = self._match_node(node)
                self.cov[node] = (n / self.length[node]
                                  if self.length[node] else 0.0)
                self.abundance[node] = self._piecewise(
                    cov_cutoff, self.cov[node], self.data[node].cat, n, mean)
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
                    self.length[node], n, mean = self._match_node(node)
                    if self.length[node] == 0:
                        self.abundance[node] = 0.0
                        self.cov[node] = 0.0
                        pending.append(list(tree.children.get(node, ())))
                        group_label.append((node, 0))
                    else:
                        self.cov[node] = n / self.length[node]
                        self.abundance[node] = self._piecewise(
                            cov_cutoff, self.cov[node], nd.cat, n, mean)
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
                     cfg: IdentifyConfig = IdentifyConfig(),
                     table: Optional[NodeTable] = None) -> Dict[int, dict]:
    """One CST search at a cutoff triple (identify.py:402), its node
    profiles from ``table`` (the sample's :func:`node_table`, built here
    when None).

    Degenerate single-node tree (Build_tree.py:283-374 DBs): treat the root
    as the single result when covered.
    """
    tree = db.tree
    if not tree.children:  # single-cluster DB
        root = tree.root
        ids = db.node_kmers.get(root, np.empty(0, np.int32))
        prof = _dense_profile(counts, ids, cfg.outlier_factor)
        total = ids.size
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
    search = CSTSearch(db, counts, cfg, table=table)
    res = search.run(cutoff)
    add_seconds(MATCH, search.match_ns / 1e9)
    return res
