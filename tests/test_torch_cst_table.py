"""The CST search's node table against the dense node profile.

``identify.cst_search.NodeTable`` serves each node's total, kept positives
and their mean from one sparse pass over a sample's counts; the dense
profile (``counts[ids]`` -> positives -> drop ``>= 100 x median`` ->
``np.mean``) is computed here with the original formulas, and the two
must agree bit for bit on every node of the fixture DB, on a hand-built DB
whose keys repeat across and within nodes, and through whole searches
(which are also held against the JAX package's dense search).
"""

import numpy as np
import pytest

from strainscan_tpu.config import IdentifyConfig as JIdentifyConfig
from strainscan_tpu.identify import cst_search as jcst
from strainscan_tpu_torch.build import db as tdb
from strainscan_tpu_torch.config import IdentifyConfig
from strainscan_tpu_torch.identify import cst_search as tcst
from strainscan_tpu_torch.identify import pipeline
from strainscan_tpu_torch.utils.trees import BinTree

from _torch_sim import e2e_fixture

CFG = IdentifyConfig()


def dense_profile(counts, ids, factor=CFG.outlier_factor):
    """(k-mers, kept positives, mean) as the dense search computed them."""
    prof = counts[ids]
    prof = prof[prof > 0]
    if prof.size:
        prof = prof[prof < factor * np.median(prof)]
    return ids.size, prof.size, (float(np.mean(prof)) if prof.size
                                 else 0.0)


class DenseTable:
    """A stand-in for ``NodeTable`` that gathers each profile densely."""

    def __init__(self, db, counts, factor=CFG.outlier_factor):
        self.db, self.counts, self.factor = db, counts, factor

    def profile(self, node):
        ids = self.db.node_kmers.get(node, np.empty(0, np.int32))
        return dense_profile(self.counts, ids, self.factor)


def assert_same_bits(got, want):
    assert [type(x) for x in got] == [int, int, float]
    assert got[:2] == want[:2]
    assert np.float64(got[2]).tobytes() == np.float64(want[2]).tobytes()


@pytest.fixture(scope="module")
def tree_db(tmp_path_factory):
    db_dir, _ = e2e_fixture(tmp_path_factory.mktemp("cst_table"))
    return tdb.load_tree_db(db_dir)


def heavy_tails(db, rng):
    """Per node a few small positives, then 100 x median and one under it
    on top (the median counts them: they are the two largest), with odd and
    even numbers of positives in turn."""
    counts = np.zeros(db.all_kmers.size, np.int32)
    for i, node in enumerate(sorted(db.node_kmers)):
        ids = db.node_kmers[node]
        k = min(ids.size, 7 + i % 2 + 2 * (i % 5))
        if k < 4:
            continue
        at = rng.choice(ids, size=k, replace=False)
        base = rng.integers(1, 6, size=k - 2)
        med = np.median(np.concatenate([base, [10 ** 6, 10 ** 6]]))
        counts[at] = np.concatenate(
            [base, [int(100 * med), int(100 * med) - 1]])
    return counts


def count_vector(kind, db, seed):
    rng = np.random.default_rng(seed)
    n = db.all_kmers.size
    if kind == "zeros":
        return np.zeros(n, np.int32)
    if kind == "tails":
        return heavy_tails(db, rng)
    counts = rng.poisson({"sparse": 0.05, "deep": 40}[kind],
                         size=n).astype(np.int32)
    counts[rng.random(n) < 0.3] = 0
    return counts


@pytest.mark.parametrize("kind", ["zeros", "sparse", "deep", "tails"])
@pytest.mark.parametrize("seed", [0, 1])
def test_table_equals_dense_profile_on_every_node(tree_db, kind, seed):
    counts = count_vector(kind, tree_db, seed)
    table = tcst.node_table(tree_db, counts, CFG)
    parity = set()
    for node in tree_db.tree.nodes():
        ids = tree_db.node_kmers.get(node, np.empty(0, np.int32))
        want = dense_profile(counts, ids)
        assert_same_bits(table.profile(node), want)
        prof = counts[ids][counts[ids] > 0]
        parity.add(prof.size % 2 if prof.size else None)
    if kind == "tails":   # both parities, and counts at the cutoff itself
        assert {0, 1} <= parity
        cut = [node for node in tree_db.node_kmers
               if dense_profile(counts, tree_db.node_kmers[node])[1]
               + 1 == (counts[tree_db.node_kmers[node]] > 0).sum()]
        assert cut


def hand_db(n_keys=4000):
    """Root 0 -> (1, 2), 1 -> (3, 4), 2 -> (5, 6); keys 250-269 belong to
    nodes 1, 3 and 5, keys 300-309 are listed twice in node 4, and keys
    3800-3849 and 3900-3999 belong to no node."""
    tree = BinTree.from_relationship(0, {0: (1, 2), 1: (3, 4), 2: (5, 6)})
    ranges = {0: (0, 200), 1: (200, 400), 2: (400, 600), 3: (600, 1400),
              4: (1400, 2200), 5: (2200, 3000)}
    shared = np.arange(250, 270)
    node_kmers = {n: np.arange(a, b, dtype=np.int32)
                  for n, (a, b) in ranges.items()}
    for n in (3, 5):
        node_kmers[n] = np.concatenate([node_kmers[n], shared]).astype(
            np.int32)
    node_kmers[6] = np.r_[3000:3800, 3850:3900].astype(np.int32)
    node_kmers[4] = np.concatenate(
        [node_kmers[4], np.arange(300, 310)]).astype(np.int32)
    return tdb.TreeDB(
        tree=tree, gcf={3: "S3", 4: "S4", 5: "S5", 6: "S6"},
        node_length={n: int(v.size) for n, v in node_kmers.items()},
        reconstructed=[], recls={}, all_kmers=np.arange(n_keys),
        node_kmers=node_kmers, overlap_info={}, table=None, k=31,
        memory_efficient=False)


HAND_CFG = dict(node_weak=100, node_small=300, ancestor_min_kmers=100)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keys_in_several_nodes(seed):
    db = hand_db()
    cfg, jcfg = IdentifyConfig(**HAND_CFG), JIdentifyConfig(**HAND_CFG)
    idx = tcst.key_index(db)
    assert idx.n_keys == 3900 and (idx.node_of[3800:3850] == -1).all()
    assert (idx.node_of[250:270] == -2).all()
    assert (idx.node_of[300:310] == -2).all() and idx.node_of[310] >= 0
    rng = np.random.default_rng(seed)
    counts = np.zeros(4000, np.int32)
    for n, depth in ((0, 9), (1, 6), (2, 4), (3, 6 + seed),
                     (5, 3 + 2 * seed)):
        ids = db.node_kmers[n]
        counts[ids] = rng.poisson(depth, size=ids.size)
    counts[250:270] = rng.integers(1, 40, size=20)
    counts[300:310] = rng.integers(1, 9, size=10)
    counts[3800:3850] = counts[3900:] = 7
    table = tcst.node_table(db, counts, cfg)
    for node in db.tree.nodes():
        assert_same_bits(table.profile(node),
                         dense_profile(counts, db.node_kmers[node]))
    for cutoff in list(cfg.ladder()) + [cfg.cutoff_ldep2]:
        got = tcst.identify_cluster(db, counts, list(cutoff), cfg, table)
        assert got
        assert got == tcst.identify_cluster(
            db, counts, list(cutoff), cfg, DenseTable(db, counts))
        assert got == jcst.identify_cluster(db, counts, list(cutoff), jcfg)


def test_ladder_builds_one_table_for_both_rungs(tree_db, monkeypatch):
    calls = []
    match = tcst.CSTSearch._match_node

    def counted(self, node):
        calls.append(node)
        return match(self, node)

    monkeypatch.setattr(tcst.CSTSearch, "_match_node", counted)
    counts = count_vector("sparse", tree_db, 5)
    tcst.reset_profiles()
    res, l2 = pipeline._search_ladder(tree_db, counts, CFG)
    assert l2 == 1           # the first rung found nothing
    assert tcst.PROFILES["tables"] == 1
    assert tcst.PROFILES["table"] == len(calls) > 0
    want = jcst.identify_cluster(tree_db, counts, list(CFG.ladder()[1]),
                                 JIdentifyConfig())
    assert res == want


def test_single_node_tree_gathers_densely():
    db = hand_db()
    db.tree = BinTree.from_relationship(0, {})
    counts = np.random.default_rng(3).poisson(5, size=4000).astype(np.int32)
    tcst.reset_profiles()
    assert tcst.node_table(db, counts, CFG) is None
    got = tcst.identify_cluster(db, counts, [0.1, 0.4, 1.0], CFG)
    assert tcst.PROFILES == {"table": 0, "dense": 1, "tables": 0}
    assert got == jcst.identify_cluster(db, counts, [0.1, 0.4, 1.0],
                                        JIdentifyConfig())


def test_table_refuses_float_counts(tree_db):
    with pytest.raises(TypeError):
        tcst.node_table(tree_db, np.ones(tree_db.all_kmers.size), CFG)
