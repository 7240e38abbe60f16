"""The clonal-complex cell: the generator's families, the metrics of the
Pre-Scan's phases, and a tiny cell of the ``identify_l2`` driver that is
judged correct, and not correct when the dominant search errs."""

import collections
import json
import os
import time

import numpy as np
import pytest

from portbench import harness, synth, synth_clonal

from conftest import CHECKOUT, PACKAGE

# the DB the port's build makes of the tiny cell's genomes (saureus-db's
# generator at families [[12, 1], [3, 1], [1, 2]])
TINY_CLONAL_DIGEST = (
    "e5c5c6d9d8a1c79c75d4ffe28a3bec4c01da6c554215f0d188a804f771e6e52e")


def _load(kind, name):
    with open(os.path.join(PACKAGE, kind, name + ".json")) as f:
        return json.load(f)


def test_the_generator_gives_the_configured_families(tmp_path):
    db = _load("configs", "saureus-db")["db"]
    names = synth_clonal.synth_clonal(str(tmp_path), db["families"], 3, 400,
                                      np.random.default_rng(db["genome_seed"]))
    sizes = synth_clonal.family_sizes(db["families"])
    assert (len(names), len(sizes)) == (1627, 202)
    assert sizes[:6] == [128, 96, 64, 48, 32, 24]
    per = collections.Counter(n.split("V")[0] for n in names)
    assert [per[f"F{f:03d}"] for f in range(len(sizes))] == sizes
    fam = np.stack([synth.genome_codes(str(tmp_path / f"{n}.fa"))
                    for n in names[:128]])
    # every variant off the family's consensus (its base) at its own 3
    # positions, which no other variant of the family uses
    base = np.array([np.bincount(c, minlength=4).argmax() for c in fam.T])
    off = fam != base
    assert (off.sum(axis=1) == 3).all()
    assert (off.sum(axis=0) <= 1).all()


def test_the_prescan_metrics_read_their_phases():
    reg = harness.Registry(os.path.join(CHECKOUT, "BENCHMARK.json"))
    pre = reg.module("metrics", "l2_prescan_s")
    dom = reg.module("metrics", "l2_dominant_s")
    recs = [{"phases": {"identify/l2_vote/prescan": 0.5,
                        "identify/l2_vote/prescan/dominant": 0.1}},
            {"phases": {"identify/l2_vote/prescan": 0.25,
                        "identify/l2_vote/prescan/dominant": 0.05}},
            {"phases": {"identify/count": 1.0}}]
    assert pre.read({"records": recs}) == 0.375
    assert dom.read({"records": recs}) == pytest.approx(0.075)
    assert pre.read({"records": recs[2:]}) is None   # a program without
    assert dom.read({"records": []}) is None         # the phases


@pytest.fixture(scope="module")
def tiny_clonal(tmp_path_factory):
    """A registry of one tiny ``identify_l2`` cell, and its DB cache."""
    root = tmp_path_factory.mktemp("clonal")
    for kind in ("configs", "traffic"):
        (root / kind).mkdir()
    cfg = _load("configs", "saureus-db")
    cfg["db"]["families"] = [[12, 1], [3, 1], [1, 2]]
    cfg["expect"]["db_digest"] = TINY_CLONAL_DIGEST
    (root / "configs" / "tiny-clonal.json").write_text(json.dumps(cfg))
    mix = _load("traffic", "identify-l2-cc")
    mix.update(distinct=2, depth=[8, 10])
    (root / "traffic" / "tiny-cc.json").write_text(json.dumps(mix))
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"] = [{"name": "tiny-cc", "config": "tiny-clonal",
                           "traffic": "tiny-cc", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny-cc"] if "identify-saureus-l2" in \
                m["workloads"] else []
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    reg = harness.Registry(str(root / "BENCHMARK.json"), [str(root)])
    return reg, str(tmp_path_factory.mktemp("cache"))


def test_a_tiny_clonal_cell_is_correct_and_its_phases_are_read(tiny_clonal,
                                                               capsys):
    reg, cache = tiny_clonal
    out = harness.execute(reg, "tiny-cc", 2**31 + 5, 0.5, True, ["cpu"],
                          time.perf_counter(), cache)
    assert out["correct"], out["checks"]
    for name in ("l2_prescan_s", "l2_dominant_s", "union_count_s",
                 "l2_vote_s"):
        assert out["metrics"][name]["value"] > 0, name
    err = capsys.readouterr().err
    line = [x for x in err.splitlines() if "L2STATS over the window" in x]
    stats = json.loads(line[0].split(": ", 1)[1])
    # the warm-up loaded the cluster: no upload nor check in the window
    assert stats["clusters"] == stats["samples"] >= 1
    assert stats["uploads"] == stats["checks"] == 0
    assert stats["shapes"][0][1] == 12


def test_a_wrong_dominant_strain_is_not_correct(tiny_clonal, monkeypatch):
    from strainscan_tpu_torch.identify import prescan

    reg, cache = tiny_clonal
    real = prescan._optimize_dominant
    monkeypatch.setattr(prescan, "_optimize_dominant",
                        lambda X, y: (real(X, y) + 1) % X.shape[1])
    out = harness.execute(reg, "tiny-cc", 2**31 + 5, 0.5, False, ["cpu"],
                          time.perf_counter(), cache)
    assert not out["correct"], out["checks"]
