"""CPU tests of the benchmark (run: ``python3 -m pytest portbench/tests``;
on a card, ``-m cuda`` runs the card-only ones)."""

import json
import os
import sys

import pytest

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)

PACKAGE = os.path.join(CHECKOUT, "portbench")
# the DB that the port's build makes of the fixture's genomes at 4 families
# (``strainscan_tpu_torch/bench/scale_fixture.py --families 4`` prints it)
TINY_DB_DIGEST = (
    "ae78379550c20822fab24cf5db5ba7c17b13fbbeb1f42672e060b09689b7305d")


def _load(kind, name):
    with open(os.path.join(PACKAGE, kind, name + ".json")) as f:
        return json.load(f)


def write_tiny(root: str) -> str:
    """A throwaway benchmark of tiny cells under ``root``: the shipped
    configurations and mixes shrunk, in files of their own; returns the
    path of its ``BENCHMARK.json``."""
    for kind in ("configs", "traffic"):
        os.makedirs(os.path.join(root, kind), exist_ok=True)

    def put(kind, name, obj):
        with open(os.path.join(root, kind, name + ".json"), "w") as f:
            json.dump(obj, f)

    table = _load("configs", "ecoli-table")
    table.update(genome_len=20000, shard_min_kmers=1)
    put("configs", "tiny-table", table)
    db = _load("configs", "ecoli-db")
    db["db"]["families"] = 4
    db["expect"]["db_digest"] = TINY_DB_DIGEST
    put("configs", "tiny-db", db)
    count = _load("traffic", "count")
    count["reads"] = 3000
    put("traffic", "tiny-count", count)
    deep = _load("traffic", "identify-deep")
    deep["reads"] = 20000
    put("traffic", "tiny-deep", deep)
    small = _load("traffic", "identify-small")
    small["distinct"] = 3
    put("traffic", "tiny-small", small)
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    rename = {"count-ecoli": "tiny-count", "identify-ecoli-deep": "tiny-deep",
              "identify-ecoli-small": "tiny-small"}
    bench["workloads"] = [
        {"name": "tiny-count", "config": "tiny-table",
         "traffic": "tiny-count", "chips": 1, "why": "test"},
        {"name": "tiny-count-2x2", "config": "tiny-table",
         "traffic": "tiny-count", "chips": 4, "why": "test"},
        {"name": "tiny-deep", "config": "tiny-db", "traffic": "tiny-deep",
         "chips": 1, "why": "test"},
        {"name": "tiny-small", "config": "tiny-db", "traffic": "tiny-small",
         "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]
                              if w in rename]
            if "tiny-count" in m["workloads"]:
                m["workloads"].append("tiny-count-2x2")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return path


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """``(registry, cache dir)`` of the tiny benchmark; the DB cache is
    shared by the session's tests."""
    from portbench import harness

    root = str(tmp_path_factory.mktemp("tiny"))
    reg = harness.Registry(write_tiny(root), [root])
    return reg, str(tmp_path_factory.mktemp("cache"))


@pytest.fixture
def card():
    """Skips a card-only test on a host without a CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
