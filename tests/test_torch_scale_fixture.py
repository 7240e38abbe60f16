"""The port's E. coli-scale fixture and parity run (``bench.scale_fixture``,
``bench.scale_parity``) against the JAX package's (``benchmarks/scale.py``,
``benchmarks/scale_fixture.py``), at 4 families on the CPU.

* The port's copies of ``synth`` and ``sim_reads`` write the same FASTA and
  FASTQ bytes as the JAX originals.
* The port's fixture and the JAX fixture, both at ``--families 4`` (8
  genomes of 100 kb), hold the same genomes, the same three shared samples,
  DBs with the same sha256 per file and the same reference-layout export.
* ``scale_parity ours --device cpu`` writes single/crossmix/intramix
  reports byte-identical to the JAX ``run_identify`` on the JAX fixture.
* ``scale_parity diff`` passes on equal trees and fails on a changed field,
  an Enet field off by 1e-12 included.

Tolerance: none; every output compared here is bytes.
"""

import importlib.util
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest

from strainscan_tpu.config import IdentifyConfig as JIdentifyConfig
from strainscan_tpu.identify.pipeline import run_identify as run_identify_jax
from strainscan_tpu_torch.bench import scale_fixture, scale_parity

from _torch_sim import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED = ("single", "crossmix", "intramix")


def jax_script(name):
    """A script of ``benchmarks/`` loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "benchmarks", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def files_of(top):
    """{relative path: bytes} of every file under ``top``."""
    out = {}
    for root, _, names in os.walk(top):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, top)] = f.read()
    return out


def test_synth_writes_the_jax_genomes(tmp_path):
    got, want = tmp_path / "port", tmp_path / "jax"
    got.mkdir()
    want.mkdir()
    names = scale_fixture.synth(str(got), 3, 3, 5_000,
                                np.random.default_rng(5))
    jnames, _ = jax_script("scale").synth(str(want), 3, 3, 5_000,
                                          np.random.default_rng(5))
    assert names == jnames == ["F000V0", "F000V1", "F000V2", "F001V0",
                               "F002V0", "F002V1", "F002V2"]
    assert files_of(got) == files_of(want)


@pytest.mark.parametrize("seed", [17, 19])
def test_sim_reads_writes_the_jax_reads(tmp_path, seed):
    jscale = jax_script("scale")
    seq = "".join(np.random.default_rng(3).choice(list("ACGT"), 5_000))
    outs = []
    for sim in (scale_fixture.sim_reads, jscale.sim_reads):
        rng, out = np.random.default_rng(seed), io.StringIO()
        n = sim(seq, 10.0, 100, rng, out)
        n += sim(seq[::-1], 4.0, 100, rng, out, n)
        outs.append((n, out.getvalue()))
    assert outs[0] == outs[1]
    assert outs[0][0] == 700 and outs[0][1].count("\n@r") == 699


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """The JAX fixture and the port's, both at 4 families."""
    d = tmp_path_factory.mktemp("scale")
    jax_root, port_root = str(d / "jax"), str(d / "port")
    jfix = jax_script("scale_fixture")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfix, "SCALE_DIR", jax_root)
        mp.setattr(sys, "argv", ["scale_fixture.py", "--families", "4"])
        jfix.main()
    meta = scale_fixture.build_fixture(port_root, families=4,
                                       deep_scale=0.001)
    return jax_root, port_root, meta


def test_fixture_is_the_jax_fixture(fixtures):
    jax_root, port_root, meta = fixtures
    assert len(meta["strains"]) == 8
    for sub in ("genomes", "REFDB"):
        assert files_of(os.path.join(port_root, sub)) == \
            files_of(os.path.join(jax_root, sub)), sub
    assert meta["db_sha256"] == scale_fixture.tree_sha256(
        os.path.join(jax_root, "DB"))
    assert {"manifest.json", "tree/fptable.npz"} <= set(meta["db_sha256"])
    for name in SHARED:
        with open(os.path.join(jax_root, "samples", name + ".fq"),
                  "rb") as f:
            want = f.read()
        with open(os.path.join(port_root, "samples", name + ".fq"),
                  "rb") as f:
            assert f.read() == want, name
    assert list(meta["samples"]) == [*SHARED, "deep"]
    assert meta["samples"]["deep"]["truth"] == ["F000V0", "F001V0"]
    assert meta["samples"]["deep"]["reads"] == 720 + 480
    # a rerun makes nothing again
    assert scale_fixture.build_fixture(port_root, families=4,
                                       deep_scale=0.001) == meta


@pytest.fixture(scope="module")
def ours_cpu(fixtures):
    _, port_root, _ = fixtures
    assert scale_parity.run_ours(port_root, "cpu") == 0
    return os.path.join(port_root, "parity", "ours_cpu")


def test_ours_cpu_reports_equal_jax(fixtures, ours_cpu, tmp_path):
    jax_root, port_root, meta = fixtures
    got = scale_parity.report_groups(ours_cpu)
    assert sorted(got) == sorted(
        [f"{p}/{s}" for p in ("cold", "warm", "batch") for s in meta[
            "samples"]] + [f"process/{SHARED[0]}"])
    for name in SHARED:
        out = str(tmp_path / name)
        run_identify_jax(os.path.join(jax_root, "samples", name + ".fq"),
                         "", os.path.join(jax_root, "DB"), out,
                         JIdentifyConfig())
        (want,) = scale_parity.report_groups(out).values()
        for pass_ in ("cold", "warm", "batch"):
            assert got[f"{pass_}/{name}"] == want, (pass_, name)
    assert any(f.endswith("StrainVote.report") for f in got["cold/intramix"])


def _edit(report, field, fn):
    """Rewrite the first row's ``field`` of a tab-separated report."""
    with open(report) as f:
        lines = f.read().splitlines()
    header, row = lines[0].split("\t"), lines[1].split("\t")
    i = header.index(field)
    new = fn(row[i])
    assert new != row[i]
    row[i] = new
    lines[1] = "\t".join(row)
    with open(report, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("case", ["equal", "non_enet", "enet_1e-12"])
def test_diff(fixtures, ours_cpu, case):
    _, port_root, _ = fixtures
    other = os.path.join(port_root, "parity", "case_" + case)
    shutil.rmtree(other, ignore_errors=True)
    shutil.copytree(ours_cpu, other)
    report = os.path.join(other, "cold", "intramix", "final_report.txt")
    if case == "non_enet":
        _edit(report, "Coverage", lambda v: repr(float(v) + 0.5))
    elif case == "enet_1e-12":
        _edit(report, "Predicted_Depth (Enet)",
              lambda v: repr(float(v) * (1 + 1e-12)))
    rc = scale_parity.run_diff(ours_cpu, other, port_root)
    out = os.path.join(port_root, "parity", f"diff_ours_cpu_case_{case}.json")
    with open(out) as f:
        res = json.load(f)
    if case == "equal":
        assert rc == 0 and res["parity"]
        assert all(d["byte_identical"] and d["truth_found"]
                   for d in res["samples"].values())
        assert res["samples"]["cold/intramix"]["l2_vote"]
        return
    assert rc == 1 and not res["parity"]
    d = res["samples"]["cold/intramix"]
    assert not d["byte_identical"]
    why = d["differs"]["final_report.txt"]
    if case == "non_enet":
        assert why["error"].startswith("non-Enet field Coverage")
    else:
        assert why["enet_within_rtol"] and 0 < why["enet_rel_err"] < 1e-11
    assert all(v["byte_identical"] for g, v in res["samples"].items()
               if g != "cold/intramix")


def test_trace_summary_shares_and_gaps():
    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    events = [x("identify/count", "user_annotation", 0, 1000),
              x("identify/l2_vote", "user_annotation", 1000, 2000),
              x("probe", "kernel", 100, 200),
              x("Memcpy DtoH", "gpu_memcpy", 250, 150),
              x("probe", "kernel", 1500, 100),
              x("aten::add", "cpu_op", 0, 3000)]
    s = scale_parity.trace_summary(events)
    count, vote = s["phases"]["identify/count"], s["phases"]["identify/l2_vote"]
    assert count["device_busy_ms"] == pytest.approx(0.3)
    assert count["device_busy_share"] == pytest.approx(0.3)
    assert vote["device_busy_share"] == pytest.approx(0.05)
    assert [(o["name"], o["calls"]) for o in s["top_device_ops"]] == \
        [("probe", 2), ("Memcpy DtoH", 1)]
    assert s["device_ms"] == pytest.approx(0.45)
    assert s["idle_gaps"][0] == {"ms": 1.4, "phase": "identify/l2_vote",
                                 "at_ms": 0.6}
    assert [g["ms"] for g in s["idle_gaps"][1:4]] == \
        pytest.approx([0.6, 0.5, 0.1])
