"""The port's opt-in ``torch.profiler`` trace (``STRAINSCAN_TRACE_DIR``).

* A traced ``build`` writes one trace per build phase (the nested
  ``tree_build/hierarchy`` only times), through the CLI in a process that
  can import neither jax nor the JAX package, and through the library; the
  DB equals an untraced build's.
* A traced CPU ``identify`` writes one trace per phase, and its reports are
  byte-identical to an untraced run; so does a traced plasmid-mode
  ``identify`` (whose run builds a DB, traced per build phase too) in a
  process that can import neither.
* A phase inside a traced phase only times; a failing export raises.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from strainscan_tpu_torch import timing
from strainscan_tpu_torch.build.pipeline import build_database
from strainscan_tpu_torch.config import IdentifyConfig
from strainscan_tpu_torch.identify.pipeline import run_identify

from _torch_sim import (assert_reports_identical, e2e_fixture,  # noqa: F401
                        one_torch_thread, report_tree)
from test_torch_no_jax import BLOCK_JAX, ROOT

IDENTIFY_PHASES = ["identify/count", "identify/cst_search",
                   "identify/l2_vote", "identify/load_db"]
BUILD_PHASES = ["clustering", "distance_matrix", "l2_matrices",
                "overlap_matrices", "tree_build"]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_trace")
    return (d, *e2e_fixture(d))


def _traces(trace_dir):
    """Phase names of the trace files under ``trace_dir``, each checked to
    be a Chrome trace with events."""
    names = []
    for root, _, files in os.walk(trace_dir):
        for f in files:
            assert f.endswith(".pt.trace.json"), f
            with open(os.path.join(root, f)) as fh:
                assert json.load(fh)["traceEvents"]
            names.append(os.path.relpath(os.path.join(root, f), trace_dir)
                         [:-len(".pt.trace.json")])
    return sorted(names)


def test_cli_build_traced_without_jax(fixture, tmp_path):
    d, db_dir, _ = fixture
    out, trace_dir = tmp_path / "DB", tmp_path / "trace"
    code = textwrap.dedent(f"""
        from strainscan_tpu_torch import cli
        assert cli.main(["build", "-i", {str(d / "genomes")!r},
                         "-o", {str(out)!r}]) == 0
        assert not any(_blocked(m) for m in sys.modules), "blocked import"
        import os
        assert os.environ["STRAINSCAN_TRACE_DIR"] == {str(trace_dir)!r}
    """)
    env = dict(os.environ, PYTHONPATH=ROOT,
               STRAINSCAN_TRACE_DIR=str(trace_dir))
    proc = subprocess.run([sys.executable, "-c", BLOCK_JAX + code], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert _traces(trace_dir) == BUILD_PHASES
    built, want = report_tree(str(out)), report_tree(db_dir)
    assert sorted(built) == sorted(want)
    assert all(built[name] == want[name] for name in want)


def test_traced_plasmid_identify_without_jax(fixture, tmp_path):
    """``identify -p 2`` builds a plasmid DB inside the run: traced, in a
    process that can import neither jax nor the JAX package, it writes the
    identify and build phases' traces, and its reports equal an untraced
    run's."""
    d, db_dir, paths = fixture
    gdir = str(d / "genomes")
    plain, traced = str(tmp_path / "plain"), str(tmp_path / "traced")
    trace_dir = tmp_path / "trace"
    cfg = IdentifyConfig(plasmid_mode=2)
    assert run_identify(paths["single"], "", db_dir, plain, "cpu", cfg,
                        rgenome=gdir)
    code = textwrap.dedent(f"""
        from strainscan_tpu_torch import cli
        assert cli.main(["identify", "-i", {paths["single"]!r},
                         "-d", {db_dir!r}, "-o", {traced!r}, "-p", "2",
                         "-r", {gdir!r}, "--device", "cpu"]) == 0
        assert not any(_blocked(m) for m in sys.modules), "blocked import"
    """)
    env = dict(os.environ, PYTHONPATH=ROOT,
               STRAINSCAN_TRACE_DIR=str(trace_dir))
    proc = subprocess.run([sys.executable, "-c", BLOCK_JAX + code], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert _traces(trace_dir) == sorted(IDENTIFY_PHASES + BUILD_PHASES)
    assert_reports_identical(traced, plain)
    assert os.path.exists(os.path.join(traced, "DB_plasmid", "manifest.json"))


def test_traced_identify_one_trace_per_phase(fixture, monkeypatch):
    d, db_dir, paths = fixture
    plain, traced = str(d / "plain"), str(d / "traced")
    trace_dir = d / "trace_identify"
    assert run_identify(paths["intra"], "", db_dir, plain, "cpu",
                        IdentifyConfig())
    monkeypatch.setenv(timing.TRACE_ENV, str(trace_dir))
    assert run_identify(paths["intra"], "", db_dir, traced, "cpu",
                        IdentifyConfig())
    assert _traces(trace_dir) == IDENTIFY_PHASES
    got = assert_reports_identical(traced, plain)
    assert any(n.endswith("StrainVote.report") for n in got)


def test_nested_phase_only_times(tmp_path, monkeypatch):
    monkeypatch.setenv(timing.TRACE_ENV, str(tmp_path))
    with timing.phase("outer/a"):
        with timing.phase("inner"):
            sum(range(1000))
    assert _traces(tmp_path) == ["outer/a"]
    assert {"outer/a", "inner"} <= set(timing.PHASE_TIMES)
    with timing.phase("again"):       # a new trace once the first ended
        pass
    assert _traces(tmp_path) == ["again", "outer/a"]


def test_failing_export_raises(tmp_path, monkeypatch):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    monkeypatch.setenv(timing.TRACE_ENV, str(blocker))
    with pytest.raises(OSError):
        with timing.phase("x"):
            pass
    # the failure left no profiler marked as running: the next phase traces
    monkeypatch.setenv(timing.TRACE_ENV, str(tmp_path / "ok"))
    with timing.phase("y"):
        pass
    assert _traces(tmp_path / "ok") == ["y"]


def test_traced_build_one_trace_per_phase(fixture, tmp_path, monkeypatch):
    """The library build, traced: one trace per top-level phase, the nested
    ``tree_build/hierarchy`` timed only, the DB equal to an untraced
    build's."""
    d, db_dir, _ = fixture
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv(timing.TRACE_ENV, str(trace_dir))
    timing.PHASE_TIMES.pop("tree_build/hierarchy", None)
    build_database(str(d / "genomes"), str(tmp_path / "DB"))
    assert _traces(trace_dir) == BUILD_PHASES
    assert "tree_build/hierarchy" in timing.PHASE_TIMES
    built, want = report_tree(str(tmp_path / "DB")), report_tree(db_dir)
    assert sorted(built) == sorted(want)
    assert all(built[name] == want[name] for name in want)
