"""The port stands alone: it imports neither jax nor the JAX package, and
asks for the card or raises.

A subprocess installs a meta-path finder that refuses every import of
``jax``, of ``strainscan_tpu`` (not ``strainscan_tpu_torch``) and of the
JAX package's scripts (``benchmarks``), then imports every module of the
port, runs a CPU ``build`` -> ``identify`` through its CLI and builds a
small E. coli-style fixture with ``bench.scale_fixture``: the host with the
card has no JAX, so any transitive import of either would break the port
there.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from strainscan_tpu_torch.device import resolve_device

from _torch_sim import mutate, rand_genome, sim_reads, write_fa, write_fq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK_JAX = textwrap.dedent("""
    import sys

    def _blocked(name):
        return (name in ("jax", "strainscan_tpu", "benchmarks")
                or name.startswith(("jax.", "jaxlib", "strainscan_tpu.",
                                    "benchmarks.")))

    class _NoJax:
        def find_spec(self, name, path=None, target=None):
            if _blocked(name):
                raise ImportError(f"blocked: {name}")
            return None

    for _m in [m for m in sys.modules if _blocked(m)]:
        del sys.modules[_m]
    sys.meta_path.insert(0, _NoJax())
""")


def port_modules():
    """Every module of the port, by its dotted name."""
    pkg = os.path.join(ROOT, "strainscan_tpu_torch")
    names = []
    for root, dirs, files in os.walk(pkg):
        dirs[:] = sorted(d for d in dirs if not d.startswith(("_", ".")))
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), ROOT)[:-3]
                names.append(rel.replace(os.sep, ".")
                             .removesuffix(".__init__"))
    return names


def _run(code):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("STRAINSCAN_TRACE_DIR", None)
    return subprocess.run([sys.executable, "-c", BLOCK_JAX + code], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=240)


def test_port_imports_without_jax():
    modules = port_modules()
    assert "strainscan_tpu_torch.build.pipeline" in modules
    assert "strainscan_tpu_torch.native" in modules
    code = textwrap.dedent(f"""
        import importlib
        for name in {modules!r}:
            importlib.import_module(name)
        assert not any(_blocked(m) for m in sys.modules), "blocked import"
        for name in ("strainscan_tpu.config", "jax"):
            try:
                importlib.import_module(name)
            except ImportError:
                print("BLOCKED", name)
    """)
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    # the blocker really blocks the JAX package and jax itself
    assert "BLOCKED strainscan_tpu.config" in proc.stdout
    assert "BLOCKED jax" in proc.stdout


def test_cli_build_identify_under_the_block(tmp_path):
    """``python -m strainscan_tpu_torch.cli`` builds a DB and identifies a
    sample on the CPU in a process that can import neither jax nor the JAX
    package."""
    rng = np.random.default_rng(5)
    gdir = tmp_path / "genomes"
    gdir.mkdir()
    base = rand_genome(rng, 30_000)
    strains = {"GA_1": base, "GA_2": mutate(rng, base, 30),
               "GB_1": rand_genome(rng, 30_000)}
    for name, seq in strains.items():
        write_fa(gdir / f"{name}.fa", name, seq)
    write_fq(tmp_path / "s.fq", sim_reads(rng, strains["GB_1"], 5))
    db, out = str(tmp_path / "DB"), str(tmp_path / "out")
    code = textwrap.dedent(f"""
        import runpy
        for argv in (["build", "-i", {str(gdir)!r}, "-o", {db!r}],
                     ["identify", "-i", {str(tmp_path / "s.fq")!r},
                      "-d", {db!r}, "-o", {out!r}, "--device", "cpu"]):
            sys.argv = ["strainscan_tpu_torch.cli", *argv]
            try:
                runpy.run_module("strainscan_tpu_torch.cli",
                                 run_name="__main__", alter_sys=True)
            except SystemExit as e:
                assert e.code == 0, (argv[0], e.code)
        assert not any(_blocked(m) for m in sys.modules), "blocked import"
    """)
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(os.path.join(db, "manifest.json")) as f:
        assert json.load(f)["n_strains"] == 3
    with open(os.path.join(out, "final_report.txt")) as f:
        rows = f.read().splitlines()[1:]
    assert [r.split("\t")[1] for r in rows] == ["GB_1"]


def test_scale_bench_stands_alone(tmp_path):
    """``bench.scale_fixture`` and ``bench.scale_parity`` keep their own
    copies of the JAX package's generators: with ``benchmarks`` blocked too
    they import and build a 2-family fixture (genomes, DB, reference
    export, four samples)."""
    root = str(tmp_path / "fixture")
    code = textwrap.dedent(f"""
        import importlib
        from strainscan_tpu_torch.bench import scale_fixture, scale_parity
        meta = scale_fixture.build_fixture({root!r}, families=2,
                                           deep_scale=0.001)
        assert list(meta["samples"]) == ["single", "crossmix", "intramix",
                                         "deep"], meta["samples"]
        assert len(meta["strains"]) == 4 and meta["n_keys"] > 0
        assert scale_parity.load_meta({root!r}) == meta
        assert not any(_blocked(m) for m in sys.modules), "blocked import"
        for name in ("benchmarks.scale", "benchmarks"):
            try:
                importlib.import_module(name)
            except ImportError:
                print("BLOCKED", name)
    """)
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "BLOCKED benchmarks.scale" in proc.stdout
    assert "BLOCKED benchmarks" in proc.stdout.splitlines()
    assert os.path.exists(os.path.join(root, "REFDB", "Tree_database",
                                       "kmer.fa"))


def test_cli_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda is valid here")
    code = textwrap.dedent(f"""
        from strainscan_tpu_torch import cli
        try:
            cli.main(["identify", "-i", "x.fq", "-d", {str(tmp_path)!r},
                      "-o", {str(tmp_path / "out")!r}, "--device", "cuda"])
        except RuntimeError as e:
            assert "cuda" in str(e).lower()
            print("RAISED")
    """)
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "RAISED" in proc.stdout
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_imports_only_the_port():
    """The smoke runs on a host without JAX: it names no module of the JAX
    package, only the port's."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in
           ("jax", "jaxlib", "strainscan_tpu", "benchmarks")]
    assert not bad, f"chip_smoke.py imports {bad}"
    assert any(n.startswith("strainscan_tpu_torch.") for n in names)
