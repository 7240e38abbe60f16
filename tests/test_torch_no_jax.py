"""The port imports no jax, and asks for the card or raises.

A subprocess installs a meta-path finder that refuses every ``jax``
import, then imports the port's modules: the host with the card has no
JAX, so any transitive jax import would break the port there.
"""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from strainscan_tpu_torch.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK_JAX = textwrap.dedent("""
    import sys

    class _NoJax:
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                raise ImportError(f"jax is blocked: {name}")
            return None

    for _m in [m for m in sys.modules if m == "jax" or m.startswith(
            ("jax.", "jaxlib"))]:
        del sys.modules[_m]
    sys.meta_path.insert(0, _NoJax())
""")

MODULES = [
    "strainscan_tpu_torch.cli",
    "strainscan_tpu_torch.identify.pipeline",
    "strainscan_tpu_torch.identify.vote",
    "strainscan_tpu_torch.identify.prescan",
    "strainscan_tpu_torch.identify.count",
    "strainscan_tpu_torch.ops.enet",
    "strainscan_tpu_torch.ops.count",
    "strainscan_tpu_torch.ops.l2",
    "strainscan_tpu_torch.ops.probe",
    "strainscan_tpu_torch.parallel",
    "strainscan_tpu_torch.parallel.sharded",
    "strainscan_tpu_torch.parallel.distributed",
    "strainscan_tpu_torch.entry",
    "strainscan_tpu_torch.bench.count",
    "strainscan_tpu_torch.bench.probe_study",
    "strainscan_tpu_torch.ops.gather",
    "strainscan_tpu_torch.timing",
]


def _run(code):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("STRAINSCAN_TRACE_DIR", None)
    return subprocess.run([sys.executable, "-c", BLOCK_JAX + code], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_port_imports_without_jax():
    code = textwrap.dedent(f"""
        import importlib
        for name in {MODULES!r}:
            importlib.import_module(name)
        assert not any(m == "jax" or m.startswith("jax.")
                       for m in sys.modules), "jax was imported"
        try:
            import strainscan_tpu.ops.count
        except ImportError:
            print("BLOCKER_OK")
    """)
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    # the blocker really blocks: the JAX package's device module fails
    assert "BLOCKER_OK" in proc.stdout


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
           ("jax", "jaxlib", "strainscan_tpu")]
    assert not bad, f"chip_smoke.py imports {bad}"
    assert any(n.startswith("strainscan_tpu_torch.") for n in names)
