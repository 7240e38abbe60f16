"""The port's entry points (``strainscan_tpu_torch.entry``) on the CPU.

``entry("cpu")`` against ``__graft_entry__.entry()`` on JAX's CPU backend
(its jnp path) on the same seeded problem; ``dryrun_multichip`` on CPU
meshes, the twins of JAX's virtual-device meshes.

Tolerance: none.  Counts are integers; the moments and Gram are float32
sums of integers below 2^24, exact in any order.
"""

import os
import sys

import numpy as np
import pytest
import torch

from strainscan_tpu_torch import entry

from _torch_sim import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import __graft_entry__  # noqa: E402  (the JAX package's entry points)


def test_problem_equals_jax():
    for got, want in zip(entry._problem(), __graft_entry__._problem()):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_entry_cpu_equals_jax():
    fn, args = entry.entry("cpu")
    assert all(t.device.type == "cpu" for t in args)
    counts, moments, gram = fn(*args)
    jfn, jargs = __graft_entry__.entry()
    jcounts, jmoments, jgram = (np.asarray(a) for a in jfn(*jargs))
    assert counts.dtype == torch.int32 and moments.dtype == torch.float32
    assert np.array_equal(counts.numpy(), jcounts)
    assert np.array_equal(moments.numpy(), jmoments)
    assert np.array_equal(gram.numpy(), jgram)
    assert int(counts.sum()) > 0


def test_entry_cuda_without_gpu_raises():
    """``entry()`` asks for the card unless told otherwise."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        entry.entry("cuda")
    with pytest.raises(RuntimeError, match="(?i)cuda"):
        entry.entry()


@pytest.mark.parametrize("n", [8, 4, 3])
def test_dryrun_multichip_cpu_mesh(n, capsys):
    entry.dryrun_multichip(["cpu"] * n)
    shape = {8: "(4x2)", 4: "(2x2)", 3: "(3x1)"}[n]
    assert f"dryrun_multichip OK: mesh={shape}" in capsys.readouterr().out
