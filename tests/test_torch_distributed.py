"""Multi-process counting in the port: two gloo processes
(``tests/_torch_dist_worker.py``) each stream every second read batch and
merge their count vectors; counts and a full identify must equal a
single-process run (the cases of tests/test_distributed.py).

Tolerance: none; counts are equal integers and reports byte-identical.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from strainscan_tpu.build.pipeline import build_database
from strainscan_tpu.config import BuildConfig, IdentifyConfig
from strainscan_tpu.identify.count import count_sample as count_sample_jax
from strainscan_tpu.index.hashtable import KmerTable
from strainscan_tpu.kmer import pack
from strainscan_tpu_torch.identify.count import count_sample
from strainscan_tpu_torch.identify.pipeline import run_identify
from strainscan_tpu_torch.parallel import distributed as dist
from strainscan_tpu_torch.parallel.sharded import resolve_mesh

from _torch_sim import (mutate, one_torch_thread,  # noqa: F401
                        rand_genome, report_tree, sim_reads, write_fa,
                        write_fq)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two(mode, src, fq, outs):
    """Run two workers to the end (300 s each at most); assert both pass."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dist_worker.py"), mode,
         coord, "2", str(pid), src, fq, out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid, out in enumerate(outs)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        errs.append(err.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), \
        f"worker failed:\n{errs[0][-2500:]}\n----\n{errs[1][-2500:]}"


def test_two_process_counts_match(tmp_path):
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, size=30_000).astype(np.uint8)
    km, _ = pack.pack_kmers(genome, 31)
    keys = np.unique(np.concatenate([km, pack.revcomp_packed(km, 31)]))
    np.savez(tmp_path / "data.npz", keys=keys)
    ascii_map = np.frombuffer(b"ACGT", dtype=np.uint8)
    fq = tmp_path / "sample.fq"
    with open(fq, "w") as f:
        for i in range(2000):
            p = int(rng.integers(0, genome.size - 100))
            seq = ascii_map[genome[p:p + 100]].tobytes().decode()
            f.write(f"@r{i}\n{seq}\n+\n{'I' * 100}\n")

    cfg = IdentifyConfig(read_batch=256)     # 8 batches: both work
    table = KmerTable.build(keys, k=31)
    expected = count_sample(table, str(fq), "cpu", cfg)
    np.testing.assert_array_equal(expected,
                                  count_sample_jax(table, str(fq), cfg))
    outs = [str(tmp_path / f"out{pid}.npz") for pid in range(2)]
    _run_two("count", str(tmp_path / "data.npz"), str(fq), outs)
    for pid, out in enumerate(outs):
        z = np.load(out)
        assert (int(z["pidx"]), int(z["pcount"])) == (pid, 2)
        assert z["counts"].dtype == np.int32
        np.testing.assert_array_equal(z["counts"], expected,
                                      err_msg=f"process {pid}")
        assert bool(z["overflow"]), "an int32 overflow must raise"


def test_two_process_full_identify(tmp_path):
    """count -> CST search -> L2 vote (its union count merged too) ->
    reports, on a genuine 2-strain cluster: byte-identical to one
    process."""
    rng = np.random.default_rng(9)
    gdir = tmp_path / "genomes"
    gdir.mkdir()
    base = rand_genome(rng, 30_000)
    strains = {"A1": base, "A2": mutate(rng, base, 15),
               "B1": rand_genome(rng, 30_000)}
    for name, seq in strains.items():
        write_fa(gdir / f"{name}.fa", name, seq)
    db = str(tmp_path / "DB")
    build_database(str(gdir), db, BuildConfig())
    fq = str(tmp_path / "mix.fq")
    write_fq(fq, sim_reads(rng, strains["A1"], 6.0)
             + sim_reads(rng, strains["A2"], 6.0))

    out_single = str(tmp_path / "out_single")
    assert run_identify(fq, "", db, out_single, "cpu",
                        IdentifyConfig(read_batch=256, min_snv_num=10))
    expected = report_tree(out_single)
    assert any(k.endswith("StrainVote.report") for k in expected), \
        "fixture must exercise the L2 vote"
    outs = [str(tmp_path / f"out_p{pid}") for pid in range(2)]
    _run_two("identify", db, fq, outs)
    for pid, out in enumerate(outs):
        got = report_tree(out)
        assert got == expected, (
            f"process {pid} reports diverge on: "
            f"{[k for k in expected if expected.get(k) != got.get(k)]}")


@pytest.mark.parametrize("world, local_rank, n_gpu, want", [
    (1, None, 4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),  # one process
    (4, "0", 4, ["cuda:0"]),
    (4, "2", 4, ["cuda:2"]),
    (8, "5", 4, ["cuda:1"]),      # two processes per card
    (2, "1", 1, ["cuda:0"]),      # CUDA_VISIBLE_DEVICES gave it one card
    (2, None, 2, ["cuda:0"]),     # no LOCAL_RANK: the first card
])
def test_cuda_device_of_each_process(monkeypatch, world, local_rank, n_gpu,
                                     want):
    """``--device cuda``: one process takes every visible GPU; under
    torchrun each process takes ``cuda:LOCAL_RANK`` (modulo the count), so
    the processes of a host spread over its cards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_gpu)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(dist, "process_info", lambda: (0, world))
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    mesh = resolve_mesh("cuda")
    assert [str(d) for d in mesh.devices] == want
