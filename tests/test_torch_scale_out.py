"""The scale-out runners' host logic, on the CPU: ``bench.scale_parity``'s
mesh names and records, its ``procs`` command line and its diff of trees
of other layouts, and ``bench.mesh_scaling``'s mesh specs and trace
shares.  No number here is a device measurement; both runners raise
without a CUDA device where they measure.

Tolerance: none; every value compared is an integer, a string or a share
computed from integers.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from strainscan_tpu_torch.bench import mesh_scaling, scale_parity
from strainscan_tpu_torch.build.db import load_tree_db
from strainscan_tpu_torch.build.pipeline import build_database
from strainscan_tpu_torch.config import BuildConfig, IdentifyConfig
from strainscan_tpu_torch.identify import count as icount
from strainscan_tpu_torch.identify.pipeline import run_identify
from strainscan_tpu_torch.parallel import sharded as psh

from _torch_sim import (mutate, one_torch_thread, rand_genome,  # noqa: F401
                        sim_reads, write_fa, write_fq)

CUDA4 = [torch.device("cuda", i) for i in range(4)]


def _mesh(devices, index_shards):
    """A Mesh of ``devices`` (no device check: CUDA ones on the CPU)."""
    n = len(devices) // index_shards
    return psh.Mesh(tuple(tuple(devices[r * index_shards:
                                        (r + 1) * index_shards])
                          for r in range(n)))


@pytest.mark.parametrize("devices,index_shards,l2_rows,want", [
    (CUDA4[:1], 1, None, "ours_cuda"),
    (CUDA4, 2, None, "ours_cuda_4gpu_2x2"),
    (CUDA4, 1, None, "ours_cuda_4gpu_4x1"),
    (CUDA4, 2, 1, "ours_cuda_4gpu_2x2_l2rows1"),
    (CUDA4[:1] * 4, 2, None, "ours_cuda_1gpu_2x2"),
    ([torch.device("cpu")] * 4, 2, 1, "ours_cpu_1cpu_2x2_l2rows1"),
])
def test_run_name_and_mesh_record(devices, index_shards, l2_rows, want):
    mesh = _mesh(devices, index_shards)
    device = devices[0].type
    assert scale_parity.run_name(device, mesh, l2_rows) == want
    rec = scale_parity.mesh_record(mesh)
    assert rec["shape"] == [len(devices) // index_shards, index_shards]
    assert rec["positions"] == len(devices)
    assert rec["distinct_devices"] == len(set(devices))
    assert rec["devices"] == [str(d) for d in devices]


def test_procs_command_and_modes(monkeypatch):
    cmd = scale_parity.procs_command("/x/fix", 4, "cuda")
    assert cmd[:3] == [sys.executable, "-m", "torch.distributed.run"]
    assert cmd[cmd.index("--nproc-per-node") + 1] == "4"
    assert "--standalone" in cmd
    at = cmd.index("-m", 3)
    assert cmd[at + 1:] == ["strainscan_tpu_torch.bench.scale_parity",
                            "--root", "/x/fix", "rank", "--device", "cuda",
                            "--name", "ours_cuda_4proc"]
    seen = {}
    for fn in ("run_ours", "run_procs", "run_rank"):
        monkeypatch.setattr(scale_parity, fn,
                            lambda *a, fn=fn: seen.setdefault(fn, a) and 0)
    scale_parity.main(["--root", "/x/fix", "ours", "--index-shards", "1",
                       "--l2-rows", "1"])
    scale_parity.main(["--root", "/x/fix", "procs", "2"])
    scale_parity.main(["--root", "/x/fix", "rank", "--device", "cpu",
                       "--name", "ours_cpu_2proc"])
    assert seen == {"run_ours": ("/x/fix", "cuda", 1, 1),
                    "run_procs": ("/x/fix", 2, "cuda"),
                    "run_rank": ("/x/fix", "cpu", "ours_cpu_2proc")}


def test_identify_each_keeps_the_smoke_s_call_form():
    """chip_smoke.py's phase 7 calls ``identify_each(fqs, db, out,
    device)``: the mesh and the config default to the device's and
    ``IdentifyConfig()``."""
    assert scale_parity.identify_each({}, "DB", "out", "cpu") == {}


def test_counterpart_by_path_then_sample():
    groups = {"cold/single": 1, "warm/single": 2, "batch/deep": 3}
    assert scale_parity.counterpart("warm/single", groups) == "warm/single"
    assert scale_parity.counterpart("rank1/single", groups) == "cold/single"
    assert scale_parity.counterpart("rank0/deep", groups) == "batch/deep"
    assert scale_parity.counterpart("rank0/crossmix", groups) is None


@pytest.fixture(scope="module")
def enet_db(tmp_path_factory):
    """A1, its 15-SNP mutant A2 (one cluster: the Elastic-Net vote) and B1;
    a sample of A1 and A2."""
    d = tmp_path_factory.mktemp("scale_out")
    rng = np.random.default_rng(34)
    gdir = d / "genomes"
    gdir.mkdir()
    base = rand_genome(rng, 30_000)
    strains = {"A1": base, "A2": mutate(rng, base, 15),
               "B1": rand_genome(rng, 30_000)}
    for name, seq in strains.items():
        write_fa(gdir / f"{name}.fa", name, seq)
    db = str(d / "DB")
    build_database(str(gdir), db, BuildConfig())
    fq = str(d / "mix.fq")
    write_fq(fq, sim_reads(rng, strains["A1"], 6.0)
             + sim_reads(rng, strains["A2"], 6.0))
    return d, db, fq


@pytest.mark.parametrize("sharded", [True, False])
def test_measured_records_routes_and_l2_gate(enet_db, sharded):
    """``measured`` names each count's pipeline and each L2 mesh gate, and
    counts the sharded pipeline's upload of the DB's table once."""
    d, db, fq = enet_db
    mesh = psh.make_mesh(["cpu"] * 4)
    cfg = IdentifyConfig(min_snv_num=10, shard_min_l2_rows=1,
                         shard_min_kmers=1 if sharded else 10**12)
    icount._SHARDED_CACHE.clear()
    try:
        rec = scale_parity.measured(lambda: run_identify(
            fq, "", db, str(d / f"out{sharded}"), mesh, cfg) is not None,
            "cpu")
    finally:
        icount._SHARDED_CACHE.clear()
    assert rec["ok"]
    route = "sharded" if sharded else "single"
    assert rec["counts"][0] == {"count": "main", "route": route}
    assert {c["count"] for c in rec["counts"][1:]} == {"union"}
    assert {c["route"] for c in rec["counts"]} == {route}
    assert len(rec["counts"]) == len(rec["fetches"])
    assert rec["l2_mesh"] and all(g["opened"] and g["min_rows"] == 1
                                  for g in rec["l2_mesh"])
    if sharded:   # the sharded pipeline's shards of the DB's table, once
        n_keys = load_tree_db(db).table.n_keys
        assert rec["uploads_keys"].count(n_keys) == 1


def test_mesh_specs():
    assert mesh_scaling.parse_mesh("2x2") == (2, 2)
    assert mesh_scaling.parse_mesh("4X1") == (4, 1)
    for bad in ("0x4", "2", "2x2x1"):
        with pytest.raises(ValueError):
            mesh_scaling.parse_mesh(bad)


def _ev(cat, name, ts, dur, device, stream):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"device": device, "stream": stream}}


def test_device_shares_busy_and_h2d_overlap():
    """GPU 0: kernels at [10, 30) and [50, 60) on stream 7, an h2d at
    [25, 55) on stream 9 (overlapping 5 + 5 of kernel time); GPU 1: one
    kernel at [0, 20), clipped to the span [10, 110); host events and
    events outside the span are left out."""
    events = [_ev("kernel", "fp_bin_probe_kernel", 10, 20, 0, 7),
              _ev("kernel", "fp_coarse_count_kernel", 50, 10, 0, 7),
              _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 25, 30,
                  0, 9),
              _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 70, 5, 0,
                  7),
              _ev("kernel", "fp_bin_probe_kernel", 0, 20, 1, 7),
              _ev("kernel", "late", 200, 10, 1, 7),
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 10,
               "dur": 90}]
    got = mesh_scaling.device_shares(events, (10, 110))
    assert sorted(got) == ["0", "1"]
    g0, g1 = got["0"], got["1"]
    assert g0["busy_share"] == pytest.approx((55 - 10 + 5 + 5) / 100)
    assert g0["kernel_ms"] == pytest.approx(0.030)
    assert g0["h2d_ms"] == pytest.approx(0.030) and g0["h2d_copies"] == 1
    assert g0["h2d_overlap_ms"] == pytest.approx(0.010)
    assert g0["h2d_overlap_share"] == pytest.approx(1 / 3)
    assert g0["kernel_streams"] == [7] and g0["h2d_streams"] == [9]
    assert g1["busy_share"] == pytest.approx(0.1)
    assert g1["h2d_ms"] == 0 and g1["h2d_overlap_share"] == 0.0
    assert mesh_scaling.overlap([[0, 10], [20, 30]], [[5, 25]]) == 10


def test_runners_refuse_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError):
        mesh_scaling.run(("1x1",), reps=1, n_reads=10)


def test_ours_cpu_mesh_config_skips_the_cli_passes(monkeypatch, tmp_path):
    """A run on a mesh other than the CLI's, or with another config,
    makes the cold and warm passes only."""
    calls = []
    monkeypatch.setattr(scale_parity, "load_meta", lambda root: {
        "samples": {}, "n_keys": 1, "db_digest": "x"})
    monkeypatch.setattr(scale_parity, "identify_each",
                        lambda fqs, db, out, device, mesh, cfg:
                        calls.append((os.path.basename(os.path.dirname(out)),
                                      mesh.shape, cfg.shard_min_l2_rows))
                        or {})
    rc = scale_parity.run_ours(str(tmp_path), "cpu", l2_rows=1,
                               mesh=psh.make_mesh(["cpu"] * 4))
    name = "ours_cpu_1cpu_2x2_l2rows1"
    assert calls == [(name, {"data": 2, "index": 2}, 1)] * 2
    with open(tmp_path / "parity" / (name + ".json")) as f:
        res = json.load(f)
    assert res["batch"] is None and res["process"] is None
    assert res["mesh"]["shape"] == [2, 2]
    assert res["config"]["shard_min_l2_rows"] == 1
    # no sample ran, so the DB's table was never uploaded: the run fails
    assert rc == 1 and res["failures"] == [
        "the DB's table was uploaded 0 times"]
