"""Entry points of the port: the one-device step and the mesh dry run.

The counterpart of ``__graft_entry__.py``.

``entry(device)`` returns ``(fn, args)``: the flagship forward step on
``device``, the k-mer match and count (``count_fp``'s binned kernels on
the raw codes of a CUDA tensor, its plain twin on the CPU), the id-space gather, and
the layer-2 moments ``X^T y`` and Gram ``X^T X`` that feed the Elastic-Net
solve, in float32 by ``torch.matmul`` with TF32 off.  The moments and Gram
are sums of integers below 2^24, so they are exact on any device.

``dryrun_multichip(devices)`` builds a ('data', 'index') mesh over
``devices`` (positions may repeat a device: ``["cpu"] * 8``, or
``["cuda:0"] * 4`` on one card), runs the sharded count, the streaming
sharded pipeline, the sharded L2 statistics and the mesh-routed Pre-Scan
column sums and Enet fold Grams on a table of over 100 k keys, and raises
unless each equals its single-device or exact integer form.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from strainscan_tpu_torch.index.hashtable import FpTable
from strainscan_tpu_torch.kmer import pack

K = 31


def _problem(n_reads=256, read_len=96, genome_len=5000, s=8, seed=0):
    """``__graft_entry__._problem``: a seeded genome's both-strand k-mers,
    reads of 90 bases from it padded with code 4, and a 0/1 float32
    strain matrix ``[n_keys, s]``."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    km, _ = pack.pack_kmers(genome, K)
    db = np.unique(np.concatenate([km, pack.revcomp_packed(km, K)]))
    codes = np.full((n_reads, read_len), 4, dtype=np.uint8)
    span = min(90, read_len)
    for i in range(n_reads):
        st = int(rng.integers(0, genome_len - span))
        codes[i, :span] = genome[st:st + span]
    X = (rng.random((db.size, s)) < 0.3).astype(np.float32)
    return db, codes, X


def _check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def entry(device="cuda"):
    """``(fn, args)`` with ``fn(*args) -> (counts int32 [n_keys], moments
    float32 [s], gram float32 [s, s])`` on ``device``."""
    from strainscan_tpu_torch.device import resolve_device
    from strainscan_tpu_torch.ops.probe import count_fp

    dev = resolve_device(device)
    db, codes, X = _problem()
    table = FpTable.build(db, k=K)
    n_slots, seed = table.n_slots, table.seed
    length = codes.shape[1]

    def fn(codes, fp_table, slot_of_id, X):
        slot_counts = torch.zeros(n_slots + 1, dtype=torch.int32,
                                  device=codes.device)
        count_fp(slot_counts, codes, fp_table, length=length, k=K, seed=seed)
        counts = slot_counts.index_select(0, slot_of_id)
        y = counts.to(torch.float32)
        return counts, X.T @ y, X.T @ X

    fp = torch.from_numpy(table.fp.reshape(table.n_buckets, table.bucket)
                          .view(np.int32))
    soi = torch.from_numpy(np.ascontiguousarray(table.slot_of_id(),
                                                dtype=np.int32))
    args = tuple(t.to(dev) for t in (torch.from_numpy(codes), fp, soi,
                                     torch.from_numpy(X)))
    return fn, args


def dryrun_multichip(devices: Sequence) -> None:
    """Sharded identify step on a mesh over ``devices``; raises on any
    disagreement, prints one line when every check holds."""
    from strainscan_tpu_torch.identify.prescan import _L2Kernels
    from strainscan_tpu_torch.ops import enet
    from strainscan_tpu_torch.parallel import (ShardedCountPipeline,
                                               ShardedTable, l2_mesh,
                                               make_mesh, pad_rows,
                                               sharded_count,
                                               sharded_l2_stats)

    mesh = make_mesh(devices)
    d, i = mesh.shape["data"], mesh.shape["index"]
    # over 100 k keys and an ODD count: the last index shard runs one key
    # short of shard_cap, so the value map padding and the slot->id remap
    # are exercised
    db, codes, X = _problem(n_reads=16 * d, read_len=64, genome_len=52_000)
    if db.size % 2 == 0:
        db, X = db[1:], X[1:]
    _check(db.size >= 100_000 and db.size % 2 == 1, f"{db.size} keys")
    st = ShardedTable.build(db, k=K, n_shards=i)
    counts = sharded_count(mesh, st, codes)[:db.size].cpu().numpy()
    _check(counts.sum() > 0, "the sharded count produced no hits")
    # the streaming multi-batch pipeline must agree with the one-shot count
    pipe = ShardedCountPipeline(db, k=K, mesh=mesh)
    pipe.add_batch(codes[:codes.shape[0] // 2])
    pipe.add_batch(codes[codes.shape[0] // 2:])
    _check(np.array_equal(pipe.finish(), counts),
           "ShardedCountPipeline != sharded_count")

    n_pad = pad_rows(mesh, db.size)
    Xp = np.zeros((n_pad, X.shape[1]), np.float32)
    Xp[:db.size] = X
    yp = np.zeros(n_pad, np.float32)
    yp[:db.size] = counts
    m, g = sharded_l2_stats(mesh, Xp, yp)
    X64 = X.astype(np.float64)
    _check(np.array_equal(m, X64.T @ counts), "sharded moments != X^T y")
    _check(np.array_equal(g, X64.T @ X64), "sharded Gram != X^T X")

    # the production mesh-routed L2 kernels: Pre-Scan column sums and Enet
    # fold Grams over the row-sharded k-mer axis equal their exact integer
    # forms
    X8 = (X > 0.5).astype(np.int8)
    kern = _L2Kernels(X8, mesh, min_shard_rows=1)
    _check(kern.mesh is not None, "Pre-Scan mesh route not engaged")
    big = counts > 1
    _check(np.array_equal(kern.colsum(kern.to_mask(big)),
                          X8.T.astype(np.int32) @ big.astype(np.int32)),
           "mesh colsum != X^T m")
    train = np.zeros((3, db.size), dtype=bool)
    train[0, ::2] = True
    train[1, 1::2] = True
    train[2, :] = True
    _check(l2_mesh(mesh, db.size, 1) is not None, "fold-Gram mesh route not "
           "engaged")
    grams, _ = enet._fold_grams(X8.astype(np.float64),
                                counts.astype(np.float64), train, mesh,
                                min_shard_rows=1)
    for f in range(train.shape[0]):
        Xf = X8[train[f]].astype(np.int64)
        _check(np.array_equal(grams[f].astype(np.int64), Xf.T @ Xf),
               f"mesh fold Gram {f} != X^T diag(t) X")
    print(f"dryrun_multichip OK: mesh=({d}x{i}) on "
          f"{sorted({str(x) for x in mesh.devices})}, {int(counts.sum())} "
          f"k-mer hits, moments shape {m.shape}, L2 mesh kernels exact")
