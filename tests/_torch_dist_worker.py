"""Subprocess worker for the port's 2-process gloo tests.

Usage: python _torch_dist_worker.py <count|identify> <host:port> <n_procs>
       <pid> <keys.npz | db_dir> <fq> <out>

Joins the gloo process group, then either counts its share of the read
batches against the keys' table (``count``: writes the merged counts, and
whether merging int32 maxima raises OverflowError, to ``<out>.npz``) or runs
the whole identify pipeline on the CPU (``identify``: writes its reports
under ``<out>``).  Imports no jax.
"""

import os
import sys

import numpy as np


def main():
    mode, coord, n, pid, src, fq, out = sys.argv[1:8]
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    torch.set_num_threads(1)
    from strainscan_tpu.config import IdentifyConfig
    from strainscan_tpu_torch.parallel import distributed as dist

    dist.initialize(coord, num_processes=int(n), process_id=int(pid))
    if mode == "count":
        from strainscan_tpu.index.hashtable import KmerTable
        from strainscan_tpu_torch.identify.count import count_sample

        keys = np.load(src)["keys"]
        counts = count_sample(KmerTable.build(keys, k=31), fq, "cpu",
                              IdentifyConfig(read_batch=256))
        try:
            dist.merge_counts(np.full(3, dist.INT32_MAX, dtype=np.int32))
            overflow = False
        except OverflowError:
            overflow = True
        pidx, pcount = dist.process_info()
        np.savez(out, counts=counts, pidx=pidx, pcount=pcount,
                 overflow=overflow)
    else:
        from strainscan_tpu_torch.identify.pipeline import run_identify

        res = run_identify(fq, "", src, out, "cpu",
                           IdentifyConfig(read_batch=256, min_snv_num=10))
        assert res is not None, "no clusters detected in distributed run"
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
