"""The benchmark of the PyTorch and CUDA port (``strainscan_tpu_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the CUDA
devices of this host.  Everything that belongs to one configuration, one
traffic mix, one driver loop or one per-layer metric sits in a file of its
own, found by the name ``BENCHMARK.json`` gives it (see ``README.md``).

Nothing here imports ``jax`` or the JAX package ``strainscan_tpu``; the
yardstick (generators, trace arithmetic, peaks, the plain reference and the
comparisons that decide ``correct``) imports nothing of the port either.
"""
