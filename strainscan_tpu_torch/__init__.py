"""StrainScan on PyTorch and CUDA: the port of ``strainscan_tpu`` to one GPU.

The JAX package ``strainscan_tpu`` stays the reference.  This package runs
``identify`` and ``batch-identify`` end to end with PyTorch tensors on an
explicit device; the k-mer count hot path runs in CUDA C++ kernels written
for Hopper (``csrc/probe_count.cu``), each with a plain PyTorch twin that a
CPU tensor is routed to.

The package imports ``torch`` and never ``jax``.  From ``strainscan_tpu`` it
imports only host modules that import no jax: ``config``, ``io.fastx``,
``kmer.pack``, ``index.hashtable``, ``native``, ``utils.prefetch``,
``build.*``, ``identify.cst_search`` and ``identify.low_depth``.
"""

__version__ = "0.1.0"
