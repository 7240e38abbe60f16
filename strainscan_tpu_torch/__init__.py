"""StrainScan on PyTorch and CUDA: the port of ``strainscan_tpu`` to one GPU.

The JAX package ``strainscan_tpu`` stays the reference.  This package runs
``identify`` and ``batch-identify`` end to end with PyTorch tensors on an
explicit device; the k-mer count hot path runs in CUDA C++ kernels written
for Hopper (``csrc/probe_count.cu``), each with a plain PyTorch twin that a
CPU tensor is routed to.

The package imports ``torch`` and never ``jax``, and nothing of
``strainscan_tpu``: it owns copies of the host modules it runs (``config``,
``io.fastx``, ``kmer.pack``, the host half of ``index.hashtable``,
``native``, ``utils.prefetch``, ``utils.trees``, ``build.*``,
``identify.cst_search`` and ``identify.low_depth``), each at the same
relative path as its original, and builds a DB byte-identical to the JAX
package's.
"""

__version__ = "0.1.0"
