"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, 700 W) and
the least time a piece of work could take against them (a copy of
``strainscan_tpu_torch/bench/__init__.py``'s ``bound_ms``, in seconds).
"""

from __future__ import annotations

# device memory, and the 32-bit rate outside the tensor cores, which the
# count kernels' integer hashing and compares run at best
HBM_BYTES_S = 3.35e12
SCALAR_OPS_S = 67e12


def least_s(n_bytes: float, n_ops: float = 0.0) -> float:
    """Seconds to move ``n_bytes`` (each input read once, each output
    written once) and do ``n_ops`` at the published peaks."""
    return max(n_bytes / HBM_BYTES_S, n_ops / SCALAR_OPS_S)
