"""Layer-2 reductions on one device's rows, exact in any order.

The Pre-Scan column sums (``identify/prescan.py``) and the Elastic-Net fold
Grams (``ops/enet.py``) are these reductions over the whole k-mer axis on
one device; the mesh route (``parallel/sharded.py``) runs the same
functions on each position's rows and sums the partials.  Column sums are
int32 sums of 0/1 products; Gram entries are float64 sums of integer
products far below 2**53.  Both are exact, so the split of the rows and
the order of the sums never change the result.
"""

from __future__ import annotations

import torch

# rows per Gram block: bounds the [F, block, s] float64 weighted copy
GRAM_BLOCK = 16384


def masked_colsum(X: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """int32 ``[s]``: ``X^T mask`` for an int8 0/1 ``X [n, s]`` and a
    bool ``mask [n]``."""
    return (X * mask.to(torch.int8)[:, None]).sum(dim=0, dtype=torch.int32)


def fold_grams(X: torch.Tensor, T: torch.Tensor,
               block: int = GRAM_BLOCK) -> torch.Tensor:
    """float64 ``[F, s, s]``: ``X^T diag(T[f]) X`` for every fold ``f``,
    over row blocks, so memory is O(F * block * s).  ``X [n, s]`` and
    ``T [F, n]`` may be any real dtype; both are taken as float64."""
    n, s = X.shape
    grams = torch.zeros((T.shape[0], s, s), dtype=torch.float64,
                        device=X.device)
    for i in range(0, n, block):
        xb = X[i:i + block].to(torch.float64)                    # [b, s]
        tb = T[:, i:i + block].to(torch.float64)                 # [F, b]
        grams += torch.matmul((tb[:, :, None] * xb[None]).transpose(1, 2),
                              xb)
    return grams
