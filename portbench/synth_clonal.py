"""Seeded genomes of a clonal-complex DB: families of variants of one base.

Each family has one random base genome, which is no strain itself; each of
its variants carries its own SNPs at positions no other variant of the
family uses.  Two variants of a family then differ at ``2 * snps``
positions: at 32 SNPs and 100 kb, a Jaccard distance of about 0.02, under
the build's 0.05 clustering cut, and about 3 % of the family's L2 rows,
above the L2 dedup's 1 % (``BuildConfig.recls_cutoff``).  Families share
nothing, so each is one cluster.  Names are ``F<family>V<variant>``,
families in the order given (the largest first in ``saureus-db``).
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from portbench.synth import ASCII


def family_sizes(groups: Sequence[Sequence[int]]) -> List[int]:
    """The size of every family, in order, from ``[[size, count], ...]``."""
    return [int(size) for size, count in groups for _ in range(int(count))]


def synth_clonal(gdir: str, groups: Sequence[Sequence[int]], snps: int,
                 glen: int, rng) -> List[str]:
    """Write the genomes of the families ``groups`` (``[[size, count],
    ...]``) under ``gdir``, ``snps`` SNPs per variant; return their names."""
    sizes = family_sizes(groups)
    wf = len(str(len(sizes) - 1))
    names = []
    for f, size in enumerate(sizes):
        base = rng.integers(0, 4, size=glen, dtype=np.uint8)
        pos = rng.choice(glen, size=(size, snps), replace=False)
        shift = rng.integers(1, 4, size=(size, snps), dtype=np.uint8)
        wv = len(str(size - 1))
        for v in range(size):
            s = base.copy()
            s[pos[v]] = (s[pos[v]] + shift[v]) % 4
            name = f"F{f:0{wf}d}V{v:0{wv}d}"
            with open(os.path.join(gdir, name + ".fa"), "wb") as fh:
                fh.write(b">%s\n%s\n" % (name.encode(), ASCII[s].tobytes()))
            names.append(name)
    return names
