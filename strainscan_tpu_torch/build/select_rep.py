"""Representative selection + strain re-assignment.

Array-native port of the reference semantics (library/select_rep.py:7-114):

* cluster of size 1 -> that strain is the representative;
* size 2 -> the first listed strain (select_rep.py:50-57);
* size >= 3 -> the member with minimum mean distance to the other members
  (select_rep.py:60-81);
* then every strain is re-assigned to the cluster of its nearest
  representative (select_rep.py:88-103), producing the ``recls`` map the
  rest of the build consumes (hclsMap_95_recls).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def pick_rep(
    names: Sequence[str],
    dist: np.ndarray,
    cls: Dict[int, List[str]],
):
    """Returns (reps, recls, moved).

    reps: {cluster_id: representative strain name}
    recls: {cluster_id: [member strain names]} after nearest-rep re-assignment
    moved: [(strain, old_rep, old_dist, new_rep, new_dist)] re-assignments
           (the reference's Other_Strain_CN.txt, select_rep.py:103)
    """
    idx = {n: i for i, n in enumerate(names)}
    reps: Dict[int, str] = {}
    strain_rep: Dict[str, str] = {}
    for cid, members in cls.items():
        if len(members) <= 2:
            rep = members[0]
        else:
            rows = np.array([idx[m] for m in members])
            sub = dist[np.ix_(rows, rows)]
            mean_d = (sub.sum(axis=1)) / (len(members) - 1)
            rep = members[int(np.argmin(mean_d))]
        reps[cid] = rep
        for m in members:
            strain_rep[m] = rep
    rep_of_cls = {reps[c]: c for c in reps}
    rep_names = list(reps.values())
    rep_rows = np.array([idx[r] for r in rep_names])

    recls: Dict[int, List[str]] = {cid: [] for cid in cls}
    moved: List[Tuple[str, str, float, str, float]] = []
    for cid in sorted(cls):
        for m in cls[cid]:
            if m in rep_of_cls:
                recls[rep_of_cls[m]].append(m)
                continue
            d = dist[idx[m], rep_rows]
            j = int(np.argmin(d))
            nearest = rep_names[j]
            own = strain_rep[m]
            if nearest == own:
                recls[cid].append(m)
            else:
                tgt = rep_of_cls[nearest]
                recls[tgt].append(m)
                moved.append(
                    (m, own, float(dist[idx[m], idx[own]]), nearest, float(d[j]))
                )
    return reps, recls, moved
