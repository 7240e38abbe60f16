"""``cst_search_s``: seconds per sample of the program's phase ``identify/cst_search``
(``timing.PHASE_TIMES``), averaged over the window's samples that ran
it."""


def read(obs):
    vals = [r["phases"]["identify/cst_search"] for r in obs["records"]
            if "identify/cst_search" in r.get("phases", {})]
    return sum(vals) / len(vals) if vals else None
