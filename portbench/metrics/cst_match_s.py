"""``cst_match_s``: seconds per sample of the program's phase
``identify/cst_search/match`` (the CST search's node-profile gathers and
their statistics, accumulated; ``timing.PHASE_TIMES``), averaged over
the window's samples that ran it."""

PHASE = "identify/cst_search/match"


def read(obs):
    vals = [r["phases"][PHASE] for r in obs["records"]
            if PHASE in r.get("phases", {})]
    return sum(vals) / len(vals) if vals else None
