"""``l2_dominant_s``: seconds per sample of the program's phase
``identify/l2_vote/prescan/dominant`` (the Pre-Scan's choice of the
dominant strain and its depth; ``timing.PHASE_TIMES``, summed over the
sample's clusters), averaged over the window's samples that ran it."""

PHASE = "identify/l2_vote/prescan/dominant"


def read(obs):
    vals = [r["phases"][PHASE] for r in obs["records"]
            if PHASE in r.get("phases", {})]
    return sum(vals) / len(vals) if vals else None
