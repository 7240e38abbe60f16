"""``l2_vote_s``: seconds per sample of the program's phase ``identify/l2_vote``
(``timing.PHASE_TIMES``), averaged over the window's samples that ran
it."""


def read(obs):
    vals = [r["phases"]["identify/l2_vote"] for r in obs["records"]
            if "identify/l2_vote" in r.get("phases", {})]
    return sum(vals) / len(vals) if vals else None
