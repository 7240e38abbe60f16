"""``union_count_s``: seconds per sample of the program's phase
``identify/l2_vote/union_count`` (the L2 vote's union count: the union's
keys, its table and its count of the sample; ``timing.PHASE_TIMES``),
averaged over the window's samples that ran it."""

PHASE = "identify/l2_vote/union_count"


def read(obs):
    vals = [r["phases"][PHASE] for r in obs["records"]
            if PHASE in r.get("phases", {})]
    return sum(vals) / len(vals) if vals else None
