"""``l2_prescan_s``: seconds per sample of the program's phase
``identify/l2_vote/prescan`` (the L2 vote's Pre-Scan, each voted cluster's
``detect_strains`` up to the Elastic-Net: the column sums, the dominant
search and the scan rounds; ``timing.PHASE_TIMES``, summed over the
sample's clusters), averaged over the window's samples that ran it."""

PHASE = "identify/l2_vote/prescan"


def read(obs):
    vals = [r["phases"][PHASE] for r in obs["records"]
            if PHASE in r.get("phases", {})]
    return sum(vals) / len(vals) if vals else None
