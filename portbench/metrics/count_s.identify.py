"""``count_s.identify``: seconds per sample of the program's phase ``identify/count``
(``timing.PHASE_TIMES``), averaged over the window's samples that ran
it."""


def read(obs):
    vals = [r["phases"]["identify/count"] for r in obs["records"]
            if "identify/count" in r.get("phases", {})]
    return sum(vals) / len(vals) if vals else None
