"""``finish_ms.count``: milliseconds per sample of the stream-end fetch of
the counts (``ops.count.FETCHES``, every fetch's seconds), averaged over the
window's samples."""


def read(obs):
    vals = [r["finish_s"] for r in obs["records"] if "finish_s" in r]
    return 1e3 * sum(vals) / len(vals) if vals else None
