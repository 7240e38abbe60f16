"""Share of the traced window in which no kernel, copy or set ran on a
device (the harness's own ``torch.profiler`` trace), in percent; on a mesh
the mean over its devices."""


def read(obs):
    t = obs.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    busy = sum(t["busy_s"]) / len(t["busy_s"])
    return 100.0 * (1.0 - busy / t["window_s"])
