"""The stream-end count fetch on one GPU, for any tree of the port
(``--root``), so a parent commit's finish is timed beside this one's in one
call: parent, change, change, parent, each tree in its own process.

* ``routes``: ``ops.count.fetch_counts`` on device vectors of
  identify-ecoli's 28,588,812 ids, each forced onto one route
  (:data:`ROUTES`: sparse and dense with values of one, two and four bytes,
  and all zeros), held bit-exact against a plain ``.cpu()`` of the same
  tensor and timed beside that copy, in turns (plain, fetch, fetch,
  plain): host wall seconds and CUDA-event ms; and the floor under any
  of them (:func:`host_floor`: the host's first write of a fresh int32
  result of that size, a rewrite, and the pinned copy of the whole vector).
  Needs a tree with ``fetch_counts``.
* ``identify``: the samples (``--samples``, default :data:`SAMPLES`) of
  ``bench/scale_fixture.py``'s fixture (``--fixture``; build it first)
  through ``run_identify`` on the GPU, once cold and ``--warm`` times warm
  (default :data:`WARM`), with each sample's phase
  seconds (``timing.PHASE_TIMES``).  Every
  ``CountPipeline.finish`` (the main count's, then the L2 union count's)
  is timed alone, the device synchronised before it, with its route and
  bytes from ``ops.count.FETCHES`` where the tree records fetches, else
  as the dense int32 copy of every id that a tree without them makes.
* ``count``: ``bench.count``'s ecoli tier (:data:`REPS` reps of its three
  passes) with the same record of each finish.

    python strainscan_tpu_torch/bench/fetch_study.py routes identify count \\
        [--root DIR] [--fixture DIR] [--samples single deep] [--warm N]

Prints one JSON line per study, each with the card's name and power limit.
Raises without a CUDA device: no number here comes from the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

# identify-ecoli's id space, and at most the keys a small sample touches
N_IDS = 28_588_812
SPARSE_NNZ = 710_000
# (route, bytes per value) of each routes case; "zeros" fetches dense u8
ROUTES = (("sparse", 1), ("sparse", 2), ("sparse", 4), ("dense", 1),
          ("dense", 2), ("dense", 4), ("zeros", 1))
SAMPLES = ("single", "crossmix", "deep")
WARM = 2
REPS = 3


def route_vector(route: str, vb: int, n: int, seed: int = 0) -> np.ndarray:
    """int32 ``[n]`` whose stats put it on ``route`` at ``vb`` bytes a value
    under the JAX rule: :data:`SPARSE_NNZ` nonzeros (``sparse``) or every
    entry nonzero (``dense``), below 2^8, below 2^16, or below 2^16 with
    one 2^20 (``vb`` = 4); ``zeros``: no nonzero."""
    a = np.zeros(n, np.int32)
    if route == "zeros":
        return a
    rng = np.random.default_rng(seed)
    top = {1: 255, 2: 65535, 4: 1 << 20}[vb]
    idx = (rng.choice(n, size=min(SPARSE_NNZ, n), replace=False)
           if route == "sparse" else np.arange(n))
    a[idx] = rng.integers(1, min(top, 65535) + 1, size=idx.size)
    a[idx[0]] = top
    return a


def _timed(fn) -> tuple:
    """``(host wall s, CUDA-event ms)`` of one call of ``fn``, which ends
    synchronised with the device."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    fn()
    wall = time.perf_counter() - t0
    stop.record()
    stop.synchronize()
    return wall, start.elapsed_time(stop)


def host_floor(dev) -> dict:
    """What any fetch of an int32 ``[N_IDS]`` result pays, each
    :data:`REPS` times: the host writing fresh memory of that size
    (``first_touch_s``, the page faults of a new array), writing it again
    (``rewrite_s``), and the copy of the whole int32 vector into a pinned
    buffer that is already mapped (``pinned_copy_s``, the link alone)."""
    import torch

    src = torch.ones(N_IDS, dtype=torch.int32, device=dev)
    pinned = torch.empty(N_IDS, dtype=torch.int32, pin_memory=True)
    kept = np.empty(N_IDS, np.int32)
    kept.fill(0)
    out: dict = {"first_touch_s": [], "rewrite_s": [], "pinned_copy_s": []}
    for _ in range(REPS):
        t0 = time.perf_counter()
        np.empty(N_IDS, np.int32).fill(1)
        out["first_touch_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        kept.fill(1)
        out["rewrite_s"].append(time.perf_counter() - t0)
        out["pinned_copy_s"].append(_timed(lambda: pinned.copy_(src))[0])
    return out


def routes(dev) -> dict:
    """Each route of ``fetch_counts`` at :data:`N_IDS`: bit-exact against
    ``.cpu()``, its record, and both timed in turns; and the
    :func:`host_floor`."""
    import torch

    from strainscan_tpu_torch.ops import count as ops_count

    out = {"host_floor": host_floor(dev)}
    for route, vb in ROUTES:
        t = torch.from_numpy(route_vector(route, vb, N_IDS)).to(dev)
        want = t.cpu().numpy()
        ops_count.reset_fetches()
        got = ops_count.fetch_counts(t, N_IDS)
        rec = ops_count.FETCHES[-1]
        expect = ("dense", 1) if route == "zeros" else (route, vb)
        if not np.array_equal(got, want):
            raise RuntimeError(f"fetch_counts differs from .cpu() on the "
                               f"{route} u{8 * vb} case")
        if (rec.route, rec.vb) != expect:
            raise RuntimeError(f"{route} u{8 * vb} took {rec}")
        fns = {"plain": lambda: t.cpu().numpy(),
               "fetch": lambda: ops_count.fetch_counts(t, N_IDS)}
        times = {name: [] for name in fns}
        for name in ("plain", "fetch", "fetch", "plain"):
            times[name].append(_timed(fns[name]))
        out[f"{route}_u{8 * vb}"] = {
            "route": rec.route, "vb": rec.vb, "nnz": rec.nnz,
            "d2h_bytes": rec.d2h_bytes,
            "fetch_s": [w for w, _ in times["fetch"]],
            "fetch_ms": [ms for _, ms in times["fetch"]],
            "plain_s": [w for w, _ in times["plain"]],
            "plain_ms": [ms for _, ms in times["plain"]],
            "plain_bytes": N_IDS * 4}
    return out


@contextlib.contextmanager
def finish_record(log: list):
    """While the body runs, time every ``CountPipeline.finish`` alone (the
    device synchronised first) and append its record to ``log``."""
    import torch

    from strainscan_tpu_torch.ops import count as ops_count

    cls, fetches = ops_count.CountPipeline, getattr(ops_count, "FETCHES",
                                                    None)
    finish = cls.finish

    def timed(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = finish(self)
        s = time.perf_counter() - t0
        if fetches is not None:
            log.append({**fetches[-1]._asdict(), "finish_s": s})
        else:   # a tree without the record copies every id as int32
            log.append({"route": "dense", "space": "id", "n": int(out.size),
                        "vb": 4, "d2h_bytes": int(out.size) * 4,
                        "soi_uploaded": None, "finish_s": s})
        return out

    cls.finish = timed
    try:
        yield
    finally:
        cls.finish = finish


def identify(dev, fixture: str, samples=SAMPLES, warm: int = WARM) -> dict:
    """``samples`` cold, then ``warm`` times warm, each sample's wall
    seconds, phase seconds and the record of each of its finishes."""
    from strainscan_tpu_torch.bench import scale_parity
    from strainscan_tpu_torch.config import IdentifyConfig
    from strainscan_tpu_torch.identify.pipeline import run_identify
    from strainscan_tpu_torch.timing import PHASE_TIMES

    meta = scale_parity.load_meta(fixture)
    fqs = scale_parity.sample_paths(fixture, meta)
    db = os.path.join(fixture, "DB")
    tmp = tempfile.mkdtemp(prefix="sst_fetch_")
    out: dict = {}
    try:
        for p in ["cold"] + [f"warm{i}" for i in range(warm)]:
            out[p] = {}
            for name in samples:
                log: list = []
                PHASE_TIMES.clear()
                with finish_record(log):
                    t0 = time.perf_counter()
                    ok = run_identify(fqs[name], "", db,
                                      os.path.join(tmp, p, name), dev.type,
                                      IdentifyConfig()) is not None
                    s = time.perf_counter() - t0
                if not ok:
                    raise RuntimeError(f"{p} {name}: no cluster detected")
                out[p][name] = {"s": s, "finishes": log,
                                "phases": dict(PHASE_TIMES)}
                print(f"[fetch_study] {p} {name}: {json.dumps(out[p][name])}",
                      file=sys.stderr, flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"n_keys": meta["n_keys"], "samples": out}


def count(dev) -> dict:
    """``bench.count``'s ecoli tier, :data:`REPS` reps, with every finish
    recorded (the first is the warm-up's, the last the host-oracle
    check's)."""
    from strainscan_tpu_torch.bench import count as bcount

    tier = next(t for t in bcount.TIERS if t[0] == "ecoli")
    log: list = []
    with finish_record(log):
        res = bcount.run(dev, tiers=(tier,), reps=REPS)
    detail = res["detail"]["ecoli"]
    return {"reads_s": res["value"], "times_s": detail["ours_times_s"],
            "finish_s": detail["breakdown"]["finish_s"],
            "d2h_MBps": res["detail"]["d2h_MBps"], "finishes": log}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("studies", nargs="+",
                    choices=("routes", "identify", "count"))
    ap.add_argument("--root", help="the tree of the port to import "
                    "(default: the one this file is in)")
    ap.add_argument("--fixture", help="bench/scale_fixture.py's root "
                    "(default: <the tree>/.scale_torch)")
    ap.add_argument("--samples", nargs="+", default=list(SAMPLES),
                    help="the fixture's samples that identify runs")
    ap.add_argument("--warm", type=int, default=WARM,
                    help="warm passes of identify")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path[0] = root   # run as a file: import the tree, not bench/
    else:
        sys.path.insert(0, root)
    import torch

    import strainscan_tpu_torch
    from strainscan_tpu_torch.bench import card_line, cuda_device

    dev = cuda_device("cuda")
    tree = os.path.dirname(os.path.dirname(os.path.abspath(
        strainscan_tpu_torch.__file__)))
    fixture = os.path.abspath(args.fixture or os.path.join(root,
                                                           ".scale_torch"))
    card = card_line()
    for name in args.studies:
        t0 = time.perf_counter()
        out = (routes(dev) if name == "routes" else
               identify(dev, fixture, args.samples, args.warm)
               if name == "identify" else count(dev))
        print(json.dumps({"study": name, "tree": tree, "card": card,
                          "torch": torch.__version__,
                          "study_s": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
