"""The control: the reference at 16-bit fingerprints put in the program's
place, judged by the cell's own comparison against its reference (exact
counts for a count cell; the 32-bit table's counts and what follows them
for an identify cell).  A narrower fingerprint row is the step a later
change would be tempted by (half the bytes a probe reads); it breaks the
configurations' stated guarantee that counts are exact up to the 32-bit
fingerprint's strays.  A sound limit fails it on every seed.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

Runs no program code beyond the DB build of an identify cell's first use;
prints one JSON line per seed: the readings beside the limits.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

CONTROL_BITS = 16


def readings(reg: harness.Registry, cell: str, seed: int, devices: list,
             cache: str = harness.CACHE, bits: int = CONTROL_BITS) -> dict:
    driver = reg.module("drivers", reg.json(
        "traffic", reg.cell(cell)["traffic"])["driver"])
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        run = harness.Run(reg, cell, seed, 0, False, devices, tmp, cache)
        t0 = time.perf_counter()
        driver.make_inputs(run)
        want = driver.reference(run)
        got = driver.reference(run, bits)
        checks = driver.compare(list(enumerate(got)), want)
    return {"workload": cell, "seed": seed, "fp_bits": bits,
            "s": time.perf_counter() - t0,
            "checks": {c.name: {"value": c.value, "limit": c.limit,
                                "fails": not c.ok} for c in checks}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    reg = harness.Registry(os.path.join(os.getcwd(), "BENCHMARK.json"))
    try:
        devices = harness.cuda_devices(1)
    except harness.NoCard as e:
        print(f"[portbench] {e}", file=sys.stderr)
        return 3
    for seed in args.seeds:
        print(json.dumps(readings(reg, args.workload, seed, devices)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
