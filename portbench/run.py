"""Run one cell of ``BENCHMARK.json`` once on this host's CUDA devices.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (data from ``--seed``, the program's state, one warm-up sample)
counts into ``setup_s``; then samples run in a closed loop for
``--seconds``; then the plain reference judges what the window produced.
The last line of standard output is the result object; the numbers compared
with the reference, each beside its limit, close standard error.  Exits 3
without a result when the host has fewer CUDA devices than the cell asks
for, 4 when JAX or the JAX package was loaded, and 5 when an input is not
the one the configuration states (an identify DB of another digest).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(harness.CACHE, _sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    reg = harness.Registry(os.path.join(os.getcwd(), "BENCHMARK.json"))
    chips = reg.cell(args.workload)["chips"]
    try:
        devices = harness.cuda_devices(chips)
    except harness.NoCard as e:
        print(f"[portbench] {e}", file=sys.stderr)
        return 3
    try:
        out = harness.execute(reg, args.workload, args.seed, args.seconds,
                              bool(args.trace), devices, T_START)
    except harness.JaxLoaded as e:
        print(f"[portbench] {e}", file=sys.stderr)
        return 4
    except harness.BadInput as e:
        print(f"[portbench] {e}", file=sys.stderr)
        return 5
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
