"""One run of one cell of the port's benchmark.

    python bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell, its configuration, traffic,
limits and per-layer metrics are found by name from BENCHMARK.json (see
bench_port/harness.py). The last line of standard output is the result's
JSON object; the numbers compared for `correct` are also the last lines of
standard error. Exits 3, printing no result, without as many CUDA devices
as the cell asks for.
"""

import time

PROCESS_T0 = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the checkout's root, not this directory, heads the path: a module here
    # must not stand in for a library module of the same name
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from bench_port import harness

    return harness.main(args.workload, args.seed, args.seconds, bool(args.trace), PROCESS_T0)


if __name__ == "__main__":
    sys.exit(main())
