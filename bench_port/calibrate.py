"""The readings the correctness limits are set from, for one cell:

    python bench_port/calibrate.py --workload <name> --seeds <n>... \\
        [--control <n>...] [--seconds 0.5] [--floors <cos>...]

For each seed a run of the cell's set-up, checked path and a short window
(the program's readings, the lower end of a limit); for each --control
seed also the control's readings (the reference in the program's place
with its blend in bfloat16, the upper end). One JSON line per run on
standard output. --floors (training cells of surfels) adds the facing
gaps at each floor of |cos| (loops/train.py:facing_gaps), from which the
cell's floor is chosen. On the card the cell's own sizes; the CPU tests hold the
same control at a small size (tests/test_bench_port_control.py).
"""

import argparse
import json
import os
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--floors", type=float, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    import torch

    from bench_port import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = harness.cell_of(args.workload)
    loop = harness.loop_of(cell["traffic"]["loop"])
    kw = {"floors": args.floors} if args.floors else {}
    for seed in args.seeds + [s for s in args.control if s not in args.seeds]:
        with tempfile.TemporaryDirectory(prefix="bench_port-") as tmp:
            t = time.time()
            out = loop.run(cell, seed, args.seconds, False, device, t, tmp, {})
            row = dict(workload=args.workload, seed=seed)
            if seed in args.control:
                row["control"], row["program"] = loop.control(cell, seed, out, device, **kw)
            else:
                row["program"] = loop.check(cell, seed, out, device, **kw)
            row["seconds"] = time.time() - t
            if seed not in args.seeds:
                row.pop("program")
        print(json.dumps(row), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
