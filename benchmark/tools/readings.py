"""The readings that the limits of a cell's output check are set from.

  python3 benchmark/tools/readings.py --workload <name> --seeds 1 2 3 ... [--seconds 1]

Runs the cell's driver once a seed in this one process, each with a short
window at the cell's own sizes, and reads beside the program's compared
numbers the control's: the reference computed one precision below the
configuration's (``run(..., control=True)``), and where the driver has
them, other sound readings (the reference summed in another order).  ``--fault`` plants one of
``harness/faults.py``'s faults in the timed path first.  Prints one JSON line a seed
and writes them to ``--out`` when given.  The benchmark's own runs never
run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from harness import core, registry  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default="")
    p.add_argument("--fault", default="", help="plant a fault of harness/faults.py first")
    p.add_argument("--program-only", action="store_true", help="read no control")
    args = p.parse_args(argv)
    core.set_cache_dirs(HERE)
    cell = registry.Cell(args.workload, root=os.path.dirname(HERE))
    sys.path.insert(0, cell.root)
    driver = cell.driver()
    if args.fault:
        from harness import faults

        faults.plant(cell.traffic["driver"], args.fault)
    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = driver.run(cell, seed, args.seconds, False, t0, control=not args.program_only)
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                "correct": out.correct,
                "program": {c.name: c.value for c in out.checks},
                "limits": {c.name: c.limit for c in out.checks}, "notes": out.notes,
                "e2e": out.e2e, "memory_peak_bytes": out.memory_peak_bytes,
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
