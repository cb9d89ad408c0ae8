"""Run one cell of the benchmark once, on this machine's cards.

  python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell (``BENCHMARK.json``'s workloads)
names a configuration (``benchmark/configs``) and a traffic mix
(``benchmark/traffic``), which names its driver (``benchmark/drivers``).
The driver makes the weights and the inputs from ``--seed``, loads the
port, warms up the cell's shapes (set-up), measures for ``--seconds``, and
then compares what the timed path produced with the plain reference
(``benchmark/reference``).  With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(``benchmark/metrics``, one reader a metric) and the device trace of a
traced window.  The last line of standard output is one JSON object; the
compared numbers and their limits are the last lines of standard error.

Exits 3 without a result where there is no card or too few, and 4 where
the process loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from harness import core, registry  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(cell, seed: int, seconds: float, trace: bool, t_start: float,
            device: str = "cuda") -> tuple:
    """Run the cell once on ``device``: (the result line, the driver's notes
    and the compared numbers beside their limits, for standard error)."""
    outcome = cell.driver().run(cell, seed, seconds, trace, t_start, device=device)
    if trace:
        metrics = {}
        for m in cell.per_layer():
            value = cell.reader(m["name"]).read(outcome.ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": outcome.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end()}
    text = "notes " + json.dumps(outcome.notes) + "\n" + core.checks_text(outcome.checks)
    return core.result_line(outcome, metrics, cell.chips), text


def main(argv=None) -> int:
    args = parse_args(argv)
    core.set_cache_dirs(HERE)
    cell = registry.Cell(args.workload, root=os.path.dirname(HERE))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, cell.root)  # the port, from the checkout
    line, checks = execute(cell, args.seed, args.seconds, bool(args.trace), T_START)
    found = core.forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {', '.join(found)}", file=sys.stderr)
        return 4
    print(line)
    sys.stdout.flush()
    print(checks, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
