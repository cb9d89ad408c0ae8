"""The readings that ``ml.lm_moe_train``'s limits are set from, with the
MoE cell's planted faults.

  python3 benchmark/tools/moe_readings.py --workload ml.lm_moe_train --seeds 1 2 3 ... \\
      [--seconds 1] [--fault NAME] [--program-only] [--out FILE]

``tools/readings.py`` with ``harness/moe.py``'s faults (``bias_dropped``,
``held_norm``, ``scale_dropped``, ``shared_dropped``, ``balance_dropped``,
and the LM cell's ``half_batch`` and ``state_unchanged``) under
``--fault``: its lines, one a seed, name the fault.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import readings  # noqa: E402
from harness import faults, moe  # noqa: E402


def main(argv=None) -> int:
    faults.FAULTS.update({("lm_moe_train", name): f for name, f in moe.FAULTS.items()})
    return readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())
