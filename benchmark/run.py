"""Run one benchmark cell once on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are named in ``BENCHMARK.json``; see ``benchlib/main.py``
for what a run does and prints.
"""

import time

T0 = time.perf_counter()     # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

if __name__ == "__main__":
    sys.path[:0] = [str(HERE), str(ROOT)]
    os.environ.setdefault("USE_FLAX", "0")
    from benchlib.main import main
    sys.exit(main(ROOT, sys.argv[1:], T0))
