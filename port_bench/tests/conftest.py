"""The benchmark's own tests: the harness's files, its reference against the
program's plain routes on the CPU, its control and faults.  Run from the
repository's root: ``python -m pytest port_bench/tests -q`` (CPU; tests
that need a GPU carry the ``cuda`` marker and skip without one)."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
