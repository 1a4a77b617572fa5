"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``port_bench/``
and the program (``simplepathtracer_tpu_torch``).  The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with the reference beside its limit); the
same numbers are the last lines of standard error.  Without CUDA, with
fewer GPUs than the cell asks for, without the program, or with JAX or the
JAX package loaded, it prints no result and exits with a non-zero code.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def _environment():
    """Caches at fixed paths inside the checkout; no library loads JAX."""
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(cache / "inductor"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(BENCH_DIR) not in sys.path:
        sys.path.insert(0, str(BENCH_DIR))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from pb_core import harness, program

    try:
        result, checks = harness.run_cell(args.workload, args.seed, args.seconds,
                                          bool(args.trace))
    except harness.NoChip as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    except program.ProgramMissing as e:
        print(f"no result: {e}", file=sys.stderr)
        return 4
    harness.forbidden_or_exit()
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
