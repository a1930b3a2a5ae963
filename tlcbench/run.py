"""Run one cell of the port's benchmark once, on the card:

    python3 tlcbench/run.py --workload NAME --seed N --seconds S --trace 0|1

The last line of standard output is the result's JSON object; the last
lines of standard error give each number compared with its limit.  The
exit code is 0 when a result was printed (correct or not) and 2 when
the run could produce none: no card, fewer cards than the cell asks
for, a file of the benchmark or the program missing, or a module loaded
that may not be (``jax``, ``jaxlib``, ``flax``, the JAX package).
"""

import time

T0 = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from tlcbench import harness

    harness.clean_env()
    try:
        harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace), T0)
    except (harness.CellError, ImportError, OSError) as e:
        traceback.print_exc()
        print(f"tlcbench: no result: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
