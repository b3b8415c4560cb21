"""Run one cell of the benchmark once, in this process.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Needs a CUDA card (no fallback to the CPU);
prints the cell's result as one JSON line, the last line of standard
output.  ``BENCHMARK.json`` names the cells; ``benchmark/core/`` holds the
harness, which names no cell and no metric.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from benchmark.core import harness
    return harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), t_start=_T0)


if __name__ == "__main__":
    sys.exit(main())
