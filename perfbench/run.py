"""Runs one cell of BENCHMARK.json once on the card and prints its result as
the last line of standard output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or `python -m perfbench.run ...` from the root of the checkout). Exits with
a code other than 0, and prints no result, where no card is found.
"""
import os
import sys

if __package__ in (None, ''):
    # run as a script: the checkout's root, not this folder, leads the path,
    # so that this folder's modules cannot shadow the standard library's
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from perfbench import harness  # noqa: E402

if __name__ == '__main__':
    sys.exit(harness.main())
