"""Run one cell of the benchmark once.

    python3 uvmbench/run.py --workload paper11.oversub --seed 7 \\
        --seconds 30 --trace 0

Run it from the root of a checkout on a machine with the cards the cell
asks for.  It exits with 2, printing no result, where there is no card.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
# the package is imported as ``uvmbench``, never its files as top-level names
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
for _path in (os.path.join(_ROOT, "src"), _ROOT):
    if _path not in sys.path:
        sys.path.insert(0, _path)

if __name__ == "__main__":
    from uvmbench import harness
    sys.exit(harness.main(sys.argv[1:], T_START))
