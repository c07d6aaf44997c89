"""Run one cell of the benchmark once:

    python3 portbench/run.py --workload <config>.<mix> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as the last line of
standard output, and each number the check compared, beside its limit,
as the last lines of standard error. Exits 2 without a result where
torch sees fewer CUDA devices than the cell asks for.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    harness.set_cache_dirs()
    sys.exit(harness.main(sys.argv[1:], T0 - harness.process_age_s()))
