"""Run one cell of the parc_torch benchmark once, on the card:

    python3 benchmark/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result as one JSON object; the numbers compared with the reference are the
last lines of standard error. See benchmark/README.md.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

from harness import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(sys.argv[1:], T0))
