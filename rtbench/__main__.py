"""python3 -m rtbench --workload <name> --seed <n> --seconds <s> --trace <0|1>"""

import time

T0 = time.perf_counter()   # the process's start, for setup_s

import sys  # noqa: E402

from .run import main  # noqa: E402

sys.exit(main(T0))
