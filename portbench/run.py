"""Run one cell of the port's benchmark once (see harness.py):

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import time

T_START = time.perf_counter()  # set-up counts from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
