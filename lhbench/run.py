"""Run one cell of the benchmark once; see ``lhbench/harness.py``.

    python3 lhbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import sys
import time

T_PROCESS = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from lhbench import harness

    sys.exit(harness.main(sys.argv[1:], T_PROCESS))
