"""Runs one cell of BENCHMARK.json once (see ``perfbench/harness.py``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:]))
