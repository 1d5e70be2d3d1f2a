"""Entry point of the benchmark; see `benchmark/harness.py`.

    python3 benchmark/run.py --workload synth20.layer --seed 1 --seconds 10 --trace 0
"""

import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
