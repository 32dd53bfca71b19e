#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (style_transfer2_tpu_torch) on one
NVIDIA card: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. It builds the port's kernels into build/ there
(once), makes the inputs and weights from --seed, warms up the cell's shapes,
measures for --seconds, compares what the timed path produced with the plain
reference under benchmark/reference/, and prints one JSON line last: the
cell's end-to-end metrics (--trace 0) or its per-layer metrics (--trace 1).
Without a CUDA device it exits with 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from portbench.core import main  # noqa: E402

if __name__ == '__main__':
    sys.exit(main(t_start=T_START))
