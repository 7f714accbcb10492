#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the machine it starts on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It exits with a non-zero code and prints no
result where CUDA is not available or the cell asks for more cards than
there are, and where JAX or the JAX package was loaded. Its last line on
standard output is the run's result (``harness.main``).
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Build and kernel caches at fixed paths inside the checkout; a few host
# threads; libraries that could load JAX by themselves kept from it.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
for var, value in (("OMP_NUM_THREADS", "4"), ("USE_FLAX", "0"), ("USE_JAX", "0"),
                   ("USE_TF", "0")):
    os.environ[var] = value
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_process=T_PROCESS))
