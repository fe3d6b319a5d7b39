"""Run one cell of the benchmark once (see h100_bench/core.py):

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port
(`multi_modal_regression_tpu_torch`) beside this folder. Every build and
kernel cache goes to a fixed directory under the checkout's `build/`.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
sys.path.insert(0, str(ROOT))

from h100_bench.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
