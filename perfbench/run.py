"""Run one cell of the benchmark of evfly_tpu_torch on this machine's card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (JSON); the numbers compared with the reference, each beside its
limit, are the last lines of standard error.  Exits non-zero without a
result when the cell's cards are missing or the process loaded JAX or the
JAX package.  See perfbench/README.md.
"""

import time

T0 = time.perf_counter()  # set-up counts from here, before torch is imported

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# every cache the program or PyTorch may write, at fixed paths in the checkout
CACHE = ROOT / "build" / "perfbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
# the checkout's root in place of this script's folder, whose modules would
# shadow the standard library's (``trace``)
sys.path[:1] = [str(ROOT)]

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
