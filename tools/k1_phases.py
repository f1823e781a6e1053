"""K1's phases of chip_smoke.py alone, on one NVIDIA GPU.

    python3 tools/k1_phases.py

Builds the kernels, then runs chip_smoke.py's phases for K1 and nothing
else: the route rules against the library's (the K3 phase's first step is
``_route_rules``), K1 on every route against its plain version with its
times at 260x346 and shape C (``phase_k1``), and the dataset path with K1
over time windows on every route, timed at 260x346 and shapes A and B,
with the band route's two kernels split by torch.profiler
(``phase_dataset``).  About 30 s after the build; its log is chip_smoke.py's
for those phases.  Exits non-zero without a CUDA device or when a check
fails.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_phases: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    with cs.Phase("device"):
        _, smi = cs.phase_device()
    with cs.Phase("build"):
        cs.phase_build()
    with cs.Phase("route rules"):
        cs._route_rules()
    flush = cs.L2Flush(dev)
    with cs.Phase("K1 vs plain"):
        cs.log(f"K1 entries: {cs.phase_k1(dev, flush)}")
    with cs.Phase("K1 over time windows"):
        cs.log(f"dataset entries: {cs.phase_dataset(dev, flush, smi)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
