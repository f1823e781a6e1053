"""CLI: ``python -m evfly_tpu_torch.train --config <file> [--key value ...]``.

As ``python -m evfly_tpu.train`` (reference ``learner/learner.py --config``,
learner.py:1274-1286): the config file gives the flags, the command line
overrides them.  Runs on the CUDA card; ``device = cpu`` (in the file or as
``--device cpu``) runs on the CPU.
"""

from ..configs import argparsing
from .learner import Learner


def main():
    args = argparsing()
    print(args)
    learner = Learner(args)
    try:
        learner.train_loop()
    except KeyboardInterrupt:
        print("[MAIN] Keyboard interrupt detected, exiting.")
        learner.logfile.close()


if __name__ == "__main__":
    main()
