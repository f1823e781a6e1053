"""CLI: ``python -m evfly_tpu_torch.train --config <file> [--key value ...]``.

As ``python -m evfly_tpu.train`` (reference ``learner/learner.py --config``,
learner.py:1274-1286): the config file gives the flags, the command line
overrides them.  Runs on the CUDA card; ``device = cpu`` (in the file or as
``--device cpu``) runs on the CPU.  Chunk-level data parallelism over N
cards: ``torchrun --nproc_per_node=N -m evfly_tpu_torch.train --config
<file> --dp_devices N`` (on one card, ``dp_devices = 1`` with
``dp_chunks_per_device = G``).
"""

from ..configs import argparsing
from .learner import Learner


def main():
    args = argparsing()
    print(args)
    if args.dp_devices > 1:
        # one process per card under torchrun: join its group first
        from ..parallel.mesh import init_from_env

        init_from_env()
    learner = Learner(args)
    try:
        learner.train_loop()
    except KeyboardInterrupt:
        print("[MAIN] Keyboard interrupt detected, exiting.")
        learner.logfile.close()


if __name__ == "__main__":
    main()
