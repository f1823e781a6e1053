"""Runs the port's ``gpu``-marked tests (the voxelizer kernels, K1 over
time windows, K4 and K5, the graph step, the deployment loop, a train step,
the velocity heads' LSTM, the model zoo, the real-data path, the
simulator's render and one lockstep tick, the chunk-DP train step, the
open-loop probe's steps and the bf16 A/B's arms) on a
machine with a CUDA card and without JAX (the GPU machine):

    python3 tests/run_gpu_tests.py [REPO]

The test files import ``jax``, ``optax`` and the JAX package at module
level, for their CPU cases; no ``gpu`` test calls them.  So for collection
alone all three are replaced here by inert modules (any call raises), ``tests/conftest.py``
(which configures JAX) is skipped, and pytest runs ``-m gpu``.  REPO is the
checkout to test, by default the one holding this file.
"""

import importlib.abc
import importlib.machinery
import os
import sys
import types

REPO = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
FILES = ("tests/test_torch_voxelizer.py", "tests/test_torch_voxelizer_cluster.py",
         "tests/test_torch_lstm.py", "tests/test_torch_stream_graph.py",
         "tests/test_torch_hil.py", "tests/test_torch_train.py", "tests/test_torch_heads.py",
         "tests/test_torch_lstm_grid.py", "tests/test_torch_zoo.py", "tests/test_torch_events.py",
         "tests/test_torch_realdata.py", "tests/test_torch_render.py",
         "tests/test_torch_closed_loop.py", "tests/test_torch_parallel.py",
         "tests/test_torch_tools_openloop.py", "tests/test_torch_tools_bf16.py")
INERT = ("jax", "optax", "evfly_tpu")


class _Inert(types.ModuleType):
    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return _Inert(f"{self.__name__}.{name}")

    def __call__(self, *args, **kwargs):
        raise RuntimeError(f"{self.__name__}: JAX is not installed here")


class _InertFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """The packages of ``INERT`` (``evfly_tpu``, not ``evfly_tpu_torch``)
    and their submodules as inert modules."""

    def find_spec(self, name, path, target=None):
        if any(name == top or name.startswith(top + ".") for top in INERT):
            return importlib.machinery.ModuleSpec(name, self, is_package=True)
        return None

    def create_module(self, spec):
        module = _Inert(spec.name)
        module.__path__ = []
        return module

    def exec_module(self, module):
        pass


def main() -> int:
    import pytest

    sys.path.insert(0, REPO)
    sys.meta_path.insert(0, _InertFinder())
    os.chdir(REPO)
    return pytest.main(["-p", "no:cacheprovider", "--noconftest", "-m", "gpu", "-rA", "-q",
                        *FILES])


if __name__ == "__main__":
    sys.exit(main())
