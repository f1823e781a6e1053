"""evfly_tpu_torch: the PyTorch and CUDA port of evfly_tpu, for NVIDIA Hopper.

The serving path of the JAX package, ported: raw events -> fused
voxelize / 97th-percentile normalize / bilinear resize (``ops.voxelizer``,
CUDA kernel ``csrc/voxelizer.cu``) -> ``models.vitfly.LSTMNetVIT`` with its
stacked LSTM as one CUDA kernel (``ops.lstm_fused``, ``csrc/lstm.cu``); the
streaming deployment path (``stream``) and training (``train.Learner``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see ``device.resolve_device``), and compute in full f32
unless the caller asks for TF32 with ``set_precision("tf32")`` (see
``precision``).  On CPU tensors every kernel wrapper takes its plain PyTorch
version.  The package imports neither JAX nor anything of ``evfly_tpu``.
"""

from .device import resolve_device
from .precision import get_precision, set_precision

__all__ = ["get_precision", "resolve_device", "set_precision"]
