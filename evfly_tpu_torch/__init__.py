"""evfly_tpu_torch: the PyTorch and CUDA port of evfly_tpu, for NVIDIA Hopper.

The serving path of the JAX package, ported: raw events -> fused
voxelize / 97th-percentile normalize / bilinear resize (``ops.voxelizer``,
CUDA kernel ``csrc/voxelizer.cu``) -> ``models.vitfly.LSTMNetVIT`` with its
stacked LSTM as one CUDA kernel (``ops.lstm_fused``, ``csrc/lstm.cu``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see ``device.resolve_device``).  On CPU tensors every
kernel wrapper takes its plain PyTorch version.  The package imports
neither JAX nor anything of ``evfly_tpu``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
