"""What every driver shares: the cell, the device, the seeded weights, the
steps kept for the check, and the errors' bookkeeping.

A driver's interface, as the harness calls it: ``setup()``; ``step(k,
keep)`` (one timed step; with ``keep`` it holds what the check needs of
step k); ``forget(k)``; ``sync()``; ``least_s(k)`` (class -> least seconds
of step k's kernels); ``free_program()``; ``check()`` (name -> number
compared); ``control()`` (the same numbers with the reference in TF32 in
the program's place); ``model_flops()``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable

import torch

from .. import weights
from ..counts import model_flops
from ..reference import models


@contextlib.contextmanager
def tf32(on: bool):
    """The reference's precision: full f32, or TF32 (the control)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Errors:
    """Per name, the largest |program - reference| and the largest
    |reference| seen: the number compared is their ratio."""

    def __init__(self):
        self.diff: Dict[str, float] = {}
        self.scale: Dict[str, float] = {}

    def add(self, name: str, got, ref) -> None:
        got, ref = torch.as_tensor(got), torch.as_tensor(ref)
        got = got.to(ref.device, torch.float32).reshape(ref.shape)
        d = float((got - ref).abs().max()) if got.numel() else 0.0
        if got.numel() and not bool(torch.isfinite(got).all()):
            d = float("inf")
        self.diff[name] = max(self.diff.get(name, 0.0), d)
        self.scale[name] = max(self.scale.get(name, 0.0), float(ref.abs().max()))

    def numbers(self) -> Dict[str, float]:
        return {n: self.diff[n] / max(self.scale[n], 1e-30) for n in self.diff}


class Driver:
    def __init__(self, cell):
        self.cell, self.dev = cell, cell.device
        self.traffic, self.config = cell.traffic, cell.config
        self.check_samples = self.traffic["check_samples"]
        self.start_steps = self.traffic["check_start_steps"]
        self.steps_done = 0
        self.kept: Dict[int, dict] = {}

    def always_keep(self) -> Iterable[int]:
        return ()

    def forget(self, k: int) -> None:
        self.kept.pop(k, None)

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def least_s(self, k: int) -> Dict[str, float]:
        return {}

    def make_weights(self):
        shapes = {"joint": models.joint_shapes, "vitlstm": models.vitlstm_shapes}[
            self.config["model"]]()
        return weights.init_state_dict(shapes, self.cell.seed, self.dev)

    def joint_program(self, sd):
        """The port's joint model, built as its drivers build it, holding
        a copy of the benchmark's weights."""
        from evfly_tpu_torch.models.composites import OrigUNet_w_VITFLY_ViTLSTM

        H, W = self.config["input_hw"]
        model = OrigUNet_w_VITFLY_ViTLSTM(device=self.dev, input_shape=[1, 1, H, W],
                                          **self.config["program"])
        return model.load_params({k: v.clone() for k, v in sd.items()})

    def free_program(self) -> None:
        for name in self.program_attrs:
            setattr(self, name, None)

    def model_flops(self) -> Dict[str, float]:
        with torch.no_grad():
            return model_flops.count(self.flops_step)
