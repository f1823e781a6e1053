"""Training: the Learner's train, validate and checkpoint loop, its steps
and losses (``evfly_tpu/train`` on torch)."""

from .learner import Learner
from .losses import combined_loss, velocity_loss, vision_loss

__all__ = ["Learner", "combined_loss", "velocity_loss", "vision_loss"]
