"""Streaming inference of the joint model, one stream or G in lockstep, and
the host-side deployment loop around it (accumulator, guarded runner)."""

from .accumulator import EventAccumulator, frame_from_accumulated
from .deploy import DeploymentRunner, SafetyConfig
from .pipeline import BatchedStreamingPipeline, StreamingPipeline

__all__ = ["EventAccumulator", "frame_from_accumulated", "StreamingPipeline",
           "BatchedStreamingPipeline", "DeploymentRunner", "SafetyConfig"]
