"""Streaming inference of the joint model, one stream or G in lockstep."""

from .pipeline import BatchedStreamingPipeline, StreamingPipeline

__all__ = ["StreamingPipeline", "BatchedStreamingPipeline"]
