"""End-to-end inference and serving: amodal depth (`amodal_pipeline`), the
generative DepthFM family (`depthfm_pipeline`), their programs captured as
CUDA graphs per batch bucket (`aot`), the micro-batching front end
(`server`), serving-state checkpoints (`serving_ckpt`) and the quality gate
of parity-breaking knobs (`quality`)."""

from .amodal_pipeline import AmodalDepthPipeline, amodal_depth_graph
from .aot import (CapturedAmodalServing, CapturedDepthFMServing,
                  capture_amodal_program, capture_depthfm_program)
from .depthfm_pipeline import DepthFMPipeline
from .server import MicroBatcher

__all__ = ["AmodalDepthPipeline", "DepthFMPipeline", "MicroBatcher",
           "CapturedAmodalServing", "CapturedDepthFMServing",
           "capture_amodal_program", "capture_depthfm_program",
           "amodal_depth_graph"]
