"""End-to-end inference and serving: amodal depth (`amodal_pipeline`), the
generative DepthFM family (`depthfm_pipeline`), their programs captured as
CUDA graphs per batch bucket and serialised by `torch.export` (`aot`:
`save_*_artifact`, `Exported*Serving`), the micro-batching front end
(`server`), serving-state checkpoints (`serving_ckpt`), the quality gate
of parity-breaking knobs (`quality`) and the raw model's keep-aspect
inference (`raw_infer`)."""

from .amodal_pipeline import AmodalDepthPipeline, amodal_depth_graph
from .aot import (CapturedAmodalServing, CapturedDepthFMServing,
                  ExportedAmodalServing, ExportedDepthFMServing,
                  capture_amodal_program, capture_depthfm_program,
                  export_amodal_program, export_depthfm_program,
                  save_amodal_artifact, save_depthfm_artifact)
from .depthfm_pipeline import DepthFMPipeline
from .raw_infer import (constrain_to_multiple_of, image2tensor_np,
                        infer_image, keep_aspect_size)
from .server import MicroBatcher

__all__ = ["AmodalDepthPipeline", "DepthFMPipeline", "MicroBatcher",
           "CapturedAmodalServing", "CapturedDepthFMServing",
           "capture_amodal_program", "capture_depthfm_program",
           "ExportedAmodalServing", "ExportedDepthFMServing",
           "export_amodal_program", "export_depthfm_program",
           "save_amodal_artifact", "save_depthfm_artifact",
           "amodal_depth_graph", "constrain_to_multiple_of",
           "image2tensor_np", "infer_image", "keep_aspect_size"]
