"""The demo's model heuristics: point hints -> SAM -> pix2gestalt ->
matting -> amodal mask (port of the JAX package's `heuristics`), and the
host image operations they need (`host_ops`, cv2's arithmetic in numpy)."""

from .mask_heuristics import (MaskHeuristics, Pix2GestaltConfig,
                              get_points_from_components,
                              init_heuristics_, make_rmbg_matting_fn)

__all__ = ["MaskHeuristics", "Pix2GestaltConfig",
           "get_points_from_components", "init_heuristics_",
           "make_rmbg_matting_fn"]
