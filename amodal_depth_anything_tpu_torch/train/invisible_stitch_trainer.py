"""InvisibleStitch trainer: the discriminative skeleton with the model's
deviating call signature `model(x, invisible_mask=, observation=)`.

Port of the JAX package's `train/invisible_stitch_trainer.py` (reference
`invisible_stitch_trainer.py` diff @195-196,538-539). The reference has no
`entire_scene` strategy for it, so that strategy raises.
"""

from __future__ import annotations

import torch

from .trainer import DiscriminativeTrainer, TrainerConfig

__all__ = ["InvisibleStitchTrainer"]


class InvisibleStitchTrainer(DiscriminativeTrainer):
    def __init__(self, cfg: TrainerConfig, model, *args, **kwargs):
        if cfg.loss_strategy == "entire_scene":
            raise ValueError(
                "InvisibleStitch does not support the entire_scene strategy")
        super().__init__(cfg, model, *args, **kwargs)

    def _forward(self, batch: dict, remat) -> torch.Tensor:
        dtype = self.dtype
        return self.model(
            (batch["rgb_int"] / 255.0).to(dtype),
            invisible_mask=batch["invisible_mask"].to(dtype),
            observation=batch["depth_observation"].to(dtype))
