"""Trainer for the ADDeepLab two-head baseline.

Port of the JAX package's `train/amodalsynthdrive_trainer.py` (reference
`AmodalSynthDriveTrainer`, `src/trainer/amodalsynthdrive_trainer.py:
34-733`): the loss combines the two sigmoid heads with the occlusion weight

    w_occ * loss(invisible_pred over amodal & valid)
    + (1 - w_occ) * loss(visible_pred over ~amodal & valid)

(reference :216-234; w_occ from the config, 0.7 in `configs/deeplab.yaml`).
The train step runs the model with `train=True`: BatchNorm normalises with
batch statistics and moves its running statistics in place (the JAX step
threads them as `new_bn`); they are buffers, outside the optimizer, as the
JAX step zeroes their gradients and overwrites their update. Evaluation
runs `train=False` and scores the invisible head under the shared protocol
(on-device scale / shift alignment to the observation over the visible
mask).
"""

from __future__ import annotations

import torch

from ..ops.resize import resize_nearest
from .trainer import DiscriminativeTrainer, TrainerConfig

__all__ = ["AmodalSynthDriveTrainer"]


class AmodalSynthDriveTrainer(DiscriminativeTrainer):
    def __init__(self, cfg: TrainerConfig, model, *args, w_occ: float = 0.7,
                 **kwargs):
        self.w_occ = w_occ
        super().__init__(cfg, model, *args, **kwargs)

    def _heads(self, batch: dict, train: bool):
        dtype = self.dtype
        return self.model((batch["rgb_int"] / 255.0).to(dtype),
                          batch["guide"].to(dtype), train=train,
                          attn_impl=self.cfg.attn_impl)

    def loss_of(self, batch: dict, draws: dict | None = None) -> torch.Tensor:
        cfg = self.cfg
        vis, invis = self._heads(batch, True)
        gt = batch[cfg.gt_depth_type]
        size = tuple(gt.shape[1:3])
        vis = resize_nearest(vis.float(), size=size)
        invis = resize_nearest(invis.float(), size=size)
        valid = batch[cfg.gt_mask_type] > 0
        amodal = batch["guide"] > 0
        loss = (self.w_occ * self.loss_fn(invis, gt, valid & amodal)
                + (1.0 - self.w_occ) * self.loss_fn(vis, gt, valid & ~amodal))
        return torch.where(torch.isfinite(loss), loss, 0.0)

    def _forward(self, batch: dict, remat) -> torch.Tensor:
        """The invisible head (eval mode), which evaluation scores."""
        return self._heads(batch, False)[1]
