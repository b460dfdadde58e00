"""SAM/pix2gestalt amodal dataset (reference `src/dataset/sam_amodal_dataset.py:7-150`).

Layout derived from the depth entry in the filename list:
  depth/...                -> paths in occlusion/ (input rgb),
  visible_object_mask/ (visible mask, *_visible_mask.png),
  whole_mask/ (amodal "guide" mask), whole/ (un-occluded guide rgb);
  depth_da_update_occ/     -> observation pseudo-depth,
  depth_da_update_combine/ -> GT pseudo-depth (both uint16/65535).

Emitted keys (NHWC numpy): rgb_int, rgb_norm, guide_rgb_int,
guide_rgb_norm, guide, visible_mask, invisible_mask (= ~visible ∧ guide),
depth_observation, depth_gt, valid_mask_raw/filled (all-ones), index,
rgb_relative_path. `img_dropout` zeroes the guide RGB with prob p
(index-seeded; reference :100-113).
"""

from __future__ import annotations

import numpy as np

from .base_depth_dataset import (BaseDepthDataset, DatasetMode,
                                 DepthFileNameMode)

__all__ = ["SAMAmodalDataset"]


class SAMAmodalDataset(BaseDepthDataset):
    def __init__(self, **kwargs) -> None:
        kwargs.setdefault("min_depth", 0.0)
        kwargs.setdefault("max_depth", 1.0)
        kwargs.setdefault("has_filled_depth", False)
        kwargs.setdefault("name_mode", DepthFileNameMode.rgb_i_d)
        super().__init__(**kwargs)

    def _read_depth_file(self, rel_path: str) -> np.ndarray:
        return self._read_image(rel_path).astype(np.float32) / 65535.0

    def _get_data_path(self, index: int):
        line = self.filenames[index]
        depth_entry = line[1]
        rgb_rel_path = depth_entry.replace("depth", "occlusion")
        visible_path = depth_entry.replace("depth", "visible_object_mask") \
            .replace("_visible_object_mask.png", "_visible_mask.png")
        guide_path = depth_entry.replace("depth", "whole_mask")
        depth_rel_path = None
        if self.mode != DatasetMode.RGB_ONLY:
            depth_rel_path = (
                depth_entry.replace("depth/", "depth_da_update_occ/"),
                depth_entry.replace("depth/", "depth_da_update_combine/"),
            )
        return rgb_rel_path, depth_rel_path, None, visible_path, guide_path

    def _load_depth_data(self, depth_rel_path, filled_rel_path=None) -> dict:
        obs = np.asarray(self._read_depth_file(depth_rel_path[0]),
                         np.float32).squeeze()[..., None]
        gt = np.asarray(self._read_depth_file(depth_rel_path[1]),
                        np.float32).squeeze()[..., None]
        return {"depth_observation": obs, "depth_gt": gt}

    def _get_data_item(self, index: int):
        (rgb_rel_path, depth_rel_path, _filled, visible_path,
         guide_path) = self._get_data_path(index)
        rasters = dict(self._load_rgb_data(rgb_rel_path))
        guide_rgb = self._load_rgb_data(rgb_rel_path.replace("occlusion", "whole"))
        rasters["guide_rgb_int"] = guide_rgb["rgb_int"]
        rasters["guide_rgb_norm"] = guide_rgb["rgb_norm"]
        rasters["guide"] = (np.asarray(self._read_image(guide_path)) > 0) \
            .astype(np.float32).squeeze()[..., None]
        rasters["visible_mask"] = (np.asarray(self._read_image(visible_path)) > 0) \
            .astype(np.float32).squeeze()[..., None]
        if self.mode != DatasetMode.RGB_ONLY:
            rasters.update(self._load_depth_data(depth_rel_path))
            ones = np.ones_like(rasters["depth_gt"], bool)
            rasters["valid_mask_raw"] = ones
            rasters["valid_mask_filled"] = ones.copy()
        other = {"index": index, "rgb_relative_path": rgb_rel_path}
        return rasters, other

    def _training_preprocess(self, rasters: dict, rng) -> dict:
        if self.augm_args is not None:
            rasters = self._augment_data(rasters, rng)
        # no depth normalization / far-plane move: SAM pseudo-labels are [0,1]
        if self.img_dropout > 0.0 and rng.random() < self.img_dropout:
            rasters["guide_rgb_int"] = np.zeros_like(rasters["guide_rgb_int"])
            rasters["guide_rgb_norm"] = np.zeros_like(rasters["guide_rgb_norm"])
        return self._resize_all(rasters)

    def __getitem__(self, index: int) -> dict:
        rasters, other = self._get_data_item(index)
        if self.mode == DatasetMode.TRAIN:
            rasters = self._training_preprocess(rasters, self._rng(index))
        else:
            rasters = self._resize_all(rasters)
        rasters["invisible_mask"] = (
            np.logical_not(rasters["visible_mask"] > 0) &
            (rasters["guide"] > 0)).astype(np.float32)
        out = dict(rasters)
        out.update(other)
        return out
