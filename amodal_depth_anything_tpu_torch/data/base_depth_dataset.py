"""Filename-list depth datasets (host-side, numpy, NHWC).

The JAX package's re-design of the reference data layer
(`src/dataset/base_depth_dataset.py:40-267`), kept as it is: every sample is
a dict of numpy arrays in NHWC (the layout of the port's public functions),
and
all randomness is *index-seeded* (`(base_seed, epoch, index)`) instead of
global-RNG-order-dependent, so any worker/shard layout reproduces the same
stream and mid-epoch resume is exact.

Semantics preserved from the reference:
  * filename lists: whitespace-separated rgb/depth relative paths
    (`base_depth_dataset.py:81-84`), tar archive support (:87-92,175-186);
  * valid mask = min_depth < d < max_depth (:200-204);
  * train preprocess: LR-flip augmentation (:239-245), depth normalizer,
    invalid -> far plane (:220-228), NEAREST_EXACT resize (:231-236);
  * modes RGB_ONLY / EVAL / TRAIN (:19-22) and prediction file naming
    modes (:253-267).
"""

from __future__ import annotations

import enum
import io
import os
import tarfile
from typing import Sequence

import numpy as np

from ..ops.resize import _nearest_indices

__all__ = ["DatasetMode", "DepthFileNameMode", "BaseDepthDataset",
           "resize_nearest_exact_np"]


class DatasetMode(enum.Enum):
    RGB_ONLY = "rgb_only"
    EVAL = "evaluate"
    TRAIN = "train"


class DepthFileNameMode(enum.Enum):
    id = 1        # id.png
    rgb_id = 2    # rgb_id.png
    i_d_rgb = 3   # i_d_1_rgb.png
    rgb_i_d = 4


def resize_nearest_exact_np(img: np.ndarray, hw: Sequence[int]) -> np.ndarray:
    """NEAREST_EXACT resize of [H,W,...] numpy array (torch semantics)."""
    h, w = img.shape[:2]
    rows = _nearest_indices(h, int(hw[0]), exact=True)
    cols = _nearest_indices(w, int(hw[1]), exact=True)
    return img[rows][:, cols]


class BaseDepthDataset:
    """Map-style dataset over a filename list; subclasses override the
    `_read_depth_file` decoding and path derivation."""

    def __init__(
        self,
        mode: DatasetMode,
        filename_ls_path: str,
        dataset_dir: str,
        disp_name: str = "",
        min_depth: float = 0.0,
        max_depth: float = 1.0,
        has_filled_depth: bool = False,
        name_mode: DepthFileNameMode = DepthFileNameMode.id,
        depth_transform=None,
        augmentation_args=None,
        resize_to_hw=None,
        move_invalid_to_far_plane: bool = True,
        img_dropout: float = 0.0,
        seed: int = 0,
        **_unused,
    ) -> None:
        self.mode = mode
        self.filename_ls_path = filename_ls_path
        self.dataset_dir = dataset_dir
        if not os.path.exists(dataset_dir):
            raise FileNotFoundError(f"dataset dir does not exist: {dataset_dir}")
        self.disp_name = disp_name
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.has_filled_depth = has_filled_depth
        self.name_mode = name_mode
        self.depth_transform = depth_transform
        self.augm_args = augmentation_args
        self.resize_to_hw = resize_to_hw
        self.move_invalid_to_far_plane = move_invalid_to_far_plane
        self.img_dropout = img_dropout
        self.seed = seed
        self.epoch = 0

        with open(filename_ls_path) as f:
            self.filenames = [line.split() for line in f if line.strip()]

        self._tar = None
        self.is_tar = os.path.isfile(dataset_dir) and tarfile.is_tarfile(dataset_dir)

    # --------------------------------------------------------------- basics

    def __len__(self) -> int:
        return len(self.filenames)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, index]))

    # ------------------------------------------------------------------- io

    def _read_image(self, img_rel_path: str) -> np.ndarray:
        if self.is_tar:
            if self._tar is None:
                self._tar = tarfile.open(self.dataset_dir)
            data = self._tar.extractfile("./" + img_rel_path).read()
        else:
            with open(os.path.join(self.dataset_dir, img_rel_path), "rb") as f:
                data = f.read()
        # PIL decode (the JAX package's fallback branch; its native codec
        # is not ported)
        from PIL import Image
        return np.asarray(Image.open(io.BytesIO(data)))

    def _read_rgb_file(self, rel_path: str) -> np.ndarray:
        return self._read_image(rel_path)  # [H,W,3] uint8 (kept HWC)

    def _read_depth_file(self, rel_path: str) -> np.ndarray:
        return self._read_image(rel_path)

    # ------------------------------------------------------------ components

    def _load_rgb_data(self, rgb_rel_path: str) -> dict:
        rgb = self._read_rgb_file(rgb_rel_path).astype(np.float32)
        return {
            "rgb_int": rgb,  # [H,W,3] in [0,255]
            "rgb_norm": rgb / 255.0 * 2.0 - 1.0,
        }

    def _load_depth_data(self, depth_rel_path, filled_rel_path=None) -> dict:
        raw = np.asarray(self._read_depth_file(depth_rel_path),
                         np.float32).squeeze()[..., None]  # [H,W,1]
        out = {"depth_raw_linear": raw.copy()}
        if self.has_filled_depth and filled_rel_path is not None:
            filled = np.asarray(self._read_depth_file(filled_rel_path),
                                np.float32).squeeze()[..., None]
            out["depth_filled_linear"] = filled
        else:
            out["depth_filled_linear"] = raw.copy()
        return out

    def _get_data_path(self, index: int):
        line = self.filenames[index]
        rgb_rel_path = line[0]
        depth_rel_path = filled_rel_path = None
        if self.mode != DatasetMode.RGB_ONLY:
            depth_rel_path = line[1]
            if self.has_filled_depth and len(line) > 2:
                filled_rel_path = line[2]
        return rgb_rel_path, depth_rel_path, filled_rel_path

    def _get_valid_mask(self, depth: np.ndarray) -> np.ndarray:
        return (depth > self.min_depth) & (depth < self.max_depth)

    def _get_data_item(self, index: int):
        rgb_rel_path, depth_rel_path, filled_rel_path = self._get_data_path(index)
        rasters = dict(self._load_rgb_data(rgb_rel_path))
        if self.mode != DatasetMode.RGB_ONLY:
            rasters.update(self._load_depth_data(depth_rel_path, filled_rel_path))
            rasters["valid_mask_raw"] = self._get_valid_mask(
                rasters["depth_raw_linear"]).copy()
            rasters["valid_mask_filled"] = self._get_valid_mask(
                rasters["depth_filled_linear"]).copy()
        other = {"index": index, "rgb_relative_path": rgb_rel_path}
        return rasters, other

    # ---------------------------------------------------------- preprocessing

    def _augment_data(self, rasters: dict, rng: np.random.Generator) -> dict:
        lr_flip_p = getattr(self.augm_args, "lr_flip_p", None) \
            if not isinstance(self.augm_args, dict) \
            else self.augm_args.get("lr_flip_p")
        if lr_flip_p and rng.random() < lr_flip_p:
            rasters = {k: np.ascontiguousarray(v[:, ::-1])
                       for k, v in rasters.items()}
        return rasters

    def _resize_all(self, rasters: dict) -> dict:
        if self.resize_to_hw is None:
            return rasters
        return {k: resize_nearest_exact_np(v, self.resize_to_hw)
                for k, v in rasters.items()}

    def _training_preprocess(self, rasters: dict, rng) -> dict:
        if self.augm_args is not None:
            rasters = self._augment_data(rasters, rng)
        if self.depth_transform is not None:
            rasters["depth_raw_norm"] = np.asarray(self.depth_transform(
                rasters["depth_raw_linear"], rasters["valid_mask_raw"]))
            rasters["depth_filled_norm"] = np.asarray(self.depth_transform(
                rasters["depth_filled_linear"], rasters["valid_mask_filled"]))
            if self.move_invalid_to_far_plane:
                far = (self.depth_transform.norm_max
                       if getattr(self.depth_transform, "far_plane_at_max", True)
                       else self.depth_transform.norm_min)
                invalid = ~rasters["valid_mask_filled"]
                rasters["depth_filled_norm"][invalid] = far
        return self._resize_all(rasters)

    def __getitem__(self, index: int) -> dict:
        rasters, other = self._get_data_item(index)
        if self.mode == DatasetMode.TRAIN:
            rasters = self._training_preprocess(rasters, self._rng(index))
        out = dict(rasters)
        out.update(other)
        return out

