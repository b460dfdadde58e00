"""Dataset registry (reference `src/dataset/__init__.py:10-41`)."""

from __future__ import annotations

import os

from .base_depth_dataset import (BaseDepthDataset, DatasetMode,
                                 DepthFileNameMode)
from .loader import ConcatDataset, DataLoader, collate
from .mixed_sampler import MixedBatchSampler
from .sam_amodal_dataset import SAMAmodalDataset

__all__ = ["BaseDepthDataset", "DatasetMode", "DepthFileNameMode",
           "SAMAmodalDataset", "MixedBatchSampler", "DataLoader",
           "ConcatDataset", "collate", "get_dataset"]


def _resolve_filenames(path: str, base_data_dir: str) -> str:
    """Filename lists may be repo-relative (reference style,
    `data_split/sam/val.txt`) or live inside the data dir."""
    if os.path.isabs(path) or os.path.exists(path):
        return path
    cand = os.path.join(base_data_dir, path)
    return cand if os.path.exists(cand) else path


def get_dataset(cfg_data_split, base_data_dir: str, mode: DatasetMode, **kwargs):
    """The dataset a config split names: "sam", or "mixed" over a list of
    them. The JAX package's zero-shot evaluation datasets are not ported
    yet."""
    name = cfg_data_split["name"] if isinstance(cfg_data_split, dict) \
        else cfg_data_split.name
    cfg_dict = cfg_data_split if isinstance(cfg_data_split, dict) \
        else cfg_data_split.to_dict()
    cfg_dict = {k: v for k, v in cfg_dict.items() if k != "name"}

    if name == "mixed":
        if mode != DatasetMode.TRAIN:
            raise ValueError("mixed datasets are train-only")
        return [get_dataset(sub, base_data_dir, mode, **kwargs)
                for sub in cfg_dict["dataset_list"]]
    if name == "sam":
        cfg_dict.pop("dir", None)
        filenames = _resolve_filenames(cfg_dict.pop("filenames"), base_data_dir)
        return SAMAmodalDataset(mode=mode, filename_ls_path=filenames,
                                dataset_dir=base_data_dir, **cfg_dict, **kwargs)
    raise ValueError(f"unknown dataset: {name!r}")
