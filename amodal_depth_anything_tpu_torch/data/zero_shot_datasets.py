"""Zero-shot eval datasets for the shipped benchmark splits.

Port of the JAX package's `data/zero_shot_datasets.py`. The reference
ships split files for nyu / kitti / eth3d / diode / scannet / vkitti /
hypersim (`data_split/*`) but its dataset registry is EMPTY
(`src/dataset/__init__.py:8`), so it cannot load them; these loaders run
the zero-shot protocol those splits imply. Decodings follow the Marigold
conventions the split layouts come from:

  * NYUv2 (labeled): 16-bit PNG millimeters (/1000), filled-depth third
    column, depth range (1e-3, 10) m.
  * KITTI (eigen): 16-bit PNG /256, third column is the focal length
    (ignored for relative depth), range (1e-5, 80) m.
  * ETH3D: raw float32 blob at 4032x6048, inf = invalid, range (1e-5, inf).
  * DIODE: float32 .npy depth + .npy validity mask, range (0.6, 350) m.
  * ScanNet: 16-bit PNG millimeters, range (1e-3, 10) m.
  * VKITTI2: 16-bit PNG centimeters (/100), clipped range (1e-5, 80) m.
  * Hypersim (amodal splits): 16-bit PNG millimeters (planar depth),
    range (1e-5, 65) m.

PNGs decode through `utils/host_image.decode_png` (`BaseDepthDataset.
_read_image`), so the loaders run where PIL is not installed.
"""

from __future__ import annotations

import io

import numpy as np

from .base_depth_dataset import (BaseDepthDataset, DatasetMode,
                                 DepthFileNameMode)

__all__ = ["NYUDataset", "KITTIDataset", "ETH3DDataset", "DIODEDataset",
           "ScanNetDataset", "VirtualKITTIDataset", "HypersimDataset",
           "ZERO_SHOT_DATASETS"]


class NYUDataset(BaseDepthDataset):
    def __init__(self, **kw):
        kw.setdefault("min_depth", 1e-3)
        kw.setdefault("max_depth", 10.0)
        kw.setdefault("has_filled_depth", True)
        kw.setdefault("name_mode", DepthFileNameMode.rgb_id)
        kw.setdefault("disp_name", "nyu")
        super().__init__(**kw)

    def _read_depth_file(self, rel_path):
        return np.asarray(self._read_image(rel_path), np.float32) / 1000.0


class KITTIDataset(BaseDepthDataset):
    """Eigen split lines carry a trailing focal length, which the base
    class ignores (`has_filled_depth` stays off)."""

    def __init__(self, **kw):
        kw.setdefault("min_depth", 1e-5)
        kw.setdefault("max_depth", 80.0)
        kw.setdefault("name_mode", DepthFileNameMode.id)
        kw.setdefault("disp_name", "kitti")
        super().__init__(**kw)

    def _read_depth_file(self, rel_path):
        return np.asarray(self._read_image(rel_path), np.float32) / 256.0


class ETH3DDataset(BaseDepthDataset):
    HEIGHT, WIDTH = 4032, 6048

    def __init__(self, **kw):
        kw.setdefault("min_depth", 1e-5)
        kw.setdefault("max_depth", np.inf)
        kw.setdefault("name_mode", DepthFileNameMode.id)
        kw.setdefault("disp_name", "eth3d")
        super().__init__(**kw)

    def _read_depth_file(self, rel_path):
        depth = np.frombuffer(self._read_bytes(rel_path), np.float32).copy()
        depth[~np.isfinite(depth)] = 0.0  # inf = invalid -> below min_depth
        return depth.reshape(self.HEIGHT, self.WIDTH)


class DIODEDataset(BaseDepthDataset):
    def __init__(self, **kw):
        kw.setdefault("min_depth", 0.6)
        kw.setdefault("max_depth", 350.0)
        kw.setdefault("name_mode", DepthFileNameMode.id)
        kw.setdefault("disp_name", "diode")
        super().__init__(**kw)

    def _load_npy(self, rel_path):
        return np.load(io.BytesIO(self._read_bytes(rel_path)))

    def _read_depth_file(self, rel_path):
        return np.asarray(self._load_npy(rel_path), np.float32).squeeze()

    def _get_data_item(self, index):
        rasters, other = super()._get_data_item(index)
        line = self.filenames[index]
        if self.mode != DatasetMode.RGB_ONLY and len(line) > 2:
            # third column: validity-mask .npy, ANDed into the range mask
            mask = np.asarray(self._load_npy(line[2])).squeeze() > 0
            for key in ("valid_mask_raw", "valid_mask_filled"):
                rasters[key] = rasters[key] & mask[..., None]
        return rasters, other


class ScanNetDataset(BaseDepthDataset):
    def __init__(self, **kw):
        kw.setdefault("min_depth", 1e-3)
        kw.setdefault("max_depth", 10.0)
        kw.setdefault("name_mode", DepthFileNameMode.id)
        kw.setdefault("disp_name", "scannet")
        super().__init__(**kw)

    def _read_depth_file(self, rel_path):
        return np.asarray(self._read_image(rel_path), np.float32) / 1000.0


class VirtualKITTIDataset(BaseDepthDataset):
    def __init__(self, **kw):
        kw.setdefault("min_depth", 1e-5)
        kw.setdefault("max_depth", 80.0)
        kw.setdefault("name_mode", DepthFileNameMode.id)
        kw.setdefault("disp_name", "vkitti")
        super().__init__(**kw)

    def _read_depth_file(self, rel_path):
        depth_cm = np.asarray(self._read_image(rel_path), np.float32)
        return np.minimum(depth_cm / 100.0, self.max_depth)


class HypersimDataset(BaseDepthDataset):
    def __init__(self, **kw):
        kw.setdefault("min_depth", 1e-5)
        kw.setdefault("max_depth", 65.0)
        kw.setdefault("name_mode", DepthFileNameMode.rgb_id)
        kw.setdefault("disp_name", "hypersim")
        super().__init__(**kw)

    def _read_depth_file(self, rel_path):
        return np.asarray(self._read_image(rel_path), np.float32) / 1000.0


ZERO_SHOT_DATASETS = {
    "nyu_v2": NYUDataset,
    "nyu": NYUDataset,
    "kitti": KITTIDataset,
    "eth3d": ETH3DDataset,
    "diode": DIODEDataset,
    "scannet": ScanNetDataset,
    "vkitti": VirtualKITTIDataset,
    "hypersim": HypersimDataset,
}
