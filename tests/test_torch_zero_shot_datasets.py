"""The port's zero-shot evaluation datasets, `scripts.zero_shot_eval` and
`scripts.precomputed_eval` against the JAX package's on the same fixtures
(the layouts of tests/test_zero_shot_datasets.py): every array each loader
returns equal to the JAX loader's, the split-file layouts parsed into the
same rows, and the two scripts' metric tables equal within 1e-4 relative
(float32 metric sums in another order; the vitt raw model at 56 px, plain
attention). The dataset's PNG decode (`utils/host_image.decode_png`)
against PIL on 8-bit RGB and 16-bit grey."""

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from amodal_depth_anything_tpu.data import DatasetMode as JaxDatasetMode
from amodal_depth_anything_tpu.data import get_dataset as jax_get_dataset
from amodal_depth_anything_tpu_torch.data import DatasetMode, get_dataset
from amodal_depth_anything_tpu_torch.data.base_depth_dataset import \
    BaseDepthDataset
from tests.test_torch_models import few_torch_threads  # noqa: F401


def _write_rgb(path, hw=(8, 10), seed=0):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    Image.fromarray((rng.random((*hw, 3)) * 255).astype(np.uint8)).save(path)


def _write_u16(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr.astype(np.uint16)).save(path)


def _nyu(d):
    _write_rgb(os.path.join(d, "rgb_0001.png"))
    depth = np.zeros((8, 10), np.uint16)
    depth[2, 3] = 2500
    depth[5, 6] = 12000   # beyond 10 m: invalid
    _write_u16(os.path.join(d, "depth_0001.png"), depth)
    filled = depth.copy()
    filled[0, 0] = 1000
    _write_u16(os.path.join(d, "filled_0001.png"), filled)
    return "rgb_0001.png depth_0001.png filled_0001.png\n"


def _kitti(d):
    _write_rgb(os.path.join(d, "img.png"))
    depth = np.zeros((8, 10), np.uint16)
    depth[1, 1] = 256 * 42
    depth[3, 4] = 256 * 90
    _write_u16(os.path.join(d, "gt.png"), depth)
    return "img.png gt.png 721.5377\n"


def _eth3d(d):
    _write_rgb(os.path.join(d, "rgb.png"), hw=(4, 6))
    depth = np.full((4, 6), np.inf, np.float32)
    depth[1, 2] = 3.25
    with open(os.path.join(d, "depth.bin"), "wb") as f:
        f.write(depth.tobytes())
    return "rgb.png depth.bin\n"


def _diode(d):
    _write_rgb(os.path.join(d, "a.png"))
    np.save(os.path.join(d, "a_depth.npy"),
            np.full((8, 10, 1), 5.0, np.float32))
    mask = np.zeros((8, 10), np.float32)
    mask[4, 4] = 1.0
    np.save(os.path.join(d, "a_mask.npy"), mask)
    return "a.png a_depth.npy a_mask.npy\n"


def _mm(d):
    _write_rgb(os.path.join(d, "rgb_0.png"))
    depth = np.zeros((8, 10), np.uint16)
    depth[3, 3] = 4200
    depth[6, 1] = 7000
    _write_u16(os.path.join(d, "d_0.png"), depth)
    return "rgb_0.png d_0.png\n"


def _vkitti(d):
    _write_rgb(os.path.join(d, "rgb.jpg"))
    depth = np.zeros((8, 10), np.uint16)
    depth[0, 0] = 65535
    depth[5, 5] = 1234
    _write_u16(os.path.join(d, "d.png"), depth)
    return "rgb.jpg d.png\n"


FIXTURES = {"nyu_v2": _nyu, "nyu": _nyu, "kitti": _kitti, "eth3d": _eth3d,
            "diode": _diode, "scannet": _mm, "hypersim": _mm,
            "vkitti": _vkitti}


@pytest.mark.parametrize("mode", ["EVAL", "RGB_ONLY"])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_loader_arrays_equal_the_jax_loaders(tmp_path, monkeypatch, name,
                                             mode):
    from amodal_depth_anything_tpu.data import zero_shot_datasets as jzs
    from amodal_depth_anything_tpu_torch.data import zero_shot_datasets as zs
    for mod in (jzs, zs):
        monkeypatch.setattr(mod.ETH3DDataset, "HEIGHT", 4)
        monkeypatch.setattr(mod.ETH3DDataset, "WIDTH", 6)
    root = str(tmp_path)
    d = os.path.join(root, name)
    os.makedirs(d)
    lst = os.path.join(root, f"{name}.txt")
    with open(lst, "w") as f:
        f.write(FIXTURES[name](d))
    cfg = {"name": name, "dir": name, "filenames": lst}
    ours = get_dataset(cfg, root, getattr(DatasetMode, mode))
    ref = jax_get_dataset(dict(cfg), root, getattr(JaxDatasetMode, mode))
    assert type(ours).__name__ == type(ref).__name__
    assert ours.disp_name == ref.disp_name and len(ours) == len(ref)
    a, b = ours[0], ref[0]
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(b[key], np.ndarray):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


# the shipped split files' layouts (data_split/*): (line, columns)
SPLIT_LAYOUTS = {
    "kitti": ("2011_09_26/x/image_02/data/0000000005.png "
              "2011_09_26_drive/proj_depth/groundtruth/image_02/"
              "0000000005.png 721.5377", 3),
    "eth3d": ("rgb/courtyard/images/dslr_images/DSC_0286.JPG "
              "depth/courtyard/ground_truth_masks/dslr_images/DSC_0286.JPG", 2),
    "diode": ("val/indoors/scene_00019/scan_00183/00019_00183_indoors_000_010"
              ".png val/indoors/scene_00019/scan_00183/00019_00183_indoors_"
              "000_010_depth.npy val/indoors/scene_00019/scan_00183/00019_"
              "00183_indoors_000_010_depth_mask.npy", 3),
    "scannet": ("scene0000_00/color/000000.jpg "
                "scene0000_00/depth/000000.png", 2),
    "hypersim": ("ai_001_010/rgb_cam_00_fr0000.png "
                 "ai_001_010/depth_plane_cam_00_fr0000.png", 2),
    "nyu_v2": ("test/bathroom/rgb_0045.png test/bathroom/depth_0045.png "
               "test/bathroom/filled_0045.png", 3),
}


@pytest.mark.parametrize("name", sorted(SPLIT_LAYOUTS))
def test_split_file_layouts_parse_as_the_jax_loaders_parse_them(tmp_path,
                                                                name):
    line, ncols = SPLIT_LAYOUTS[name]
    lst = tmp_path / "split.txt"
    lst.write_text(f"{line}\n\n{line}\n")
    cfg = {"name": name, "dir": "", "filenames": str(lst)}
    ours = get_dataset(cfg, str(tmp_path), DatasetMode.EVAL)
    ref = jax_get_dataset(dict(cfg), str(tmp_path), JaxDatasetMode.EVAL)
    assert ours.filenames == ref.filenames
    assert len(ours) == 2 and all(len(r) == ncols for r in ours.filenames)
    for i in range(len(ours)):
        assert ours._get_data_path(i) == ref._get_data_path(i)


@pytest.mark.parametrize("kind", ["rgb8", "gray16", "gray8"])
def test_read_image_decodes_pngs_as_pil(tmp_path, kind):
    """`_read_image` decodes PNGs in numpy (no PIL on the card's machine):
    the same arrays as PIL for 8-bit RGB, 16-bit grey (the zero-shot sets'
    depth) and 8-bit grey masks."""
    rng = np.random.default_rng(7)
    arr = {"rgb8": (rng.random((13, 17, 3)) * 255).astype(np.uint8),
           "gray16": (rng.random((13, 17)) * 65535).astype(np.uint16),
           "gray8": (rng.random((13, 17)) * 255).astype(np.uint8)}[kind]
    Image.fromarray(arr).save(tmp_path / "a.png")
    (tmp_path / "list.txt").write_text("a.png a.png\n")
    ds = BaseDepthDataset(DatasetMode.EVAL, str(tmp_path / "list.txt"),
                          str(tmp_path))
    ours = ds._read_image("a.png")
    ref = np.asarray(Image.open(io.BytesIO((tmp_path / "a.png")
                                           .read_bytes())))
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


@pytest.fixture(scope="module")
def nyu_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("nyu_zero_shot")
    d = root / "data"
    d.mkdir()
    rng = np.random.default_rng(0)
    lines = []
    for i in range(5):
        Image.fromarray((rng.random((64, 80, 3)) * 255).astype(np.uint8)
                        ).save(d / f"rgb_{i:04d}.png")
        _write_u16(str(d / f"depth_{i:04d}.png"),
                   (rng.random((64, 80)) * 8000 + 500).astype(np.uint16))
        lines.append(f"rgb_{i:04d}.png depth_{i:04d}.png depth_{i:04d}.png")
    (root / "list.txt").write_text("\n".join(lines))
    from amodal_depth_anything_tpu.models.amodal_dav2 import DAV2Config
    from tests.test_models import _fake_torch_sd
    sd, _ = _fake_torch_sd(DAV2Config(encoder="vitt", guide_type="none",
                                      raw=True), seed=3)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               root / "base.pth")
    return root


def _close_tables(ours, ref):
    assert ours.keys() == ref.keys()
    for key in ref:
        assert abs(ours[key] - ref[key]) <= 1e-4 * max(1.0, abs(ref[key])), \
            key


@pytest.mark.parametrize("align", ["depth", "disparity"])
def test_zero_shot_eval_matches_jax(nyu_tree, align):
    from amodal_depth_anything_tpu.scripts import \
        zero_shot_eval as jax_zero_shot_eval
    from amodal_depth_anything_tpu_torch.scripts import zero_shot_eval
    args = ["--dataset", "nyu_v2", "--base_data_dir",
            str(nyu_tree / "data"), "--filenames", str(nyu_tree / "list.txt"),
            "--checkpoint", str(nyu_tree / "base.pth"), "--encoder", "vitt",
            "--size", "56", "--batch", "2", "--align", align]
    ref = jax_zero_shot_eval.main(args)
    out = nyu_tree / f"eval_{align}.txt"
    ours = zero_shot_eval.main(args + ["--device", "cpu",
                                       "--output_file", str(out)])
    _close_tables(ours, ref)
    assert "abs_relative_difference" in out.read_text()


def test_precomputed_eval_matches_jax(tmp_path, capsys):
    from amodal_depth_anything_tpu.scripts import \
        precomputed_eval as jax_precomputed_eval
    from amodal_depth_anything_tpu_torch.scripts import precomputed_eval
    rng = np.random.default_rng(5)
    dirs = {k: tmp_path / k for k in ("pred", "gt", "obs", "vis", "whole")}
    for p in dirs.values():
        p.mkdir()
    for i, sid in enumerate(["scene_0001", "scene_0002", "b", "c"]):
        yy, xx = np.mgrid[:40, :48]
        whole = ((yy > 8) & (yy < 32) & (xx > 6) & (xx < 40))
        vis = whole & (xx < 12 + 6 * i)
        for key in ("pred", "gt", "obs"):
            _write_u16(str(dirs[key] / f"{sid}_depth.png"),
                       rng.random((40, 48)) * 60000 + 1000)
        Image.fromarray((vis * 255).astype(np.uint8)).save(
            dirs["vis"] / f"{sid}_visible_mask.png")
        Image.fromarray((whole * 255).astype(np.uint8)).save(
            dirs["whole"] / f"{sid}_whole_mask.png")
    args = ["--pred_dir", str(dirs["pred"]), "--gt_dir", str(dirs["gt"]),
            "--obs_dir", str(dirs["obs"]), "--visible_dir", str(dirs["vis"]),
            "--whole_dir", str(dirs["whole"]), "--size", "32"]
    jax_precomputed_eval.main(args)
    ref_text = capsys.readouterr().out
    ours = precomputed_eval.main(args + ["--device", "cpu"])
    our_text = capsys.readouterr().out
    assert set(ours) == {"align_easy", "align_mid", "align_diff",
                         "align_overall"}
    ref_vals = [float(v) for line in ref_text.splitlines()[2::3]
                for v in line.split()]
    our_vals = [float(v) for line in our_text.splitlines()[2::3]
                for v in line.split()]
    assert len(ref_vals) == len(our_vals) == 12
    for a, b in zip(our_vals, ref_vals):
        assert (np.isnan(a) and np.isnan(b)) or \
            abs(a - b) <= 1e-4 * max(1.0, abs(b))
