"""Synthetic SAM-amodal fixture generator.

The reference's training data (pix2gestalt_occlusions_release, ~480k
samples) is external and its train split is a missing LFS blob
(SURVEY.md §2.6) — so the training pipeline must be testable without it.
This writes a miniature on-disk tree with the exact directory layout the
SAMAmodalDataset expects (occlusion/ whole/ whole_mask/
visible_object_mask/ depth_da_update_occ/ depth_da_update_combine/ and a
filename list), with geometrically consistent masks/depths.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["make_synthetic_sam_tree"]


def _silhouette(rng, hw: int) -> np.ndarray:
    """Random rectangle or ellipse mask [hw,hw] bool."""
    yy, xx = np.mgrid[:hw, :hw]
    cy, cx = rng.integers(hw // 6, hw - hw // 6, 2)
    ry = rng.integers(hw // 8, hw // 3)
    rx = rng.integers(hw // 8, hw // 3)
    if rng.random() < 0.5:
        return (np.abs(yy - cy) < ry) & (np.abs(xx - cx) < rx)
    return ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0


def _render_scene(rng, hw: int):
    """Layered geometric scene: depth-ordered colored shapes over a
    gradient background. Returns (rgb_occluded, rgb_whole, scene_depth,
    amodal_depth, whole_mask, visible_mask) — a genuinely LEARNABLE
    amodal-depth task (depth is a deterministic function of the visible
    geometry; the target object's hidden extent is recoverable from its
    visible part), with piecewise-smooth images whose trained-token
    similarity structure a quality proxy needs (token
    merging is meaningless on noise images / random weights).

    Depth convention follows the fixture's disparity-like maps: larger =
    nearer, background 0.1, objects in (0.2, 0.95)."""
    gx, gy = np.meshgrid(np.linspace(0, 1, hw), np.linspace(0, 1, hw))
    c0, c1 = rng.random(3) * 0.5, rng.random(3) * 0.5 + 0.25
    t = (gx * rng.random() + gy * rng.random())[..., None]
    bg = c0 + (c1 - c0) * t / max(t.max(), 1e-6)

    n_obj = int(rng.integers(3, 6))
    depths = np.sort(rng.uniform(0.2, 0.95, n_obj))  # far -> near
    shapes = [_silhouette(rng, hw) for _ in range(n_obj)]
    colors = [rng.random(3) * 0.8 + 0.1 for _ in range(n_obj)]

    def paint(order):
        img = bg.copy()
        dep = np.full((hw, hw), 0.1, np.float32)
        for k in order:
            m = shapes[k]
            # mild per-object shading so tokens inside an object are
            # similar but not identical
            shade = 1.0 - 0.15 * (gy[m] - gy[m].min())
            img[m] = colors[k] * shade[:, None]
            dep[m] = depths[k]
        return img, dep

    rgb_occ, scene_depth = paint(range(n_obj))

    # amodal target: the most-occluded non-top object (retries happen at
    # the caller level if nothing is occluded)
    occ_frac = []
    for k in range(n_obj - 1):
        nearer = np.zeros((hw, hw), bool)
        for j in range(k + 1, n_obj):
            nearer |= shapes[j]
        area = max(int(shapes[k].sum()), 1)
        occ_frac.append(float((shapes[k] & nearer).sum()) / area)
    k_t = int(np.argmax(occ_frac))

    whole_mask = shapes[k_t]
    nearer = np.zeros((hw, hw), bool)
    for j in range(k_t + 1, n_obj):
        nearer |= shapes[j]
    visible = whole_mask & ~nearer

    # whole image: target painted last (un-occluded view)
    rgb_whole, _ = paint([j for j in range(n_obj) if j != k_t] + [k_t])
    amodal_depth = scene_depth.copy()
    amodal_depth[whole_mask] = depths[k_t]
    frac = occ_frac[k_t]
    return (rgb_occ, rgb_whole, scene_depth, amodal_depth,
            whole_mask, visible, frac)


def make_synthetic_sam_tree(root: str, n: int = 4, hw: int = 64,
                            seed: int = 0, style: str = "noise") -> str:
    """Create the tree under `root`; returns the filename-list path.

    style="noise" (default): the original random-noise fixtures — fast,
    exercises the data plumbing. style="scenes": layered geometric
    scenes (`_render_scene`) — a learnable amodal-depth task for
    training the structured-weight quality proxy
    (scripts/train_proxy.py)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    dirs = ["occlusion", "whole", "whole_mask", "visible_object_mask",
            "depth", "depth_da_update_occ", "depth_da_update_combine"]
    for d in dirs:
        os.makedirs(os.path.join(root, d), exist_ok=True)

    if style == "scenes":
        lines = []
        for i in range(n):
            # resample until the target is partially (not fully) occluded
            for attempt in range(100):
                (rgb_f, whole_f, sdep, adep, wm, vm,
                 frac) = _render_scene(rng, hw)
                if 0.05 < frac < 0.95 and vm.sum() > 4:
                    break
            else:
                # never fall through silently: a degenerate sample (fully
                # occluded / unoccluded target) would poison the proxy
                # corpus and fail the geometric-consistency tests
                # seed-dependently
                raise RuntimeError(
                    f"scenes sample {i}: no valid occlusion after "
                    f"{attempt + 1} renders (last frac={frac:.3f}, "
                    f"visible px={int(vm.sum())})")
            rgb = (np.clip(rgb_f, 0, 1) * 255).astype(np.uint8)
            whole_rgb = (np.clip(whole_f, 0, 1) * 255).astype(np.uint8)
            stem = f"{i:04d}"
            Image.fromarray(rgb).save(
                os.path.join(root, "occlusion", f"{stem}_occlusion.png"))
            Image.fromarray(whole_rgb).save(
                os.path.join(root, "whole", f"{stem}_whole.png"))
            Image.fromarray((wm * 255).astype(np.uint8)).save(
                os.path.join(root, "whole_mask", f"{stem}_occlusion.png"))
            Image.fromarray((vm * 255).astype(np.uint8)).save(os.path.join(
                root, "visible_object_mask", f"{stem}_occlusion.png"))
            Image.fromarray((sdep * 65535).astype(np.uint16)).save(
                os.path.join(root, "depth_da_update_occ",
                             f"{stem}_occlusion.png"))
            Image.fromarray((adep * 65535).astype(np.uint16)).save(
                os.path.join(root, "depth_da_update_combine",
                             f"{stem}_occlusion.png"))
            lines.append(f"occlusion/{stem}_occlusion.png "
                         f"depth/{stem}_occlusion.png")
        list_path = os.path.join(root, "train.txt")
        with open(list_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return list_path

    lines = []
    for i in range(n):
        rgb = (rng.random((hw, hw, 3)) * 255).astype(np.uint8)
        whole_rgb = (rng.random((hw, hw, 3)) * 255).astype(np.uint8)

        # amodal object: a rectangle; occluder hides its right part
        y0, x0 = rng.integers(4, hw // 3, 2)
        y1, x1 = y0 + hw // 3, x0 + hw // 2
        whole_mask = np.zeros((hw, hw), np.uint8)
        whole_mask[y0:y1, x0:x1] = 255
        visible = whole_mask.copy()
        visible[:, (x0 + x1) // 2:] = 0

        depth = (rng.random((hw, hw)) * 0.5 + 0.25)
        depth_occ = (depth * 65535).astype(np.uint16)
        depth_combine = (np.clip(depth + 0.1 * (whole_mask > 0), 0, 1)
                         * 65535).astype(np.uint16)

        stem = f"{i:04d}"
        Image.fromarray(rgb).save(os.path.join(root, "occlusion",
                                               f"{stem}_occlusion.png"))
        # the dataset derives the whole-RGB path by replacing "occlusion" ->
        # "whole" in the FULL relative path (directory AND filename), and the
        # visible mask keeps the depth entry's basename — mirror that here.
        Image.fromarray(whole_rgb).save(os.path.join(root, "whole",
                                                     f"{stem}_whole.png"))
        Image.fromarray(whole_mask).save(os.path.join(root, "whole_mask",
                                                      f"{stem}_occlusion.png"))
        Image.fromarray(visible).save(os.path.join(
            root, "visible_object_mask", f"{stem}_occlusion.png"))
        Image.fromarray(depth_occ).save(os.path.join(
            root, "depth_da_update_occ", f"{stem}_occlusion.png"))
        Image.fromarray(depth_combine).save(os.path.join(
            root, "depth_da_update_combine", f"{stem}_occlusion.png"))
        # the filename list references rgb + depth/ entries; loaders rewrite
        # "depth" into the sibling dirs (sam_amodal_dataset path derivation)
        lines.append(f"occlusion/{stem}_occlusion.png depth/{stem}_occlusion.png")

    list_path = os.path.join(root, "train.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return list_path
