"""Qualitative pix2gestalt baseline: depth on ONE pre-computed
reconstruction.

Port of the JAX package's `scripts/pix2gestalt_eval_single.py` (the
reference's `src/scripts/pix2gestalt_eval_single.py`): given a
pix2gestalt whole-object reconstruction, the raw scene depth and the
visible mask, run the frozen DAV2 on the reconstruction, min-max normalise,
and least-squares align it to the scene depth over the visible region;
write both 16-bit maps. The reference's protocol (:108-148): inputs resized
to 256 with PIL's default (bicubic) filter, the model input bilinear-resized
to 266 (= 14 x 19), the depth nearest-resized back to 256, uint16/65535.

Images are read and written by the port's host codec (JPEG through the
native decoder): no PIL, cv2 or matplotlib.

    python -m amodal_depth_anything_tpu_torch.scripts.pix2gestalt_eval_single \\
        --reconstruction pred_reconstructions.jpg \\
        --raw_depth depth_raw.png --visible_mask visible_mask.png \\
        --checkpoint work_dir/ckp/depth_anything_v2_vitg.pth \\
        --output_dir out/ [--device cpu]
"""

from __future__ import annotations

import argparse
import os

__all__ = ["build_parser", "make_dav2_apply", "main"]


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reconstruction", required=True,
                   help="pix2gestalt whole-object RGB render")
    p.add_argument("--raw_depth", required=True,
                   help="16-bit scene depth PNG (the alignment target)")
    p.add_argument("--visible_mask", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="raw DAV2 torch .pth / safetensors")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--size", type=int, default=266,
                   help="model input size (multiple of 14; reference 266)")
    p.add_argument("--out_size", type=int, default=256)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    return p


def make_dav2_apply(model, size: int, out_size: int | None = None):
    """u8 [S,S,3] -> the min-max normalised depth of `model` on it,
    bilinear-resized to `size` on the way in; [1, size, size] float32
    numpy, or nearest-resized back to `out_size` when given."""
    import numpy as np
    import torch

    from ..ops.resize import resize2d, resize_nearest

    device = next(model.parameters()).device
    dtype = next(model.parameters()).dtype

    @torch.no_grad()
    def apply(img_u8: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(img_u8, np.float32)).to(device)
        x = resize2d(x[None] / 255.0, size=(size, size), method="bilinear")
        d = model(x.to(dtype)).float()
        d = (d - d.min()) / torch.clamp(d.max() - d.min(), min=1e-8)
        if out_size is not None:
            d = resize_nearest(d[..., None], size=(out_size, out_size))[..., 0]
        return d.cpu().numpy()

    return apply


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from ..utils.alignment import align_depth_least_square_np
    from ..utils.image import read_image, read_rgb, resize_default, write_png
    from .sam_pl_gen import load_raw_dav2

    s = args.out_size
    rec = resize_default(read_rgb(args.reconstruction), (s, s))
    gt_depth = resize_default(read_image(args.raw_depth), (s, s)
                              ).astype(np.float32) / 65535.0
    vis = resize_default(read_image(args.visible_mask), (s, s)) > 0
    if vis.ndim == 3:
        vis = vis[..., 0]

    model = load_raw_dav2(args.checkpoint, torch.device(args.device))
    depth = make_dav2_apply(model, args.size, s)(rec)[0]

    os.makedirs(args.output_dir, exist_ok=True)
    write_png(os.path.join(args.output_dir, "pred_depth.png"),
              (depth * 65535.0).astype(np.uint16))
    aligned, scale, shift = align_depth_least_square_np(gt_depth, depth, vis)
    write_png(os.path.join(args.output_dir, "combined_depth.png"),
              (np.clip(aligned, 0, 1) * 65535.0).astype(np.uint16))
    print(f"scale={float(scale):.5f} shift={float(shift):.5f}")
    return depth, aligned


if __name__ == "__main__":
    main()
