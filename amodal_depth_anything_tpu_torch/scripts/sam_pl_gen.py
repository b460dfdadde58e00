"""Pseudo-label factory: composite amodal depth GT from a frozen DAV2.

Port of the JAX package's `scripts/sam_pl_gen.py` (the reference's
`src/scripts/sam_pl_gen_dav2.py:40-152`): for each pix2gestalt sample, run
the frozen base DAV2 on the whole (un-occluded) render and on the occluded
render, min-max normalise both, least-squares align the whole depth to the
occluded depth over the visible mask (`utils.alignment.fit_scale_shift`),
and composite the aligned whole depth into the occluded depth under the
whole mask -> `depth_da_update_combine/` (the occluded depth ->
`depth_da_update_occ/`), both uint16/65535 PNGs resized to `--out_size`
with PIL's default (bicubic) filter. `--data_index` / `--num_chunks` split
the work as `np.array_split` does (SLURM arrays).

Images are read and written by the port's host codec (`utils.image`,
`utils.host_image`): no PIL, cv2 or matplotlib.

    python -m amodal_depth_anything_tpu_torch.scripts.sam_pl_gen \\
        --data_root /data/pix2gestalt_occlusions_release \\
        --base_ckpt work_dir/ckp/depth_anything_v2_vitg.pth \\
        --data_index 0 --num_chunks 12 [--batch 8] [--device cpu]

The DAV2 forwards compute in the checkpoint's dtype (`load_raw_dav2`).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

__all__ = ["build_parser", "make_label_fn", "load_raw_dav2", "main"]


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", required=True,
                   help="pix2gestalt_occlusions_release root")
    p.add_argument("--base_ckpt", required=True)
    p.add_argument("--data_index", type=int, default=0)
    p.add_argument("--num_chunks", type=int, default=1)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=518)
    p.add_argument("--out_size", type=int, default=512)
    p.add_argument("--encoder", type=str, default="vitg")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    return p


def load_raw_dav2(path: str, device):
    """The raw DAV2 module of a reference `.pth` / `.safetensors` on
    `device`, in eval mode, computing in the file's floating dtype (the
    released float32 files as the JAX script computes; a bfloat16 file in
    bfloat16)."""
    import torch

    from ..convert.weights import infer_dav2_config, load_state_dict
    from ..models.amodal_dav2 import build_model
    from ..ops.precision import apply_precision_policy

    sd = load_state_dict(path)
    dtype = next((v.dtype for v in sd.values() if v.is_floating_point()),
                 torch.float32)
    model = build_model(infer_dav2_config(sd, raw=True), device=device)
    model.load_state_dict(sd, strict=True)
    apply_precision_policy(dtype)
    return model.to(dtype).eval()


def make_label_fn(model):
    """(whole, occ [B,S,S,3] in [0,1], visible, whole_mask [B,S,S,1]) ->
    (occ_depth, combined) [B,S,S] float32 in [0,1], on the model's device."""
    import torch

    from ..utils.alignment import fit_scale_shift

    dtype = next(model.parameters()).dtype

    @torch.no_grad()
    def label(whole_img, occ_img, visible_mask, whole_mask):
        def depth_of(img):
            d = model(img.to(dtype)).float()
            lo = d.amin(dim=(-1, -2), keepdim=True)
            hi = d.amax(dim=(-1, -2), keepdim=True)
            return (d - lo) / torch.clamp(hi - lo, min=1e-8)

        whole_depth = depth_of(whole_img)
        occ_depth = depth_of(occ_img)
        scale, shift = fit_scale_shift(whole_depth, occ_depth,
                                       visible_mask[..., 0])
        aligned = whole_depth * scale[:, None, None] + shift[:, None, None]
        combined = torch.where(whole_mask[..., 0] > 0, aligned, occ_depth)
        return occ_depth, combined

    return label


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from ..data.base_depth_dataset import resize_nearest_exact_np
    from ..utils.image import read_image, read_rgb, resize_default, write_png

    device = torch.device(args.device)
    model = load_raw_dav2(args.base_ckpt, device)
    label = make_label_fn(model)

    occ_dir = os.path.join(args.data_root, "occlusion")
    stems = sorted(f.replace("_occlusion.png", "")
                   for f in os.listdir(occ_dir) if f.endswith(".png"))
    chunks = np.array_split(np.asarray(stems), max(args.num_chunks, 1))
    stems = chunks[args.data_index].tolist()

    out_occ = os.path.join(args.data_root, "depth_da_update_occ")
    out_comb = os.path.join(args.data_root, "depth_da_update_combine")
    os.makedirs(out_occ, exist_ok=True)
    os.makedirs(out_comb, exist_ok=True)

    def load_img(path):
        img = read_rgb(path).astype(np.float32) / 255.0
        return resize_nearest_exact_np(img, (args.size, args.size))

    def load_mask(path):
        m = (read_image(path) > 0).astype(np.float32)
        if m.ndim == 3:
            m = m[..., 0]
        return resize_nearest_exact_np(m[..., None], (args.size, args.size))

    def dev(arrays):
        return torch.from_numpy(np.stack(arrays)).to(device)

    for i in range(0, len(stems), args.batch):
        batch = stems[i:i + args.batch]
        whole = dev([load_img(os.path.join(
            args.data_root, "whole", f"{s}_whole.png")) for s in batch])
        occ = dev([load_img(os.path.join(
            occ_dir, f"{s}_occlusion.png")) for s in batch])
        vis = dev([load_mask(os.path.join(
            args.data_root, "visible_object_mask", f"{s}_visible_mask.png"))
            for s in batch])
        wm = dev([load_mask(os.path.join(
            args.data_root, "whole_mask", f"{s}_whole_mask.png"))
            for s in batch])
        occ_depth, combined = (t.cpu().numpy()
                               for t in label(whole, occ, vis, wm))
        for b, stem in enumerate(batch):
            for arr, out_dir in ((occ_depth[b], out_occ),
                                 (combined[b], out_comb)):
                u16 = (np.clip(arr, 0, 1) * 65535.0).astype(np.uint16)
                write_png(os.path.join(out_dir, f"{stem}_depth.png"),
                          resize_default(u16, (args.out_size,
                                               args.out_size)))
        print(f"[{i + len(batch)}/{len(stems)}]", flush=True)


if __name__ == "__main__":
    main()
