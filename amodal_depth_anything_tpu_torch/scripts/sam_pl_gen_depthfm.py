"""Pseudo-label factory, DepthFM flavour.

Port of the JAX package's `scripts/sam_pl_gen_depthfm.py` (the reference's
`src/scripts/sam_pl_gen.py:35-65`): run plain DepthFM
(`models.depthfm.depthfm_predict_depth`: 2 Euler steps, an ensemble of 10)
over the raw SA-1B images and write `{id}_depth.png` uint16/65535, the
labels the DAV2 flavour (`scripts/sam_pl_gen.py`) later composites. Chunked
over `--data_index` for SLURM arrays.

The `sa_{id}.jpg` images are decoded by the port's host codec (libjpeg
where it is linked, else the baseline decoder of `native/imagecodec.cpp`:
PIL's pixels either way) and resized with PIL's default (bicubic) filter in
`utils.host_image`: no PIL, cv2 or matplotlib. `label_image` is the
per-image work (the noise injectable, as the JAX draws differ from
torch's).

    python -m amodal_depth_anything_tpu_torch.scripts.sam_pl_gen_depthfm \\
        --image_dir /data/sam/images --split valid.txt \\
        --ckpt work_dir/ckp/depthfm-v1.ckpt --vae_ckpt vae.safetensors \\
        --out_dir /data/sam/pix2gestalt_occlusions_release/depth \\
        [--num_steps 2] [--ensemble 10] [--size 512] \\
        [--data_index 0 --num_chunks 12] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

__all__ = ["build_parser", "load_model", "label_image", "main"]


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image_dir", required=True,
                   help="raw SA-1B images (sa_{id}.jpg)")
    p.add_argument("--split", required=True, help="one id per line")
    p.add_argument("--ckpt", required=True, help="depthfm-v1.ckpt")
    p.add_argument("--vae_ckpt", required=True,
                   help="SD VAE weights (diffusers .safetensors/.bin/.pth)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--num_steps", type=int, default=2)
    p.add_argument("--ensemble", type=int, default=10)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--data_index", type=int, default=0)
    p.add_argument("--num_chunks", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--tome", type=float, default=None,
                   help="ToMe-SD ratio in the UNet (opt-in, approximate)")
    p.add_argument("--deep_cache", default=None,
                   help="DeepCache 'interval' or 'interval,groups' over "
                        "the Euler steps (opt-in, approximate; interval "
                        "must divide --num_steps; groups default 3 - the "
                        "gated serving recommendation is '2,2')")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    return p


def load_model(ckpt: str, vae_ckpt: str, *, dtype, device):
    """The unguided DepthFM of the reference artifacts, cast to `dtype`."""
    from ..convert.weights import load_depthfm_checkpoints
    from ..ops.precision import apply_precision_policy

    apply_precision_policy(dtype)
    model = load_depthfm_checkpoints(ckpt, vae_ckpt, guide_type="none",
                                     device=device)
    return model.to(dtype).eval()


def label_image(model, path: str, rng, *, size: int, num_steps: int,
                ensemble: int, tome=None, deep_cache=None):
    """(label [H,W] float32 in [0,1], its uint16 PNG samples) of one image:
    RGB, PIL-bicubic to `size`, to [-1, 1], `depthfm_predict_depth`. `rng`:
    a torch generator or the q_sample noise
    [ensemble, size/8, size/8, 4]."""
    import numpy as np
    import torch

    from ..models.depthfm import depthfm_predict_depth
    from ..utils.image import read_rgb, resize_default

    p = next(model.parameters())
    im = resize_default(read_rgb(path), (size, size))
    x = torch.from_numpy(np.asarray(im, np.float32) / 127.5 - 1.0)
    x = x.to(p.device, p.dtype)[None]
    with torch.no_grad():
        depth = depthfm_predict_depth(
            model, rng, x, num_steps=num_steps, ensemble_size=ensemble,
            tome=tome, deep_cache=deep_cache)[0, :, :, 0]
    depth = depth.float().cpu().numpy()
    return depth, (depth * 65535.0).astype(np.uint16)


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from ..ops.ddim import parse_deep_cache
    from ..utils.image import write_png

    deep_cache = parse_deep_cache(args.deep_cache)
    with open(args.split) as f:
        ids = [ln.strip() for ln in f if ln.strip()]
    chunks = np.array_split(np.asarray(ids), args.num_chunks)
    ids = list(chunks[args.data_index])

    device = torch.device(args.device)
    model = load_model(args.ckpt, args.vae_ckpt,
                       dtype=getattr(torch, args.dtype), device=device)
    os.makedirs(args.out_dir, exist_ok=True)
    for i, sid in enumerate(ids):
        rng = torch.Generator(device=device).manual_seed(args.seed + i)
        _, u16 = label_image(
            model, os.path.join(args.image_dir, f"sa_{sid}.jpg"), rng,
            size=args.size, num_steps=args.num_steps,
            ensemble=args.ensemble,
            tome=(args.tome, 4096) if args.tome else None,
            deep_cache=deep_cache)
        write_png(os.path.join(args.out_dir, f"{sid}_depth.png"), u16)
    print(f"wrote {len(ids)} labels to {args.out_dir}")


if __name__ == "__main__":
    main()
