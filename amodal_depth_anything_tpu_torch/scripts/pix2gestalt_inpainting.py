"""pix2gestalt inpainting baseline: generate + score over the val split.

Port of the JAX package's `scripts/pix2gestalt_inpainting.py` (the
reference's `src/scripts/pix2gestalt_inpainting.py:200-300`): for each
sample of the pix2gestalt occlusions layout, run the pix2gestalt completion
on the occluded render conditioned on the visible mask
(`heuristics.MaskHeuristics`), extract the amodal mask by matting (RMBG when
loaded, a threshold otherwise), predict depth on the completion with the
frozen DAV2 (266 px bilinear in, min-max, nearest back to 256),
least-squares align it to the GT depth over the visible mask, and score it
into difficulty buckets. Writes per-sample amodal_inpainting / amodal_mask /
amodal_depth / amodal_aligned_depth PNGs, the precomputed outputs
`scripts/precomputed_eval.py` consumes.

Images are read and written by the port's host codec: no PIL, cv2 or
matplotlib. `--deep_cache` is checked against `--ddim_steps` before any
checkpoint is read.

    python -m amodal_depth_anything_tpu_torch.scripts.pix2gestalt_inpainting \\
        --data_dir /data/pix2gestalt_occlusions_release \\
        --split data_split/sam/val_80.txt \\
        --sam_ckpt sam_vit_h.pth --p2g_ckpt epoch=000005.ckpt \\
        --vae_ckpt vae.safetensors --clip_ckpt clip.safetensors \\
        [--rmbg_ckpt rmbg14.pth] --dav2_ckpt depth_anything_v2_vitg.pth \\
        --output_dir out/ [--ddim_steps 200] [--limit N] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

__all__ = ["build_parser", "run", "main"]


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", required=True,
                   help="pix2gestalt_occlusions_release root (occlusion/, "
                        "visible_object_mask/, depth_da_update_combine/)")
    p.add_argument("--split", required=True,
                   help="split file; ids derived as in the reference "
                        "(name.split('_')[1] before the extension)")
    p.add_argument("--sam_ckpt")
    p.add_argument("--p2g_ckpt")
    p.add_argument("--vae_ckpt")
    p.add_argument("--clip_ckpt")
    p.add_argument("--rmbg_ckpt", default=None)
    p.add_argument("--dav2_ckpt", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--ddim_steps", type=int, default=200)
    p.add_argument("--deep_cache", default=None,
                   help="DeepCache 'interval' or 'interval,groups' over "
                        "the DDIM steps (opt-in, approximate; interval "
                        "must divide --ddim_steps; groups default 3)")
    p.add_argument("--size", type=int, default=266,
                   help="DAV2 input (multiple of 14; reference 266)")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--metrics", nargs="*",
                   default=["rmse_linear", "log10", "delta1_acc"])
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    return p


def _deep_cache(args):
    """The parsed `--deep_cache`, checked against `--ddim_steps`."""
    from ..ops.ddim import parse_deep_cache
    dc = parse_deep_cache(args.deep_cache)
    if dc is not None and args.ddim_steps % dc[0]:
        raise SystemExit(f"--deep_cache interval {dc[0]} does not divide "
                         f"--ddim_steps {args.ddim_steps}")
    return dc


def run(args, heuristics, dav2_apply):
    """Core loop, injectable for tests: `heuristics` is a MaskHeuristics,
    `dav2_apply(rgb_u8 [S,S,3]) -> [1,s,s]` the frozen depth model
    (`scripts.pix2gestalt_eval_single.make_dav2_apply`)."""
    import numpy as np
    import torch

    from ..data.base_depth_dataset import resize_nearest_exact_np
    from ..utils.alignment import align_depth_least_square_np
    from ..utils.image import read_image, read_rgb, resize_default, write_png
    from ..utils.logging_util import eval_dic_to_text
    from ..utils.metrics import MetricTracker, compute_metrics_per_sample
    from ..utils.stats import sample_difficulty

    names = list(args.metrics)
    banks = {k: MetricTracker(*names)
             for k in ("align_easy", "align_mid", "align_diff",
                       "align_overall")}
    out_dirs = {}
    for d in ("amodal_inpainting", "amodal_mask", "amodal_depth",
              "amodal_aligned_depth"):
        out_dirs[d] = os.path.join(args.output_dir, d)
        os.makedirs(out_dirs[d], exist_ok=True)

    with open(args.split) as f:
        entries = [ln.strip() for ln in f if ln.strip()]
    if args.limit:
        entries = entries[:args.limit]

    n_done = 0
    for entry in entries:
        # reference id derivation (:209): second '_'-field, extension off
        base = os.path.basename(entry.split()[0])
        sid = base.split("_")[1].split(".")[0] if "_" in base else \
            os.path.splitext(base)[0]

        occ = read_rgb(os.path.join(args.data_dir, "occlusion",
                                    f"{sid}_occlusion.png"))
        visible = resize_default(read_image(os.path.join(
            args.data_dir, "visible_object_mask", f"{sid}_visible_mask.png")),
            (256, 256)) > 0
        if visible.ndim == 3:
            visible = visible[..., 0]
        gt = resize_default(read_image(os.path.join(
            args.data_dir, "depth_da_update_combine", f"{sid}_depth.png")),
            (256, 256)).astype(np.float32) / 65535.0

        # pix2gestalt completion conditioned on the visible mask
        completion = heuristics.pix2gestalt_completion(occ, visible)
        comp_u8 = (np.clip(completion, 0, 1) * 255).astype(np.uint8)
        write_png(os.path.join(out_dirs["amodal_inpainting"],
                               f"{sid}_amodal_inpainting.png"), comp_u8)

        # amodal mask by matting (RMBG when loaded; threshold fallback)
        if heuristics.matting_fn is not None:
            amodal = heuristics.matting_fn(completion) > 0
        else:
            amodal = completion.mean(axis=-1) < 0.95
        amodal_518 = resize_nearest_exact_np(
            amodal.astype(np.float32), (518, 518)) > 0
        write_png(os.path.join(out_dirs["amodal_mask"],
                               f"{sid}_amodal_mask.png"),
                  (amodal_518 * 65535.0).astype(np.uint16))

        # frozen DAV2 on the completion (266 bilinear in, nearest out)
        depth = np.asarray(dav2_apply(comp_u8))
        depth = resize_nearest_exact_np(depth[0], (256, 256))
        write_png(os.path.join(out_dirs["amodal_depth"], f"{sid}_depth.png"),
                  (depth * 65535.0).astype(np.uint16))

        aligned, _, _ = align_depth_least_square_np(gt, depth, visible)
        write_png(os.path.join(out_dirs["amodal_aligned_depth"],
                               f"{sid}_depth.png"),
                  (np.clip(aligned, 0, 1) * 65535.0).astype(np.uint16))

        amodal_256 = resize_nearest_exact_np(
            amodal.astype(np.float32), (256, 256)) > 0
        bucket, _, _, _ = sample_difficulty(amodal_256 | visible, visible)
        key = {"easy": "align_easy", "mid": "align_mid",
               "hard": "align_diff"}[bucket]
        invisible = (amodal_256 | visible) & ~visible
        vals = compute_metrics_per_sample(
            torch.from_numpy(np.asarray(aligned[None] + 1e-5, np.float32)),
            torch.from_numpy(gt[None] + 1e-5),
            torch.from_numpy(invisible[None]), names)[0].numpy()
        for name, val in zip(names, vals):
            if np.isfinite(val):
                banks[key].update(name, float(val))
                banks["align_overall"].update(name, float(val))
        n_done += 1

    for key, bank in banks.items():
        print(eval_dic_to_text(val_metrics=bank.result(),
                               dataset_name=f"pix2gestalt-inpaint [{key}]"))
    return banks, n_done


def main(argv=None):
    args = build_parser().parse_args(argv)
    import dataclasses

    import torch

    from ..heuristics.mask_heuristics import MaskHeuristics
    from .pix2gestalt_eval_single import make_dav2_apply
    from .sam_pl_gen import load_raw_dav2

    deep_cache = _deep_cache(args)
    device = torch.device(args.device)
    heuristics = MaskHeuristics.from_checkpoints(
        args.sam_ckpt, args.p2g_ckpt, args.vae_ckpt, args.clip_ckpt,
        rmbg_ckpt=args.rmbg_ckpt, device=device)
    heuristics.p2g_cfg = dataclasses.replace(
        heuristics.p2g_cfg, ddim_steps=args.ddim_steps,
        ddim_deep_cache=deep_cache)
    model = load_raw_dav2(args.dav2_ckpt, device)
    return run(args, heuristics, make_dav2_apply(model, args.size))


if __name__ == "__main__":
    main()
