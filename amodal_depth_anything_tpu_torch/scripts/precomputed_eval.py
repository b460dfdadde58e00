"""Score PRE-COMPUTED amodal-depth predictions (baseline evaluation).

Port of the JAX package's `scripts/precomputed_eval.py`, the reference's
`src/scripts/pix2gestalt_eval.py:180-314`: a directory of 16-bit depth
PNGs produced by any external baseline (pix2gestalt composites, SDXL
inpainting, ...) is aligned to the observation over the visible mask and
scored on the invisible region with difficulty-binned trackers. File
layout (reference naming):

  --pred_dir        {id}_depth.png        (uint16 / 65535)
  --gt_dir          {id}_depth.png        combined GT depth
  --obs_dir         {id}_depth.png        occluded-view observation
  --visible_dir     {id}_visible_mask.png
  --whole_dir       {id}_whole_mask.png

Buckets: visibility ratio > 0.75 easy / > 0.5 mid / else diff
(pix2gestalt_eval.py:250-260); metrics over `whole & ~visible`
(:281-292); NaN samples skipped (:295-297). PNGs decode in numpy
(`utils/host_image.decode_png`); the metrics run on `--device`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

__all__ = ["main"]


def _parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pred_dir", required=True)
    p.add_argument("--gt_dir", required=True)
    p.add_argument("--obs_dir", required=True)
    p.add_argument("--visible_dir", required=True)
    p.add_argument("--whole_dir", required=True)
    p.add_argument("--output", default=None,
                   help="append the report here (default: stdout only)")
    p.add_argument("--metrics", nargs="*",
                   default=["rmse_linear", "log10", "delta1_acc"])
    p.add_argument("--size", type=int, default=518)
    p.add_argument("--dataset_name", default="sam-pix2gestalt")
    p.add_argument("--device", default="cuda",
                   help="torch device for the metrics (default: the card)")
    return p


def _load_png(path: str, size: int) -> np.ndarray:
    from ..data.base_depth_dataset import resize_nearest_exact_np
    from ..utils.host_image import decode_png

    with open(path, "rb") as f:
        a = decode_png(f.read())
    if a.ndim == 3:
        a = a[..., 0]
    return resize_nearest_exact_np(a.astype(np.float32), (size, size))


def main(argv=None):
    args = _parser().parse_args(argv)

    import torch

    from ..utils.alignment import align_depth_least_square_np
    from ..utils.logging_util import eval_dic_to_text
    from ..utils.metrics import MetricTracker, compute_metrics_per_sample
    from ..utils.stats import sample_difficulty

    device = torch.device(args.device)
    names = list(args.metrics)
    banks = {k: MetricTracker(*names)
             for k in ("align_easy", "align_mid", "align_diff",
                       "align_overall")}
    # score in fixed-size chunks: one pass per chunk instead of
    # len(metrics) dispatches per sample
    chunk_aligned, chunk_gt, chunk_inv, chunk_bucket = [], [], [], []

    def flush():
        if not chunk_aligned:
            return
        with torch.no_grad():
            vals = compute_metrics_per_sample(
                torch.from_numpy(np.stack(chunk_aligned) + 1e-5).to(device),
                torch.from_numpy(np.stack(chunk_gt) + 1e-5).to(device),
                torch.from_numpy(np.stack(chunk_inv)).to(device),
                names).cpu().numpy()
        for bucket, row in zip(chunk_bucket, vals):
            for name, val in zip(names, row):
                if np.isnan(val):
                    continue  # reference skips NaN samples (:295-297)
                banks[bucket].update(name, float(val))
                banks["align_overall"].update(name, float(val))
        chunk_aligned.clear()
        chunk_gt.clear()
        chunk_inv.clear()
        chunk_bucket.clear()

    # strip the known suffix (NOT split("_")[0]: ids like scene_0001 carry
    # underscores and would truncate / collide)
    ids = sorted(f[:-len("_depth.png")] for f in os.listdir(args.pred_dir)
                 if f.endswith("_depth.png"))
    if not ids:
        raise SystemExit(f"no *_depth.png in {args.pred_dir}")

    for sid in ids:
        pred = _load_png(os.path.join(args.pred_dir, f"{sid}_depth.png"),
                         args.size) / 65535.0
        gt = _load_png(os.path.join(args.gt_dir, f"{sid}_depth.png"),
                       args.size) / 65535.0
        obs = _load_png(os.path.join(args.obs_dir, f"{sid}_depth.png"),
                        args.size) / 65535.0
        visible = _load_png(
            os.path.join(args.visible_dir, f"{sid}_visible_mask.png"),
            args.size) > 0
        whole = _load_png(
            os.path.join(args.whole_dir, f"{sid}_whole_mask.png"),
            args.size) > 0

        aligned, _, _ = align_depth_least_square_np(obs, pred, visible)
        invisible = whole & ~visible

        vis_bucket, _, _, _ = sample_difficulty(whole, visible)
        chunk_aligned.append(aligned.astype(np.float32))
        chunk_gt.append(gt.astype(np.float32))
        chunk_inv.append(invisible)
        chunk_bucket.append({"easy": "align_easy", "mid": "align_mid",
                             "hard": "align_diff"}[vis_bucket])
        if len(chunk_aligned) >= 16:
            flush()
    flush()

    results = {}
    for key, bank in banks.items():
        results[key] = bank.result()
        text = eval_dic_to_text(val_metrics=results[key],
                                dataset_name=f"{args.dataset_name} [{key}]")
        print(text)
        if args.output:
            os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
            with open(args.output, "a") as f:
                f.write(text)
    return results


if __name__ == "__main__":
    main()
