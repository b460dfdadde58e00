"""Zero-shot relative-depth evaluation over the shipped benchmark splits.

Port of the JAX package's `scripts/zero_shot_eval.py`. The reference ships
split files for nyu/kitti/eth3d/diode/scannet/vkitti/hypersim
(`data_split/*`) but cannot load them (empty dataset registry,
`src/dataset/__init__.py:8`). This runs the standard zero-shot protocol
those splits imply (Marigold-style): predict relative depth with a raw
DAV2 model on the card, least-squares align the prediction to the ground
truth over the valid mask on the host (in depth or in disparity), and
report the 10-metric suite.

    python -m amodal_depth_anything_tpu_torch.scripts.zero_shot_eval \
        --dataset nyu_v2 --base_data_dir /data/nyu \
        --filenames data_split/nyu/labeled/filename_list_test.txt \
        --checkpoint work_dir/ckp/depth_anything_v2_vitg.pth \
        [--encoder vitg] [--size 518] [--align disparity|depth] \
        [--device cpu]

`--checkpoint` takes what `cli/eval.py::load_state_any` takes.
"""

from __future__ import annotations

import argparse
import os

__all__ = ["build_parser", "main"]


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True,
                   help="registry name: nyu_v2/kitti/eth3d/diode/"
                        "scannet/vkitti/hypersim")
    p.add_argument("--base_data_dir", required=True)
    p.add_argument("--filenames", required=True)
    p.add_argument("--dataset_dir", default="",
                   help="subdir of base_data_dir holding the files")
    p.add_argument("--checkpoint", required=True,
                   help="torch .pth / safetensors / .npz / port checkpoint")
    p.add_argument("--encoder", default="vitg")
    p.add_argument("--size", type=int, default=518)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--align", default="depth", choices=("depth", "disparity"),
                   help="fit scale/shift in depth or disparity space")
    p.add_argument("--output_file", default="")
    p.add_argument("--limit", type=int, default=0,
                   help="evaluate only the first N samples (0 = all)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from ..cli.eval import load_state_any
    from ..data import DataLoader, DatasetMode, get_dataset
    from ..data.base_depth_dataset import resize_nearest_exact_np
    from ..models import get_model
    from ..ops.precision import apply_precision_policy
    from ..utils.alignment import align_depth_least_square_np
    from ..utils.logging_util import eval_dic_to_text
    from ..utils.metrics import (METRIC_FNS, MetricTracker,
                                 compute_metrics_per_sample)

    # build the dataset first: a typo'd name/split fails fast, before the
    # (slow) checkpoint load
    cfg = {"name": args.dataset, "dir": args.dataset_dir,
           "filenames": args.filenames}
    ds = get_dataset(cfg, args.base_data_dir, DatasetMode.EVAL)
    loader = DataLoader(ds, batch_size=args.batch, pad_last=True)

    device = torch.device(args.device)
    dtype = getattr(torch, args.dtype)
    apply_precision_policy(dtype)
    model = get_model("DepthAnythingV2Raw", encoder=args.encoder,
                      device=device)
    model.load_state_dict(load_state_any(args.checkpoint, model,
                                         "DepthAnythingV2Raw"), strict=True)
    model = model.to(dtype).eval()
    size = args.size

    names = list(METRIC_FNS)
    tracker = MetricTracker(*names)
    n_done = 0
    for batch in loader:
        rgb = np.stack([resize_nearest_exact_np(r, (size, size))
                        for r in batch["rgb_int"]])
        with torch.no_grad():
            # the raw model returns [B, H', W'] relative (inverse-ish) depth
            pred = model((torch.from_numpy(rgb).to(device) / 255.0).to(dtype)
                         ).float().cpu().numpy()
        # host per-sample alignment (lstsq), then one device pass scores
        # every kept sample of the batch ([K, n_metrics])
        keep_aligned, keep_gt, keep_valid = [], [], []
        for b in range(pred.shape[0]):
            mask_ok = batch.get("__sample_mask__")
            if mask_ok is not None and not mask_ok[b]:
                continue
            if args.limit and n_done + len(keep_aligned) >= args.limit:
                break
            gt = batch["depth_raw_linear"][b][..., 0]
            valid = batch["valid_mask_raw"][b][..., 0]
            if valid.sum() < 10:  # not enough points for a stable fit
                continue
            pr = resize_nearest_exact_np(pred[b], gt.shape[:2])
            if args.align == "disparity":
                # the model outputs relative inverse depth: fit it to 1/gt,
                # then invert back to metric depth
                v = valid & (gt > 0)
                target = np.where(v, 1.0 / np.where(v, gt, 1.0), 0.0)
                aligned_disp, _, _ = align_depth_least_square_np(
                    target, pr, v, return_scale_shift=True)
                aligned = 1.0 / np.maximum(aligned_disp, 1e-6)
            else:
                aligned, _, _ = align_depth_least_square_np(
                    gt, pr, valid, return_scale_shift=True)
            keep_aligned.append(aligned)
            keep_gt.append(gt)
            keep_valid.append(valid)
        if keep_aligned:
            def dev(arrays):
                return torch.from_numpy(np.stack(arrays)).to(device)
            with torch.no_grad():
                vals = compute_metrics_per_sample(
                    dev(keep_aligned).float() + 1e-5,
                    dev(keep_gt).float() + 1e-5, dev(keep_valid),
                    names).cpu().numpy()
            for row in vals:
                for name, val in zip(names, row):
                    if np.isfinite(val):
                        tracker.update(name, float(val))
            n_done += len(keep_aligned)
        if args.limit and n_done >= args.limit:
            break

    result = tracker.result()
    text = eval_dic_to_text(result, args.dataset, args.filenames)
    print(text)
    if args.output_file:
        os.makedirs(os.path.dirname(args.output_file) or ".", exist_ok=True)
        with open(args.output_file, "a") as f:
            f.write(text + "\n")
    return result


if __name__ == "__main__":
    main()
