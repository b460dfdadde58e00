"""Batch amodal-depth inference over a val split with GT amodal masks.

Port of the JAX package's `scripts/batch_inference.py` (the reference's
`src/scripts/amodel_dav2_inference.py:43-120`): runs the guided model over
a filename-list split through `DiscriminativeTrainer.
validate_single_dataset` (bf16), data-parallel over the process group's
ranks (`parallel.make_mesh`; one process: one device; `--batch` must
divide over the ranks), optionally writes 16-bit predictions, and writes
the aligned / raw metric suite per difficulty bucket to `metrics.txt`.

    python -m amodal_depth_anything_tpu_torch.scripts.batch_inference \\
        --model AmodalDAv2 --checkpoint ckpt_dir_or_safetensors \\
        --base_data_dir /data/sam --filenames data_split/sam/val_sub.txt \\
        --output_dir work_dir/preds [--batch 8] [--device cpu]

`--checkpoint` takes what `cli/eval.py::load_state_any` takes.
"""

from __future__ import annotations

import argparse
import os

__all__ = ["build_parser", "main"]


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="AmodalDAv2")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--base_data_dir", required=True)
    p.add_argument("--filenames", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=518)
    p.add_argument("--save_predictions", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..cli.eval import load_state_any
    from ..data import DataLoader, DatasetMode, SAMAmodalDataset
    from ..models import get_model
    from ..parallel import initialize, is_main_process, make_mesh
    from ..train import DiscriminativeTrainer, TrainerConfig
    from ..utils.logging_util import eval_dic_to_text

    initialize(device=args.device)
    mesh = make_mesh()
    model = get_model(args.model, device=args.device)
    params = load_state_any(args.checkpoint, model, args.model)

    ds = SAMAmodalDataset(mode=DatasetMode.EVAL,
                          filename_ls_path=args.filenames,
                          dataset_dir=args.base_data_dir,
                          resize_to_hw=(args.size, args.size))
    loader = DataLoader(ds, batch_size=args.batch, pad_last=True)

    cfg = TrainerConfig(compute_dtype="bfloat16")
    trainer = DiscriminativeTrainer(cfg, model, train_loader=None,
                                    device=args.device, params=params,
                                    mesh=mesh)
    save_dir = args.output_dir if args.save_predictions else None
    os.makedirs(args.output_dir, exist_ok=True)
    results = trainer.validate_single_dataset(loader, save_to_dir=save_dir,
                                              eval=True)
    if is_main_process():
        with open(os.path.join(args.output_dir, "metrics.txt"), "w") as f:
            for bucket, metrics in results.items():
                text = eval_dic_to_text(metrics, bucket)
                print(text)
                f.write(text + "\n")
    return results


if __name__ == "__main__":
    main()
