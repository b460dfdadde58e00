"""Single-image amodal depth CLI on the card (reference `infer.py:123-141`).

    python -m amodal_depth_anything_tpu_torch.cli.infer \
        --input_image_path assets/inference_examples/case1.jpg \
        --input_mask_path assets/inference_masks/case1_mask.png \
        --output_folder out/ \
        --base_ckpt work_dir/ckp/amodal_depth_anything_base.pth \
        --amodal_ckpt work_dir/ckp/amodal_dav2_vitl

Checkpoints are the reference's published files (HF
`Zhyever/Amodal-Depth-Anything-DAV2` safetensors and the raw base .pth),
loaded as they are. Runs on `--device cuda` unless told otherwise.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Amodal depth inference (PyTorch/CUDA port)")
    p.add_argument("--input_image_path", type=str, required=True,
                   help="Path to the input image.")
    p.add_argument("--input_mask_path", type=str, required=True,
                   help="Path to the amodal mask image.")
    p.add_argument("--output_folder", type=str, required=True,
                   help="Output folder.")
    p.add_argument("--base_ckpt", type=str,
                   default="work_dir/ckp/amodal_depth_anything_base.pth",
                   help="Frozen base DAV2 checkpoint (.pth/.safetensors).")
    p.add_argument("--amodal_ckpt", type=str,
                   default="work_dir/ckp/amodal_dav2_vitl",
                   help="AmodalDAv2 checkpoint dir or model.safetensors.")
    p.add_argument("--size", type=int, default=518)
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda).")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    import torch

    from ..pipeline.amodal_pipeline import AmodalDepthPipeline

    pipe = AmodalDepthPipeline.from_checkpoints(
        args.base_ckpt, args.amodal_ckpt, size=args.size,
        device=args.device, dtype=getattr(torch, args.dtype))
    pipe.infer_single_image(args.input_image_path, args.input_mask_path,
                            args.output_folder)
    print(f"wrote renders to {args.output_folder}")


if __name__ == "__main__":
    main()
