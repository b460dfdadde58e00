"""Evaluation CLI (reference `eval.py:43-306` contract).

    python -m amodal_depth_anything_tpu_torch.cli.eval \
        --config configs/train_discriminative_vitl.yaml \
        --trained_checkpoint work_dir/.../checkpoint/latest \
        --base_data_dir /data/sam --output_dir work_dir/eval [--device cpu]

The JAX package's CLI with the same flags, on one device: loads the trained
model, runs the config trainer's `validate_single_dataset(eval=True)` over
each configured val split, and appends the per-bucket metric tables to
`<output_dir>/evaluation/eval.txt`.

`--trained_checkpoint` takes (`load_state_any`):
  * a checkpoint directory written by the port's trainer (`state.pt`);
  * a reference state dict, `.pth` or `.safetensors` (or the HF directory
    holding `model.safetensors`), in the layout of the config's model:
    the DAV2 keys as released, the jo_amodal DPT (`amodal_depth.pth.tar`)
    and ZoeDepth / InvisibleStitch layouts through the port's own loaders
    (`convert/jo_dpt_convert.py`, `convert/zoedepth_convert.py`);
  * an `.npz` of the JAX package's parameter tree (flat "/"-joined keys,
    the in-repo proxies' format), through the weight bridge.
An Orbax directory of the JAX trainer cannot be read without JAX: the CLI
exits and names the way across (the JAX package's
`convert/emit_torch.py` writes the reference layout).
"""

from __future__ import annotations

import argparse
import logging
import os

__all__ = ["build_parser", "load_state_any", "main"]

_BASELINES = ("ADDeepLab", "PartialCompletionContentDPT", "InvisibleStitch",
              "JoUNet")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate amodal depth models "
                                "(PyTorch port)")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--trained_checkpoint", type=str, required=True)
    p.add_argument("--base_data_dir", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="work_dir/eval")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card)")
    return p


def load_state_any(path: str, model, model_name: str) -> dict:
    """The state dict of `model` (registry name `model_name`) held at
    `path`; see the module docstring for the formats."""
    import torch

    from ..convert.weights import (baseline_params_from_jax, load_params_npz,
                                   load_state_dict, params_from_jax)
    from ..train.trainer import CHECKPOINT_FILE

    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, CHECKPOINT_FILE)):
            tree = torch.load(os.path.join(path, CHECKPOINT_FILE),
                              map_location="cpu", weights_only=True)
            return tree["params"]
        if not os.path.exists(os.path.join(path, "model.safetensors")):
            raise SystemExit(
                f"--trained_checkpoint {path}: a directory without "
                f"{CHECKPOINT_FILE} or model.safetensors, such as an Orbax "
                "checkpoint of the JAX package, which the port cannot read "
                "without JAX. Write it as a reference state dict with the "
                "JAX package's convert/emit_torch.py and pass that file.")
        path = os.path.join(path, "model.safetensors")
    if path.endswith(".npz"):
        tree = load_params_npz(path)
        if model_name in _BASELINES:
            return baseline_params_from_jax(model_name, tree, model.cfg)
        return params_from_jax(tree, model.cfg)
    sd = load_state_dict(path)
    if model_name == "PartialCompletionContentDPT":
        from ..convert.jo_dpt_convert import jo_dpt_state_dict
        return jo_dpt_state_dict(sd, model)
    if model_name == "InvisibleStitch":
        from ..convert.zoedepth_convert import zoedepth_state_dict
        return zoedepth_state_dict(sd, model)
    return sd


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from ..data import DataLoader, DatasetMode, get_dataset
    from ..models import get_model
    from ..parallel import initialize, make_mesh
    from ..parallel.mesh import axis_size
    from ..train import get_trainer_cls
    from ..utils.config import recursive_load_config
    from ..utils.depth_transform import get_depth_normalizer
    from ..utils.logging_util import config_logging, eval_dic_to_text
    from .train import trainer_config_from_cfg, trainer_kwargs_from_cfg

    initialize(device=args.device)
    # data-parallel evaluation: each data rank scores its rows of a batch
    mesh = make_mesh()
    cfg = recursive_load_config(args.config)
    base_data_dir = args.base_data_dir or os.environ.get("BASE_DATA_DIR")
    if base_data_dir is None:
        raise SystemExit("--base_data_dir or $BASE_DATA_DIR required")
    out_dir = os.path.join(args.output_dir, "evaluation")
    os.makedirs(out_dir, exist_ok=True)
    config_logging(cfg.get("logging"), out_dir=args.output_dir)

    model = get_model(cfg.model.name, device=args.device,
                      **cfg.model.kwargs.to_dict())
    params = load_state_any(args.trained_checkpoint, model, cfg.model.name)
    normalizer = get_depth_normalizer(cfg.get("depth_normalization"))

    val_cfg = cfg.dataset.val
    items = val_cfg if isinstance(val_cfg, list) else [val_cfg]
    workers = int((cfg.get("dataloader") or {}).get("num_workers", 0) or 0)
    val_loaders = [DataLoader(get_dataset(item, base_data_dir,
                                          DatasetMode.EVAL,
                                          depth_transform=normalizer),
                              batch_size=axis_size(mesh, "data"),
                              pad_last=True,
                              num_workers=workers) for item in items]

    tcfg = trainer_config_from_cfg(cfg, accumulation_steps=1)
    trainer = get_trainer_cls(cfg.trainer.name)(
        tcfg, model, None, val_loaders, device=args.device, mesh=mesh,
        out_dir_eval=out_dir, params=params, **trainer_kwargs_from_cfg(cfg))

    eval_txt = os.path.join(out_dir, "eval.txt")
    with open(eval_txt, "a") as f:
        for loader in val_loaders:
            name = getattr(loader.dataset, "disp_name", "val")
            logging.info("evaluating %s", name)
            results = trainer.validate_single_dataset(loader, eval=True)
            for bucket, metrics in results.items():
                text = eval_dic_to_text(metrics, f"{name}/{bucket}")
                print(text)
                f.write(text + "\n")
    logging.info("wrote %s", eval_txt)


if __name__ == "__main__":
    main()
