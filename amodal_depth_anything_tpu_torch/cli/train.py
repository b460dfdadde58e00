"""Config-driven training CLI (reference `train.py:42-328` contract).

    python -m amodal_depth_anything_tpu_torch.cli.train \
        --config configs/train_discriminative_vitl.yaml \
        --base_data_dir /data/sam --output_dir work_dir/out [--resume_run DIR]
        [--exit_after MINUTES] [--no_wandb] [--device cuda|cpu]

The JAX package's CLI with the same flags (`--device`, default "cuda"):
  * multi-process launches (the JAX package's `JAX_COORDINATOR_ADDRESS` /
    `JAX_NUM_PROCESSES` / `JAX_PROCESS_ID`, `torch.distributed.run`'s
    variables, or a multi-task SLURM job) join the process group before any
    device is touched (`parallel.initialize`); each rank trains on its
    card, `cuda:{local rank}`. One process: a 1 x 1 mesh.
  * the mesh: every rank on ``data``, `--mesh_model` of them on ``model``
    (tensor parallelism of the trunk, `parallel.make_mesh`).
  * effective batch / grad accumulation: accumulation_steps =
    round(eff_batch_size / (max_train_batch_size * data ranks)) -- the
    reference's formula (`train.py:104-107`); the loader yields the global
    batch of max_train_batch_size * data ranks, of which each data rank
    trains on its rows.
  * `--resume_run` actually restores (the reference raises
    NotImplementedError, `train.py:94-95`).
  * on the card each train step is one captured CUDA graph
    (`train/trainer.py`), as the JAX trainer jits its step.
  * run-dir scaffolding, config snapshot, tb logging preserved; wandb is
    optional and no-ops when not installed.
"""

from __future__ import annotations

import argparse
import datetime
import logging
import os
import shutil
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train amodal depth models (PyTorch/CUDA port)")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--base_data_dir", type=str, default=None,
                   help="Dataset root (defaults to $BASE_DATA_DIR)")
    p.add_argument("--output_dir", type=str, default="work_dir/output")
    p.add_argument("--resume_run", type=str, default=None,
                   help="Checkpoint dir to resume from")
    p.add_argument("--exit_after", type=int, default=-1,
                   help="Save latest and exit after N minutes (SLURM)")
    p.add_argument("--no_wandb", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--img_dropout", type=float, default=None)
    p.add_argument("--max_iter", type=int, default=None)
    p.add_argument("--mesh_model", type=int, default=1,
                   help="Tensor-parallel degree: ranks on the mesh's model "
                        "axis")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to train on: 'cuda' (default) or 'cpu'")
    return p


def _metric_names():
    from ..utils.metrics import METRIC_FNS
    return METRIC_FNS


def _loss_kwargs(name: str, kwargs: dict) -> dict:
    """The loss kwargs the named loss takes. A child config that names
    another loss with `kwargs: {}` still inherits its base's kwargs (the
    merge is deep: `train_depthfm_base.yaml` names `l1_loss` over the
    discriminative base's `silog_loss` with `beta`), so keys the loss does
    not take are dropped, with a warning."""
    import inspect

    from ..utils.loss import get_loss
    params = inspect.signature(get_loss(name)).parameters
    kept = {k: v for k, v in kwargs.items() if k in params}
    if kept != kwargs:
        logging.warning("loss %s takes no %s; dropped", name,
                        sorted(set(kwargs) - set(kept)))
    return kept


def trainer_config_from_cfg(cfg, accumulation_steps: int):
    from ..train import TrainerConfig
    from ..utils.config import find_value

    loss_cfg = cfg.get("loss")
    lr_sched = cfg.get("lr_scheduler")
    kw = lr_sched.kwargs if lr_sched else None
    tcfg = cfg.get("trainer")
    val = cfg.get("validation")
    ev = cfg.get("eval")
    logg = cfg.get("logging")
    strategy = find_value(cfg, "loss_stategy") or \
        find_value(cfg, "loss_strategy") or "entire_target_object"
    loss_name = loss_cfg.name if loss_cfg else "silog_loss"
    return TrainerConfig(
        loss_strategy=strategy,
        loss_name=loss_name,
        loss_kwargs=_loss_kwargs(loss_name, loss_cfg.kwargs.to_dict()
                                 if loss_cfg and loss_cfg.get("kwargs")
                                 else {}),
        lr=float(cfg.get("lr", 3e-5)) * float(cfg.get("scale_lr", 1.0)),
        lr_total_iter=int(kw.total_iter) if kw else 50000,
        lr_final_ratio=float(kw.final_ratio) if kw else 0.01,
        lr_warmup_steps=int(kw.warmup_steps) if kw else 100,
        max_grad_norm=float(tcfg.get("max_grad_norm", 0.01)) if tcfg else 0.01,
        max_iter=int(cfg.get("max_iter", 60000)),
        max_epoch=int(cfg.get("max_epoch", 10000)),
        accumulation_steps=accumulation_steps,
        gt_depth_type=cfg.get("gt_depth_type", "depth_gt"),
        gt_mask_type=cfg.get("gt_mask_type", "valid_mask_raw"),
        init_seed=int(tcfg.get("init_seed", 2024)) if tcfg else 2024,
        val_init_seed=int(val.get("init_seed", 2024)) if val else 2024,
        eval_metrics=(tuple(ev.eval_metrics) if ev and ev.get("eval_metrics")
                      else tuple(_metric_names())),
        main_val_metric=val.get("main_val_metric",
                                "abs_relative_difference") if val
        else "abs_relative_difference",
        main_val_metric_goal=val.get("main_val_metric_goal", "minimize")
        if val else "minimize",
        save_period=int(tcfg.get("save_period", 20000)) if tcfg else 20000,
        backup_period=int(tcfg.get("backup_period", 20000)) if tcfg else 20000,
        validation_period=int(tcfg.get("validation_period", 10000))
        if tcfg else 10000,
        visualization_period=int(tcfg.get("visualization_period", 10000))
        if tcfg else 10000,
        log_interval=int(logg.get("log_interval", 200)) if logg else 200,
        compute_dtype=cfg.get("compute_dtype", "bfloat16"),
        # sharding knobs: accepted at top level or under trainer; not
        # ported yet, so the trainer raises on anything but the default
        fsdp=bool(cfg.get("fsdp", tcfg.get("fsdp", False) if tcfg
                          else False)),
        sequence_parallel=bool(cfg.get(
            "sequence_parallel",
            tcfg.get("sequence_parallel", False) if tcfg else False)),
        remat=cfg.get("remat", tcfg.get("remat", "attn") if tcfg
                      else "attn"),
        # update rule (train/state.py): adam | adam-bf16mu | adafactor
        optimizer=cfg.get("optimizer", tcfg.get("optimizer", "adam")
                          if tcfg else "adam"),
        # DPT head over batch chunks, recomputed in the backward
        head_tile=cfg.get("head_tile", tcfg.get("head_tile") if tcfg
                          else None),
    )


def trainer_kwargs_from_cfg(cfg) -> dict:
    """Trainer-class-specific kwargs from the config tree."""
    extra = {}
    name = cfg.trainer.name
    if name == "AmodalSynthDriveTrainer" and \
            cfg.trainer.get("w_occ") is not None:
        extra["w_occ"] = float(cfg.trainer.w_occ)
    if name == "DepthFMTrainer":
        # DDPM finetune settings (the reference reads the diffusers
        # scheduler dir, `depthfm_trainer.py:93-105`; these are explicit
        # keys)
        for key in ("prediction_type", "num_train_timesteps",
                    "beta_start", "beta_end"):
            val = cfg.trainer.get(key)
            if val is not None:
                extra[key] = val
        mrn = cfg.get("multi_res_noise")
        if mrn is not None:
            extra["multi_res_noise"] = mrn.to_dict()
    return extra


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    t_start = time.time()
    t_end = t_start + args.exit_after * 60 if args.exit_after > 0 else None

    from ..parallel import MeshConfig, initialize, make_mesh
    from ..parallel.mesh import axis_size
    from ..parallel.multihost import process_count

    # multi-process launches bring up the process group before any device
    # use; no-op in a single process
    initialize(device=args.device)
    mesh = make_mesh(MeshConfig(model=args.mesh_model))
    from ..data import DataLoader, DatasetMode, MixedBatchSampler, \
        ConcatDataset, get_dataset
    from ..models import get_model
    from ..train import get_trainer_cls
    from ..utils.config import recursive_load_config
    from ..utils.depth_transform import get_depth_normalizer
    from ..utils.logging_util import (config_logging, init_wandb,
                                      load_wandb_job_id, log_slurm_job_id,
                                      save_wandb_job_id, tb_logger)

    cfg = recursive_load_config(args.config)
    if args.img_dropout is not None:
        cfg.dataset.train.img_dropout = args.img_dropout
    if args.max_iter is not None:
        cfg.max_iter = args.max_iter

    base_data_dir = args.base_data_dir or os.environ.get("BASE_DATA_DIR")
    if base_data_dir is None:
        raise SystemExit("--base_data_dir or $BASE_DATA_DIR required")

    # run dir scaffolding (reference train.py:124-149)
    job_name = os.path.splitext(os.path.basename(args.config))[0]
    ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    if process_count() > 1:   # one run directory: rank 0's clock
        import torch.distributed as dist
        box = [ts]
        dist.broadcast_object_list(box, src=0)
        ts = box[0]
    run_dir = os.path.join(args.output_dir, job_name, ts)
    out_ckpt = os.path.join(run_dir, "checkpoint")
    out_tb = os.path.join(run_dir, "tensorboard")
    out_eval = os.path.join(run_dir, "evaluation")
    out_vis = os.path.join(run_dir, "visualization")
    for d in (out_ckpt, out_tb, out_eval, out_vis):
        os.makedirs(d, exist_ok=True)
    config_logging(cfg.get("logging"), out_dir=run_dir)
    log_slurm_job_id()
    shutil.copyfile(args.config, os.path.join(run_dir, "config.yaml"))
    tb_logger.set_dir(out_tb)
    if not args.no_wandb:
        wcfg = cfg.get("wandb")
        # resume: re-attach to the original wandb run via the persisted
        # WANDB_ID (reference logging_util.py:85-93 persists it but its
        # resume path raises NotImplementedError, train.py:163-164; here
        # resume works, so the id round-trip is live). --resume_run
        # points at a checkpoint dir; WANDB_ID lives at the run-dir
        # level, so search a few levels up.
        resume_kw = {}
        if args.resume_run:
            probe = os.path.abspath(args.resume_run)
            for _ in range(4):
                if os.path.exists(os.path.join(probe, "WANDB_ID")):
                    resume_kw = {"id": load_wandb_job_id(probe),
                                 "resume": "must"}
                    break
                probe = os.path.dirname(probe)
        run = init_wandb(enable=wcfg is not None,
                         project=wcfg.get("project") if wcfg else None,
                         name=ts, config=cfg.to_dict() if wcfg else None,
                         **resume_kw)
        if run is not None:
            # persist the id into THIS run_dir unconditionally: a resumed
            # run must also carry it so a second-generation --resume_run
            # (pointing at this run's checkpoints) re-attaches instead of
            # silently forking a new wandb run
            save_wandb_job_id(run, run_dir)

    n_data = axis_size(mesh, "data")
    eff_bs = int(cfg.dataloader.effective_batch_size)
    max_bs = int(cfg.dataloader.max_train_batch_size)
    accumulation_steps = max(1, round(eff_bs / (max_bs * n_data)))
    logging.info("devices=%d eff_bs=%d per-device bs=%d accum=%d",
                 n_data, eff_bs, max_bs, accumulation_steps)

    normalizer = get_depth_normalizer(cfg.get("depth_normalization"))
    seed = args.seed if args.seed is not None else int(
        cfg.get("dataloader").get("seed", 0) or 0)

    # reference contract: cfg.dataloader.num_workers (train.py:247,253,270)
    workers = int(cfg.dataloader.get("num_workers", 0) or 0)

    train_ds = get_dataset(cfg.dataset.train, base_data_dir, DatasetMode.TRAIN,
                           depth_transform=normalizer, seed=seed)
    if isinstance(train_ds, list):
        sampler = MixedBatchSampler(
            train_ds, batch_size=max_bs * n_data, drop_last=True,
            shuffle=True, prob=cfg.dataset.train.get("prob_ls"), seed=seed)
        train_loader = DataLoader(ConcatDataset(train_ds), sampler=sampler,
                                  num_workers=workers)
    else:
        train_loader = DataLoader(train_ds, batch_size=max_bs * n_data,
                                  shuffle=True, drop_last=True, seed=seed,
                                  num_workers=workers)

    val_loaders, vis_loaders = [], []
    for key, sink in (("val", val_loaders), ("vis", vis_loaders)):
        split_cfg = cfg.dataset.get(key)
        if split_cfg is None:
            continue
        items = split_cfg if isinstance(split_cfg, list) else [split_cfg]
        for item in items:
            ds = get_dataset(item, base_data_dir, DatasetMode.EVAL,
                             depth_transform=normalizer)
            sink.append(DataLoader(ds, batch_size=n_data, pad_last=True,
                                   num_workers=workers))

    model = get_model(cfg.model.name, device=args.device,
                      **cfg.model.kwargs.to_dict())
    tcfg = trainer_config_from_cfg(cfg, accumulation_steps)
    trainer_cls = get_trainer_cls(cfg.trainer.name)
    trainer = trainer_cls(tcfg, model, train_loader, val_loaders, vis_loaders,
                          device=args.device, mesh=mesh,
                          out_dir_ckpt=out_ckpt,
                          out_dir_eval=out_eval, out_dir_vis=out_vis,
                          seed=seed, **trainer_kwargs_from_cfg(cfg))
    if args.resume_run:
        trainer.load_checkpoint(args.resume_run, resume_training=True)
    try:
        trainer.train(t_end=t_end)
    finally:
        # the run's event file is complete; a later run in this process
        # (or its directory's removal) must not find the writer open
        tb_logger.close()
    logging.info("training finished at iter %d", trainer.effective_iter)


if __name__ == "__main__":
    main()
