"""Logging / observability (reference `src/util/logging_util.py:12-102`).

File+console python logging, a lazy TensorBoard writer singleton, a wandb
gate (calls no-op with a warning when wandb isn't installed),
and SLURM job-id logging.
"""

from __future__ import annotations

import logging
import os

__all__ = ["config_logging", "TrainingLogger", "tb_logger", "init_wandb",
           "load_wandb_job_id", "save_wandb_job_id",
           "log_slurm_job_id"]


def config_logging(cfg=None, out_dir: str | None = None) -> None:
    file_level = console_level = logging.INFO
    if cfg is not None:
        file_level = getattr(cfg, "file_level", file_level)
        console_level = getattr(cfg, "console_level", console_level)
    handlers: list[logging.Handler] = []
    console = logging.StreamHandler()
    console.setLevel(console_level)
    handlers.append(console)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(out_dir, "logging.log"))
        fh.setLevel(file_level)
        handlers.append(fh)
    logging.basicConfig(
        level=min(file_level, console_level),
        format="%(asctime)s [%(levelname)s] %(name)s: %(message)s",
        handlers=handlers, force=True)


class TrainingLogger:
    """Global TensorBoard writer singleton (reference logging_util.py:42-64)."""

    def __init__(self):
        self._writer = None

    def set_dir(self, tb_dir: str) -> None:
        from torch.utils.tensorboard import SummaryWriter
        self._writer = SummaryWriter(tb_dir)

    @property
    def writer(self):
        return self._writer

    def log_scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)

    def log_dic(self, scalars: dict, step: int, prefix: str = "") -> None:
        for k, v in scalars.items():
            self.log_scalar(f"{prefix}{k}" if prefix else k, float(v), step)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()


tb_logger = TrainingLogger()


def init_wandb(enable: bool, **kwargs):
    """wandb.init with sync_tensorboard (reference logging_util.py:68-73).

    Degrades to a warning no-op when wandb isn't installed.
    Pass `id=` + `resume=` (from `load_wandb_job_id`) to re-attach a
    resumed training run to its original wandb run — the reference
    persists WANDB_ID but its resume path raises NotImplementedError
    (train.py:163-164); here resume actually works, so the id round-trip
    is live (cli/train.py)."""
    if not enable:
        return None
    try:
        import wandb
    except ImportError:
        logging.warning("wandb is not installed; skipping wandb init")
        return None
    return wandb.init(sync_tensorboard=True, **kwargs)


def load_wandb_job_id(out_dir: str) -> str:
    """Read the persisted wandb run id (reference logging_util.py:85-88)."""
    with open(os.path.join(out_dir, "WANDB_ID")) as f:
        return f.read().strip()


def save_wandb_job_id(run, out_dir: str) -> None:
    """Persist the wandb run id next to the checkpoints so a resumed run
    re-attaches (reference logging_util.py:91-93)."""
    with open(os.path.join(out_dir, "WANDB_ID"), "w+") as f:
        f.write(run.id)


def log_slurm_job_id(step: int = 0) -> None:
    job_id = os.getenv("SLURM_JOB_ID")
    if job_id is not None:
        logging.info("SLURM_JOB_ID: %s", job_id)
        try:
            tb_logger.log_scalar("slurm_job_id", float(job_id), step)
        except ValueError:
            pass

