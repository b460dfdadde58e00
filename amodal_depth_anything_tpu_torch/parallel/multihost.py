"""Multi-process runtime on `torch.distributed`.

Port of the JAX package's `parallel/multihost.py`. The reference's
distributed backend (HF Accelerate over NCCL: a process group, the gradient
all-reduce, `gather_for_metrics`, a broadcast and `wait_for_everyone`)
becomes:

  * `initialize()` -> `torch.distributed.init_process_group` on a TCP store
    at the coordinator's address. The backend follows the device the ranks
    run on: "nccl" where every rank of a host has a card of its own,
    "gloo" on the CPU and where ranks share a card.
  * the gradient all-reduce -> the trainer (`train/trainer.py`), over the
    mesh's data group (`parallel/mesh.py`).
  * `gather_metrics()` -> an all-gather of host arrays.
  * `sync_processes()` -> a barrier.
  * rank-0 side effects -> `is_main_process()` guards (checkpoint writes).

Everything is the identity or a no-op in a single process, so the same
entry points run from a laptop's CPU to several hosts. Where the group
comes from, in order: the arguments; `JAX_COORDINATOR_ADDRESS` /
`JAX_NUM_PROCESSES` / `JAX_PROCESS_ID` (the JAX package's variables);
`torch.distributed.run`'s `MASTER_ADDR` / `MASTER_PORT` / `WORLD_SIZE` /
`RANK`; a multi-task SLURM job (`_derive_slurm_coordinator`). Nothing of
that set: no group, no store, no timeout.
"""

from __future__ import annotations

import datetime
import logging
import os
import subprocess

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize", "is_main_process", "process_index", "process_count",
           "sync_processes", "gather_metrics", "local_rank", "local_device",
           "backend"]

# how long a rank waits in the store and in a collective before failing
_TIMEOUT = datetime.timedelta(seconds=600)


def _derive_slurm_coordinator() -> str | None:
    """A multi-task SLURM launch without an explicit coordinator: the first
    node of the job's nodelist (`scontrol show hostnames`), port
    `JAX_COORDINATOR_PORT` (default 56207). None off SLURM, on a
    single-task job, or when the nodelist does not expand."""
    if int(os.environ.get("SLURM_NTASKS", "1")) < 2:
        return None
    nodelist = (os.environ.get("SLURM_JOB_NODELIST")
                or os.environ.get("SLURM_NODELIST"))
    if not nodelist:
        return None
    try:
        first = subprocess.run(
            ["scontrol", "show", "hostnames", nodelist],
            capture_output=True, text=True, timeout=10,
            check=True).stdout.splitlines()[0].strip()
    except Exception:  # noqa: BLE001 -- then the address must be given
        logging.warning(
            "SLURM multi-task launch detected but the coordinator could "
            "not be derived from %r; set JAX_COORDINATOR_ADDRESS "
            "explicitly or each host will train independently", nodelist)
        return None
    port = os.environ.get("JAX_COORDINATOR_PORT", "56207")
    return f"{first}:{port}"


def _env_int(*names: str, default: int) -> int:
    for name in names:
        value = os.environ.get(name)
        if value:
            # SLURM writes "2(x3)" for repeated counts
            return int(value.split("(")[0].split(",")[0])
    return default


def _torchrun_address() -> str | None:
    if os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
        return (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    return None


def local_rank() -> int:
    """This process's index among the ranks of its host."""
    if not dist.is_initialized():
        return 0
    default = dist.get_rank() % _local_world_size(dist.get_world_size())
    return _env_int("LOCAL_RANK", "SLURM_LOCALID", default=default)


def _local_world_size(world: int) -> int:
    return _env_int("LOCAL_WORLD_SIZE", "SLURM_NTASKS_PER_NODE",
                    default=world)


def local_device(device="cuda") -> torch.device:
    """The device of this rank: `cuda:{local rank}` (modulo the cards the
    host has, so that ranks may share one) for "cuda", else `device`."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None \
            or not dist.is_initialized():
        return device
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device="cuda") -> bool:
    """Join the process group if this looks like a multi-process launch;
    True iff this call made the group. See the module docstring for where
    the address, the world size and the rank come from. `device`: what the
    ranks compute on ("cuda" or "cpu"); the backend is "nccl" when every
    rank of a host has its own card, else "gloo"."""
    if dist.is_initialized():
        return False
    env_rank = env_world = None
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        coordinator_address = _torchrun_address()
        if coordinator_address is not None:
            env_world, env_rank = "WORLD_SIZE", "RANK"
    if coordinator_address is None:
        coordinator_address = _derive_slurm_coordinator()
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES", env_world or "",
                                 "SLURM_NTASKS", default=1)
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID", env_rank or "",
                              "SLURM_PROCID", default=0)
    device = torch.device(device)
    own_card = (device.type == "cuda" and torch.cuda.device_count()
                >= _local_world_size(num_processes))
    dist.init_process_group(
        "nccl" if own_card else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=_TIMEOUT)
    if device.type == "cuda":
        torch.cuda.set_device(local_device(device))
    return True


def backend() -> str | None:
    """The default group's backend, None without a group."""
    return dist.get_backend() if dist.is_initialized() else None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Accelerate's `is_main_process`: gate file writes on it."""
    return process_index() == 0


def sync_processes(name: str = "barrier") -> None:
    """`wait_for_everyone` (reference train.py:152): a barrier over every
    rank. `name` labels it in logs. No-op in a single process."""
    if process_count() <= 1:
        return
    logging.debug("barrier %s", name)
    dist.barrier()


def gather_metrics(x):
    """`gather_for_metrics`: every process receives the concatenation over
    the ranks, in rank order, of each rank's host array `x` (axis 0; a
    scalar becomes one row). The identity in a single process."""
    if process_count() <= 1:
        return x
    parts = [None] * process_count()
    dist.all_gather_object(parts, np.asarray(x))
    return np.concatenate([np.atleast_1d(p) for p in parts], axis=0)
