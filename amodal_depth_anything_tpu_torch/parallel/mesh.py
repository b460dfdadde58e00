"""The rank mesh for data, tensor and pipeline parallel execution.

Port of the JAX package's `parallel/mesh.py`. There a `jax.sharding.Mesh`
lays the devices out and XLA inserts the collectives; here the ranks of
the process group are laid out as a `torch.distributed.device_mesh.
DeviceMesh`, one process group per axis, and the port's modules call the
collectives themselves (`parallel/comm.py`).

Axes:
  * ``data``  -- batch rows (the DDP equivalent), and FSDP's shards.
  * ``model`` -- tensor parallelism of the ViT trunks: attention heads and
    FFN hidden units split Megatron-style (`parallel/sharding.py`), the
    token stream split between the matmuls under sequence parallelism.
  * ``pipe``  -- pipeline stages of the trunk (`parallel/pipeline.py`);
    present only when its size is > 1, as in the JAX package.

The ranks fill the mesh in the order of the JAX package's reshape: rank r
sits at (r // model, r % model), or (r // (data * model), ...) with a pipe
axis. A process without a group gets a 1 x 1 `LocalMesh`, which needs no
group; callers read sizes, groups and coordinates through `axis_size`,
`axis_group` and `axis_rank`, which treat a missing mesh or axis as size 1.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

__all__ = ["MeshConfig", "make_mesh", "LocalMesh", "axis_size",
           "axis_group", "axis_rank", "capturable", "check_capturable"]


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1   # -1 = all remaining ranks
    model: int = 1
    pipe: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        model = max(1, self.model)
        pipe = max(1, self.pipe)
        data = self.data if self.data > 0 else n_devices // (model * pipe)
        if data * model * pipe != n_devices:
            raise ValueError(
                f"mesh {data}x{model}x{pipe} != {n_devices} available devices")
        return data, model, pipe


class LocalMesh:
    """The mesh of a process without a process group: every axis has one
    rank, this one, and no group (nothing to communicate)."""

    def __init__(self, names: tuple[str, ...] = ("data", "model")):
        self.mesh_dim_names = tuple(names)

    def size(self, mesh_dim=None) -> int:
        return 1

    def get_group(self, mesh_dim=None):
        return None

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0

    def __repr__(self) -> str:
        return f"LocalMesh({self.mesh_dim_names})"


def make_mesh(cfg: MeshConfig | None = None, devices=None):
    """A DeviceMesh over `devices` (global ranks; default every rank of the
    group) shaped by `cfg` (default: every rank on ``data``). Without a
    process group: a 1 x 1 `LocalMesh`, and any other shape raises."""
    cfg = cfg or MeshConfig()
    if not dist.is_initialized():
        data, model, pipe = cfg.resolve(1)
        return LocalMesh(("data", "model") if pipe == 1
                         else ("pipe", "data", "model"))
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(range(dist.get_world_size())) if devices is None \
        else [int(r) for r in devices]
    data, model, pipe = cfg.resolve(len(ranks))
    if pipe == 1:
        shape, names = (data, model), ("data", "model")
    else:
        shape, names = (pipe, data, model), ("pipe", "data", "model")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=names)


def axis_size(mesh, name: str) -> int:
    """The number of ranks along axis `name` (1 without a mesh or axis)."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_group(mesh, name: str):
    """The process group of this rank's line along `name`; None without a
    group (a `LocalMesh`, no mesh or no such axis). An axis of one rank of
    a real mesh keeps its group, so its collectives run (and are captured
    into CUDA graphs) as on a larger mesh."""
    if mesh is None or isinstance(mesh, LocalMesh) \
            or name not in mesh.mesh_dim_names:
        return None
    return mesh.get_group(name)


def capturable(mesh) -> bool:
    """Whether a program over `mesh` can be captured as a CUDA graph: it
    runs no collective, or runs them over NCCL (gloo's are host calls)."""
    return mesh is None or isinstance(mesh, LocalMesh) \
        or dist.get_backend() == "nccl"


def check_capturable(mesh, what: str) -> None:
    """Raise ValueError if `what`, captured as a CUDA graph, would run
    collectives over a backend that cannot be captured (gloo)."""
    if not capturable(mesh):
        backend = dist.get_backend()
        raise ValueError(
            f"{what} cannot be captured over a {backend!r} group: its "
            f"collectives do not run inside a CUDA graph (NCCL's do); run "
            f"it eagerly (captured=False)")


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate along `name` (0 without a mesh or axis)."""
    if axis_group(mesh, name) is None:
        return 0
    return mesh.get_local_rank(name)

