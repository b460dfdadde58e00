"""The port's scale-out runtime in one process: the mesh, the sharding
rules against the JAX package's, the multi-process runtime's contract,
the refusals, and the proxy checkpoints' format both ways.

The rules are held against the JAX `param_sharding` on the same vitt
trees (4 x 2 and 8 x 1 over the test session's 8 virtual CPU devices),
mapped onto the port's tensors through `convert.weights.jax_param_layout`.
The ranks themselves run in `tests/test_torch_parallel_ranks.py`."""

import subprocess

import jax
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.models import get_model as jax_get_model
from amodal_depth_anything_tpu.parallel import MeshConfig as JaxMeshConfig
from amodal_depth_anything_tpu.parallel import make_mesh as jax_make_mesh
from amodal_depth_anything_tpu.parallel import \
    param_sharding as jax_param_sharding
from amodal_depth_anything_tpu.scripts import train_proxy as jax_proxy
from amodal_depth_anything_tpu_torch.convert.weights import (
    jax_param_layout, params_from_jax, params_to_jax)
from amodal_depth_anything_tpu_torch.models import get_model
from amodal_depth_anything_tpu_torch.parallel import (MeshConfig,
                                                      gather_metrics,
                                                      initialize,
                                                      is_main_process,
                                                      make_mesh,
                                                      param_sharding,
                                                      process_count,
                                                      process_index,
                                                      shard_params,
                                                      sync_processes)
from amodal_depth_anything_tpu_torch.parallel import multihost
from amodal_depth_anything_tpu_torch.parallel import sharding
from amodal_depth_anything_tpu_torch.parallel.mesh import (LocalMesh,
                                                           axis_size)
from amodal_depth_anything_tpu_torch.scripts import train_proxy
from tests.test_torch_models import few_torch_threads  # noqa: F401


class FakeMesh:
    """A mesh shape without ranks behind it: what the sharding rules
    read (axis names and sizes), rank 0 on every axis, no groups."""

    def __init__(self, data, model):
        self.mesh_dim_names = ("data", "model")
        self._sizes = (data, model)

    def size(self, i):
        return self._sizes[i]

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return 0


@pytest.mark.parametrize("cfg,n", [
    ((-1, 1, 1), 8), ((4, 2, 1), 8), ((-1, 2, 1), 8), ((2, 1, 4), 8),
    ((-1, 1, 1), 1), ((3, 1, 1), 8), ((-1, 3, 1), 8), ((2, 2, 1), 1)])
def test_mesh_config_resolve_matches_jax(cfg, n):
    """The same sizes, and the same error text where they do not fit."""
    def run(cls):
        try:
            return cls(*cfg).resolve(n)
        except ValueError as e:
            return str(e)
    assert run(MeshConfig) == run(JaxMeshConfig)


def test_make_mesh_without_a_group():
    mesh = make_mesh()
    assert isinstance(mesh, LocalMesh)
    assert mesh.mesh_dim_names == ("data", "model")
    assert axis_size(mesh, "data") == axis_size(mesh, "model") == 1
    assert make_mesh(MeshConfig(pipe=1)).mesh_dim_names == ("data", "model")
    with pytest.raises(ValueError, match="mesh 2x1x1 != 1 available"):
        make_mesh(MeshConfig(data=2))


def _vitt():
    """A vitt AmodalDAv2 on the CPU with seeded weights (the registry
    leaves them uninitialised)."""
    from amodal_depth_anything_tpu_torch.models.amodal_dav2 import \
        init_weights_
    return init_weights_(get_model("AmodalDAv2", encoder="vitt",
                                   device="cpu"),
                         torch.Generator().manual_seed(0))


def _vitt_pair():
    jmodel = jax_get_model("AmodalDAv2", encoder="vitt")
    params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    model = get_model("AmodalDAv2", encoder="vitt", device="meta")
    return params, model


def _jax_specs_on_port(jspecs, model):
    """{port key: per-torch-dim axis names} of the JAX specs on the JAX
    tree: a block leaf drops its stacked axis, then the JAX axes are taken
    back to the port's dimension order by the layout."""
    layout = jax_param_layout(model)
    out = {}
    for key, (dims, stack) in layout.items():
        path = _jax_path(model, key)
        node = jspecs
        for part in path:
            node = node[part]
        spec = list(node.spec) + [None] * 4
        if stack is not None:
            spec = spec[1:]
        ndim = dict(model.named_parameters())[key].ndim
        spec = spec[:ndim]
        torch_spec = [None] * ndim
        for j, axis in enumerate(spec):
            torch_spec[j if dims is None else dims[j]] = axis
        out[key] = tuple(torch_spec)
    return out


def _jax_path(model, key):
    from amodal_depth_anything_tpu_torch.convert.weights import _leaf_map
    for k, path, _, _ in _leaf_map(model.cfg):
        if k == key:
            return path
    raise KeyError(key)


@pytest.mark.parametrize("shape,fsdp,min_elements", [
    ((4, 2), False, None), ((4, 2), True, None), ((4, 2), True, 1024),
    ((8, 1), True, 1024)])
def test_param_sharding_matches_jax(shape, fsdp, min_elements, monkeypatch):
    """Every vitt parameter gets the JAX rule's axes: the TP dims, and
    under FSDP the data axis on the same logical axis (the cases of the
    JAX tests/test_fsdp.py; 1024 is the threshold they lower it to)."""
    from amodal_depth_anything_tpu.parallel import sharding as jax_sharding
    if min_elements is not None:
        monkeypatch.setattr(jax_sharding, "FSDP_MIN_ELEMENTS", min_elements)
        monkeypatch.setattr(sharding, "FSDP_MIN_ELEMENTS", min_elements)
    params, model = _vitt_pair()
    jmesh = jax_make_mesh(JaxMeshConfig(data=shape[0], model=shape[1]))
    want = _jax_specs_on_port(jax_param_sharding(jmesh, params, fsdp=fsdp),
                              model)
    got = param_sharding(FakeMesh(*shape), model, fsdp=fsdp)
    assert set(got) == set(want)
    for key, pl in got.items():
        assert pl.spec == want[key], key
    assert any("data" in p.spec for p in got.values()) == fsdp
    qkv = got["encoder.pretrained.blocks.0.attn.qkv.weight"]
    assert qkv.parts == (3 if shape[1] > 1 else 1)


def test_shard_params_cuts_whole_heads_and_fsdp_pieces(monkeypatch):
    """Under model = 2 each rank holds q, k and v of its heads (not a
    contiguous third of the concatenated rows); FSDP pieces are 1/data of
    the leaf (the placement of JAX tests/test_fsdp.py:138-151)."""
    monkeypatch.setattr(sharding, "FSDP_MIN_ELEMENTS", 1024)
    model = _vitt()
    full = {k: v.clone() for k, v in model.state_dict().items()}
    pls = shard_params(FakeMesh(2, 2), model, fsdp=True)
    key = "encoder.pretrained.blocks.0.attn.qkv.weight"
    piece = model.state_dict()[key]
    d = 64
    rows = torch.cat([full[key][i * d:i * d + d // 2] for i in range(3)])
    assert pls[key].spec == ("model", "data")
    assert torch.equal(piece, rows[:, :d // 2])
    assert piece.numel() * 4 == full[key].numel()
    attn = model.encoder.pretrained.blocks[0].attn
    assert attn.num_heads == 1
    # the unsharded mesh leaves everything whole
    model2 = get_model("AmodalDAv2", encoder="vitt", device="cpu")
    pls2 = shard_params(make_mesh(), model2, fsdp=True)
    assert all(p.replicated for p in pls2.values())


def test_shard_params_fsdp_piece_bytes(monkeypatch):
    """data = 8: the qkv weight's piece times the data size is the leaf."""
    monkeypatch.setattr(sharding, "FSDP_MIN_ELEMENTS", 1024)
    model = get_model("AmodalDAv2", encoder="vitt", device="cpu")
    full = model.encoder.pretrained.blocks[0].attn.qkv.weight.numel()
    shard_params(FakeMesh(8, 1), model, fsdp=True)
    piece = model.encoder.pretrained.blocks[0].attn.qkv._parameters["weight"]
    assert piece.numel() * 8 == full


def test_heads_must_divide_the_model_axis():
    """vitt has 2 heads: model = 4 cannot hold whole heads (the JAX tests
    run vitt at model = 4; the port raises, naming both numbers)."""
    model = get_model("AmodalDAv2", encoder="vitt", device="cpu")
    with pytest.raises(ValueError, match=r"model axis \(4\).*heads \(2\)"):
        shard_params(FakeMesh(2, 4), model, tensor_parallel=True)


@pytest.mark.parametrize("kw", [dict(act_sharding="mesh"),
                                dict(token_merge=(1, 4))])
def test_pipeline_mesh_excludes(kw):
    model = get_model("AmodalDAv2", encoder="vitt", device="cpu")
    kw = {k: (make_mesh() if v == "mesh" else v) for k, v in kw.items()}
    x = torch.zeros(2, 28, 28, 3)
    g = torch.zeros(2, 28, 28, 1)
    with pytest.raises(ValueError, match="mutually exclusive"):
        model(x, guide_mask=g, observation=g, attn_impl="plain",
              pipeline_mesh=make_mesh(), **kw)


def test_single_process_contract():
    assert process_index() == 0
    assert process_count() == 1
    assert is_main_process()
    sync_processes("test")  # must not raise / block
    x = np.arange(6).reshape(2, 3)
    assert gather_metrics(x) is x


@pytest.fixture
def no_group(monkeypatch):
    """`torch.distributed` without a group, its init recorded."""
    calls = {}

    def fake_init(backend, init_method, world_size, rank, timeout):
        calls.update(backend=backend, addr=init_method, n=world_size,
                     pid=rank)

    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group", fake_init)
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                "RANK", "SLURM_NTASKS", "SLURM_PROCID", "SLURM_JOB_NODELIST",
                "SLURM_NODELIST", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    return calls


def test_initialize_noop_without_coordinator(no_group):
    assert initialize(device="cpu") is False
    assert no_group == {}


@pytest.mark.parametrize("env,want", [
    ({"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234", "SLURM_NTASKS": "4",
      "SLURM_PROCID": "2"}, ("tcp://10.0.0.1:1234", 4, 2)),
    ({"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234", "JAX_NUM_PROCESSES": "8",
      "JAX_PROCESS_ID": "5"}, ("tcp://10.0.0.1:1234", 8, 5)),
    ({"MASTER_ADDR": "h0", "MASTER_PORT": "29400", "WORLD_SIZE": "2",
      "RANK": "1"}, ("tcp://h0:29400", 2, 1))])
def test_initialize_reads_the_launch_env(no_group, monkeypatch, env, want):
    """The JAX package's variables with SLURM's counts (JAX
    tests/test_multihost.py), and torch.distributed.run's."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert initialize(device="cpu") is True
    assert (no_group["addr"], no_group["n"], no_group["pid"]) == want
    assert no_group["backend"] == "gloo"


def test_derive_slurm_coordinator(monkeypatch):
    """Multi-task SLURM launches derive the coordinator from the first
    nodelist host via scontrol (no JAX_COORDINATOR_ADDRESS needed)."""
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("JAX_COORDINATOR_PORT", raising=False)
    monkeypatch.setenv("SLURM_NTASKS", "4")
    monkeypatch.setenv("SLURM_JOB_NODELIST", "tpu[01-04]")

    def fake_run(cmd, **kw):
        assert cmd == ["scontrol", "show", "hostnames", "tpu[01-04]"]

        class R:
            stdout = "tpu01\ntpu02\ntpu03\ntpu04\n"
        return R()

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert multihost._derive_slurm_coordinator() == "tpu01:56207"
    monkeypatch.setenv("JAX_COORDINATOR_PORT", "777")
    assert multihost._derive_slurm_coordinator() == "tpu01:777"
    # single-task jobs never derive (dev runs stay local)
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert multihost._derive_slurm_coordinator() is None
    # scontrol failure degrades to None (warning), not an exception
    monkeypatch.setenv("SLURM_NTASKS", "4")
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: (_ for _ in ())
                        .throw(OSError("no scontrol")))
    assert multihost._derive_slurm_coordinator() is None


def test_proxy_npz_both_ways(tmp_path):
    """The port writes the JAX layout in float16, which the JAX
    `load_params_npz` reads, and reads what the JAX package writes."""
    model = get_model("AmodalDAv2", encoder="vitt", device="cpu")
    gen = torch.Generator().manual_seed(0)
    for p in model.parameters():
        p.data.normal_(generator=gen)
    tree = params_to_jax(model.state_dict(), model.cfg)
    path = str(tmp_path / "port.npz")
    train_proxy.save_params_npz(path, tree)
    back = jax_proxy.load_params_npz(path)
    sd = params_from_jax(back, model.cfg)
    for k, v in model.state_dict().items():
        want = v.numpy().astype(np.float16).astype(np.float32)
        assert np.array_equal(sd[k].numpy(), want), k
    jpath = str(tmp_path / "jax.npz")
    jax_proxy.save_params_npz(jpath, back)
    ours = train_proxy.load_params_npz(jpath)
    assert (train_proxy.flatten_params(ours).keys()
            == jax_proxy.flatten_params(back).keys())
    for k, v in jax_proxy.flatten_params(back).items():
        assert np.array_equal(train_proxy.flatten_params(ours)[k], v), k


def test_shard_params_twice():
    """A model cut for a mesh is left as it is by a second call for that
    mesh and request (a pipeline built again on its modules), refused for
    another mesh or another request (FSDP asked of a tensor-parallel cut),
    and a model nothing was cut from (one process) may go to any
    trainer."""
    model = _vitt()
    mesh = FakeMesh(1, 2)
    first = shard_params(mesh, model, tensor_parallel=True)
    qkv = model.encoder.pretrained.blocks[0].attn.qkv.weight.clone()
    assert shard_params(mesh, model, tensor_parallel=True) is first
    assert torch.equal(model.encoder.pretrained.blocks[0].attn.qkv.weight,
                       qkv)
    assert model.encoder.pretrained.blocks[0].attn.num_heads == 1
    assert shard_params(mesh, model) is first   # the same request
    with pytest.raises(ValueError, match="already sharded over another"):
        shard_params(FakeMesh(1, 2), model, tensor_parallel=True)
    with pytest.raises(ValueError, match="fsdp=False; this call asks"):
        shard_params(mesh, model, tensor_parallel=True, fsdp=True)
    whole = get_model("AmodalDAv2", encoder="vitt", device="cpu")
    shard_params(make_mesh(), whole)
    assert all(p.replicated for p in shard_params(make_mesh(),
                                                  whole).values())


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_train_step_captured_by_default_only_where_it_can_be(monkeypatch,
                                                             backend):
    """On the card the train step is captured by default unless the mesh's
    collectives run over gloo (no CUDA graph holds them): then it runs
    eagerly, and only an explicit `captured=True` is refused; on the CPU it
    is eager unless asked for."""
    from amodal_depth_anything_tpu_torch.train.trainer import \
        _resolve_captured
    monkeypatch.setattr(torch.distributed, "get_backend", lambda: backend)
    cuda, cpu, mesh = torch.device("cuda"), torch.device("cpu"), \
        FakeMesh(2, 1)
    for local in (None, LocalMesh()):
        assert _resolve_captured(cuda, local, None) is True
        assert _resolve_captured(cpu, local, None) is False
    assert _resolve_captured(cuda, mesh, None) is (backend == "nccl")
    assert _resolve_captured(cuda, mesh, False) is False
    assert _resolve_captured(cpu, mesh, True) is True
    if backend == "gloo":
        with pytest.raises(ValueError, match="'gloo' group"):
            _resolve_captured(cuda, mesh, True)
    else:
        assert _resolve_captured(cuda, mesh, True) is True
