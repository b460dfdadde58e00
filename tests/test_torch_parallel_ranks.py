"""The port's scale-out over real ranks: gloo process groups on the CPU,
spawned with `torch.multiprocessing`, one torch thread a rank.

Three spawns: four ranks on a 2 x 2 mesh (tensor and sequence parallel
serving and training, FSDP) held against the JAX package on the same mesh
shape with the weights carried across by `convert/weights.py`; four ranks
on a pipe = 4 mesh and on data = 4 (the GPipe trunk against the sequential
one, DepthFM serving, the AmodalDAv2 and ADDeepLab trainers against their
one-process runs); two ranks running `cli.train --mesh_model 2`. The JAX
references and the one-process CLI run in the test's own process while the
ranks run (the ranks' results come back by file); a rank's exception fails
the test. Tolerances: the pipeline 1e-5 (JAX tests/test_pipeline.py), train
losses 1e-5 and parameters 1e-5 against JAX (tests/test_torch_trainer.py),
FSDP and sequence parallelism against the plain run at rtol 2e-4 / atol
2e-5 (JAX tests/test_fsdp.py), the GPipe trunk 1e-5, data parallelism
against one process: losses 1e-5, every gradient 1e-4 of its max abs."""

import contextlib
import dataclasses
import os
import pickle
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

HW = 56


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, work, path):
    torch.set_num_threads(1)
    from amodal_depth_anything_tpu_torch.parallel import initialize
    with open(path, "rb") as f:
        payload = pickle.load(f)
    initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        work(rank, payload)
    finally:
        dist.destroy_process_group()


def _spawn(work, world, payload, tmp_path, join=True):
    """`work(rank, payload)` on `world` gloo ranks. The payload goes by a
    file: a large pickled argument would block each start until the child
    before it has read it, starting the ranks one after another. With
    `join=False` returns the running ranks' context."""
    path = str(tmp_path / f"{work.__name__}.pkl")
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return mp.spawn(_entry, args=(world, _free_port(), work, path),
                    nprocs=world, join=join)


@contextlib.contextmanager
def _ranks_meanwhile(work, world, payload, tmp_path):
    """`work(rank, payload)` on `world` gloo ranks, started on entry and
    joined on exit (a rank's exception raises there), so that the body
    runs while they do; a body that raises stops them."""
    ctx = _spawn(work, world, payload, tmp_path, join=False)
    try:
        yield
    except BaseException:
        for proc in ctx.processes:
            proc.terminate()
            proc.join()
        raise
    while not ctx.join():
        pass


def _put(p, rank, result):
    with open(f"{p['out']}.{rank}", "wb") as f:
        pickle.dump(result, f)


def _results(out, world):
    """Each rank's `_put` result, in rank order."""
    got = []
    for rank in range(world):
        with open(f"{out}.{rank}", "rb") as f:
            got.append(pickle.load(f))
    return got


def _close(got, want, what, rtol=0.0, atol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want)
    bound = atol + rtol * np.abs(want)
    assert (err <= bound).all(), (what, float(err.max()))


def _grads_close(got: dict, want: dict, what: str):
    assert set(got) == set(want)
    for name, w in want.items():
        scale = float(w.abs().max())
        err = float((got[name] - w).abs().max())
        assert err <= 1e-4 * scale + 1e-12, (what, name, err, scale)


@pytest.fixture(scope="module")
def sam_tree(tmp_path_factory):
    from amodal_depth_anything_tpu_torch.data.synthetic import \
        make_synthetic_sam_tree
    root = tmp_path_factory.mktemp("sam_ranks")
    return str(root), make_synthetic_sam_tree(str(root), n=8, hw=HW)


def _batches(sam_tree, n=2, batch=4):
    from amodal_depth_anything_tpu_torch.data import (DataLoader,
                                                      DatasetMode,
                                                      SAMAmodalDataset)
    root, list_path = sam_tree
    loader = DataLoader(SAMAmodalDataset(
        mode=DatasetMode.TRAIN, filename_ls_path=list_path, dataset_dir=root,
        resize_to_hw=(HW, HW)), batch_size=batch, shuffle=True,
        drop_last=True)
    loader.set_epoch(0)
    return [b for _, b in zip(range(n), loader)]


def _cfg(**kw):
    from amodal_depth_anything_tpu_torch.train import TrainerConfig
    base = dict(loss_strategy="entire_target_object", max_iter=2, lr=1e-3,
                lr_total_iter=100, lr_warmup_steps=1, validation_period=0,
                visualization_period=0, save_period=0, log_interval=100,
                compute_dtype="float32", remat=False, attn_impl="plain",
                eval_metrics=("abs_relative_difference",))
    base.update(kw)
    return TrainerConfig(**base)


# ------------------------------------------------------- 2 x 2: TP, SP, FSDP

def _work_2x2(rank, p):
    from amodal_depth_anything_tpu_torch.convert.weights import (
        params_from_jax, params_to_jax)
    from amodal_depth_anything_tpu_torch.models import get_model
    from amodal_depth_anything_tpu_torch.models.amodal_dav2 import (
        DAV2Config, build_model)
    from amodal_depth_anything_tpu_torch.parallel import (MeshConfig,
                                                          make_mesh, sharding)
    from amodal_depth_anything_tpu_torch.parallel.mesh import LocalMesh
    from amodal_depth_anything_tpu_torch.pipeline.amodal_pipeline import \
        AmodalDepthPipeline
    from amodal_depth_anything_tpu_torch.train import DiscriminativeTrainer
    from amodal_depth_anything_tpu_torch.train.state import Adafactor
    from amodal_depth_anything_tpu_torch.train.trainer import \
        _resolve_captured

    mesh = make_mesh(MeshConfig(data=2, model=2))
    # on the card a gloo mesh's step defaults to eager; asked for, capture
    # is refused by name
    assert _resolve_captured(torch.device("cuda"), mesh, None) is False
    with pytest.raises(ValueError, match="gloo"):
        _resolve_captured(torch.device("cuda"), mesh, True)
    # serving: both trunks tensor-parallel, sequence-parallel streams
    models = []
    for name, cfg in (("raw", DAV2Config(encoder="vitt", guide_type="none",
                                         raw=True)),
                      ("amodal", DAV2Config(encoder="vitt",
                                            guide_type="mask+observation"))):
        m = build_model(cfg, device="cpu")
        m.load_state_dict(params_from_jax(p[name], cfg))
        models.append(m)
    pipe = AmodalDepthPipeline(*models, size=HW, attn_impl="plain",
                               device="cpu", mesh=mesh)
    assert pipe.act_sharding is mesh
    assert pipe.amodal_model.encoder.pretrained.blocks[0].attn.num_heads == 1
    base, blend = pipe(p["img"], p["mask"])

    # training: the plain 2 x 2 run (held against the JAX trainer's by the
    # test), FSDP and sequence parallelism against the plain run
    sharding.FSDP_MIN_ELEMENTS = 1024   # vitt's leaves are small
    runs = {}
    for name, kw in (("plain", {}), ("fsdp", {"fsdp": True}),
                     ("sp", {"sequence_parallel": True})):
        model = get_model("AmodalDAv2", encoder="vitt", device="cpu")
        tr = DiscriminativeTrainer(
            _cfg(**kw), model, None, device="cpu", mesh=mesh,
            params=params_from_jax(p["noisy"], model.cfg))
        assert not tr.captured
        losses = [float(tr._train_step(tr._device_batch(b)))
                  for b in p["batches"]]
        full = tr.full_state_dict()
        runs[name] = (losses, params_to_jax(full, model.cfg))
        if name == "fsdp":
            key = "encoder.pretrained.blocks.0.attn.qkv.weight"
            i = list(tr.state.params).index(key)
            piece = tr.state.params[key]
            assert tr.placements[key].spec == ("model", "data")
            for t in (piece, tr.state.opt_state["mu"][i],
                      tr.state.opt_state["nu"][i]):
                assert t.numel() * 4 == full[key].numel()
    flat = _flat(runs["plain"][1])
    for run in ("fsdp", "sp"):
        _close(runs[run][0], runs["plain"][0], f"{run} losses", 2e-4, 2e-5)
        other = _flat(runs[run][1])
        for name, want in flat.items():
            _close(other[name], want, f"{run} {name}", 2e-4, 2e-5)

    # adafactor on pieces: statistics and block RMS of the whole tensors
    updated = {}
    for key, m in (("pieces", mesh), ("whole", LocalMesh())):
        model = get_model("AmodalDAv2", encoder="vitt", device="cpu")
        tr = DiscriminativeTrainer(
            _cfg(optimizer="adafactor", fsdp=True), model, None,
            device="cpu", mesh=m, params=params_from_jax(p["noisy"],
                                                         model.cfg))
        assert isinstance(tr.tx, Adafactor)
        gen = torch.Generator().manual_seed(5)
        grads = []
        for name, q in tr.state.params.items():
            g = torch.randn(_full_shape(tr, name, q), generator=gen)
            pl = tr.placements[name]
            grads.append(g if pl.replicated
                         else sharding.shard_tensor(g, pl, m))
        scalars = tr.tx.scalars(tr.state.opt_state, "cpu")
        tr.tx.step_(list(tr.state.params.values()), grads,
                    tr.state.opt_state, scalars, True)
        updated[key] = tr.full_state_dict()
    for name, want in updated["whole"].items():
        _close(updated["pieces"][name], want, f"adafactor {name}",
               atol=1e-6)
    _put(p, rank, dict(base=np.asarray(base), blend=np.asarray(blend),
                       losses=runs["plain"][0], params=flat))


def _seeded_jax_params(cfg, seed, noise=0.0):
    """The port's seeded init of `cfg`'s model (plus `noise` times a
    standard normal on every leaf) as the JAX package's tree: the weights
    both packages start from, without a JAX init to trace."""
    from amodal_depth_anything_tpu_torch.convert.weights import params_to_jax
    from amodal_depth_anything_tpu_torch.models.amodal_dav2 import (
        DAV2Config, build_model, init_weights_)
    port_cfg = DAV2Config(**dataclasses.asdict(cfg))
    gen = torch.Generator().manual_seed(seed)
    model = init_weights_(build_model(port_cfg, device="cpu"), gen)
    if noise:
        for q in model.parameters():
            q.data.add_(noise * torch.randn(q.shape, generator=gen))
    return params_to_jax(model.state_dict(), port_cfg)


def _full_shape(tr, name, q):
    pl = tr.placements[name]
    shape = list(q.shape)
    for axis in ("model", "data"):
        d = pl.dim(axis)
        if d is not None:
            shape[d] *= 2
    return shape


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_tensor_sequence_fsdp_on_2x2_match_jax(sam_tree, rng, tmp_path):
    """AmodalDepthPipeline(mesh=2x2) and two trainer steps (plain, fsdp,
    sequence_parallel) on a 2 x 2 mesh against the JAX package on its own
    2 x 2 mesh; Adafactor's sharded reductions against whole tensors. The
    JAX references run while the ranks do."""
    import jax
    import jax.numpy as jnp

    from amodal_depth_anything_tpu.models import get_model as jax_get_model
    from amodal_depth_anything_tpu.models.amodal_dav2 import DAV2Config
    from amodal_depth_anything_tpu.parallel import MeshConfig, make_mesh
    from amodal_depth_anything_tpu.pipeline.amodal_pipeline import \
        AmodalDepthPipeline
    from amodal_depth_anything_tpu.train import DiscriminativeTrainer
    from amodal_depth_anything_tpu.train import TrainerConfig

    mesh = make_mesh(MeshConfig(data=2, model=2), devices=jax.devices()[:4])
    raw_cfg = DAV2Config(encoder="vitt", guide_type="none", raw=True)
    am_cfg = DAV2Config(encoder="vitt", guide_type="mask+observation")
    params = {"raw": _seeded_jax_params(raw_cfg, 0),
              "amodal": _seeded_jax_params(am_cfg, 1)}
    img = (rng.random((2, 80, 100, 3)) * 255).astype(np.float32)
    mask = np.zeros((2, 80, 100), np.float32)
    mask[:, 20:50, 30:70] = 1.0
    # every leaf noisy, so that biases, layer scales and the guidance embed
    # carry gradients (tests/test_torch_trainer.py::_noisy_jax_params)
    noisy = _seeded_jax_params(am_cfg, 2, noise=0.05)
    batches = _batches(sam_tree)
    out = str(tmp_path / "out")
    with _ranks_meanwhile(_work_2x2, 4, dict(
            raw=params["raw"], amodal=params["amodal"], img=img, mask=mask,
            noisy=noisy, batches=batches, out=out), tmp_path):
        jpipe = AmodalDepthPipeline(params["raw"], raw_cfg, params["amodal"],
                                    am_cfg, size=HW, attn_impl="xla",
                                    mesh=mesh)
        jbase, jblend = jpipe(img, mask)

        jcfg = TrainerConfig(**{**dataclasses.asdict(_cfg()),
                                "attn_impl": "xla"})
        jmodel = jax_get_model("AmodalDAv2", encoder="vitt")
        jtr = DiscriminativeTrainer(jcfg, jmodel, None, mesh=mesh,
                                    params=jax.tree.map(jnp.asarray, noisy))
        losses = []
        with jax.default_matmul_precision("highest"):
            for b in batches:
                jtr.state, loss = jtr._train_step(jtr.state,
                                                  jtr._device_batch(b))
                losses.append(float(loss))
        jax_params = _flat(jax.tree.map(np.asarray,
                                        jax.device_get(jtr.state.params)))
    for rank, got in enumerate(_results(out, 4)):
        _close(got["base"], np.asarray(jbase), f"rank {rank} pipeline base",
               rtol=1e-5)
        _close(got["blend"], np.asarray(jblend),
               f"rank {rank} pipeline blended", rtol=1e-5)
        for step, (a, b) in enumerate(zip(got["losses"], losses)):
            assert abs(a - b) <= 1e-5, ("loss", rank, step, a, b)
        for name, want in jax_params.items():
            _close(got["params"][name], want, f"rank {rank} params vs JAX "
                   f"{name}")


# ----------------------------------------- pipe = 4 and data = 4 on 4 ranks

def _work_pipe_data(rank, p):
    from amodal_depth_anything_tpu_torch.data import (DataLoader,
                                                      DatasetMode,
                                                      SAMAmodalDataset)
    from amodal_depth_anything_tpu_torch.models import get_model
    from amodal_depth_anything_tpu_torch.models.dinov2 import (
        DinoVisionTransformer, ViTConfig)
    from amodal_depth_anything_tpu_torch.models.amodal_dav2 import \
        init_weights_
    from amodal_depth_anything_tpu_torch.parallel import (MeshConfig,
                                                          make_mesh)
    from amodal_depth_anything_tpu_torch.parallel.mesh import LocalMesh
    from amodal_depth_anything_tpu_torch.parallel.pipeline import (
        pipeline_vit_blocks, reduce_stage_grads)
    from amodal_depth_anything_tpu_torch.pipeline.depthfm_pipeline import \
        DepthFMPipeline
    from amodal_depth_anything_tpu_torch.train import (
        AmodalSynthDriveTrainer, DiscriminativeTrainer)

    # remat="attn"'s checkpoint imports torch._dynamo at its first call
    # (about 2.5 s): import it on every rank at once, not one pipeline
    # stage after another
    import torch._dynamo  # noqa: F401

    # the GPipe trunk over pipe = 4 against the sequential trunk
    pmesh = make_mesh(MeshConfig(data=1, model=1, pipe=4))
    vit = DinoVisionTransformer(ViTConfig.preset("vitt"))
    gen = torch.Generator().manual_seed(0)
    for q in vit.parameters():
        q.data.normal_(0.0, 0.05, generator=gen)
    tokens0 = torch.randn(4, 20, 64, generator=gen)
    taps = (0, 1, 2, 3)
    for remat in (False, "attn"):
        def block_fn(blk, x):
            return blk(x, attn_impl="plain", remat=remat)
        results = {}
        for how in ("pipe", "seq"):
            vit.zero_grad()
            tokens = tokens0.clone().requires_grad_(True)
            if how == "pipe":
                out, tap_outs = pipeline_vit_blocks(
                    vit.blocks, tokens, block_fn, mesh=pmesh,
                    n_microbatches=2, taps=taps)
            else:
                x, tap_outs = tokens, []
                for blk in vit.blocks:
                    x = block_fn(blk, x)
                    tap_outs.append(x)
                out = x
            loss = out.square().sum() + sum((t * (i + 1)).sum()
                                             for i, t in enumerate(tap_outs))
            loss.backward()
            if how == "pipe":
                reduce_stage_grads(vit.blocks, pmesh)
            results[how] = ([out.detach()] + [t.detach() for t in tap_outs],
                            tokens.grad.clone(),
                            [q.grad.clone() for q in vit.blocks.parameters()])
        (o_p, tg_p, g_p), (o_s, tg_s, g_s) = results["pipe"], results["seq"]
        for a, b in zip(o_p, o_s):
            _close(a, b, f"pipe {remat} forward")
        _close(tg_p, tg_s, f"pipe {remat} token grads", 1e-5)
        for a, b in zip(g_p, g_s):
            _close(a, b, f"pipe {remat} block grads", 1e-5)

    dmesh = make_mesh(MeshConfig(data=4))
    # DepthFM serving: data-parallel against one process
    img = p["img"]
    outs = {}
    for key, m in (("mesh", dmesh), ("one", None)):
        pipe = DepthFMPipeline.init_random(3, size=32, num_steps=2,
                                           device="cpu", mesh=m)
        outs[key] = pipe(img, p["mask"], p["obs"])
    _close(outs["mesh"], outs["one"], "DepthFM data-parallel")

    # the AmodalDAv2 and ADDeepLab trainers: data = 4 against one process,
    # loss and every gradient of a step, then two steps
    root, list_path = p["tree"]
    loader = DataLoader(SAMAmodalDataset(
        mode=DatasetMode.TRAIN, filename_ls_path=list_path, dataset_dir=root,
        resize_to_hw=(HW, HW)), batch_size=4, shuffle=True, drop_last=True)
    for cls, name, kw in ((DiscriminativeTrainer, "AmodalDAv2",
                           dict(encoder="vitt")),
                          (AmodalSynthDriveTrainer, "ADDeepLab",
                           dict(tiny=True))):
        runs = {}
        for key, m in (("mesh", dmesh), ("one", LocalMesh())):
            model = get_model(name, device="cpu", **kw)
            if name == "AmodalDAv2":
                init_weights_(model, torch.Generator().manual_seed(1))
                params = model.state_dict()
            else:
                params = None
            tr = cls(_cfg(), model, loader, device="cpu", mesh=m, seed=1,
                     params=params)
            batch = tr._device_batch(p["batches"][0])
            loss, grads = tr.loss_and_grads(batch)
            steps = [float(tr._train_step(batch))]
            runs[key] = (float(loss), grads, steps, tr.full_state_dict())
        (l_m, g_m, s_m, sd_m), (l_o, g_o, s_o, sd_o) = \
            runs["mesh"], runs["one"]
        assert abs(l_m - l_o) <= 1e-5, (name, l_m, l_o)
        _grads_close(g_m, g_o, name)
        _close(s_m, s_o, f"{name} losses")
        for k, v in sd_o.items():
            _close(sd_m[k], v, f"{name} {k}", 2e-4, 2e-5)


def test_pipeline_trunk_and_data_parallel_on_4_ranks(sam_tree, rng,
                                                     tmp_path):
    """pipeline_vit_blocks on pipe = 4 (forward, taps, gradients with remat
    False and "attn") against the sequential trunk; DepthFMPipeline(mesh=)
    and the AmodalDAv2 / ADDeepLab trainers at data = 4 against their
    one-process runs (a step on 4 ranks of 1 row equals one of 4 rows)."""
    img = (rng.random((4, 40, 48, 3)) * 255).astype(np.float32)
    mask = (rng.random((4, 40, 48)) > 0.5).astype(np.float32)
    obs = rng.random((4, 40, 48)).astype(np.float32)
    _spawn(_work_pipe_data, 4, dict(img=img, mask=mask, obs=obs,
                                    tree=sam_tree,
                                    batches=_batches(sam_tree)), tmp_path)


# ----------------------------------------------- cli.train --mesh_model 2

def _no_tensorboard(logger_cls):
    """The CLI's TensorBoard writer left out: torch's SummaryWriter imports
    TensorFlow where it is installed (about 20 s a process), and these runs
    read only the checkpoints."""
    logger_cls.set_dir = lambda self, tb_dir: None


def _work_cli(rank, p):
    from amodal_depth_anything_tpu_torch.cli import train as train_cli
    from amodal_depth_anything_tpu_torch.utils.logging_util import \
        TrainingLogger
    _no_tensorboard(TrainingLogger)
    # the group is up: the CLI's initialize() finds it and joins no other
    train_cli.main(p["argv"] + ["--output_dir", p["out"], "--mesh_model",
                                "2"])


def _final_state(out):
    run = next((p for p in out.rglob("state.pt")
                if p.parent.name == "latest"))
    return torch.load(run, weights_only=True)


def test_train_cli_mesh_model_2_on_2_ranks(sam_tree, tmp_path, monkeypatch):
    """`cli.train --mesh_model 2 --device cpu` on 2 ranks (the trunk
    tensor-parallel) writes the checkpoint its one-process run writes (run
    here while the ranks run)."""
    import logging

    from amodal_depth_anything_tpu_torch.cli import train as train_cli
    from amodal_depth_anything_tpu_torch.utils.logging_util import \
        TrainingLogger
    monkeypatch.setattr(TrainingLogger, "set_dir", lambda self, d: None)
    root, _ = sam_tree
    cfg = os.path.join(os.path.dirname(__file__), "..", "configs",
                       "smoke_synthetic_vitt.yaml")
    argv = ["--config", cfg, "--base_data_dir", root, "--no_wandb",
            "--device", "cpu", "--max_iter", "2"]
    root_logger = logging.getLogger()
    handlers, level = root_logger.handlers[:], root_logger.level
    with _ranks_meanwhile(_work_cli, 2, dict(argv=argv,
                                             out=str(tmp_path / "two")),
                          tmp_path):
        try:
            train_cli.main(argv + ["--output_dir", str(tmp_path / "one")])
        finally:   # the CLI configures the root logger: put it back
            for h in root_logger.handlers[:]:
                if h not in handlers:
                    root_logger.removeHandler(h)
                    h.close()
            root_logger.handlers[:] = handlers
            root_logger.setLevel(level)
    one, two = _final_state(tmp_path / "one"), _final_state(tmp_path / "two")
    assert one["step"] == two["step"] == 2
    assert set(one["params"]) == set(two["params"])
    for k, v in one["params"].items():
        _close(two["params"][k], v, f"cli {k}", 2e-4, 2e-5)
    for key in ("mu", "nu"):
        for a, b in zip(two["opt_state"][key], one["opt_state"][key]):
            assert a.shape == b.shape
