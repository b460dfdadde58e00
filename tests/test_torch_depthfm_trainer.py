"""The port's DepthFM trainers vs the JAX package's, on the CPU.

Tiny DepthFMAmodal / DepthFM at 32 px on the synthetic SAM tree, float32,
plain attention on both sides (JAX `attn_impl="xla"` at HIGHEST matmul
precision). The same seeded numpy weights go to both packages through the
weight bridge, and the port's trainers are handed the JAX trainers' random
draws (`fold_in(PRNGKey(init_seed), step)`, then `split`, as the JAX steps
draw them) through their `_draws` hook. The JAX references come from the
JAX package's functions, each train-step function compiled once.

Tolerances: train outputs and evaluation 1e-4; loss 1e-5; every UNet
gradient leaf 1e-4 of its max abs (sums in another order); every parameter
1e-5 after three steps; the frozen VAE and text embedding bit-identical; a
resumed run bit-identical to an unbroken one."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from amodal_depth_anything_tpu.cli.train import \
    trainer_kwargs_from_cfg as jax_trainer_kwargs_from_cfg
from amodal_depth_anything_tpu.models import get_model as jax_get_model
from amodal_depth_anything_tpu.models.unet_ldm import apply_unet
from amodal_depth_anything_tpu.models.vae import vae_encode_mode
from amodal_depth_anything_tpu.ops import ddim as jddim
from amodal_depth_anything_tpu.parallel import MeshConfig, make_mesh
from amodal_depth_anything_tpu.train import \
    DepthFMAmodalTrainer as JaxFlowTrainer
from amodal_depth_anything_tpu.train import DepthFMTrainer as JaxDDPMTrainer
from amodal_depth_anything_tpu.train import TrainerConfig as JaxTrainerConfig
from amodal_depth_anything_tpu.train.depthfm_trainer import \
    _latent_masks as jax_latent_masks
from amodal_depth_anything_tpu.utils.config import \
    recursive_load_config as jax_load_config
from amodal_depth_anything_tpu.utils.loss import get_loss as jax_get_loss
from amodal_depth_anything_tpu.utils.multi_res_noise import \
    multi_res_noise_like as jax_multi_res_noise_like
from amodal_depth_anything_tpu_torch.cli.train import trainer_kwargs_from_cfg
from amodal_depth_anything_tpu_torch.convert.weights import (
    depthfm_params_from_jax, depthfm_params_to_jax)
from amodal_depth_anything_tpu_torch.data import DataLoader
from amodal_depth_anything_tpu_torch.data.base_depth_dataset import (
    BaseDepthDataset, DatasetMode, DepthFileNameMode)
from amodal_depth_anything_tpu_torch.models import depthfm as tfm
from amodal_depth_anything_tpu_torch.models import get_model
from amodal_depth_anything_tpu_torch.train import (DepthFMAmodalTrainer,
                                                   DepthFMTrainer,
                                                   TrainerConfig,
                                                   get_trainer_cls)
from amodal_depth_anything_tpu_torch.train.depthfm_trainer import \
    _unet_remat
from amodal_depth_anything_tpu_torch.utils.config import \
    recursive_load_config
from tests.test_torch_models import few_torch_threads  # noqa: F401
from tests.test_torch_trainer import _leaves, restore_logging  # noqa: F401

HW = 32
OUT_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
CONFIGS = os.path.join(os.path.dirname(__file__), os.pardir, "configs")
FLOW_CONFIG = os.path.join(CONFIGS, "train_depthfm_base.yaml")
DDPM_CONFIG = os.path.join(CONFIGS, "train_depthfm_ddpm_finetune.yaml")
MRN = {"strength": 0.9, "annealed": True, "downscale_strategy": "original"}
# the tiny preset with 48 UNet channels: with the preset's 32 every GroupNorm
# of the first level has one channel per group and removes any per-channel
# constant, so the conv bias before it and the time-embedding projections
# get a gradient of exactly 0, and only rounding would be compared there
WIDE = {"model_channels": 48}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def sam_tree(tmp_path_factory):
    from amodal_depth_anything_tpu_torch.data.synthetic import \
        make_synthetic_sam_tree
    root = tmp_path_factory.mktemp("sam_depthfm_torch")
    return str(root), make_synthetic_sam_tree(str(root), n=8, hw=HW)


def _batches(sam_tree, n):
    from amodal_depth_anything_tpu_torch.data import (SAMAmodalDataset,
                                                      DatasetMode as Mode)
    root, list_path = sam_tree
    loader = DataLoader(SAMAmodalDataset(
        mode=Mode.TRAIN, filename_ls_path=list_path, dataset_dir=root,
        resize_to_hw=(HW, HW)), batch_size=2, shuffle=True, drop_last=True)
    loader.set_epoch(0)
    return [b for _, b in zip(range(n), loader)]


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()
            if isinstance(v, np.ndarray) and v.dtype != object}


class _JaxFlowDraws:
    """The draws of the JAX flow-matching step (noise, then t) and of its
    evaluation (the q_sample noise from PRNGKey(val_init_seed))."""

    def _draws(self, specs, *, step=None):
        if step is None:
            (name, (_, shape)), = specs.items()
            return {name: _t(jax.random.normal(jax.random.PRNGKey(
                self.cfg.val_init_seed), shape, jnp.float32))}
        rng = jax.random.fold_in(jax.random.PRNGKey(self.cfg.init_seed or 0),
                                 step)
        k_noise, k_t, _ = jax.random.split(rng, 3)
        b = specs["t"][1][0]
        return {"noise": _t(jax.random.normal(k_noise, specs["noise"][1],
                                              jnp.float32)),
                "t": _t(jax.random.randint(k_t, (b, 1, 1, 1), 0,
                                           specs["t"][2])).view(b)}


class _JaxDDPMDraws(_JaxFlowDraws):
    """The draws of the JAX DDPM step: t, then the noise (split in 16 for
    the multi-resolution draws)."""

    def _draws(self, specs, *, step=None):
        if step is None:
            return super()._draws(specs)
        rng = jax.random.fold_in(jax.random.PRNGKey(self.cfg.init_seed or 0),
                                 step)
        k_t, k_noise = jax.random.split(rng)
        _, tshape, high = specs["t"]
        shapes = specs["noise"][1]
        if isinstance(shapes, list):
            keys = jax.random.split(k_noise, 16)
            noise = [_t(jax.random.normal(k, s, jnp.float32))
                     for k, s in zip(keys, shapes)]
        else:
            noise = _t(jax.random.normal(k_noise, shapes, jnp.float32))
        return {"t": _t(jax.random.randint(k_t, tshape, 0, high)),
                "noise": noise}


class FlowTrainer(_JaxFlowDraws, DepthFMAmodalTrainer):
    pass


class DDPMTrainer(_JaxDDPMDraws, DepthFMTrainer):
    pass


def _cfg(**kw):
    base = dict(loss_strategy="entire_target_object", loss_name="l1_loss",
                loss_kwargs={}, lr=1e-3, lr_total_iter=100,
                lr_warmup_steps=1, max_iter=3, validation_period=0,
                visualization_period=0, save_period=0, log_interval=1,
                compute_dtype="float32", remat=False, attn_impl="plain",
                eval_metrics=("abs_relative_difference",))
    base.update(kw)
    return TrainerConfig(**base)


def _jax_cfg(cfg):
    return JaxTrainerConfig(**{**dataclasses.asdict(cfg), "attn_impl": "xla"})


def _mesh():
    return make_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def flow():
    """(JAX model, seeded JAX params, the JAX trainer built once)."""
    jmodel = _jax_model("DepthFMAmodal")
    params = seeded_tree(jmodel, 2)
    jtrainer = JaxFlowTrainer(_jax_cfg(_cfg()), jmodel, None, mesh=_mesh(),
                              params=jax.tree.map(jnp.asarray, params))
    return jmodel, params, jtrainer


@pytest.fixture(scope="module")
def ddpm():
    jmodel = _jax_model("DepthFM")
    params = seeded_tree(jmodel, 3)
    jtrainer = JaxDDPMTrainer(
        _jax_cfg(_cfg(loss_name="mse_loss", loss_strategy="entire_scene")),
        jmodel, None, mesh=_mesh(), params=jax.tree.map(jnp.asarray, params),
        prediction_type="v_prediction", multi_res_noise=MRN)
    return jmodel, params, jtrainer


def seeded_tree(jmodel, seed):
    """Seeded numpy weights of the JAX tree's shapes (read off
    `jax.eval_shape`, so the init is never compiled): norm scales near 1,
    every other leaf near uniform(+-1/sqrt(fan_in)), none of them zero."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        noise = 0.05 * rng.standard_normal(a.shape)
        if path[-1].key == "scale":
            return (1.0 + noise).astype(np.float32)
        fan_in = int(np.prod(a.shape[:-1])) if a.ndim > 1 else a.shape[0]
        bound = fan_in ** -0.5
        return (rng.uniform(-bound, bound, a.shape) + noise).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))


def _jax_model(name):
    return jax_get_model(name, tiny=True, cfg_overrides=WIDE)


def _model(name):
    return get_model(name, tiny=True, device="cpu", cfg_overrides=WIDE)


def _port(cls, name, params, cfg, **kw):
    model = _model(name)
    return cls(cfg, model, None, device="cpu",
               params=depthfm_params_from_jax(params, model.cfg), **kw)


def _check_unet_grads(trainer, grads, ref_unet):
    """Every UNet gradient leaf within GRAD_TOL of its max abs."""
    sd = {k: torch.zeros_like(v)
          for k, v in trainer.model.state_dict().items()}
    sd.update(grads)
    assert set(grads) == {k for k in sd if k.startswith("unet.")}
    ours = dict(_leaves(depthfm_params_to_jax(sd, trainer.model.cfg)["unet"]))
    ref = dict(_leaves(ref_unet))
    assert set(ours) == set(ref)
    live = 0
    for name, r in ref.items():
        scale = np.abs(r).max()
        err = np.abs(ours[name] - r).max()
        assert err <= GRAD_TOL * scale, (name, err, scale)
        live += scale > 0
    assert live == len(ref)


# ------------------------------------------------------------ model outputs

@pytest.mark.parametrize("name", ["DepthFMAmodal", "DepthFM"])
def test_train_outputs_match_jax(sam_tree, flow, name):
    """`depthfm_train_outputs` (prediction and target latents) for each
    guide type the DepthFM configs name, with the noise and t of the JAX
    flow step at step 0 (DepthFMAmodal: the outputs inside that step's
    compiled loss)."""
    guide_type = recursive_load_config(
        FLOW_CONFIG if name == "DepthFMAmodal" else DDPM_CONFIG
    ).model.kwargs.guide_type
    assert guide_type == ("mask+observation" if name == "DepthFMAmodal"
                          else "none")
    batch = _batches(sam_tree, 1)[0]
    jb = _jax_batch(batch)
    rng = jax.random.fold_in(jax.random.PRNGKey(2024), 0)
    if name == "DepthFMAmodal":
        jmodel, params, _ = flow
        (_, (ref_pred, ref_target)), _ = _jax_flow_value_and_grad(jmodel)(
            params["unet"], {k: v for k, v in params.items() if k != "unet"},
            jb, jnp.ones((2, 16, 16, 4), bool))
    else:
        jmodel = _jax_model(name)
        params = seeded_tree(jmodel, 4)
        with jax.default_matmul_precision("highest"):
            ref_pred, ref_target = jmodel.apply(
                jax.tree.map(jnp.asarray, params), jb["rgb_norm"], rng=rng,
                mode="train", depth=jb["depth_gt"], attn_impl="xla")
    k_noise, k_t, _ = jax.random.split(rng, 3)
    noise = _t(jax.random.normal(k_noise, ref_pred.shape, jnp.float32))
    t = _t(jax.random.randint(k_t, (2, 1, 1, 1), 0, 400)).view(2)
    model = _model(name)
    assert model.cfg.guide_type == guide_type
    model.load_state_dict(depthfm_params_from_jax(params, model.cfg))
    tb = {k: _t(v) for k, v in batch.items()
          if isinstance(v, np.ndarray) and v.dtype != object}
    guides = {"guide_rgb": tb["guide_rgb_norm"], "guide_mask": tb["guide"],
              "observation": tb["depth_observation"]}
    with torch.no_grad():
        pred, target = model(tb["rgb_norm"], noise, mode="train",
                             depth=tb["depth_gt"], t=t, **guides)
    assert pred.shape == target.shape == (2, 16, 16, 4)
    assert np.asarray(ref_pred).std() > 0.05
    assert np.abs(pred.numpy() - np.asarray(ref_pred)).max() <= OUT_TOL
    assert np.abs(target.numpy() - np.asarray(ref_target)).max() <= OUT_TOL
    with pytest.raises(ValueError, match="pass t"):
        tfm.depthfm_train_outputs(model, noise, tb["rgb_norm"],
                                  tb["depth_gt"], **guides)


def test_unet_remat_keeps_loss_and_gradients(sam_tree, monkeypatch):
    """remat=True recomputes each UNet level in the backward pass: the same
    loss and gradients, twice the attention forwards. The default "attn"
    is no UNet recompute."""
    from amodal_depth_anything_tpu_torch.ops import flash_attention as fa
    forwards = []
    plain = fa.mha_reference
    monkeypatch.setattr(fa, "mha_reference", lambda *a, **kw:
                        forwards.append(1) or plain(*a, **kw))
    assert _unet_remat(_cfg(remat=True))
    assert not _unet_remat(_cfg(remat="attn"))
    assert not _unet_remat(_cfg(remat=False))
    batch = _batches(sam_tree, 1)[0]
    model = _model("DepthFMAmodal")
    results, counts = {}, {}
    for remat in (False, True, "attn"):
        trainer = DepthFMAmodalTrainer(_cfg(remat=remat, attn_impl=None),
                                       model, None, device="cpu", seed=5)
        forwards.clear()
        results[remat] = trainer.loss_and_grads(trainer._device_batch(batch))
        counts[remat] = len(forwards)
    n_attn = 2 * 11   # self + cross in each of the tiny UNet's 11 blocks
    assert counts == {False: n_attn, True: 2 * n_attn, "attn": n_attn}
    base_loss, base_grads = results[False]
    for remat in (True, "attn"):
        loss, grads = results[remat]
        assert abs(loss.item() - base_loss.item()) <= 1e-6 * abs(
            base_loss.item())
        for name, g in grads.items():
            scale = base_grads[name].abs().max().item()
            assert (g - base_grads[name]).abs().max().item() <= 1e-6 * scale


# --------------------------------------------------------- flow matching

@pytest.mark.parametrize("strategy", ["invisible_part",
                                      "entire_target_object",
                                      "entire_scene"])
def test_flow_loss_and_grads_match_jax(sam_tree, flow, strategy):
    """`DepthFMAmodalTrainer.loss_and_grads` against `jax.value_and_grad`
    of the JAX step's loss (its `loss_of`, one compile for the three
    strategies: the strategy only picks the mask)."""
    jmodel, params, jtrainer = flow
    batch = _batches(sam_tree, 1)[0]
    cfg = _cfg(loss_strategy=strategy)
    trainer = _port(FlowTrainer, "DepthFMAmodal", params, cfg)
    loss, grads = trainer.loss_and_grads(trainer._device_batch(batch))

    jb = _jax_batch(batch)
    valid, guide, invisible = jax_latent_masks(jb, _jax_cfg(cfg), (16, 16), 2)
    mask = {"invisible_part": valid & invisible,
            "entire_target_object": valid & guide,
            "entire_scene": valid}[strategy]
    (ref_loss, _), ref_grads = _jax_flow_value_and_grad(jmodel)(
        params["unet"], {k: v for k, v in params.items() if k != "unet"}, jb,
        jnp.broadcast_to(mask, (2, 16, 16, 4)))
    assert abs(float(loss) - float(ref_loss)) <= LOSS_TOL
    _check_unet_grads(trainer, grads, ref_grads)


_JAX_FNS = {}


def _jax_flow_value_and_grad(jmodel):
    """The JAX flow step's loss_of (step 0's key), differentiated with
    respect to the UNet, with the strategy mask as an input and the train
    outputs as its auxiliary result."""
    if "flow" not in _JAX_FNS:
        l1 = jax_get_loss("l1_loss")
        rng = jax.random.fold_in(jax.random.PRNGKey(2024), 0)

        def loss_of(unet, frozen, b, mask4):
            pred, target = jmodel.apply(
                {**frozen, "unet": unet}, b["rgb_norm"], rng=rng,
                mode="train", depth=b["depth_gt"],
                guide_rgb=b["guide_rgb_norm"], guide_mask=b["guide"],
                observation=b["depth_observation"], attn_impl="xla")
            loss = l1(pred, target, mask4)
            return jnp.where(jnp.isfinite(loss), loss, 0.0), (pred, target)

        fn = jax.jit(jax.value_and_grad(loss_of, has_aux=True))
        _JAX_FNS["flow"] = lambda *a: _highest(fn, *a)
    return _JAX_FNS["flow"]


def _highest(fn, *args):
    with jax.default_matmul_precision("highest"):
        out = fn(*args)
    return jax.device_get(out)


def test_three_flow_steps_match_the_jax_trainer(sam_tree, flow):
    """Three steps (clip, Adam and the schedule included), the loss of each
    and then every parameter against the JAX trainer's; the frozen VAE and
    text embedding bit-identical."""
    jmodel, params, jtrainer = flow
    batches = _batches(sam_tree, 3)
    trainer = _port(FlowTrainer, "DepthFMAmodal", params, _cfg())
    frozen = {k: v.clone() for k, v in trainer.model.state_dict().items()
              if not k.startswith("unet.")}
    assert len(frozen) and not any(
        k in trainer.state.params for k in frozen)
    with jax.default_matmul_precision("highest"):
        for batch in batches:
            jtrainer.state, ref_loss = jtrainer._train_step(
                jtrainer.state, jtrainer._device_batch(batch))
            loss = trainer._train_step(trainer._device_batch(batch))
            assert abs(float(loss) - float(ref_loss)) <= LOSS_TOL
    assert trainer.state.step == 3 and trainer.state.opt_state["count"] == 3
    sd = trainer.model.state_dict()
    for k, v in frozen.items():
        assert torch.equal(sd[k], v), k
    ours = dict(_leaves(depthfm_params_to_jax(sd, trainer.model.cfg)))
    before = dict(_leaves(params))
    moved = 0.0
    for name, r in _leaves(jax.device_get(jtrainer.state.params)):
        assert np.abs(ours[name] - r).max() <= PARAM_TOL, name
        if not name.startswith("unet/"):
            np.testing.assert_array_equal(r, before[name])
        moved = max(moved, np.abs(r - before[name]).max())
    assert moved > 1e-4


def test_flow_eval_forward_matches_jax(sam_tree, flow):
    jmodel, params, jtrainer = flow
    batch = _batches(sam_tree, 1)[0]
    with jax.default_matmul_precision("highest"):
        ref = jtrainer._eval_forward(jax.tree.map(jnp.asarray, params),
                                     jtrainer._device_batch(batch))
    trainer = _port(FlowTrainer, "DepthFMAmodal", params, _cfg())
    ours = trainer._eval_forward(trainer._device_batch(batch))
    for a, r in zip(ours, ref):
        assert a.shape == (2, HW, HW, 1)
        assert np.abs(a.numpy() - np.asarray(r)).max() <= OUT_TOL
    assert np.asarray(ref[0]).std() > 0.01


# --------------------------------------------------------------------- DDPM

def _jax_ddpm_reference(jmodel, params, batch, pred_type, mrn):
    """The JAX DDPM step's loss_of at step 0, written out: the frozen VAE's
    latents, the drawn t and noise, the target; the UNet's loss is
    differentiated by one compiled function for every variant."""
    mcfg = jmodel.config
    T = 1000
    alphas = jddim.linear_alphas_cumprod(T)
    b = _jax_batch(batch)
    rng = jax.random.fold_in(jax.random.PRNGKey(2024), 0)
    k_t, k_noise = jax.random.split(rng)
    encode = _JAX_FNS.setdefault("encode", jax.jit(vae_encode_mode,
                                                   static_argnums=2))
    with jax.default_matmul_precision("highest"):
        rgb_latent = encode(params["vae"], b["rgb_norm"], mcfg.vae)
        gt_latent = encode(params["vae"], jnp.repeat(b["depth_gt"], 3, -1),
                           mcfg.vae)
    t = jax.random.randint(k_t, (2,), 0, T)
    if mrn:
        ann = (t.astype(jnp.float32) / T).reshape(2, 1, 1, 1)
        noise = jax_multi_res_noise_like(k_noise, gt_latent, strength=0.9,
                                         annealed_t=ann)
    else:
        noise = jax.random.normal(k_noise, gt_latent.shape, jnp.float32)
    noisy = jddim.ddpm_add_noise(alphas, gt_latent, noise, t)
    target = {"sample": gt_latent, "epsilon": noise,
              "v_prediction": jddim.ddpm_velocity(alphas, gt_latent, noise,
                                                  t)}[pred_type]
    valid, _, _ = jax_latent_masks(b, JaxTrainerConfig(), (16, 16), 2)
    cond = jnp.broadcast_to(params["empty_text_embed"], (2, 7, 32))
    if "ddpm" not in _JAX_FNS:
        mse = jax_get_loss("mse_loss")

        def loss_of(unet, noisy, tf, ctx, ca, target, mask4):
            pred = apply_unet(unet, mcfg.unet, noisy, tf, context=ctx,
                              context_ca=ca, attn_impl="xla")
            loss = mse(pred, target, mask4)
            return jnp.where(jnp.isfinite(loss), loss, 0.0)

        _JAX_FNS["ddpm"] = jax.jit(jax.value_and_grad(loss_of))
    return _highest(_JAX_FNS["ddpm"], params["unet"], noisy,
                    t.astype(jnp.float32), rgb_latent, cond, target,
                    jnp.broadcast_to(valid, (2, 16, 16, 4)))


@pytest.mark.parametrize("mrn", [False, True])
@pytest.mark.parametrize("pred_type", ["sample", "epsilon", "v_prediction"])
def test_ddpm_loss_and_grads_match_jax(sam_tree, ddpm, pred_type, mrn):
    jmodel, params, _ = ddpm
    batch = _batches(sam_tree, 1)[0]
    trainer = _port(DDPMTrainer, "DepthFM", params,
                    _cfg(loss_name="mse_loss", loss_strategy="entire_scene"),
                    prediction_type=pred_type,
                    multi_res_noise=MRN if mrn else None)
    loss, grads = trainer.loss_and_grads(trainer._device_batch(batch))
    ref_loss, ref_grads = _jax_ddpm_reference(jmodel, params, batch,
                                              pred_type, mrn)
    assert float(ref_loss) > 0
    assert abs(float(loss) - float(ref_loss)) <= LOSS_TOL
    _check_unet_grads(trainer, grads, ref_grads)


def test_ddpm_eval_forward_matches_jax(sam_tree, ddpm):
    """DDIM (4 steps, v converted to eps), decode, per-sample min-max,
    alignment to the observation."""
    jmodel, params, jtrainer = ddpm
    batch = _batches(sam_tree, 1)[0]
    with jax.default_matmul_precision("highest"):
        ref = jtrainer._eval_forward(jax.tree.map(jnp.asarray, params),
                                     jtrainer._device_batch(batch))
    trainer = _port(DDPMTrainer, "DepthFM", params,
                    _cfg(loss_name="mse_loss", loss_strategy="entire_scene"),
                    prediction_type="v_prediction", multi_res_noise=MRN)
    pred, aligned = trainer._eval_forward(trainer._device_batch(batch))
    assert pred.min() == 0.0 and abs(pred.max().item() - 1.0) <= 1e-6
    for a, r in zip((pred, aligned), ref):
        assert np.abs(a.numpy() - np.asarray(r)).max() <= OUT_TOL


def test_ddpm_trainer_rejects_unknown_prediction_type():
    with pytest.raises(ValueError, match="prediction type"):
        DepthFMTrainer(_cfg(), get_model("DepthFM", tiny=True, device="cpu"),
                       None, device="cpu", prediction_type="x0")
    with pytest.raises(ValueError, match="depthfm loss strategy"):
        DepthFMAmodalTrainer(_cfg(loss_strategy="ssi invisible_part"),
                             get_model("DepthFMAmodal", tiny=True,
                                       device="cpu"), None, device="cpu")


def test_ddpm_plain_depth_validation(tmp_path):
    """The factory's eval protocol (reference depthfm_trainer.py:544-560):
    plain depth batches, without amodal keys, validate through the shared
    loop, aligned to the ground truth over the valid mask, into the overall
    banks only."""
    from PIL import Image

    root = tmp_path / "plain"
    root.mkdir()
    rng = np.random.default_rng(0)
    lines = []
    for i in range(2):
        rgb = (rng.random((HW, HW, 3)) * 255).astype(np.uint8)
        d16 = (rng.random((HW, HW)) * 60000 + 1000).astype(np.uint16)
        Image.fromarray(rgb).save(root / f"img{i}.png")
        Image.fromarray(d16).save(root / f"img{i}_depth.png")
        lines.append(f"img{i}.png img{i}_depth.png")
    (root / "list.txt").write_text("\n".join(lines) + "\n")
    ds = BaseDepthDataset(mode=DatasetMode.EVAL,
                          filename_ls_path=str(root / "list.txt"),
                          dataset_dir=str(root),
                          name_mode=DepthFileNameMode.id,
                          min_depth=1.0, max_depth=70000.0,
                          has_filled_depth=False)
    loader = DataLoader(ds, batch_size=2, pad_last=True)
    cfg = _cfg(loss_name="mse_loss", loss_strategy="entire_scene",
               gt_depth_type="depth_raw_linear")
    trainer = DepthFMTrainer(cfg, get_model("DepthFM", tiny=True,
                                            device="cpu"),
                             [], val_loaders=[loader], device="cpu")
    res = trainer.validate_single_dataset(loader, eval=True)
    assert np.isfinite(res["align_overall"]["abs_relative_difference"])
    assert np.isnan(res["align_easy"]["abs_relative_difference"])


# ------------------------------------------------------- recipe and resume

@pytest.mark.parametrize("path", [FLOW_CONFIG, DDPM_CONFIG])
def test_trainer_kwargs_from_cfg_matches_jax(path):
    cfg = recursive_load_config(path)
    ours = trainer_kwargs_from_cfg(cfg)
    assert ours == jax_trainer_kwargs_from_cfg(jax_load_config(path))
    cls = get_trainer_cls(cfg.trainer.name)
    if path == DDPM_CONFIG:
        assert cls is DepthFMTrainer
        assert ours == {"prediction_type": "v_prediction",
                        "num_train_timesteps": 1000, "beta_start": 0.00085,
                        "beta_end": 0.012, "multi_res_noise": MRN}
    else:
        assert cls is DepthFMAmodalTrainer and ours == {}
    trainer = cls(_cfg(), get_model(cfg.model.name, tiny=True, device="cpu",
                                    **cfg.model.kwargs.to_dict()),
                  None, device="cpu", **ours)
    assert trainer.model.cfg.guide_type == cfg.model.kwargs.guide_type


@pytest.mark.parametrize("cls,name", [(DepthFMAmodalTrainer, "DepthFMAmodal"),
                                      (DepthFMTrainer, "DepthFM")])
def test_resume_is_bitwise(sam_tree, tmp_path, cls, name):
    """One step, save, load into a fresh trainer, one more step: the same
    loss and parameters as two straight steps (the draws are seeded by
    (init_seed, step))."""
    def trainer(seed):
        kw = {"multi_res_noise": MRN} if cls is DepthFMTrainer else {}
        return cls(_cfg(loss_name="mse_loss"), get_model(
            name, tiny=True, device="cpu"), None, device="cpu", seed=seed,
            out_dir_ckpt=str(tmp_path), **kw)

    b0, b1 = _batches(sam_tree, 2)
    straight = trainer(0)
    losses = [float(straight._train_step(straight._device_batch(b)))
              for b in (b0, b1)]
    first = trainer(0)
    first._train_step(first._device_batch(b0))
    first.save_checkpoint("one")
    resumed = trainer(1)     # other weights until the load
    resumed.load_checkpoint(str(tmp_path / "one"))
    assert float(resumed._train_step(resumed._device_batch(b1))) == losses[1]
    ref = straight.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, ref[k]), k


@pytest.mark.parametrize("path", [FLOW_CONFIG, DDPM_CONFIG])
def test_train_cli_runs_a_depthfm_config_at_tiny_size(
        sam_tree, tmp_path, restore_logging, path):
    """`cli.train --device cpu` on the synthetic tree: the DepthFM config's
    model, trainer, loss and noise settings over the tiny smoke recipe."""
    from amodal_depth_anything_tpu_torch.cli import train as train_cli

    recipe = recursive_load_config(path).to_dict()
    overlay = {
        "base_config": [os.path.abspath(os.path.join(
            CONFIGS, "smoke_synthetic_vitt.yaml"))],
        "model": {"name": recipe["model"]["name"],
                  "kwargs": {**recipe["model"]["kwargs"], "tiny": True}},
        "trainer": {**recipe["trainer"], "save_period": 0,
                    "validation_period": 0, "visualization_period": 0},
        "loss": recipe["loss"], "max_iter": 2,
        "dataset": {s: {"resize_to_hw": [HW, HW]} for s in ("train", "val")},
        **({"multi_res_noise": recipe["multi_res_noise"]}
           if "multi_res_noise" in recipe else {}),
    }
    cfg_path = tmp_path / "depthfm_tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(overlay))
    out = tmp_path / "out"
    train_cli.main(["--config", str(cfg_path), "--base_data_dir",
                    sam_tree[0], "--output_dir", str(out), "--no_wandb",
                    "--device", "cpu"])
    run = next((out / "depthfm_tiny").iterdir())
    state = torch.load(run / "checkpoint" / "latest" / "state.pt",
                       weights_only=True)
    assert state["meta"]["effective_iter"] == 2 and state["step"] == 2
    assert any(k.startswith("vae.") for k in state["params"])
