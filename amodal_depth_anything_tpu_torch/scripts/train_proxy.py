"""Train the structured-weight quality proxies through the port.

Port of the JAX package's `scripts/train_proxy.py`. Every serving-ladder
quality verdict (int8 / ToMe / stacks, `pipeline/quality.py`) would rest on
seeded random weights otherwise, which understate trained-token similarity
and misstate activation outliers. This script trains small-but-real models
on the layered-scene synthetic task (`data/synthetic.make_synthetic_sam_tree(
style="scenes")`, a learnable amodal-depth problem) and writes float16
checkpoints in the JAX package's layout (flat "/"-keyed `.npz`, blocks
stacked [L, ...]), which both packages' `load_params_npz` read:

  * "flagship": the raw base (RawDAV2, a supervised L1 loop) and the guided
    AmodalDAv2 (the port's `DiscriminativeTrainer`, the production code
    path, on a one-rank mesh as the JAX script pins it);
  * "depthfm": a proxy VAE pretrained as an autoencoder, then frozen, and
    DepthFMAmodal's UNet through `DepthFMAmodalTrainer`;
  * "p2g": pix2gestalt's DDPM eps-prediction from (occluded RGB + visible
    mask) to the whole RGB, with 10% conditioning dropout.

The two packages' random draws differ (torch's generators, the port's
seeded inits), so these proxies are not the committed
`checkpoints/proxy/*.npz` bit for bit; train into another directory.
The corpus is read through the port's codec (`utils.image.read_image`,
`utils.host_image.resize_nearest`), not PIL.

    python -m amodal_depth_anything_tpu_torch.scripts.train_proxy \\
        --out work_dir/proxy --encoder vitp --size 112 --steps 800 \\
        [--family flagship|depthfm|p2g|all] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import tempfile

import numpy as np

__all__ = ["flatten_params", "unflatten_params", "save_params_npz",
           "load_params_npz", "main", "DEPTHFM_PROXY_OVERRIDES"]

# narrow-channel analogs of the SD-1.5 bodies (the JAX script's)
DEPTHFM_PROXY_OVERRIDES = dict(
    model_channels=48, channel_mult=(1, 2, 4, 4), num_heads=4,
    context_dim=64, context_len=7, vae_channels=(32, 64, 96, 96),
    vae_layers=1)


def flatten_params(params) -> dict:
    """Nested-dict tree (JAX layout) -> {'a/b/c': np.ndarray}."""
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            path = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(val, dict):
                walk(val, path)
            else:
                out[path] = np.asarray(val.detach().cpu().float()
                                       if hasattr(val, "detach") else val)
    walk(params, "")
    return out


def unflatten_params(flat: dict) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def save_params_npz(path: str, params, *, dtype=np.float16) -> None:
    """A JAX-layout tree as the JAX package's compressed flat `.npz`
    (float leaves cast to `dtype`)."""
    flat = {k: v.astype(dtype) if np.issubdtype(v.dtype, np.floating)
            else v for k, v in flatten_params(params).items()}
    np.savez_compressed(path, **flat)


def load_params_npz(path: str, *, dtype=np.float32) -> dict:
    with np.load(path) as z:
        flat = {k: (np.asarray(z[k], dtype)
                    if np.issubdtype(z[k].dtype, np.floating) else z[k])
                for k in z.files}
    return unflatten_params(flat)


def _load_corpus(root: str, list_path: str, size: int):
    """The whole scenes tree as arrays (tiny by construction): rgb, depth,
    amodal depth, whole and visible masks."""
    from ..utils.host_image import resize_nearest
    from ..utils.image import read_image

    def img(d, name):
        px = read_image(os.path.join(root, d, name))
        if px.shape[:2] != (size, size):
            px = resize_nearest(px, (size, size))
        return px

    rgbs, depths, amodal_depths, wholes, visibles = [], [], [], [], []
    with open(list_path) as f:
        for line in f:
            stem = os.path.basename(line.split()[0])
            rgbs.append(img("occlusion", stem).astype(np.float32) / 255.0)
            depths.append(img("depth_da_update_occ", stem)
                          .astype(np.float32) / 65535.0)
            amodal_depths.append(img("depth_da_update_combine", stem)
                                 .astype(np.float32) / 65535.0)
            wholes.append(img("whole_mask", stem) > 127)
            visibles.append(img("visible_object_mask", stem) > 127)
    return (np.stack(rgbs), np.stack(depths), np.stack(amodal_depths),
            np.stack(wholes), np.stack(visibles))


def _adam(params, lr: float, steps: int):
    """optax.chain(clip_by_global_norm(1.0), adam(cosine_decay_schedule(lr,
    steps))) on the port's optimizer (`train.state.Optimizer`)."""
    from ..train.state import Optimizer

    def cosine(count):
        t = min(count, steps) / steps
        return lr * 0.5 * (1.0 + math.cos(math.pi * t))

    tx = Optimizer(cosine, 1.0, schedule_constant_from=steps)
    return tx, tx.init(params)


def _fit(loss_fn, params, batches, *, lr, steps, tag, log_every=50):
    """A plain supervised loop: Adam with a global-norm clip and a cosine
    schedule; returns the losses."""
    import torch

    tx, state = _adam(params, lr, steps)
    losses = []
    for it in range(steps):
        loss, aux = loss_fn(*batches(it))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        tx.update(params, [torch.zeros_like(p) if g is None else g.detach()
                           for p, g in zip(params, grads)], state)
        losses.append(float(loss))
        if it % log_every == 0 or it == steps - 1:
            print(f"[{tag}] step {it} loss {float(loss):.4f}"
                  + "".join(f" {k} {v:.4f}" for k, v in aux.items()),
                  flush=True)
    return losses


def train_raw_base(rgbs, depths, *, encoder: str, steps: int, batch: int,
                   lr: float, seed: int = 0, device="cuda"):
    """RGB -> scene depth, scale-aware L1 (the raw ReLU head gives
    unnormalised relative depth; an absolute target keeps the proxy
    deterministic). The head's last bias starts positive (`init_weights_`),
    or the output ReLU starts dead. Returns (model, losses)."""
    import torch

    from ..models.amodal_dav2 import DAV2Config, build_model, init_weights_

    cfg = DAV2Config(encoder=encoder, guide_type="none", raw=True)
    model = init_weights_(build_model(cfg, device=device),
                          torch.Generator(device=device).manual_seed(seed))
    params = list(model.parameters())
    rng = np.random.default_rng(seed)
    n = rgbs.shape[0]

    def batches(it):
        idx = rng.choice(n, size=batch, replace=False)
        return (torch.as_tensor(rgbs[idx], device=device),
                torch.as_tensor(depths[idx], device=device))

    def loss_fn(x, y):
        return (model(x, attn_impl="plain") - y).abs().mean(), {}

    losses = _fit(loss_fn, params, batches, lr=lr, steps=steps,
                  tag=f"raw {encoder}")
    return model, losses


def train_amodal(root: str, list_path: str, *, encoder: str, size: int,
                 steps: int, batch: int, lr: float, device="cuda"):
    """The guided model through the port's `DiscriminativeTrainer` on the
    scenes tree, on a one-rank mesh. Returns the trained model."""
    from ..data import DataLoader, DatasetMode, SAMAmodalDataset
    from ..models import get_model
    from ..parallel import MeshConfig, make_mesh
    from ..train import DiscriminativeTrainer, TrainerConfig

    ds = SAMAmodalDataset(mode=DatasetMode.TRAIN, filename_ls_path=list_path,
                          dataset_dir=root, resize_to_hw=(size, size))
    loader = DataLoader(ds, batch_size=batch, shuffle=True, drop_last=True)
    cfg = TrainerConfig(loss_strategy="entire_target_object", max_iter=steps,
                        lr=lr, lr_total_iter=steps, lr_warmup_steps=20,
                        max_grad_norm=1.0, validation_period=0,
                        visualization_period=0, save_period=0,
                        log_interval=max(steps // 10, 1),
                        compute_dtype="float32", remat=False,
                        attn_impl="plain")
    model = get_model("AmodalDAv2", encoder=encoder, device=device)
    trainer = DiscriminativeTrainer(
        cfg, model, loader, device=device,
        mesh=make_mesh(MeshConfig(data=1, model=1)))
    trainer.train()
    return trainer.model


def pretrain_vae(images_m1, vae_cfg, *, steps: int, batch: int, lr: float,
                 seed: int = 0, device="cuda"):
    """Autoencoder pretrain of a proxy VAE (the SD VAE is pretrained and
    frozen in every recipe): L1 reconstruction plus a unit-latent-std pull.
    images_m1: [N,H,W,3] in [-1, 1]. Returns (vae, recon l1, latent std)."""
    import torch

    from ..heuristics.mask_heuristics import init_heuristics_
    from ..models.vae import AutoencoderKL

    vae = init_heuristics_(AutoencoderKL(vae_cfg).to(device),
                           torch.Generator(device=device)
                           .manual_seed(seed + 17))
    rng = np.random.default_rng(seed)
    n = images_m1.shape[0]
    last = {}

    def batches(it):
        idx = rng.choice(n, size=min(batch, n), replace=False)
        return (torch.as_tensor(images_m1[idx], device=device),)

    def loss_fn(x):
        lat = vae.encode_mode(x)
        l1 = (vae.decode(lat) - x).abs().mean()
        std = lat.std()
        last.update(recon_l1=float(l1), latent_std=float(std))
        return l1 + 0.05 * (std - 1.0) ** 2, dict(last)

    _fit(loss_fn, list(vae.parameters()), batches, lr=lr, steps=steps,
         tag="vae")
    vae.requires_grad_(False)
    return vae, last["recon_l1"], last["latent_std"]


def train_depthfm_proxy(root: str, list_path: str, out: str, *, size: int,
                        steps: int, batch: int, lr: float, seed: int = 0,
                        device="cuda"):
    """DepthFMAmodal proxy: a pretrained, frozen proxy VAE and the UNet
    trained through `DepthFMAmodalTrainer` (flow matching in the latents),
    on a one-rank mesh; writes `depthfm.npz` and `depthfm_meta.json`."""
    import torch

    from ..convert.weights import depthfm_params_to_jax
    from ..data import DataLoader, DatasetMode, SAMAmodalDataset
    from ..models import get_model
    from ..models.depthfm import init_depthfm_
    from ..parallel import MeshConfig, make_mesh
    from ..train import DepthFMAmodalTrainer, TrainerConfig

    model = get_model("DepthFMAmodal", device=device,
                      cfg_overrides=dict(DEPTHFM_PROXY_OVERRIDES))
    init_depthfm_(model, torch.Generator(device=device).manual_seed(seed))
    rgbs, depths, _, _, _ = _load_corpus(root, list_path, size)
    depth3 = np.repeat(depths[..., None], 3, axis=-1)
    corpus = (np.concatenate([rgbs, depth3]) * 2.0 - 1.0).astype(np.float32)
    vae, vae_l1, vae_std = pretrain_vae(
        corpus, model.cfg.vae, steps=max(steps // 2, 200), batch=batch,
        lr=lr, seed=seed, device=device)
    model.vae.load_state_dict(vae.state_dict())

    ds = SAMAmodalDataset(mode=DatasetMode.TRAIN, filename_ls_path=list_path,
                          dataset_dir=root, resize_to_hw=(size, size))
    loader = DataLoader(ds, batch_size=batch, shuffle=True, drop_last=True)
    cfg = TrainerConfig(loss_strategy="entire_target_object",
                        loss_name="l1_loss", loss_kwargs={}, max_iter=steps,
                        lr=lr, lr_total_iter=steps, lr_warmup_steps=20,
                        max_grad_norm=1.0, compute_dtype="float32",
                        remat=False, attn_impl="plain", validation_period=0,
                        visualization_period=0, save_period=0,
                        log_interval=max(steps // 10, 1))
    trainer = DepthFMAmodalTrainer(
        cfg, model, loader, device=device, params=model.state_dict(),
        mesh=make_mesh(MeshConfig(data=1, model=1)))
    trainer.train()
    model = trainer.model

    # a flat 4-step output would make every gate delta vacuously small
    with torch.no_grad():
        x = torch.as_tensor(rgbs[:2] * 2.0 - 1.0, device=device)
        m = torch.ones(x.shape[:3] + (1,), device=device)
        noise = torch.Generator(device=device).manual_seed(1)
        pred = model(x, noise, mode="eval", num_steps=4, guide_mask=m,
                     observation=torch.zeros_like(m), attn_impl="plain")
    pred_std = float(pred.std())
    os.makedirs(out, exist_ok=True)
    save_params_npz(os.path.join(out, "depthfm.npz"),
                    depthfm_params_to_jax(model.state_dict(), model.cfg))
    meta = {"family": "depthfm", "overrides": DEPTHFM_PROXY_OVERRIDES,
            "size": size, "steps": steps, "batch": batch, "lr": lr,
            "seed": seed, "style": "scenes", "vae_recon_l1": vae_l1,
            "vae_latent_std": vae_std, "eval_pred_std": pred_std}
    with open(os.path.join(out, "depthfm_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps(meta))
    if pred_std < 0.01:
        print("WARNING: depthfm proxy eval output near-flat "
              f"(std {pred_std:.4f}) -- gate verdicts unreliable")
    return model


def _p2g_proxy_cfgs():
    from ..models.clip_vit import CLIPVisionConfig
    from ..models.pix2gestalt import Pix2GestaltConfig
    from ..models.vae import VAEConfig
    return (Pix2GestaltConfig(image_size=256, context_dim=64,
                              model_channels=48, channel_mult=(1, 2, 4, 4),
                              num_heads=4),
            CLIPVisionConfig(image_size=64, patch_size=16, width=64,
                             depth=2, num_heads=2, projection_dim=64),
            VAEConfig(block_out_channels=(32, 64, 96, 96),
                      layers_per_block=1))


def train_p2g_proxy(root: str, list_path: str, out: str, *, size: int,
                    steps: int, batch: int, lr: float, seed: int = 0,
                    device="cuda"):
    """pix2gestalt proxy: DDPM eps-prediction on (occluded RGB + visible
    mask) -> whole RGB, conditioned as `Pix2Gestalt.context` conditions
    (VAE latents of the image and the mask render channel-concatenated,
    the CLIP image embedding as a one-token context), with 10%
    conditioning dropout so classifier-free guidance is trained. Writes
    `p2g.npz` and `p2g_meta.json`."""
    import torch

    from ..convert.weights import p2g_params_to_jax
    from ..heuristics.mask_heuristics import init_heuristics_
    from ..models.pix2gestalt import Pix2Gestalt
    from ..ops.ddim import ddpm_add_noise, linear_alphas_cumprod
    from ..utils.host_image import resize_nearest
    from ..utils.image import read_image

    p2g_cfg, clip_cfg, vae_cfg = _p2g_proxy_cfgs()
    rgbs, _, _, _, visibles = _load_corpus(root, list_path, size)
    whole = []
    with open(list_path) as f:
        for line in f:
            stem = os.path.basename(line.split()[0]).replace(
                "_occlusion", "_whole")
            px = read_image(os.path.join(root, "whole", stem))
            if px.shape[:2] != (size, size):
                px = resize_nearest(px, (size, size))
            whole.append(px.astype(np.float32) / 255.0)
    whole = np.stack(whole)
    mask01 = visibles.astype(np.float32)[..., None]
    corpus = np.concatenate([rgbs, whole, np.repeat(mask01, 3, axis=-1)])
    vae, vae_l1, vae_std = pretrain_vae(
        (corpus * 2.0 - 1.0).astype(np.float32), vae_cfg,
        steps=max(steps // 2, 200), batch=batch, lr=lr, seed=seed + 1,
        device=device)

    p2g = init_heuristics_(Pix2Gestalt(p2g_cfg, clip_cfg, vae_cfg).to(device),
                           torch.Generator(device=device)
                           .manual_seed(seed + 2))
    p2g.vae.load_state_dict(vae.state_dict())
    p2g.vae.requires_grad_(False)
    alphas = linear_alphas_cumprod(1000, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    rng = np.random.default_rng(seed)
    n = rgbs.shape[0]

    def batches(it):
        idx = rng.choice(n, size=min(batch, n), replace=False)
        return tuple(torch.as_tensor(a[idx], device=device)
                     for a in (rgbs, mask01, whole))

    def loss_fn(vis01, m01, whole01):
        b = vis01.shape[0]
        with torch.no_grad():
            ctx, cond = p2g.context(vis01, m01, p2g_cfg)
            target = p2g.vae.encode_mode(whole01 * 2.0 - 1.0)
        # 10% CFG dropout zeroes both conditionings together
        drop = torch.rand(b, 1, 1, generator=gen, device=device) < 0.1
        ctx = torch.where(drop, p2g.uncond_ctx.expand_as(ctx), ctx)
        cond = torch.where(drop[..., None], 0.0, cond)
        t = torch.randint(0, 1000, (b,), generator=gen, device=device)
        noise = torch.randn(target.shape, generator=gen, device=device)
        noisy = ddpm_add_noise(alphas, target, noise, t)
        pred = p2g.unet(noisy, t.float(), context=cond, context_ca=ctx,
                        attn_impl="plain")
        return (pred - noise).square().mean(), {}

    losses = _fit(loss_fn, list(p2g.unet.parameters()), batches, lr=lr,
                  steps=steps, tag="p2g")
    os.makedirs(out, exist_ok=True)
    save_params_npz(os.path.join(out, "p2g.npz"), p2g_params_to_jax(
        p2g.state_dict(), p2g_cfg, clip_cfg, vae_cfg))
    first, last = float(np.mean(losses[:50])), float(np.mean(losses[-50:]))
    meta = {"family": "p2g", "p2g_cfg": dataclasses.asdict(p2g_cfg),
            "clip_cfg": dataclasses.asdict(clip_cfg),
            "vae_cfg": dataclasses.asdict(vae_cfg), "size": size,
            "steps": steps, "batch": batch, "lr": lr, "seed": seed,
            "style": "scenes", "vae_recon_l1": vae_l1,
            "vae_latent_std": vae_std, "eps_mse_first50_mean": first,
            "eps_mse_last50_mean": last}
    with open(os.path.join(out, "p2g_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps(meta))
    if not last < 0.9 * first:
        print(f"WARNING: p2g proxy under-trained (eps_mse {first:.4f} -> "
              f"{last:.4f}) -- gate verdicts unreliable")
    return p2g


def _scenes(args) -> tuple[str, str]:
    root = args.data_dir or os.path.join(
        tempfile.gettempdir(),
        f"proxy_scenes_{args.data_n}_{args.size}_{args.seed}")
    list_path = os.path.join(root, "train.txt")
    if not os.path.exists(list_path):
        from ..data.synthetic import make_synthetic_sam_tree
        list_path = make_synthetic_sam_tree(root, n=args.data_n,
                                            hw=args.size, seed=args.seed,
                                            style="scenes")
    return root, list_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="checkpoints/proxy")
    ap.add_argument("--family", default="flagship",
                    choices=["flagship", "depthfm", "p2g", "all"])
    ap.add_argument("--encoder", default="vitp")
    ap.add_argument("--size", type=int, default=112,
                    help="train resolution (multiple of 14 for flagship; "
                         "multiple of 8 for the generative families)")
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data-n", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-dir", default=None,
                    help="reuse an existing scenes tree")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    import torch

    from ..convert.weights import params_to_jax
    from ..ops.precision import apply_precision_policy

    apply_precision_policy(torch.float32)
    root, list_path = _scenes(args)
    kw = dict(size=args.size, steps=args.steps, batch=args.batch,
              lr=args.lr, seed=args.seed, device=args.device)
    if args.family in ("depthfm", "all"):
        train_depthfm_proxy(root, list_path, args.out, **kw)
    if args.family in ("p2g", "all"):
        train_p2g_proxy(root, list_path, args.out, **kw)
    if args.family not in ("flagship", "all"):
        return

    rgbs, depths, _, _, _ = _load_corpus(root, list_path, args.size)
    os.makedirs(args.out, exist_ok=True)
    raw, raw_losses = train_raw_base(
        rgbs, depths, encoder=args.encoder, steps=args.steps,
        batch=args.batch, lr=args.lr, seed=args.seed, device=args.device)
    save_params_npz(os.path.join(args.out, "raw_base.npz"),
                    params_to_jax(raw.state_dict(), raw.cfg))
    amodal = train_amodal(root, list_path, encoder=args.encoder,
                          size=args.size, steps=args.steps, batch=args.batch,
                          lr=args.lr, device=args.device)
    save_params_npz(os.path.join(args.out, "amodal.npz"),
                    params_to_jax(amodal.state_dict(), amodal.cfg))

    # convergence and non-degeneracy evidence for the gate runs
    with torch.no_grad():
        pred = raw(torch.as_tensor(rgbs[:4], device=args.device),
                   attn_impl="plain")
    pred_std = float(pred.std())
    first = float(np.mean(raw_losses[:50]))
    last = float(np.mean(raw_losses[-50:]))
    if not (last < 0.8 * first and pred_std > 0.01):
        print(f"WARNING: raw proxy under-trained (loss {first:.4f} -> "
              f"{last:.4f}, pred_std {pred_std:.4f}) -- gate verdicts on "
              "this checkpoint are unreliable")
    meta = {"encoder": args.encoder, "size": args.size,
            "steps": args.steps, "batch": args.batch, "lr": args.lr,
            "data_n": args.data_n, "seed": args.seed, "style": "scenes",
            "raw_loss_first50_mean": first, "raw_loss_last50_mean": last,
            "raw_pred_std": pred_std}
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
