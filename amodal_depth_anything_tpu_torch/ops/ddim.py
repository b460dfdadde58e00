"""The DDPM noise schedule, the DDIM sampler and the DeepCache spec parser.

Port of the JAX package's `ops/ddim.py`. The schedule is the LDM
"scaled_linear" one (SD-1.5 defaults): betas linear in sqrt space, in
float32, then their cumulative product. `ddpm_add_noise` and `ddpm_velocity`
are the forward process and the v-prediction target the DDPM trainer
(`train/depthfm_trainer.py::DepthFMTrainer`) trains on; `ddim_sample` is the
deterministic (eta = 0) DDIM loop its evaluation samples with, with
classifier-free guidance and DeepCache for the pix2gestalt path. The JAX loop
is a `lax.scan`; here it is a Python loop over the same steps.
"""

from __future__ import annotations

import torch

__all__ = ["ddim_sample", "linear_alphas_cumprod", "ddpm_add_noise",
           "ddpm_velocity", "parse_deep_cache"]


def parse_deep_cache(spec, default_groups: int = 3):
    """A DeepCache spec -> (interval, groups) or None.

    None, "" and 0 turn it off; an int or "N" means (N, default_groups);
    "N,G" or a pair means (N, G). The interval is how many solver steps
    share one full UNet pass, the groups how many of the shallowest
    input/output groups the steps in between still run. Malformed specs
    and non-positive values raise ValueError."""
    if spec is None or spec == "" or (isinstance(spec, int) and spec == 0):
        return None
    if isinstance(spec, (tuple, list)):
        if len(spec) != 2:
            raise ValueError(f"deep_cache pair must be (interval, groups), "
                             f"got {spec!r}")
        parts = list(spec)
    elif isinstance(spec, int):
        parts = [spec]
    else:
        parts = str(spec).split(",")
        if len(parts) > 2:
            raise ValueError(f"deep_cache spec must be 'N' or 'N,G', got "
                             f"{spec!r}")
    try:
        values = [int(p) for p in parts]
    except (TypeError, ValueError):
        raise ValueError(f"deep_cache spec must hold integers, got "
                         f"{spec!r}") from None
    if values[0] == 0:
        return None
    if len(values) == 1:
        values.append(default_groups)
    interval, groups = values
    if interval < 1 or groups < 1:
        raise ValueError(f"deep_cache interval and groups must be positive, "
                         f"got {spec!r}")
    return (interval, groups)


def linear_alphas_cumprod(n_timesteps: int = 1000, beta_start: float = 0.00085,
                          beta_end: float = 0.012, *,
                          device=None) -> torch.Tensor:
    """SD 'scaled_linear' schedule: betas linear in sqrt space, float32."""
    betas = torch.linspace(beta_start ** 0.5, beta_end ** 0.5, n_timesteps,
                           dtype=torch.float32, device=device) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


def _gather_ab(alphas_cumprod, t, like):
    """alphas_cumprod at the per-sample integer `t`, in `like`'s dtype,
    shaped to broadcast over `like`."""
    ab = alphas_cumprod[t.long()].to(like.dtype)
    return ab.reshape(ab.shape + (1,) * (like.dim() - ab.dim()))


def ddpm_add_noise(alphas_cumprod, x0, noise, t):
    """DDPM forward process q(x_t | x_0) with per-sample integer timesteps
    (diffusers `DDPMScheduler.add_noise`, reference
    `src/trainer/depthfm_trainer.py:268-270`): sqrt(ab_t) x0 +
    sqrt(1 - ab_t) eps. t: [B] integers; x0, noise: [B, ...]."""
    ab = _gather_ab(alphas_cumprod, t, x0)
    return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise


def ddpm_velocity(alphas_cumprod, x0, noise, t):
    """v-prediction target (diffusers `get_velocity`, reference
    `depthfm_trainer.py:296-298`): sqrt(ab_t) eps - sqrt(1 - ab_t) x0."""
    ab = _gather_ab(alphas_cumprod, t, x0)
    return torch.sqrt(ab) * noise - torch.sqrt(1.0 - ab) * x0


def ddim_sample(model_fn, rng, shape, *, num_steps: int = 50,
                guidance_scale: float = 1.0, uncond_fn=None, joint_fn=None,
                deep_cache=None, n_train_timesteps: int = 1000,
                dtype: torch.dtype = torch.float32,
                beta_start: float = 0.00085, beta_end: float = 0.012,
                device=None) -> torch.Tensor:
    """Sample latents of `shape` by DDIM (eta = 0).

    `rng`: a `torch.Generator` (the initial noise is drawn on its device in
    float32) or the initial noise itself; the latents live on `device`
    (default: the generator's or the noise's) in `dtype`.

    model_fn(x, t) -> predicted noise eps; `t` is a [B] int64 tensor of
    diffusion timesteps, "leading" spacing, descending. With
    guidance_scale != 1, `uncond_fn(x, t)` gives the unconditional
    prediction for classifier-free guidance, or `joint_fn(x2b, t2b)` both at
    once at batch 2B (conditional half first). `beta_start`/`beta_end` must
    match the training schedule.

    `deep_cache=(interval N, groups G)`: every N-th step runs the full UNet
    and keeps its deep feature; the steps in between run only the G
    shallowest input/output groups with the kept feature spliced in (see
    `models.unet_ldm.UNetModel.forward`). The model fns then take
    `deep_cache_groups=` / `cached_deep=` keywords (a full pass returns
    `(eps, deep)`). N must divide `num_steps`; N = 1 equals the plain loop,
    N > 1 is an opt-in approximation."""
    if deep_cache is not None and num_steps % deep_cache[0] != 0:
        raise ValueError(f"deep_cache interval {deep_cache[0]} must divide "
                         f"num_steps {num_steps}")
    if isinstance(rng, torch.Tensor):
        if tuple(rng.shape) != tuple(shape):
            raise ValueError(f"initial noise must have shape {tuple(shape)}, "
                             f"got {tuple(rng.shape)}")
        x = rng.to(device=device or rng.device, dtype=dtype)
    elif isinstance(rng, torch.Generator):
        x = torch.randn(tuple(shape), generator=rng, device=rng.device,
                        dtype=torch.float32)
        x = x.to(device=device or rng.device, dtype=dtype)
    else:
        raise TypeError(f"rng must be a torch.Generator or the initial noise, "
                        f"got {type(rng).__name__}")
    alphas = linear_alphas_cumprod(n_train_timesteps, beta_start, beta_end,
                                   device=x.device)
    step = n_train_timesteps // num_steps
    ts = [i * step for i in range(num_steps)][::-1]
    b = shape[0]
    guided = guidance_scale != 1.0
    use_joint = guided and joint_fn is not None

    def eps_at(x, tb, **dc):
        """-> (guided eps, the deep feature a full pass kept, or None)."""
        full = dc.get("deep_cache_groups") is not None \
            and dc.get("cached_deep") is None
        deep = None
        if use_joint:
            out = joint_fn(torch.cat([x, x]), torch.cat([tb, tb]), **dc)
            if full:
                out, deep = out
            eps, eps_u = out[:b], out[b:]
            return eps_u + guidance_scale * (eps - eps_u), deep
        if full:
            eps, deep = model_fn(x, tb, **dc)
            if guided:
                eps_u, deep_u = uncond_fn(x, tb, **dc)
                eps = eps_u + guidance_scale * (eps - eps_u)
                deep = (deep, deep_u)
            return eps, deep
        if guided and dc.get("cached_deep") is not None:
            deep_c, deep_u = dc.pop("cached_deep")
            eps = model_fn(x, tb, cached_deep=deep_c, **dc)
            eps_u = uncond_fn(x, tb, cached_deep=deep_u, **dc)
            return eps_u + guidance_scale * (eps - eps_u), None
        eps = model_fn(x, tb, **dc)
        if guided:
            eps_u = uncond_fn(x, tb, **dc)
            eps = eps_u + guidance_scale * (eps - eps_u)
        return eps, None

    def update(x, i, eps):
        a_t = alphas[ts[i]].to(dtype)
        a_prev = (alphas[ts[i + 1]] if i < num_steps - 1
                  else torch.ones((), device=x.device)).to(dtype)
        x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps

    def timesteps(i):
        return torch.full((b,), ts[i], dtype=torch.int64, device=x.device)

    if deep_cache is None:
        for i in range(num_steps):
            eps, _ = eps_at(x, timesteps(i))
            x = update(x, i, eps)
        return x

    interval, groups = deep_cache
    for i0 in range(0, num_steps, interval):
        # one full step keeps the deep feature, the next interval - 1 reuse it
        eps, deep = eps_at(x, timesteps(i0), deep_cache_groups=groups)
        x = update(x, i0, eps)
        for i in range(i0 + 1, i0 + interval):
            eps, _ = eps_at(x, timesteps(i), deep_cache_groups=groups,
                            cached_deep=deep)
            x = update(x, i, eps)
    return x
