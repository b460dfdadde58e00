"""Multi-resolution pyramid noise (reference
`src/util/multi_res_noise.py:8-74`).

Port of the JAX package's `utils/multi_res_noise.py`: the DDPM trainer
correlates its noise across scales by adding bilinearly upsampled
low-resolution draws, each scaled by a power of `strength`, to a
full-resolution draw, then rescaling to unit (population) variance. Four
strategies set the pyramid's scales.
"""

from __future__ import annotations

import math

import torch

from ..ops.resize import resize2d

__all__ = ["multi_res_noise_like", "multi_res_noise_shapes"]


def _scales(h: int, w: int, strategy: str) -> list[tuple[int, int]]:
    """The low-resolution (h, w) of each scale, coarser in turn, up to the
    first 1 x 1 one."""
    if strategy == "original":
        scales, cur_h, cur_w = [], h, w
        for _ in range(1, 16):
            cur_h, cur_w = max(1, cur_h // 2), max(1, cur_w // 2)
            scales.append((cur_h, cur_w))
            if cur_h == 1 and cur_w == 1:
                break
    elif strategy == "every_layer":
        scales = [(max(1, h // 2 ** i), max(1, w // 2 ** i))
                  for i in range(1, int(math.log2(min(h, w))))]
    elif strategy == "power_of_two":
        scales = [(max(1, h // 2 ** i), max(1, w // 2 ** i))
                  for i in range(1, 5)]
    elif strategy == "random_step":
        scales = [(max(1, h // 3 ** i), max(1, w // 3 ** i))
                  for i in range(1, 4)]
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    if (1, 1) in scales:
        scales = scales[:scales.index((1, 1)) + 1]
    return scales


def multi_res_noise_shapes(shape, downscale_strategy: str = "original"
                           ) -> list[tuple[int, ...]]:
    """The shapes of the standard normal draws `multi_res_noise_like` takes
    for an NHWC `shape`: the full-resolution one, then one per scale."""
    b, h, w, c = shape
    return [tuple(shape)] + [(b, sh, sw, c)
                             for sh, sw in _scales(h, w, downscale_strategy)]


def multi_res_noise_like(rng, x: torch.Tensor, *, strength: float = 0.9,
                         downscale_strategy: str = "original",
                         annealed_t=None) -> torch.Tensor:
    """x: [B,H,W,C]; returns correlated noise of x's shape, device and dtype,
    rescaled to unit population std over the whole tensor.

    `rng`: a `torch.Generator` (the draws are made on its device in float32,
    in the order of `multi_res_noise_shapes`) or the list of those draws.
    Scale i (from 1) adds its upsampled draw times strength ** i; with
    `annealed_t` (a scalar or a [B,1,1,1] tensor, the DDPM trainer's t / T)
    the strength is multiplied by it first.
    strategies: 'original' (halving until 1 x 1), 'every_layer',
    'power_of_two', 'random_step'."""
    shapes = multi_res_noise_shapes(x.shape, downscale_strategy)
    if isinstance(rng, torch.Generator):
        draws = [torch.randn(s, generator=rng, device=rng.device,
                             dtype=torch.float32) for s in shapes]
    else:
        draws = list(rng)
        got = [tuple(d.shape) for d in draws]
        if got != shapes:
            raise ValueError(f"multi-resolution draws must have the shapes "
                             f"{shapes}, got {got}")
    draws = [d.to(device=x.device, dtype=x.dtype) for d in draws]
    if annealed_t is not None:
        strength = strength * annealed_t
    h, w = x.shape[1:3]
    noise = draws[0]
    for i, low in enumerate(draws[1:], start=1):
        noise = noise + resize2d(low, size=(h, w), method="bilinear") \
            * strength ** i
    return noise / torch.std(noise, correction=0)
