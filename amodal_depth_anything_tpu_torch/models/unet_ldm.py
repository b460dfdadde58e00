"""Latent-diffusion UNet (SD-1.5 family) as torch modules.

Port of the JAX package's `models/unet_ldm.py` (reference
`src/models/depthfm/unet/openaimodel.py:422-894`, `unet/attention.py:141-374`),
the network DepthFM runs: timestep-embedded ResBlocks, SpatialTransformer
blocks (self-attention, cross-attention over a text-embedding context, GEGLU
feed-forward), strided-conv downsampling and nearest-2x upsampling, and the
DepthFM input contract in which the conditioning latents are concatenated on
channels before conv-in while `context_ca` feeds cross-attention.

Module names give the reference checkpoint's state-dict keys
(`input_blocks.{i}.{j}.in_layers.0.weight`, `...transformer_blocks.0.attn1.
to_q.weight`, `out.2.bias`, ...), so the UNet of `depthfm-v1.ckpt` loads
with a strict `load_state_dict`. `build_plan` is the static topology both
this module and the weight bridge walk.

Tensors are NHWC as in the JAX package; GroupNorm runs in float32 with the
JAX package's group rule; both attentions go through `ops.attention`
(on CUDA tensors the flash-attention kernels, forward and backward, at head
dims 40, 80 and 160, self-attention over 64-4096 latent tokens and
cross-attention onto the 77 context tokens alike). `remat=True` recomputes
each level in the backward pass (the DepthFM trainers' option).

Serving compression (opt-in, `ops.quant` / `ops.token_merge`): the linears
and convolutions may be quantised modules (W8A8, w8, w4) under the same
names; a W8A8 upsampling conv runs unfused (nearest 2x, then the int8
conv), a weight-only one dequantises before the fold. `tome=(ratio,
min_tokens)` is ToMe-SD in the spatial transformers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import multi_head_attention
from ..ops.conv import Conv2dNHWC, upsample2x_conv
from ..ops.token_merge import tome_apply, tome_merge, tome_unmerge
from .layers import LayerNorm, Linear

__all__ = ["UNetConfig", "DEPTHFM_UNET", "build_plan", "timestep_embedding",
           "group_norm", "GroupNorm", "ResBlock", "CrossAttention",
           "SpatialTransformer", "UNetModel"]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 8
    model_channels: int = 320
    out_channels: int = 4
    num_res_blocks: int = 2
    attention_resolutions: Sequence[int] = (4, 2, 1)
    channel_mult: Sequence[int] = (1, 2, 4, 4)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int | None = 1024
    use_linear_in_transformer: bool = True
    image_size: int = 32  # informational only
    # The reference's vanilla CrossAttention rescales SELF-attention by
    # sqrt(log(n)/log(4n)/d) instead of 1/sqrt(d) (unet/attention.py:175-177)
    # while its xformers path, the one the released environment runs, uses
    # the standard scale. False = released behaviour.
    rescale_self_attention: bool = False


# DepthFM checkpoint hparams (reference dfm_amodal.py:44)
DEPTHFM_UNET = UNetConfig()


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding in float32, cos half then sin half
    (reference unet/util.py:77-98)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def build_plan(cfg: UNetConfig):
    """Static topology: lists of (kind, meta) per block index, mirroring the
    reference constructor (openaimodel.py:566-760)."""
    input_blocks = [[("conv_in", {})]]
    chans = [cfg.model_channels]
    ch, ds = cfg.model_channels, 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            layers = [("res", {"in": ch, "out": mult * cfg.model_channels})]
            ch = mult * cfg.model_channels
            if ds in cfg.attention_resolutions:
                layers.append(("attn", {"ch": ch}))
            input_blocks.append(layers)
            chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            input_blocks.append([("down", {"ch": ch})])
            chans.append(ch)
            ds *= 2
    middle = [("res", {"in": ch, "out": ch}), ("attn", {"ch": ch}),
              ("res", {"in": ch, "out": ch})]
    output_blocks = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = chans.pop()
            layers = [("res", {"in": ch + ich,
                               "out": cfg.model_channels * mult})]
            ch = cfg.model_channels * mult
            if ds in cfg.attention_resolutions:
                layers.append(("attn", {"ch": ch}))
            if level and i == cfg.num_res_blocks:
                layers.append(("up", {"ch": ch}))
                ds //= 2
            output_blocks.append(layers)
    return input_blocks, middle, output_blocks


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm on NHWC with float32 statistics and arithmetic, output in
    x's dtype. Production channel counts are multiples of 32; narrow test
    configs fall back to the largest group count that divides C."""
    b, h, w, c = x.shape
    groups = math.gcd(c, groups)
    xf = x.float().reshape(b, h * w, groups, c // groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
    # (x - mean) * rsqrt(var + eps) * weight + bias as one multiply-add
    scale = torch.rsqrt(var + eps) * weight.float().view(groups, -1)
    shift = bias.float().view(groups, -1) - mean * scale
    return torch.addcmul(shift, xf, scale).view(b, h, w, c).to(x.dtype)


class GroupNorm(nn.Module):
    """`group_norm` with the reference's `weight`/`bias` keys."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, eps=self.eps)


class ResBlock(nn.Module):
    """GN -> SiLU -> conv, plus the projected timestep embedding, GN -> SiLU
    -> conv, plus the (1x1-projected) input. The Sequentials exist for the
    reference's key indices; `forward` calls their members by index."""

    def __init__(self, c_in: int, c_out: int, emb_dim: int):
        super().__init__()
        self.in_layers = nn.Sequential(
            GroupNorm(c_in), nn.SiLU(), Conv2dNHWC(c_in, c_out, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_dim, c_out))
        self.out_layers = nn.Sequential(
            GroupNorm(c_out), nn.SiLU(), nn.Identity(),
            Conv2dNHWC(c_out, c_out, 3, padding=1))
        self.skip_connection = (Conv2dNHWC(c_in, c_out, 1) if c_in != c_out
                                else nn.Identity())

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers[2](F.silu(self.in_layers[0](x)))
        emb_out = self.emb_layers[1](F.silu(emb))
        h = h + emb_out[:, None, None, :].to(h.dtype)
        h = self.out_layers[3](F.silu(self.out_layers[0](h)))
        return self.skip_connection(x) + h


class CrossAttention(nn.Module):
    """Multi-head attention of x [B,N,C] onto `context` [B,L,D] (onto x
    itself when None). The q/k/v handed to the attention are [B,H,N,d]
    views of the projections' outputs and its output is read back as
    [B,N,H*d] without a copy."""

    def __init__(self, q_dim: int, kv_dim: int, inner: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.to_q = Linear(q_dim, inner, bias=False)
        self.to_k = Linear(kv_dim, inner, bias=False)
        self.to_v = Linear(kv_dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, q_dim), nn.Identity())

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None, *,
                attn_impl: str | None = None,
                sm_scale: float | None = None) -> torch.Tensor:
        b, n, _ = x.shape
        ctx = x if context is None else context
        heads = self.num_heads
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        d = q.shape[-1] // heads
        q = q.view(b, n, heads, d).transpose(1, 2)
        k = k.view(b, ctx.shape[1], heads, d).transpose(1, 2)
        v = v.view(b, ctx.shape[1], heads, d).transpose(1, 2)
        o = multi_head_attention(q, k, v, impl=attn_impl, sm_scale=sm_scale)
        return self.to_out[0](o.transpose(1, 2).reshape(b, n, heads * d))


class GEGLU(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.proj = Linear(dim, 2 * hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU -> linear, under the reference's `net.0.proj` / `net.2` keys."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Identity(),
                                 Linear(dim * mult, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int | None, num_heads: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, dim, num_heads)
        self.attn2 = CrossAttention(dim, context_dim or dim, dim, num_heads)
        self.ff = FeedForward(dim)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.norm3 = LayerNorm(dim, eps=1e-5)

    def parts(self, context_ca, attn_impl, self_scale):
        """The block's three residual branches, in order."""
        return (lambda y: self.attn1(self.norm1(y), None, attn_impl=attn_impl,
                                     sm_scale=self_scale),
                lambda y: self.attn2(self.norm2(y), context_ca,
                                     attn_impl=attn_impl),
                lambda y: self.ff(self.norm3(y)))

    def forward(self, y, context_ca, attn_impl, self_scale):
        for part in self.parts(context_ca, attn_impl, self_scale):
            y = y + part(y)
        return y


class SpatialTransformer(nn.Module):
    """GN -> project in -> transformer blocks over the H*W tokens -> project
    out, plus the input (reference unet/attention.py:296-374)."""

    def __init__(self, cfg: UNetConfig, ch: int):
        super().__init__()
        self.cfg = cfg
        self.norm = GroupNorm(ch, eps=1e-6)
        if cfg.use_linear_in_transformer:
            self.proj_in = Linear(ch, ch)
            self.proj_out = Linear(ch, ch)
        else:
            self.proj_in = Conv2dNHWC(ch, ch, 1)
            self.proj_out = Conv2dNHWC(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(ch, cfg.context_dim, cfg.num_heads)
            for _ in range(cfg.transformer_depth))

    def forward(self, x: torch.Tensor, context_ca: torch.Tensor | None, *,
                attn_impl: str | None = None, tome=None) -> torch.Tensor:
        """`tome=(ratio, min_tokens)`: ToMe-SD (Bolya & Hoffman) at levels
        of at least `min_tokens` tokens: one bipartite match per call on the
        projected tokens, r = min(int(n * ratio), n // 2 - 1); each branch
        of each block runs on the merged [B, n - r, C] stream and its output
        is un-merged into the full-resolution residual, which is re-merged
        for the next branch (JAX `_spatial_transformer`)."""
        b, h, w, c = x.shape
        linear = self.cfg.use_linear_in_transformer
        y = self.norm(x)
        if not linear:
            y = self.proj_in(y)
        y = y.reshape(b, h * w, c)
        if linear:
            y = self.proj_in(y)
        self_scale = None
        if self.cfg.rescale_self_attention:
            n, dh = h * w, c // self.cfg.num_heads
            self_scale = (math.log(n) / math.log(n * 4) / dh) ** 0.5
        n_tok, r = h * w, 0
        if tome is not None:
            ratio, min_tokens = tome
            if n_tok >= min_tokens:
                r = min(int(n_tok * ratio), n_tok // 2 - 1)
        if r > 0:
            merged, idx = tome_merge(y, r)
            parts = [part for block in self.transformer_blocks
                     for part in block.parts(context_ca, attn_impl,
                                             self_scale)]
            for i, part in enumerate(parts):
                y = y + tome_unmerge(part(merged), idx)
                if i + 1 < len(parts):
                    merged = tome_apply(y, idx, n_tok - r)
        else:
            for block in self.transformer_blocks:
                y = block(y, context_ca, attn_impl, self_scale)
        if linear:
            y = self.proj_out(y).view(b, h, w, c)
        else:
            y = self.proj_out(y.view(b, h, w, c))
        return x + y


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.op = Conv2dNHWC(ch, ch, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Upsample(nn.Module):
    """Nearest 2x then a 3x3 conv, run as one low-resolution conv
    (`ops.conv.upsample2x_conv`)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2dNHWC(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample2x_conv(x, self.conv)


class Level(nn.ModuleList):
    """One block of the plan: its layers in order, indexed as the
    reference's TimestepEmbedSequential."""

    def forward(self, x, emb, context_ca, attn_impl, tome=None):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, context_ca, attn_impl=attn_impl, tome=tome)
            else:
                x = layer(x)
        return x


class UNetModel(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        emb_dim = cfg.model_channels * 4
        self.time_embed = nn.Sequential(Linear(cfg.model_channels, emb_dim),
                                        nn.SiLU(), Linear(emb_dim, emb_dim))

        def make(kind, meta):
            if kind == "conv_in":
                return Conv2dNHWC(cfg.in_channels, cfg.model_channels, 3,
                                  padding=1)
            if kind == "res":
                return ResBlock(meta["in"], meta["out"], emb_dim)
            if kind == "attn":
                return SpatialTransformer(cfg, meta["ch"])
            if kind == "down":
                return Downsample(meta["ch"])
            if kind == "up":
                return Upsample(meta["ch"])
            raise ValueError(kind)

        inp, mid, out = build_plan(cfg)
        self.input_blocks = nn.ModuleList(
            Level(make(*layer) for layer in layers) for layers in inp)
        self.middle_block = Level(make(*layer) for layer in mid)
        self.output_blocks = nn.ModuleList(
            Level(make(*layer) for layer in layers) for layers in out)
        self.out = nn.Sequential(
            GroupNorm(cfg.model_channels), nn.SiLU(),
            Conv2dNHWC(cfg.model_channels, cfg.out_channels, 3, padding=1))

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor | None = None,
                context_ca: torch.Tensor | None = None, *,
                attn_impl: str | None = None, tome=None, remat: bool = False,
                deep_cache_groups: int | None = None,
                cached_deep: torch.Tensor | None = None):
        """x: [B,H,W,C_latent]; t: [B] in diffusion-time units; `context` is
        concatenated on channels (DepthFM conditioning); `context_ca`:
        [B,L,D] cross-attention conditioning (text embedding).

        DeepCache (Ma et al. 2023): with `deep_cache_groups=G` and
        `cached_deep=None` the full network runs and `(y, deep)` comes
        back, `deep` being the feature that enters the last G output
        groups. Handing it back as `cached_deep` on a later step runs only
        the G shallowest input groups (fresh skip tensors) and the last G
        output groups, with the cached feature in place of everything
        deeper. With identical (x, t) the spliced pass reproduces the full
        pass exactly; across nearby solver steps it is an approximation,
        so it is opt-in.

        `remat=True` recomputes each input, middle and output level in the
        backward pass (`torch.utils.checkpoint` per level; the reference
        trains the SD UNet with `use_checkpoint=True`). The skip tensors
        `hs` stay live: they are consumed far from where they are made, so
        recomputing them would cascade. The time embedding and the output
        head are not recomputed. `tome=(ratio, min_tokens)`: ToMe-SD in
        the spatial transformers (`SpatialTransformer.forward`)."""
        remat = remat and torch.is_grad_enabled()

        def run(level, h):
            if remat:
                # no random op in a level: nothing to replay, and capturable
                return checkpoint(level, h, emb, context_ca, attn_impl, tome,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            return level(h, emb, context_ca, attn_impl, tome)

        n_inp, n_out = len(self.input_blocks), len(self.output_blocks)
        if deep_cache_groups is not None:
            if not 1 <= deep_cache_groups < n_inp or n_inp != n_out:
                raise ValueError(
                    f"deep_cache_groups must be in [1, {n_inp - 1}] on a "
                    f"symmetric plan (inp {n_inp} / out {n_out})")

        t_emb = timestep_embedding(t, self.cfg.model_channels).to(x.dtype)
        emb = self.time_embed[2](F.silu(self.time_embed[0](t_emb)))
        h = x if context is None else torch.cat([x, context], dim=-1)
        hs = []
        shallow = cached_deep is not None
        for i in range(deep_cache_groups if shallow else n_inp):
            h = run(self.input_blocks[i], h)
            hs.append(h)
        deep = None
        if shallow:
            h = cached_deep
            out_start = n_out - deep_cache_groups
        else:
            h = run(self.middle_block, h)
            out_start = 0
        for i in range(out_start, n_out):
            if deep_cache_groups is not None and not shallow \
                    and i == n_out - deep_cache_groups:
                deep = h
            h = torch.cat([h, hs.pop()], dim=-1)
            h = run(self.output_blocks[i], h)
        y = self.out[2](F.silu(self.out[0](h)))
        if deep_cache_groups is not None and not shallow:
            return y, deep
        return y
