"""Segment Anything (SAM): image encoder, prompt encoder and mask decoder.

Port of the JAX package's `models/sam.py`, the SAM ViT-H stack the demo
uses for point-prompted visible-object masks:

  * image encoder: ViT with 14 x 14 windowed attention (the 64 x 64 grid
    padded to 70) and four global blocks over all 4096 tokens, both with
    the decomposed relative-position bias; patch 16; neck (1x1 conv, LN,
    3x3 conv, LN) to 256 channels;
  * prompt encoder: learned point embeddings on a random-Fourier
    positional encoding;
  * mask decoder: two-way transformer, IoU head, hypernetwork MLPs over the
    upscaled embedding.

Module names give the `segment_anything` state-dict keys
(`image_encoder.blocks.N.attn.rel_pos_h`, `prompt_encoder.pe_layer.
positional_encoding_gaussian_matrix`, `mask_decoder.transformer.layers.N.
cross_attn_token_to_image.q_proj.weight`, ...); the mask-prompt
downscaling convolutions are left out (point prompts only), and
`convert.heuristics.sam_state_dict` drops their keys.

All of SAM's attention is plain PyTorch, as in the JAX package: the
encoder's scores carry the relative-position bias, which the flash kernel
does not take, and the decoder's attend over a handful of tokens. Scores
are computed in the activations' dtype and the softmax in float32. At
full width a global block's float32 scores are [1, 16, 4096, 4096], 1 GiB.
LayerNorm eps is the JAX package's 1e-6 throughout (the released decoder's
is 1e-5; see ROADMAP, Queue 3). Tensors are NHWC.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import Conv2dNHWC, ConvTranspose2dNHWC, LayerNorm2d
from .layers import DEFAULT_LN_EPS, LayerNorm, Linear

__all__ = ["SAMConfig", "SAM", "plain_attention"]


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 1280          # vit-h
    depth: int = 32
    num_heads: int = 16
    window_size: int = 14
    global_blocks: tuple = (7, 15, 23, 31)
    out_chans: int = 256
    decoder_dim: int = 256
    decoder_heads: int = 8
    decoder_layers: int = 2
    num_multimask: int = 3

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """softmax((q / sqrt(d)) k^T + bias) v on [B,H,N,d], as the JAX package
    computes it: products in the inputs' dtype, softmax in float32, the
    probabilities cast back before P.V."""
    s = torch.einsum("bhqd,bhkd->bhqk", q * q.shape[-1] ** -0.5, k)
    if bias is not None:
        s = s + bias
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _ln(dim: int) -> LayerNorm:
    return LayerNorm(dim, eps=DEFAULT_LN_EPS)


# ------------------------------------------------------------------ encoder

class EncoderAttention(nn.Module):
    """Attention over a window (or the whole grid) with the decomposed
    relative-position bias (SAM `Attention` with `use_rel_pos`)."""

    def __init__(self, dim: int, num_heads: int, size: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1,
                                                  dim // num_heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1,
                                                  dim // num_heads))

    @staticmethod
    def _table(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
        """[size, size, d]: rel_pos[q - k + size - 1]."""
        idx = torch.arange(size, device=rel_pos.device)
        return rel_pos[idx[:, None] - idx[None, :] + (size - 1)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        heads, d = self.num_heads, c // self.num_heads
        qkv = self.qkv(x.reshape(b, h * w, c)).view(b, h * w, 3, heads, d)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        # the bias reads the unscaled q (SAM add_decomposed_rel_pos)
        qr = q.reshape(b, heads, h, w, d)
        rh = self._table(self.rel_pos_h.to(x.dtype), h)
        rw = self._table(self.rel_pos_w.to(x.dtype), w)
        bias_h = torch.einsum("bnhwd,hkd->bnhwk", qr, rh)
        bias_w = torch.einsum("bnhwd,wkd->bnhwk", qr, rw)
        bias = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(
            b, heads, h * w, h * w)
        o = plain_attention(q, k, v, bias)
        return self.proj(o.transpose(1, 2).reshape(b, h, w, c))


class EncoderMlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.lin1 = Linear(dim, 4 * dim)
        self.lin2 = Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(F.gelu(self.lin1(x)))


class EncoderBlock(nn.Module):
    def __init__(self, cfg: SAMConfig, window: int):
        super().__init__()
        d = cfg.embed_dim
        self.window = window
        self.norm1 = _ln(d)
        self.attn = EncoderAttention(d, cfg.num_heads,
                                     window if window else cfg.grid)
        self.norm2 = _ln(d)
        self.mlp = EncoderMlp(d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        win = self.window
        if win:
            b, h, w, c = y.shape
            ph, pw = (win - h % win) % win, (win - w % win) % win
            y = F.pad(y, (0, 0, 0, pw, 0, ph))     # zeros after the norm
            hp, wp = h + ph, w + pw
            y = y.view(b, hp // win, win, wp // win, win, c).transpose(2, 3)
            y = self.attn(y.reshape(-1, win, win, c))
            y = y.view(b, hp // win, wp // win, win, win, c).transpose(2, 3)
            y = y.reshape(b, hp, wp, c)[:, :h, :w]
        else:
            y = self.attn(y)
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        self.proj = Conv2dNHWC(3, cfg.embed_dim, cfg.patch_size,
                               stride=cfg.patch_size)


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        self.patch_embed = PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.grid, cfg.grid, cfg.embed_dim))
        self.blocks = nn.ModuleList(
            EncoderBlock(cfg, 0 if i in cfg.global_blocks
                         else cfg.window_size)
            for i in range(cfg.depth))
        self.neck = nn.Sequential(
            Conv2dNHWC(cfg.embed_dim, cfg.out_chans, 1, bias=False),
            LayerNorm2d(cfg.out_chans),
            Conv2dNHWC(cfg.out_chans, cfg.out_chans, 3, padding=1,
                       bias=False),
            LayerNorm2d(cfg.out_chans))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B,S,S,3] ImageNet-normalised -> [B, S/16, S/16, out_chans]."""
        h = self.patch_embed.proj(x) + self.pos_embed.to(x.dtype)
        for block in self.blocks:
            h = block(h)
        return self.neck(h)


# --------------------------------------------------------- prompt / decoder

class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        """Random-Fourier encoding of [..., 2] coordinates in [0, 1]."""
        g = self.positional_encoding_gaussian_matrix.to(coords.dtype)
        c = 2.0 * math.pi * ((coords * 2.0 - 1.0) @ g)
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        dd = cfg.decoder_dim
        self.pe_layer = PositionEmbeddingRandom(dd // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, dd)
                                              for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, dd)
        self.no_mask_embed = nn.Embedding(1, dd)

    def image_pe(self, gh: int, gw: int, dtype) -> torch.Tensor:
        """[gh, gw, dd]: the encoding of every grid cell's centre."""
        dev = self.no_mask_embed.weight.device
        ys = (torch.arange(gh, dtype=torch.float32, device=dev) + 0.5) / gh
        xs = (torch.arange(gw, dtype=torch.float32, device=dev) + 0.5) / gw
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        return self.pe_layer(torch.stack([xx, yy], dim=-1).to(dtype))

    def points(self, coords: torch.Tensor, labels: torch.Tensor,
               dtype) -> torch.Tensor:
        """coords [B,P,2] (x, y) in [0,1]; labels [B,P] (1 fg, 0 bg, -1
        padding) -> [B,P,dd] sparse embeddings."""
        pts = self.pe_layer(coords.to(dtype))
        lbl = labels[..., None]
        w = [e.weight.to(dtype) for e in self.point_embeddings]
        pts = torch.where(lbl == -1, self.not_a_point_embed.weight.to(dtype),
                          pts)
        zero = torch.zeros((), dtype=dtype, device=pts.device)
        return pts + torch.where(lbl == 1, w[1],
                                 torch.where(lbl == 0, w[0], zero))


class DecoderAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.num_heads = num_heads
        self.q_proj = Linear(dim, inner)
        self.k_proj = Linear(dim, inner)
        self.v_proj = Linear(dim, inner)
        self.out_proj = Linear(inner, dim)

    def forward(self, q, k, v) -> torch.Tensor:
        b, nq, _ = q.shape
        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        heads = self.num_heads

        def split(t):
            return t.view(b, t.shape[1], heads, -1).transpose(1, 2)

        o = plain_attention(split(q), split(k), split(v))
        return self.out_proj(o.transpose(1, 2).reshape(b, nq, -1))


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = Linear(dim, hidden)
        self.lin2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(F.relu(self.lin1(x)))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int = 2048):
        super().__init__()
        self.self_attn = DecoderAttention(dim, num_heads)
        self.norm1 = _ln(dim)
        self.cross_attn_token_to_image = DecoderAttention(dim, num_heads, 2)
        self.norm2 = _ln(dim)
        self.mlp = MLPBlock(dim, mlp_dim)
        self.norm3 = _ln(dim)
        self.norm4 = _ln(dim)
        self.cross_attn_image_to_token = DecoderAttention(dim, num_heads, 2)

    def forward(self, q, src, tokens, pos, first: bool):
        attn_in = q if first else q + tokens
        q = self.norm1(q + self.self_attn(attn_in, attn_in, q))
        q = self.norm2(q + self.cross_attn_token_to_image(q + tokens,
                                                          src + pos, src))
        q = self.norm3(q + self.mlp(q))
        src = self.norm4(src + self.cross_attn_image_to_token(
            src + pos, q + tokens, q))
        return q, src


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        dd = cfg.decoder_dim
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(dd, cfg.decoder_heads)
            for _ in range(cfg.decoder_layers))
        self.final_attn_token_to_image = DecoderAttention(
            dd, cfg.decoder_heads, 2)
        self.norm_final_attn = _ln(dd)


class MLP(nn.Module):
    """Linear layers under `layers.N`, ReLU between them."""

    def __init__(self, dims):
        super().__init__()
        self.layers = nn.ModuleList(Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        dd = cfg.decoder_dim
        self.n_masks = cfg.num_multimask + 1
        self.iou_token = nn.Embedding(1, dd)
        self.mask_tokens = nn.Embedding(self.n_masks, dd)
        self.transformer = TwoWayTransformer(cfg)
        # indices 2 and 4 are the parameter-free GELUs of the reference
        self.output_upscaling = nn.Sequential(
            ConvTranspose2dNHWC(dd, dd // 4, 2, stride=2),
            LayerNorm2d(dd // 4), nn.GELU(),
            ConvTranspose2dNHWC(dd // 4, dd // 8, 2, stride=2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP((dd, dd, dd, dd // 8)) for _ in range(self.n_masks))
        self.iou_prediction_head = MLP((dd, dd, dd, self.n_masks))


class SAM(nn.Module):
    """`image_encoder`, `prompt_encoder` and `mask_decoder` under the
    reference's names; `encode_image` and `predict_masks` are the JAX
    package's `sam_encode_image` and `sam_predict_masks`."""

    def __init__(self, cfg: SAMConfig = SAMConfig()):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)

    def encode_image(self, x: torch.Tensor) -> torch.Tensor:
        return self.image_encoder(x)

    def predict_masks(self, image_embedding: torch.Tensor,
                      point_coords: torch.Tensor,
                      point_labels: torch.Tensor):
        """image_embedding [B,gh,gw,256]; point_coords [B,P,2] (x, y) in
        [0,1]; point_labels [B,P] (1 fg, 0 bg, -1 padding).

        Returns (mask logits [B, n_masks, 4 gh, 4 gw], iou [B, n_masks]).
        The coordinates are cast to the embedding's dtype here, as the JAX
        package casts them."""
        pe, dec = self.prompt_encoder, self.mask_decoder
        b, gh, gw, dd = image_embedding.shape
        dtype = image_embedding.dtype
        pts = pe.points(point_coords, point_labels, dtype)
        out_tokens = torch.cat([dec.iou_token.weight,
                                dec.mask_tokens.weight]).to(dtype)
        tokens = torch.cat([out_tokens.expand(b, -1, -1), pts], dim=1)
        src = (image_embedding + pe.no_mask_embed.weight.to(dtype)).reshape(
            b, gh * gw, dd)
        pos = pe.image_pe(gh, gw, dtype).reshape(1, gh * gw, dd)

        q = tokens
        tf = dec.transformer
        for i, layer in enumerate(tf.layers):
            q, src = layer(q, src, tokens, pos, first=i == 0)
        q = tf.norm_final_attn(q + tf.final_attn_token_to_image(
            q + tokens, src + pos, src))

        iou = dec.iou_prediction_head(q[:, 0])
        mask_tokens = q[:, 1:1 + dec.n_masks]
        up = dec.output_upscaling(src.reshape(b, gh, gw, dd))
        hyper = torch.stack([mlp(mask_tokens[:, i]) for i, mlp in
                             enumerate(dec.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("bnc,bhwc->bnhw", hyper, up)
        return masks, iou

    def forward(self, image: torch.Tensor, point_coords: torch.Tensor,
                point_labels: torch.Tensor):
        return self.predict_masks(self.encode_image(image), point_coords,
                                  point_labels)
