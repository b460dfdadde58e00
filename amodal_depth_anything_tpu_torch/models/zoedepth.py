"""ZoeDepth metric-depth model + InvisibleStitch baseline.

Port of the JAX package's `models/zoedepth.py`, the vendored ZoeDepth the
reference reaches via `invisible_stitch.py:19-21,43-110`:

  * MiDaS DPT core over a BEiT-L/16 backbone (`models.beit`): taps at
    blocks [5,11,17,23], the 'project' readout, DPT reassemble +
    refinenets (features 256), an output head whose 32-channel pre-logit
    activation and relative depth are both used.
  * The metric-bins head (`zoedepth/models/zoedepth/zoedepth_v1.py:37-211`)
    at the SHIPPED config: bottleneck 1x1 conv, softplus seed-bin regressor
    (n_bins 64), bin-embedding projectors, INVERSE attractor layers
    ([16,8,4,1] attractors, MEAN aggregation) with alpha 300 / gamma 2:
    the reference's forward never passes its configured alpha=1000 on
    (`attractor.py:45-57,191-199`), so every published checkpoint ran the
    function defaults, and this keeps them. Then the conditional
    log-binomial over bins with a GELU-hidden conditioning mlp and the
    reference's Stirling log-binomial coefficients (`dist_layers.py:
    29-120`, min_temp 0.0212); metric depth = sum(p * bin_centers).
  * InvisibleStitch (`invisible_stitch.py:77-110`): patch embed widened +2
    channels (observation, depth_mask); observation zeroed inside the
    invisible region; depth_mask = ~invisible; MiDaS prep (mean/std 0.5)
    on the rgb channels only.

Module names follow the JAX tree (`backbone.blocks.N.attn.q_bias`,
`readout.N`, `scratch.refinenetN`, `seed_bin_regressor.conv1`, ...).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import Conv2dNHWC
from ..ops.resize import resize2d
from .beit import BEiT, BEiTConfig
from .deeplab import reset_norms_
from .jo_dpt import DPTReadout, init_dpt_readout_

__all__ = ["ZoeDepthConfig", "ZoeDepth", "InvisibleStitch"]


@dataclasses.dataclass(frozen=True)
class ZoeDepthConfig:
    backbone: BEiTConfig = BEiTConfig(in_chans=5)  # rgb + obs + depth_mask
    hooks: tuple = (5, 11, 17, 23)
    tap_channels: tuple = (256, 512, 1024, 1024)
    features: int = 256
    n_bins: int = 64
    bin_embedding_dim: int = 128
    n_attractors: tuple = (16, 8, 4, 1)
    attractor_alpha: float = 300.0   # the function default; see above
    attractor_gamma: float = 2.0
    attractor_type: str = "inv"      # "inv" | "exp"
    attractor_kind: str = "mean"     # "mean" | "sum"
    min_depth: float = 1e-3
    max_depth: float = 10.0
    min_temp: float = 0.0212
    max_temp: float = 50.0
    midas_out: int = 32


class Mlp2(nn.Module):
    """Two 1x1 convs (`conv1`, `conv2`)."""

    def __init__(self, cin: int, hidden: int, cout: int):
        super().__init__()
        self.conv1 = Conv2dNHWC(cin, hidden, 1)
        self.conv2 = Conv2dNHWC(hidden, cout, 1)

    def forward(self, x, *, final_act=None, hidden_act=F.relu):
        h = self.conv2(hidden_act(self.conv1(x)))
        return final_act(h) if final_act is not None else h


def _inv_attractor(dx, alpha, gamma):
    """attractor.py:45-57, the shipped default (an integer gamma squares a
    negative dx as torch's `pow(2.0)` does)."""
    g = int(gamma) if float(gamma).is_integer() else gamma
    return dx / (1.0 + alpha * dx ** g)


def _exp_attractor(dx, alpha, gamma):
    """attractor.py:30-42."""
    return torch.exp(-alpha * dx.abs() ** gamma) * dx


def _log_binomial(p, t, n_classes: int, eps: float = 1e-4):
    """p, t: [B,H,W,1] -> probs [B,H,W,K] (dist_layers.py:29-69), with the
    reference's Stirling approximation of log nCk (k-dependent error, so
    checkpoint parity needs it rather than the exact lgamma)."""
    k = torch.arange(n_classes, dtype=torch.float32,
                     device=p.device).reshape(1, 1, 1, -1)
    big_k = float(n_classes - 1)
    e7 = 1e-7
    # a fill on the device, not a copy from host memory: capturable
    n_ = torch.full((), big_k + e7, dtype=torch.float32, device=p.device)
    k_ = k + e7
    nk = (n_ - k_).clamp_min(0.0)
    log_coef = (n_ * torch.log(n_) - k_ * torch.log(k_)
                - nk * torch.log(nk + e7))
    p = p.float().clamp(eps, 1.0)
    one_minus = (1.0 - p).clamp(eps, 1.0)
    y = log_coef + k * torch.log(p) + (big_k - k) * torch.log(one_minus)
    return torch.softmax(y / t.float(), dim=-1)


class ZoeDepth(DPTReadout):
    def __init__(self, cfg: ZoeDepthConfig = ZoeDepthConfig()):
        super().__init__(cfg.backbone.embed_dim, cfg.tap_channels,
                         cfg.features, cfg.midas_out)
        self.cfg = cfg
        self.backbone = BEiT(cfg.backbone)
        f, e = cfg.features, cfg.bin_embedding_dim
        self.conv2 = Conv2dNHWC(f, f, 1)
        self.seed_bin_regressor = Mlp2(f, 256, cfg.n_bins)
        self.seed_projector = Mlp2(f, 128, e)
        self.projectors = nn.ModuleList(Mlp2(f, 128, e) for _ in range(4))
        self.attractors = nn.ModuleList(Mlp2(e, 128, cfg.n_attractors[i])
                                        for i in range(4))
        clb_in = cfg.midas_out + 1 + e
        self.conditional_log_binomial = Mlp2(clb_in, clb_in // 2, 4)

    def midas_core(self, x):
        """BEiT + DPT decoder -> (rel_depth [B,H,W], out_conv32, btlnck,
        [r4, r3, r2, r1])."""
        cfg = self.cfg
        ps = cfg.backbone.patch_size
        grid = (x.shape[1] // ps, x.shape[2] // ps)
        taps = self.backbone(x, cfg.hooks)
        l1, l2, l3, l4 = self.taps_to_maps(taps, grid)
        sc = self.scratch
        r4 = sc.refinenet4(l4, None, None)
        r3 = sc.refinenet3(r4, l3, None)
        r2 = sc.refinenet2(r3, l2, None)
        r1 = sc.refinenet1(r2, l1, None)
        out32, rel = self.output_head(r1)
        return F.relu(rel)[..., 0], out32, l4, [r4, r3, r2, r1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B,H,W,in_chans] (already MiDaS-prepped) -> metric depth
        [B,H',W',1] at the MiDaS head's resolution."""
        cfg = self.cfg
        rel_depth, out32, btlnck, x_blocks = self.midas_core(x)
        x_d0 = self.conv2(btlnck)
        b_prev = self.seed_bin_regressor(x_d0, final_act=F.softplus)
        prev_emb = self.seed_projector(x_d0)
        attractor_fn = (_inv_attractor if cfg.attractor_type == "inv"
                        else _exp_attractor)
        for i, blk in enumerate(x_blocks):
            emb = self.projectors[i](blk)
            size = tuple(emb.shape[1:3])
            prev_up = resize2d(prev_emb, size=size, method="bilinear",
                               align_corners=True)
            a = self.attractors[i](emb + prev_up, final_act=F.softplus)
            b_up = resize2d(b_prev, size=size, method="bilinear",
                            align_corners=True)
            # delta for every bin from every attractor (attractor.py:
            # 191-199): [B,h,w,n_attractors,n_bins]
            dx = a[..., :, None] - b_up[..., None, :]
            delta = attractor_fn(dx, cfg.attractor_alpha,
                                 cfg.attractor_gamma)
            delta = delta.mean(dim=-2) if cfg.attractor_kind == "mean" \
                else delta.sum(dim=-2)
            b_prev = b_up + delta
            prev_emb = emb

        rel_cond = resize2d(rel_depth[..., None],
                            size=tuple(out32.shape[1:3]), method="bilinear",
                            align_corners=True)
        last = torch.cat([out32, rel_cond], dim=-1)
        emb_up = resize2d(prev_emb, size=tuple(last.shape[1:3]),
                          method="bilinear", align_corners=True)
        # the conditioning mlp hides a GELU, not the ReLU the other heads
        # use (dist_layers.py:130-135)
        pt = self.conditional_log_binomial(
            torch.cat([last, emb_up], dim=-1), final_act=F.softplus,
            hidden_act=F.gelu)
        eps = 1e-4
        p = (pt[..., 0:1] + eps) / (pt[..., 0:1] + pt[..., 1:2] + 2 * eps)
        t_raw = (pt[..., 2:3] + eps) / (pt[..., 2:3] + pt[..., 3:4] + 2 * eps)
        t = cfg.min_temp + (cfg.max_temp - cfg.min_temp) * t_raw
        probs = _log_binomial(p, t, cfg.n_bins)
        centers_up = resize2d(b_prev, size=tuple(probs.shape[1:3]),
                              method="bilinear", align_corners=True)
        return (probs * centers_up).sum(dim=-1, keepdim=True)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> "ZoeDepth":
        """Seeded random init with the JAX scheme (`init_zoedepth`): BEiT
        qkv and patch embed normal(0.02), q/v biases and the bias table
        zero, gamma 0.1, trunk linears trunc-normal(0.02), convs
        uniform(+-1/sqrt(fan_in)), transposed convs zero."""
        init_dpt_readout_(self, generator)
        reset_norms_(self)
        bb = self.backbone
        bb.patch_embed.proj.weight.normal_(0.0, 0.02, generator=generator)
        bb.patch_embed.proj.bias.zero_()
        bb.cls_token.zero_()
        for blk in bb.blocks:
            blk.attn.qkv.weight.normal_(0.0, 0.02, generator=generator)
            for t in (blk.attn.q_bias, blk.attn.v_bias,
                      blk.attn.relative_position_bias_table):
                t.zero_()
            blk.gamma_1.fill_(0.1)
            blk.gamma_2.fill_(0.1)
        return self


class InvisibleStitch(ZoeDepth):
    """ZoeDepth-N with the depth-completion channels; its forward takes
    `invisible_mask=` and `observation=` (reference
    `invisible_stitch.py:84-105`)."""

    def forward(self, x: torch.Tensor, *, invisible_mask: torch.Tensor,
                observation: torch.Tensor, **_unused) -> torch.Tensor:
        """x: [B,H,W,3] rgb in [0,1]; invisible_mask / observation:
        [B,H,W,1]."""
        inv = (invisible_mask > 0).to(x.dtype)
        obs = observation * (1.0 - inv)
        rgb = (x - 0.5) / 0.5
        return super().forward(torch.cat([rgb, obs, 1.0 - inv], dim=-1))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> "InvisibleStitch":
        """`ZoeDepth.init_weights_` with the two depth-completion input
        channels of the patch embed zero (`init_invisible_stitch`)."""
        super().init_weights_(generator)
        self.backbone.patch_embed.proj.weight[:, 3:] = 0.0
        return self
