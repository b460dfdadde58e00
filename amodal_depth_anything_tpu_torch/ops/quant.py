"""Opt-in serving compression: W8A8 int8, weight-only int8 (w8) and int4 (w4).

Port of the JAX package's `ops/quant.py`. Parity-breaking by design and
never a default; the pipelines expose it as `quantize_int8`.

Schemes (the JAX package's, bit for bit in the codes and the scales):
  * W8A8: symmetric per-output-channel int8 weights
    (`w_q = round(w / s_w)`, `s_w = max|w| / 127` over the input axes) and a
    per-tensor int8 activation scale that is static (bounded from the
    feeding LayerNorm's affine parameters, or calibrated from recorded
    maxima) or dynamic (the input's amax at run time, a device reduction).
    The products run as int8 x int8 -> int32 on `torch._int_mm` (cuBLASLt
    on the card); a convolution is an im2col of the int8 codes followed by
    the same product, in row chunks. The output is `acc * (s_act * s_w)` in
    float32, plus the bias, cast to the input's dtype.
  * SmoothQuant (arXiv:2211.10438): per-input-channel outlier migration
    into the weight rows, the input multiplied by the stored `smooth`.
  * Per-layer masks: a quantised trunk linear may keep its original weight
    (`w_orig`) and a `use_q` flag; the flag is read once, on the host, when
    the module is built, so the path holds no branch on the device.
  * w8 / w4: weights stored as int8 codes (w4 nibble-packed along the input
    axis, two per byte, with per-(input group, output) scales) and turned
    back into the compute dtype at use; activations stay as they are.

The quantised layers are modules that take the place of `layers.Linear`,
`conv.Conv2dNHWC` and `conv.ConvTranspose2dNHWC` under the same name, and
whose buffers carry the JAX leaves' names (`weight` for the int8 `w`,
`w_scale`, `act_scale`, `smooth`, `use_q`, `w_orig`, `w8`, `w4`,
`w4_scale`, `w4_group`, `bias`), so the weight bridge maps them one to one
(`convert.weights`). Weights keep torch's layouts: linear [out, in], conv
OIHW, transposed conv [C_in, C_out, k, k]; `w4_scale` is [out, in/group].

`torch._int_mm` on the card wants more than 16 rows and a reduction and an
output width that are multiples of 8: `int8_matmul` pads the rows, the
reduction (zeros, exact) and the output width, and never falls back to a
float product. Nothing here calls `.item()` or syncs with the host, so the
dynamic paths capture in a CUDA graph.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["ACT_SIGMA", "FAMILIES", "W4_GROUP", "int8_matmul",
           "quantize_weight_int8", "int8_linear", "int8_conv2d",
           "int8_conv_transpose", "w8_weight", "w4_weight", "pack_nibbles",
           "unpack_nibbles", "QuantLinear", "QuantConv2d",
           "QuantConvTranspose2d", "is_quantized", "quantize_linear_int8",
           "quantize_conv_int8", "quantize_linear_w8", "quantize_conv_w8",
           "quantize_linear_w4", "quantize_conv_w4", "smooth_linear",
           "stat_scale", "ln_act_scale", "swap_module", "apply_quantized_",
           "quantize_vit_trunk_int8", "collect_trunk_act_stats",
           "merge_act_stats", "collect_dpt_head_act_stats",
           "quantize_dpt_head_int8", "HEAD_STAT_SITES",
           "diffusion_site", "quantize_diffusion_modules",
           "calibrate_dynamic_scales"]

ACT_SIGMA = 6.0
FAMILIES = ("qkv", "proj", "ffn1", "ffn2")
W4_GROUP = 64
# rows of an im2col chunk: its int8 columns stay under ~256 MiB
_CHUNK_BYTES = 256 * 1024 * 1024


# ----------------------------------------------------------------- products

def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a: int8 [M, K] codes; w: int8 [N, K] (a linear's [out, in]) ->
    a @ w.T as int32 [M, N], exact.

    `torch._int_mm` on the card needs M > 16 and K, N multiples of 8: the
    rows are padded to a multiple of 8 (at least 32), K and N with zeros,
    which changes no sum; the padding is sliced off again."""
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 codes, got {a.dtype} and "
                        f"{w.dtype}")
    m, k = a.shape
    n = w.shape[0]
    if w.shape[1] != k:
        raise ValueError(f"int8_matmul: a {tuple(a.shape)} vs w "
                         f"{tuple(w.shape)}")
    mp, kp, np_ = max(32, _round_up(m, 8)), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    acc = torch._int_mm(a.contiguous(), w.contiguous().t())
    return acc[:m, :n]


def _act_scale(x: torch.Tensor, act_scale: torch.Tensor | None):
    """The per-tensor activation scale: the static one, or the input's
    amax / 127 (a device tensor; no host sync)."""
    if act_scale is not None:
        return act_scale.float()
    return torch.clamp_min(x.float().abs().amax() / 127.0, 1e-9)


def _quantize_act(x: torch.Tensor, s_act: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / s_act), -127.0,
                       127.0).to(torch.int8)


def _rescale(acc, s_act, w_scale, bias, dtype):
    y = acc.float() * (s_act * w_scale.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def int8_linear(x: torch.Tensor, weight: torch.Tensor, w_scale, *,
                act_scale=None, bias=None, smooth=None) -> torch.Tensor:
    """W8A8 linear: x [..., in]; weight int8 [out, in]; w_scale [out];
    act_scale: scalar, or None for the dynamic per-tensor amax. `smooth`
    (SmoothQuant) multiplies the input's channels first."""
    if smooth is not None:
        x = x * smooth.to(x.dtype)
    s_act = _act_scale(x, act_scale)
    xq = _quantize_act(x, s_act)
    acc = int8_matmul(xq.reshape(-1, x.shape[-1]), weight)
    y = _rescale(acc, s_act, w_scale, bias, x.dtype)
    return y.reshape(*x.shape[:-1], weight.shape[0])


def _pad_nhwc(x: torch.Tensor, padding):
    """Zero padding of an NHWC tensor; `padding` an int or
    ((top, bottom), (left, right))."""
    if isinstance(padding, int):
        padding = ((padding, padding), (padding, padding))
    (top, bottom), (left, right) = padding
    if top or bottom or left or right:
        x = F.pad(x, (0, 0, left, right, top, bottom))
    return x


def _int8_conv_acc(xq: torch.Tensor, weight: torch.Tensor, stride: int,
                   padding) -> torch.Tensor:
    """The int32 sums of an int8 convolution: codes xq [B,H,W,C] padded
    with zeros (code 0 is the value 0), unfolded into columns ordered
    (kh, kw, C) and multiplied on `int8_matmul`, in chunks of output rows
    when the columns would pass ~256 MiB. -> [B, Ho, Wo, O]."""
    xq = _pad_nhwc(xq, padding)
    o, c, kh, kw = weight.shape
    wmat = weight.permute(0, 2, 3, 1).reshape(o, kh * kw * c)
    b, hp, wp, _ = xq.shape
    ho, wo = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    k = kh * kw * c
    if kh == kw == 1 and stride == 1:
        acc = int8_matmul(xq.reshape(-1, c), wmat)
    else:
        cols = xq.unfold(1, kh, stride).unfold(2, kw, stride)  # [B,Ho,Wo,C,kh,kw]
        cols = cols.permute(0, 1, 2, 4, 5, 3)                   # [..,kh,kw,C]
        if b * ho * wo * k <= _CHUNK_BYTES:
            acc = int8_matmul(cols.reshape(-1, k), wmat)
        else:
            rows = max(1, _CHUNK_BYTES // (wo * k))
            acc = torch.cat([
                int8_matmul(cols[bi, r0:r0 + rows].reshape(-1, k), wmat)
                for bi in range(b) for r0 in range(0, ho, rows)])
    return acc.reshape(b, ho, wo, o)


def int8_conv2d(x: torch.Tensor, weight: torch.Tensor, w_scale, *,
                act_scale=None, bias=None, stride: int = 1,
                padding=0) -> torch.Tensor:
    """W8A8 convolution on NHWC: x [B,H,W,C]; weight int8 OIHW; w_scale
    [O]; `padding` an int or ((top, bottom), (left, right)). The int32
    sums are exact (an f32 convolution of the codes would not be: a
    3x3x384 fan sums past 2^24)."""
    s_act = _act_scale(x, act_scale)
    acc = _int8_conv_acc(_quantize_act(x, s_act), weight, stride, padding)
    return _rescale(acc, s_act, w_scale, bias, x.dtype)


def int8_conv_transpose(x: torch.Tensor, weight: torch.Tensor, w_scale, *,
                        act_scale=None, bias=None) -> torch.Tensor:
    """W8A8 ConvTranspose2d with kernel == stride == k on NHWC: weight int8
    [C_in, C_out, k, k], w_scale [C_out]. Each input pixel maps to its own
    k x k block, so it is one product [B*H*W, C_in] x [C_in, C_out*k*k]."""
    ci, co, k, _ = weight.shape
    b, h, w, _ = x.shape
    s_act = _act_scale(x, act_scale)
    xq = _quantize_act(x, s_act).reshape(-1, ci)
    acc = int8_matmul(xq, weight.reshape(ci, co * k * k).t().contiguous())
    acc = acc.view(b, h, w, co, k, k).permute(0, 1, 4, 2, 5, 3)
    return _rescale(acc.reshape(b, h * k, w * k, co), s_act, w_scale, bias,
                    x.dtype)


# ------------------------------------------------------ weight quantisation

def quantize_weight_int8(w: torch.Tensor, out_dim: int = 0):
    """Symmetric per-output-channel int8 of a float weight: (codes int8,
    scales f32 [out]). `out_dim` is the output axis (0 for linear [out, in]
    and OIHW, 1 for a transposed conv [C_in, C_out, k, k])."""
    wf = w.float()
    red = tuple(d for d in range(wf.dim()) if d != out_dim)
    s_w = torch.clamp_min(wf.abs().amax(dim=red, keepdim=True) / 127.0,
                          1e-12)
    w_q = torch.clamp(torch.round(wf / s_w), -127, 127).to(torch.int8)
    return w_q, s_w.reshape(-1)


def w8_weight(w8: torch.Tensor, w_scale: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """A w8 weight back in `dtype` (codes times the per-output scale in
    float32, then the cast)."""
    s = w_scale.float().reshape(-1, *([1] * (w8.dim() - 1)))
    return (w8.float() * s).to(dtype)


def pack_nibbles(q: torch.Tensor, dim: int) -> torch.Tensor:
    """int8 values in [-8, 7], paired along `dim` (even length): low nibble
    the even index, high nibble the odd one."""
    q = q.movedim(dim, 0)
    lo, hi = q[0::2], q[1::2]
    packed = torch.bitwise_or(torch.bitwise_and(lo, 0xF),
                              torch.bitwise_left_shift(hi, 4))
    return packed.to(torch.int8).movedim(0, dim)


def unpack_nibbles(packed: torch.Tensor, dim: int) -> torch.Tensor:
    """The inverse of `pack_nibbles`, sign-extended by arithmetic shifts."""
    p = packed.movedim(dim, 0)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(p, 4), 4)
    hi = torch.bitwise_right_shift(p, 4)
    out = torch.stack([lo, hi], dim=1).reshape(-1, *p.shape[1:])
    return out.movedim(0, dim)


def _w4_group(n: int, group: int) -> int:
    """The largest divisor of `n` that is <= `group`."""
    for g in range(min(group, n), 0, -1):
        if n % g == 0:
            return g
    return n


def w4_weight(w4: torch.Tensor, w4_scale: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """A w4 weight back in `dtype`: unpack along the input axis (dim 1 of
    [out, in/2] or [C_out, C_in/2, kh, kw]) and scale each input group."""
    q = unpack_nibbles(w4, 1)
    n_grp = w4_scale.shape[1]
    shape = q.shape
    grp = q.reshape(shape[0], n_grp, shape[1] // n_grp, *shape[2:])
    s = w4_scale.float().reshape(shape[0], n_grp, 1,
                                 *([1] * (q.dim() - 2)))
    return (grp.float() * s).reshape(shape).to(dtype)


def _w4_codes(w: torch.Tensor, group: int):
    """(packed int8, scales f32 [out, in/g], g) of a float weight whose
    input axis is dim 1."""
    wf = w.float()
    n_in = wf.shape[1]
    if n_in % 2:
        raise ValueError(
            f"W4 nibble packing needs an even input-axis length, got {n_in} "
            f"(shape {tuple(w.shape)})")
    g = _w4_group(n_in, group)
    grp = wf.reshape(wf.shape[0], n_in // g, g, *wf.shape[2:])
    red = (2,) + tuple(range(3, grp.dim()))
    s = torch.clamp_min(grp.abs().amax(dim=red, keepdim=True) / 7.0, 1e-12)
    q = torch.clamp(torch.round(grp / s), -8, 7).to(torch.int8)
    q = q.reshape(wf.shape)
    return pack_nibbles(q, 1), s.reshape(wf.shape[0], n_in // g), g


# ------------------------------------------------------------------ modules

def _leaf(t) -> torch.Tensor:
    return t.detach() if isinstance(t, torch.Tensor) else torch.as_tensor(t)


class _Quantized(nn.Module):
    """Holds the leaves of one quantised layer as buffers under their JAX
    names; `mode` is "int8" (W8A8), "w8", "w4" or "smooth" (a float weight
    with a SmoothQuant input multiplier)."""

    def __init__(self, leaves: dict):
        super().__init__()
        for name, t in leaves.items():
            if t is not None:
                self.register_buffer(name, _leaf(t))
        names = set(self._buffers)
        if "w4" in names:
            self.mode = "w4"
        elif "w8" in names:
            self.mode = "w8"
        elif self._buffers["weight"].dtype == torch.int8:
            self.mode = "int8"
        elif "smooth" in names:
            self.mode = "smooth"
        else:
            raise ValueError(f"not a quantised layer: {sorted(names)}")
        # the per-layer mask, read once on the host
        self.use_int8 = bool(self._buffers["use_q"]) if "use_q" in names \
            else True
        self.site = None      # the layer's name, for error messages

    def _get(self, name):
        return self._buffers.get(name)

    def _apply(self, fn, recurse=True):
        # a quantised layer keeps its leaves' dtypes (int8 codes, float32
        # scales, the serving dtype's bias) when its model is cast, as the
        # JAX package's quantised trees are never re-cast; it does move
        # with its model's device
        for name, buf in list(self._buffers.items()):
            if buf is not None:
                moved = fn(buf)
                self._buffers[name] = moved if moved.dtype == buf.dtype \
                    else buf.to(moved.device)
        return self

    def dense_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The weight in `dtype` in its float layout (w8 / w4 dequantised;
        a float weight cast)."""
        if self.mode == "w4":
            return w4_weight(self.w4, self.w4_scale, dtype)
        if self.mode == "w8":
            return w8_weight(self.w8, self.w_scale, dtype)
        if self.mode == "int8":
            raise ValueError("a W8A8 layer has no float weight to use")
        return self.weight.to(dtype)


class QuantLinear(_Quantized):
    """The quantised counterpart of `layers.Linear` (leaves: `weight` int8
    [out, in] or float, `w_scale`, `act_scale`, `smooth`, `use_q`, `w_orig`,
    `w8`, `w4`, `w4_scale`, `w4_group`, `bias`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self._get("bias")
        if self.mode == "int8":
            smooth = self._get("smooth")
            if not self.use_int8:
                if smooth is not None:   # w_orig's rows carry the migration
                    x = x * smooth.to(x.dtype)
                return F.linear(x, self.w_orig.to(x.dtype),
                                None if bias is None else bias.to(x.dtype))
            return int8_linear(x, self.weight, self.w_scale,
                               act_scale=self._get("act_scale"), bias=bias,
                               smooth=smooth)
        if self.mode == "smooth":
            x = x * self.smooth.to(x.dtype)
        return F.linear(x, self.dense_weight(x.dtype),
                        None if bias is None else bias.to(x.dtype))


class QuantConv2d(_Quantized):
    """The quantised counterpart of `conv.Conv2dNHWC` (NHWC in and out;
    leaves `weight` int8 OIHW, `w_scale`, `act_scale`, `w8`, `w4`,
    `w4_scale`, `w4_group`, `bias`), with the stride and padding of the
    module it replaces."""

    def __init__(self, leaves: dict, *, stride: int = 1, padding=0):
        super().__init__(leaves)
        self.stride = stride
        self.padding = padding

    def conv(self, x: torch.Tensor, *, stride: int, padding) -> torch.Tensor:
        bias = self._get("bias")
        if self.mode == "int8":
            return int8_conv2d(x, self.weight, self.w_scale,
                               act_scale=self._get("act_scale"), bias=bias,
                               stride=stride, padding=padding)
        from .conv import conv2d
        return conv2d(x, self.dense_weight(x.dtype), bias, stride=stride,
                      padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, stride=self.stride, padding=self.padding)


class QuantConvTranspose2d(_Quantized):
    """The W8A8 counterpart of `conv.ConvTranspose2dNHWC` (kernel ==
    stride; `weight` int8 [C_in, C_out, k, k], `w_scale` [C_out])."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode != "int8":
            raise ValueError(f"transposed conv in mode {self.mode!r}")
        return int8_conv_transpose(x, self.weight, self.w_scale,
                                   act_scale=self._get("act_scale"),
                                   bias=self._get("bias"))


def is_quantized(module: nn.Module) -> bool:
    return isinstance(module, _Quantized)


def _kind(module: nn.Module) -> str:
    from .conv import ConvTranspose2dNHWC
    if isinstance(module, (nn.Linear, QuantLinear)):
        return "linear"
    if isinstance(module, (ConvTranspose2dNHWC, QuantConvTranspose2d)):
        return "convt"
    if isinstance(module, (nn.Conv2d, QuantConv2d)):
        return "conv"
    raise TypeError(f"no quantised form for {type(module).__name__}")


def _conv_geometry(module: nn.Module) -> dict:
    if isinstance(module, QuantConv2d):
        return {"stride": module.stride, "padding": module.padding}
    stride, padding = module.stride, module.padding
    return {"stride": stride[0] if isinstance(stride, tuple) else stride,
            "padding": padding[0] if isinstance(padding, tuple) else padding}


def _build(module: nn.Module, leaves: dict) -> _Quantized:
    """The quantised module that takes `module`'s place, from `leaves`."""
    kind = _kind(module)
    if kind == "linear":
        return QuantLinear(leaves)
    if kind == "convt":
        return QuantConvTranspose2d(leaves)
    return QuantConv2d(leaves, **_conv_geometry(module))


def swap_module(root: nn.Module, name: str, new: nn.Module) -> None:
    """Put `new` in the place of `root`'s submodule `name` (dotted)."""
    parent_name, _, attr = name.rpartition(".")
    parent = root.get_submodule(parent_name) if parent_name else root
    setattr(parent, attr, new)
    if is_quantized(new):
        new.site = name


def apply_quantized_(model: nn.Module, state_dict: dict) -> nn.Module:
    """Swap in a quantised module wherever `state_dict` (the port's keys)
    holds a quantised layer's leaves, built from those leaves; the caller
    then loads the rest. A state dict without such leaves changes
    nothing."""
    markers = ("w_scale", "w8", "w4", "smooth")
    names = sorted({k.rpartition(".")[0] for k in state_dict
                    if k.rpartition(".")[2] in markers})
    for name in names:
        prefix = name + "."
        leaves = {k[len(prefix):]: v for k, v in state_dict.items()
                  if k.startswith(prefix) and "." not in k[len(prefix):]}
        swap_module(model, name, _build(model.get_submodule(name), leaves))
    return model


def _float_leaves(module: nn.Module) -> dict:
    """(weight, bias, smooth) of a float layer, as they are."""
    if is_quantized(module):
        if module.mode != "smooth":
            raise ValueError(f"{module.site}: already quantised "
                             f"({module.mode})")
        return {"weight": module.weight, "bias": module._get("bias"),
                "smooth": module.smooth}
    return {"weight": module.weight.detach(),
            "bias": None if module.bias is None else module.bias.detach(),
            "smooth": None}


def quantize_linear_int8(module: nn.Module, act_scale=None,
                         use_q: bool | None = None) -> QuantLinear:
    """W8A8 of a linear (JAX `quantize_linear_int8`). `act_scale`: the
    static input scale, or None for the dynamic amax. `use_q` (per-layer
    mask): keep the original weight as `w_orig` and run it when False."""
    f = _float_leaves(module)
    w_q, s_w = quantize_weight_int8(f["weight"], 0)
    leaves = {"weight": w_q, "w_scale": s_w, "bias": f["bias"],
              "smooth": f["smooth"]}
    if act_scale is not None:
        leaves["act_scale"] = torch.as_tensor(act_scale).float()
    if use_q is not None:
        leaves["use_q"] = torch.tensor(bool(use_q), device=w_q.device)
        leaves["w_orig"] = f["weight"]
    return QuantLinear(leaves)


def quantize_conv_int8(module: nn.Module, act_scale=None) -> _Quantized:
    """W8A8 of a conv or a kernel == stride transposed conv (JAX
    `quantize_conv_int8`)."""
    f = _float_leaves(module)
    kind = _kind(module)
    w_q, s_w = quantize_weight_int8(f["weight"], 1 if kind == "convt" else 0)
    leaves = {"weight": w_q, "w_scale": s_w, "bias": f["bias"]}
    if act_scale is not None:
        leaves["act_scale"] = torch.as_tensor(act_scale).float()
    return _build(module, leaves)


def quantize_linear_w8(module: nn.Module) -> QuantLinear:
    f = _float_leaves(module)
    w_q, s_w = quantize_weight_int8(f["weight"], 0)
    return QuantLinear({"w8": w_q, "w_scale": s_w, "bias": f["bias"]})


def quantize_conv_w8(module: nn.Module) -> QuantConv2d:
    f = _float_leaves(module)
    w_q, s_w = quantize_weight_int8(f["weight"], 0)
    return _build(module, {"w8": w_q, "w_scale": s_w, "bias": f["bias"]})


def _w4_leaves(module, group):
    f = _float_leaves(module)
    packed, s, g = _w4_codes(f["weight"], group)
    return {"w4": packed, "w4_scale": s,
            "w4_group": torch.tensor(g, dtype=torch.int32,
                                     device=packed.device),
            "bias": f["bias"]}


def quantize_linear_w4(module: nn.Module, *,
                       group: int = W4_GROUP) -> QuantLinear:
    return QuantLinear(_w4_leaves(module, group))


def quantize_conv_w4(module: nn.Module, *,
                     group: int = W4_GROUP) -> QuantConv2d:
    return _build(module, _w4_leaves(module, group))


# ----------------------------------------------------------- trunk (ViT)

def stat_scale(amax, margin: float) -> torch.Tensor:
    """A static scale from a recorded amax: max(amax * margin / 127, 1e-9)
    in float32."""
    return torch.clamp_min(torch.as_tensor(amax).float() * margin / 127.0,
                           1e-9)


def ln_act_scale(ln: nn.Module, sigma: float) -> torch.Tensor:
    """Static input bound of a matmul fed by LayerNorm `ln`:
    (sigma * max|gamma| + max|beta|) / 127, in the parameters' dtype."""
    bound = sigma * ln.weight.detach().abs().amax(-1) + \
        ln.bias.detach().abs().amax(-1)
    return torch.clamp_min(bound / 127.0, 1e-9)


def smooth_linear(module: nn.Module, ch_amax: torch.Tensor, alpha: float):
    """SmoothQuant migration of one linear (JAX `_smooth_linear`): weight
    rows (input channels) times s = amax_x^alpha / amax_w^(1-alpha), the
    input times the stored 1/s. Returns (the smoothed module, the smoothed
    input's per-tensor amax)."""
    f = _float_leaves(module)
    w = f["weight"].float()                                  # [out, in]
    a = torch.clamp_min(ch_amax.float(), 1e-6)
    w_amax = torch.clamp_min(w.abs().amax(dim=0), 1e-6)      # [in]
    s = torch.clamp((a ** alpha) / (w_amax ** (1.0 - alpha)), 1e-4, 1e4)
    inv = (1.0 / s).float()
    prev = f["smooth"]
    smoothed = QuantLinear({
        "weight": (w * s[None, :]).to(f["weight"].dtype),
        "bias": f["bias"],
        "smooth": inv if prev is None else prev * inv})
    return smoothed, (a / s).amax(-1)


def _families(block) -> dict:
    mlp = block.mlp
    return {"qkv": "attn.qkv", "proj": "attn.proj",
            "ffn1": "mlp.fc1" if hasattr(mlp, "fc1") else "mlp.w12",
            "ffn2": "mlp.fc2" if hasattr(mlp, "fc2") else "mlp.w3"}


@torch.no_grad()
def quantize_vit_trunk_int8(vit: nn.Module, *, sigma: float = ACT_SIGMA,
                            act_stats: dict | None = None,
                            margin: float = 1.0, dynamic: bool = False,
                            families: tuple = FAMILIES,
                            smooth_alpha: float | None = None,
                            layer_mask=None) -> nn.Module:
    """Quantise a DINOv2 trunk's block matmuls in place (JAX
    `quantize_vit_trunk_int8`): the default LayerNorm-bound static scales on
    the LN-fed qkv and first FFN projection; `act_stats` (from
    `collect_trunk_act_stats`) calibrated static scales on all four
    families; `dynamic` run-time scales on all four. `families` restricts
    the families, `smooth_alpha` migrates proj / ffn2 first (needs the
    per-channel stats), `layer_mask` ([depth] bools) keeps the unselected
    blocks' original weights (incompatible with `smooth_alpha`)."""
    if layer_mask is not None and smooth_alpha is not None:
        raise ValueError("layer_mask and smooth_alpha are incompatible")
    if smooth_alpha is not None:
        if act_stats is None or "proj_in_ch" not in act_stats:
            raise ValueError("smooth_alpha needs per-channel act_stats "
                             "from collect_trunk_act_stats")
        act_stats = dict(act_stats)
        proj_in, fc2_in = [], []
        for i, blk in enumerate(vit.blocks):
            fam = _families(blk)
            for key, stat, out in (("proj", "proj_in_ch", proj_in),
                                   ("ffn2", "fc2_in_ch", fc2_in)):
                mod, amax = smooth_linear(blk.get_submodule(fam[key]),
                                          act_stats[stat][i], smooth_alpha)
                swap_module(blk, fam[key], mod)
                out.append(amax)
        act_stats["proj_in"] = torch.stack(proj_in)
        act_stats["fc2_in"] = torch.stack(fc2_in)
    if layer_mask is not None:
        mask = [bool(m) for m in torch.as_tensor(layer_mask).reshape(-1)]
        if len(mask) != len(vit.blocks):
            raise ValueError(f"layer_mask of {len(mask)} does not match "
                             f"{len(vit.blocks)} blocks")
    for i, blk in enumerate(vit.blocks):
        use_q = None if layer_mask is None else mask[i]
        if dynamic:
            scales = dict.fromkeys(FAMILIES)
        elif act_stats:
            scales = {"qkv": stat_scale(act_stats["qkv_in"][i], margin),
                      "proj": stat_scale(act_stats["proj_in"][i], margin),
                      "ffn1": stat_scale(act_stats["fc1_in"][i], margin),
                      "ffn2": stat_scale(act_stats["fc2_in"][i], margin)}
        else:
            scales = {"qkv": ln_act_scale(blk.norm1, sigma),
                      "ffn1": ln_act_scale(blk.norm2, sigma)}
        for fam, name in _families(blk).items():
            if fam in families and fam in scales:
                swap_module(blk, name, quantize_linear_int8(
                    blk.get_submodule(name), scales[fam], use_q))
    for name, mod in vit.named_modules():
        if is_quantized(mod):
            mod.site = name
    return vit


@torch.no_grad()
def collect_trunk_act_stats(vit: nn.Module, x: torch.Tensor,
                            guide: torch.Tensor | None = None, *,
                            attn_impl: str | None = None) -> dict:
    """One forward through every block of the trunk with the amax of the
    four matmul inputs recorded per block (JAX `collect_trunk_act_stats`):
    {"qkv_in", "proj_in", "fc1_in", "fc2_in"} [L] float32, and per-channel
    {"proj_in_ch" [L, D], "fc2_in_ch" [L, H]}. `x` is the normalised image
    [B,H,W,3]. The blocks run their own forward; hooks read the inputs."""
    rec = {k: [] for k in ("qkv_in", "proj_in", "fc1_in", "fc2_in",
                           "proj_in_ch", "fc2_in_ch")}

    def hook(key, ch_key=None):
        def fn(_mod, args):
            a = args[0]
            rec[key].append(a.abs().amax().float())
            if ch_key:
                rec[ch_key].append(a.float().abs().amax(dim=(0, 1)))
        return fn

    handles = []
    for blk in vit.blocks:
        fam = _families(blk)
        for fam_key, key, ch in (("qkv", "qkv_in", None),
                                 ("proj", "proj_in", "proj_in_ch"),
                                 ("ffn1", "fc1_in", None),
                                 ("ffn2", "fc2_in", "fc2_in_ch")):
            handles.append(blk.get_submodule(fam[fam_key])
                           .register_forward_pre_hook(hook(key, ch)))
    try:
        t = vit.prepare_tokens(x, guide)
        for blk in vit.blocks:
            t = blk(t, attn_impl=attn_impl)
    finally:
        for h in handles:
            h.remove()
    return {k: torch.stack(v) for k, v in rec.items()}


def merge_act_stats(stats_list) -> dict:
    """Element-wise max over several calibration batches' stats."""
    out = dict(stats_list[0])
    for s in stats_list[1:]:
        for k, v in s.items():
            out[k] = torch.maximum(out[k], v)
    return out


# ---------------------------------------------------------------- DPT head

# the head convs with recorded input maxima: the port's module name and the
# JAX package's stats key (its tree path); the final sigmoid-feeding 1x1
# stays high precision, and so do the transposed-conv resize layers
HEAD_STAT_SITES = (
    [(f"projects.{i}", f"projects.{i}") for i in range(4)]
    + [("resize_layers.3", "resize_layers.3")]
    + [(f"input_projection.{i}.0", f"input_projection.{i}.conv")
       for i in range(4)]
    + [(f"scratch.layer{i}_rn", f"scratch.layer{i}_rn") for i in range(1, 5)]
    + [(f"scratch.refinenet{i}.{u}.{c}", f"scratch.refinenet{i}.{u}.{c}")
       for i in range(1, 5) for u in ("resConfUnit1", "resConfUnit2")
       for c in ("conv1", "conv2")]
    + [(f"scratch.refinenet{i}.out_conv", f"scratch.refinenet{i}.out_conv")
       for i in range(1, 5)]
    + [("scratch.output_conv1", "scratch.output_conv1"),
       ("scratch.output_conv2.0", "scratch.output_conv2.conv1")])


@torch.no_grad()
def collect_dpt_head_act_stats(head: nn.Module, features, patch_hw) -> dict:
    """The amax of every quantisable head conv's input under the JAX
    package's keys (`collect_dpt_head_act_stats`), from one run of the
    head itself (hooks read the inputs). Returns (stats, head output)."""
    stats: dict = {}
    handles = []
    for name, key in HEAD_STAT_SITES:
        try:
            mod = head.get_submodule(name)
        except AttributeError:
            continue    # the raw head has no input_projection

        def fn(_mod, args, key=key):
            stats[key] = args[0].abs().amax().float()
        handles.append(mod.register_forward_pre_hook(fn))
    try:
        out = head(features, patch_hw)
    finally:
        for h in handles:
            h.remove()
    return stats, out


@torch.no_grad()
def quantize_dpt_head_int8(head: nn.Module, act_stats: dict, *,
                           margin: float = 1.25) -> nn.Module:
    """W8A8 of the head convs with calibrated static scales, in place (JAX
    `quantize_dpt_head_int8`); a residual unit with no stats (refinenet4's
    first, which never runs) stays high precision."""
    for name, key in HEAD_STAT_SITES:
        if ".resConfUnit" in name:
            unit = key.rpartition(".")[0]
            if f"{unit}.conv1" not in act_stats:
                continue
        elif name.startswith("input_projection") and \
                not hasattr(head, "input_projection"):
            continue
        swap_module(head, name, quantize_conv_int8(
            head.get_submodule(name), stat_scale(act_stats[key], margin)))
    return head


# --------------------------------------------------------------- diffusion

def diffusion_site(path: str, module: nn.Module, *, min_conv_fan: int = 512,
                   min_lin_dim: int = 256,
                   skip_suffixes: tuple = ("out/conv", "conv_out"),
                   weight_only: bool = False, bits: int = 8):
    """What JAX `quantize_diffusion_int8` makes of the layer at JAX tree
    path `path` ("/"-joined, the parameter's container): None, or one of
    "int8", "w8", "w4". The rules read the JAX layout's shapes: a conv's fan
    is kh*kw*C_in (C_in*k*k for a transposed conv), a linear quantises when
    both its dims reach `min_lin_dim`."""
    if any(path.endswith(sfx) for sfx in skip_suffixes):
        return None
    if weight_only and path.endswith("upsampler"):
        return None
    kind = _kind(module)
    w = module.weight
    if kind == "linear":
        if min(w.shape) < min_lin_dim:
            return None
        even = w.shape[1] % 2 == 0
    else:
        fan = w.shape[0] * w.shape[2] * w.shape[3] if kind == "convt" \
            else w[0].numel()
        if fan < min_conv_fan:
            return None
        even = kind == "conv" and w.shape[1] % 2 == 0
    if not weight_only:
        return "int8"
    return "w4" if bits == 4 and even else "w8"


@torch.no_grad()
def quantize_diffusion_modules(root: nn.Module, sites: dict, *,
                               min_conv_fan: int = 512,
                               min_lin_dim: int = 256,
                               skip_suffixes: tuple = ("out/conv",
                                                       "conv_out"),
                               weight_only: bool = False,
                               bits: int = 8) -> dict:
    """Quantise, in place, the layers of `root` that JAX
    `quantize_diffusion_int8` picks: `sites` maps each layer's module name
    (under `root`) to its JAX tree path. W8A8 with dynamic scales, or with
    `weight_only` w8 (`bits=8`) or w4 (`bits=4`, even fans only; the others
    w8). Returns {module name: scheme} of the layers quantised."""
    if bits == 4 and not weight_only:
        raise ValueError("bits=4 is weight-only")
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if any(is_quantized(m) for m in root.modules()):
        raise ValueError("the model is already quantised")
    done = {}
    for name, path in sites.items():
        mod = root.get_submodule(name)
        scheme = diffusion_site(path, mod, min_conv_fan=min_conv_fan,
                                min_lin_dim=min_lin_dim,
                                skip_suffixes=skip_suffixes,
                                weight_only=weight_only, bits=bits)
        if scheme is None:
            continue
        linear = _kind(mod) == "linear"
        if scheme == "int8":
            new = quantize_linear_int8(mod) if linear \
                else quantize_conv_int8(mod)
        elif scheme == "w8":
            new = quantize_linear_w8(mod) if linear else quantize_conv_w8(mod)
        else:
            new = quantize_linear_w4(mod) if linear else quantize_conv_w4(mod)
        swap_module(root, name, new)
        done[name] = scheme
    return done


# ------------------------------------------- calibration of dynamic sites

@torch.no_grad()
def calibrate_dynamic_scales(root: nn.Module, run, margin: float) -> int:
    """Promote `root`'s dynamic W8A8 layers to static scales (JAX
    `calibrate_diffusion_scales`): forward pre-hooks record the largest
    scale each such layer computes during `run()`, and each one's
    float(scale) x `margin` is baked in as its `act_scale` (float32).
    Returns the number of layers promoted."""
    scales: dict = {}

    def hook(mod, args):
        x = args[0]
        if mod._get("smooth") is not None:
            x = x * mod.smooth.to(x.dtype)
        s = _act_scale(x, None)
        prev = scales.get(mod)
        scales[mod] = s if prev is None else torch.maximum(prev, s)

    handles = [m.register_forward_pre_hook(hook) for m in root.modules()
               if is_quantized(m) and m.mode == "int8" and m.use_int8
               and m._get("act_scale") is None]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    if not scales:
        raise ValueError("calibration forward hit no dynamic int8 sites "
                         "(tree not quantized, or already static?)")
    for mod, s in scales.items():
        mod.register_buffer("act_scale", torch.tensor(
            float(s) * margin, dtype=torch.float32, device=s.device))
    return len(scales)
