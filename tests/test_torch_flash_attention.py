"""Port flash-attention (plain version on the CPU) vs the JAX package's
Pallas kernel in interpret mode and its XLA reference.

The same seeded numpy inputs go to both packages; max abs <= 1e-5 (f32
softmax on both sides, sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.ops.flash_attention import mha as jax_mha
from amodal_depth_anything_tpu.ops.flash_attention import \
    mha_reference as jax_mha_reference
from amodal_depth_anything_tpu_torch.ops import _build
from amodal_depth_anything_tpu_torch.ops.attention import multi_head_attention
from amodal_depth_anything_tpu_torch.ops.flash_attention import (
    SHORT_FEW_KEYS, SHORT_KEYS, _check, _check_bwd, fwd_instantiation, mha,
    mha_reference)
from tests.test_torch_models import few_torch_threads  # noqa: F401

TOL = 1e-5

# (batch, heads, n_q, n_k, kv_len, sm_scale)
CASES = [
    (1, 2, 200, 200, None, None),    # ragged N (not a multiple of 64/128)
    (2, 3, 37, 37, None, None),      # tiny ragged N, batch > 1
    (1, 2, 256, 256, 200, None),     # kv_len < N (model-level padding)
    (1, 2, 130, 130, None, 0.3),     # custom sm_scale
    (1, 2, 100, 150, None, None),    # cross attention, Nq != Nk
]


# the edges of the Hopper forward kernel's 128-row query and key tiles (and
# of the 64 rows each consumer warpgroup owns): N around 64, 128 and 256,
# kv_len one short of N and in the middle of a tile, 77 keys under many rows
EDGE_KV_CASES = [(1, 1, 129, 129, 128, None), (1, 1, 257, 257, 187, None),
                 (1, 2, 128, 128, 58, None), (1, 1, 1024, 77, None, None)]
EDGE_CASES = [(1, 1, n, n, None, None)
              for n in (1, 63, 64, 65, 127, 128, 129, 255, 257)] + EDGE_KV_CASES
# the Pallas kernel in interpret mode is slow: the 128 edge and the kv cases
INTERPRET_EDGE_CASES = [(1, 1, n, n, None, None)
                        for n in (127, 128, 129)] + EDGE_KV_CASES


# d = 40 (the bf16 forward's KSTEPS 3, which reads boxes of d columns) on
# N that is no multiple of its 128-row blocks and 128-key tiles, on the
# edges of three and six 64-row warpgroups, kv_len inside a tile, and a
# 77-key cross-attention under a ragged block (b, h, n_q, n_k, kv_len)
D40_EDGE_CASES = [(1, 1, n, n, None) for n in (191, 192, 193, 383, 385)] + [
    (1, 2, 385, 385, 200), (2, 1, 193, 77, None)]


def _qkv(b, h, nq, nk, d=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, nq, d), dtype=np.float32)
    k = rng.standard_normal((b, h, nk, d), dtype=np.float32)
    v = rng.standard_normal((b, h, nk, d), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize("b,h,nq,nk,kv_len,scale",
                         CASES + INTERPRET_EDGE_CASES)
def test_mha_matches_jax_pallas_interpret(b, h, nq, nk, kv_len, scale):
    q, k, v = _qkv(b, h, nq, nk)
    ref = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             interpret=True, kv_len=kv_len, sm_scale=scale))
    ours = mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
               kv_len=kv_len, sm_scale=scale).numpy()
    assert ours.shape == (b, h, nq, 64)
    assert np.abs(ours - ref).max() <= TOL


@pytest.mark.parametrize("b,h,nq,nk,kv_len,scale", CASES + EDGE_CASES)
def test_mha_reference_matches_jax_reference(b, h, nq, nk, kv_len, scale):
    q, k, v = _qkv(b, h, nq, nk, seed=1)
    ref = np.asarray(jax_mha_reference(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), kv_len=kv_len,
                                       sm_scale=scale))
    ours = mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), kv_len=kv_len,
                         sm_scale=scale).numpy()
    assert np.abs(ours - ref).max() <= TOL


@pytest.mark.parametrize("kv_len,scale", [(None, None), (150, None),
                                          (None, 0.2)])
def test_mha_lse_matches_jax_logsumexp(kv_len, scale):
    b, h, n = 1, 2, 180
    q, k, v = _qkv(b, h, n, n, seed=2)
    sc = 64 ** -0.5 if scale is None else scale
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q) * sc, jnp.asarray(k),
                   precision=jax.lax.Precision.HIGHEST)
    if kv_len is not None:
        s = s[..., :kv_len]
    ref_lse = np.asarray(jax.scipy.special.logsumexp(s, axis=-1))
    o, lse = mha(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v), kv_len=kv_len, sm_scale=scale,
                 return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, n)
    assert np.abs(lse.numpy() - ref_lse).max() <= TOL
    ref_o = np.asarray(jax_mha_reference(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), kv_len=kv_len,
                                         sm_scale=scale))
    assert np.abs(o.numpy() - ref_o).max() <= TOL


def test_mha_plain_takes_other_head_dims():
    # the CPU plain version takes any D
    q, k, v = _qkv(1, 2, 50, 50, d=32, seed=3)
    ref = np.asarray(jax_mha_reference(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v)))
    ours = mha(torch.from_numpy(q), torch.from_numpy(k),
               torch.from_numpy(v)).numpy()
    assert np.abs(ours - ref).max() <= TOL


def test_cpu_never_counts_a_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 40, 40, seed=4))
    counters = ("launches", "short_launches", "bwd_dq_launches",
                "bwd_dkv_launches", "bwd_short_launches")
    before = [getattr(mha, c) for c in counters]
    mha(q, k, v)
    multi_head_attention(q, k, v)
    multi_head_attention(q, k, v, impl="plain")
    mha(q.bfloat16(), k[:, :, :1].bfloat16(), v[:, :, :1].bfloat16())
    # backward passes: the pair (float32) and the short-key op (bfloat16)
    for dtype in (torch.float32, torch.bfloat16):
        leaves = [t.to(dtype).requires_grad_() for t in (q, k, v)]
        mha(*leaves).float().sum().backward()
    assert [getattr(mha, c) for c in counters] == before


def test_dispatch_defaults_to_plain_on_cpu_and_rejects_unknown():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 40, 40, seed=5))
    torch.testing.assert_close(multi_head_attention(q, k, v),
                               mha_reference(q, k, v), rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown attention impl"):
        multi_head_attention(q, k, v, impl="pallas")


# the SD-1.5 UNet's head dims (40/80/160), the DepthFM proxy's 12, and
# cross-attention onto 77 context tokens: (heads, n_q, n_k, d, sm_scale)
UNET_CASES = [(2, 64, 64, 12, None), (2, 100, 100, 40, None),
              (2, 70, 70, 80, None), (1, 64, 64, 160, None),
              (2, 100, 77, 40, None), (1, 64, 77, 160, None),
              (2, 64, 64, 40, 0.11)]
# pix2gestalt's UNet at 256 px: self-attention and cross-attention onto ONE
# context token (the CLIP embedding) at head dims 40/80/160, and the CLIP
# tower's 257 tokens at 64: (heads, n_q, n_k, d, sm_scale)
P2G_CASES = [(2, 1024, 1, 40, None), (2, 256, 1, 80, None),
             (2, 64, 1, 160, None), (2, 16, 1, 160, None),
             (2, 16, 16, 160, None), (2, 257, 257, 64, None)]


@pytest.mark.parametrize("h,nq,nk,d,scale", UNET_CASES + P2G_CASES)
def test_mha_reference_matches_jax_reference_at_unet_head_dims(h, nq, nk, d,
                                                               scale):
    q, k, v = _qkv(2, h, nq, nk, d=d, seed=6)
    ref = np.asarray(jax_mha_reference(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), sm_scale=scale))
    ours = mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
               sm_scale=scale).numpy()
    assert ours.shape == (2, h, nq, d)
    assert np.abs(ours - ref).max() <= TOL


@pytest.mark.parametrize("h,nq,nk,d,scale", [UNET_CASES[1], UNET_CASES[4],
                                             UNET_CASES[5], P2G_CASES[3]])
def test_mha_matches_jax_pallas_interpret_at_unet_head_dims(h, nq, nk, d,
                                                            scale):
    # the Pallas kernel lane-pads d; the port's kernel pads it to a
    # multiple of 16; both must equal plain attention at the true d
    q, k, v = _qkv(1, h, nq, nk, d=d, seed=7)
    ref = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             interpret=True, sm_scale=scale))
    ours = mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), sm_scale=scale).numpy()
    assert np.abs(ours - ref).max() <= TOL


@pytest.mark.parametrize("b,h,nq,nk,kv_len", D40_EDGE_CASES)
def test_mha_matches_jax_reference_at_d40_block_edges(b, h, nq, nk, kv_len):
    """The port's plain version at d = 40 against the JAX reference on
    D40_EDGE_CASES, LSE included."""
    q, k, v = _qkv(b, h, nq, nk, d=40, seed=8)
    ref = np.asarray(jax_mha_reference(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), kv_len=kv_len))
    ours, lse = mha(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), kv_len=kv_len, return_lse=True)
    assert np.abs(ours.numpy() - ref).max() <= TOL
    s = np.einsum("bhqd,bhkd->bhqk", q * 40 ** -0.5, k)[..., :kv_len or nk]
    ref_lse = np.asarray(jax.scipy.special.logsumexp(jnp.asarray(s), axis=-1))
    assert np.abs(lse.numpy() - ref_lse).max() <= TOL


@pytest.mark.parametrize("b,h,nq,nk,kv_len", D40_EDGE_CASES[:3]
                         + D40_EDGE_CASES[5:])
def test_mha_matches_jax_pallas_interpret_at_d40_block_edges(b, h, nq, nk,
                                                             kv_len):
    q, k, v = _qkv(b, h, nq, nk, d=40, seed=9)
    ref = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             interpret=True, kv_len=kv_len))
    ours = mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
               kv_len=kv_len).numpy()
    assert np.abs(ours - ref).max() <= TOL


class _OnCard:
    """A stand-in the kernel wrappers' checks see as a CUDA tensor: the
    head-dim rule is plain Python and is held here without a card."""

    is_cuda = True
    device = "cuda:0"

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self._t = torch.empty(shape, dtype=dtype)

    def dim(self):
        return len(self.shape)

    def stride(self, *a):
        return self._t.stride(*a)

    def element_size(self):
        return self._t.element_size()

    def data_ptr(self):
        return 0

    def is_contiguous(self):
        return True


@pytest.mark.parametrize("dtype,d,ok", [
    (torch.float32, 12, True), (torch.float32, 40, True),
    (torch.float32, 160, True), (torch.float32, 64, True),
    (torch.bfloat16, 40, True), (torch.bfloat16, 80, True),
    (torch.bfloat16, 160, True), (torch.bfloat16, 24, True),
    (torch.bfloat16, 12, False), (torch.float32, 6, False),
    (torch.float32, 164, False), (torch.bfloat16, 168, False),
    (torch.bfloat16, 20, False)])
def test_check_head_dim_rule(dtype, d, ok):
    q = _OnCard((1, 2, 9, d), dtype)
    k = _OnCard((1, 2, 7, d), dtype)
    if ok:
        _check(q, k, k, 7)
    else:
        with pytest.raises(ValueError, match="head dim"):
            _check(q, k, k, 7)


# (dtype, head dim, kernel) with every key past the short-key cut
FWD_TABLE = [
    (torch.bfloat16, 8, "flash_attn_fwd_bf16_wgmma<1, 2>"),
    (torch.bfloat16, 40, "flash_attn_fwd_bf16_wgmma<3, 2>"),
    (torch.bfloat16, 48, "flash_attn_fwd_bf16_wgmma<3, 2>"),
    (torch.bfloat16, 64, "flash_attn_fwd_bf16_wgmma<4, 2>"),
    (torch.bfloat16, 72, "flash_attn_fwd_bf16_wgmma<5, 2>"),
    (torch.bfloat16, 80, "flash_attn_fwd_bf16_wgmma<5, 2>"),
    (torch.bfloat16, 96, "flash_attn_fwd_bf16_wgmma<10, 2>"),
    (torch.bfloat16, 160, "flash_attn_fwd_bf16_wgmma<10, 2>"),
    (torch.float32, 12, "flash_attn_fwd_f32<16>"),
    (torch.float32, 40, "flash_attn_fwd_f32<48>"),
    (torch.float32, 80, "flash_attn_fwd_f32<80>"),
    (torch.float32, 100, "flash_attn_fwd_f32<160>")]
# (dtype, head dim, kv_len, kernel) around the short-key cut: onto one key
# and 77, at the cut and one past it
FWD_KV_TABLE = [
    (torch.bfloat16, 40, 1, "flash_attn_fwd_bf16_short<3, 16>"),
    (torch.bfloat16, 40, 77, "flash_attn_fwd_bf16_short<3, 80>"),
    (torch.bfloat16, 40, SHORT_KEYS, "flash_attn_fwd_bf16_short<3, 80>"),
    (torch.bfloat16, 40, SHORT_KEYS + 1, "flash_attn_fwd_bf16_wgmma<3, 2>"),
    (torch.bfloat16, 64, SHORT_FEW_KEYS, "flash_attn_fwd_bf16_short<4, 16>"),
    (torch.bfloat16, 64, SHORT_FEW_KEYS + 1,
     "flash_attn_fwd_bf16_short<4, 80>"),
    (torch.bfloat16, 80, 1, "flash_attn_fwd_bf16_short<5, 16>"),
    (torch.bfloat16, 80, 77, "flash_attn_fwd_bf16_short<5, 80>"),
    (torch.bfloat16, 80, SHORT_KEYS + 1, "flash_attn_fwd_bf16_wgmma<5, 2>"),
    (torch.bfloat16, 160, 1, "flash_attn_fwd_bf16_short<10, 16>"),
    (torch.bfloat16, 160, 77, "flash_attn_fwd_bf16_short<10, 80>"),
    (torch.bfloat16, 160, SHORT_KEYS + 1,
     "flash_attn_fwd_bf16_wgmma<10, 2>"),
    (torch.bfloat16, 24, 64, "flash_attn_fwd_bf16_short<2, 80>"),
    (torch.float32, 40, 77, "flash_attn_fwd_f32<48>")]


@pytest.mark.parametrize("dtype,d,kv_len,name", [
    pytest.param(dtype, d, None, name, id=f"dtype{i}-{d}-{name}")
    for i, (dtype, d, name) in enumerate(FWD_TABLE)] + [
    pytest.param(dtype, d, kv, name, id=f"{dtype}-{d}-kv{kv}-{name}")
    for dtype, d, kv, name in FWD_KV_TABLE])
def test_fwd_instantiation_follows_the_source_table(dtype, d, kv_len, name):
    """`fwd_instantiation` names the kernel `flash_attn_fwd.cu` dispatches
    to: its template, and the instantiation in the source's table (at
    KSTEPS 3 its warpgroups by name, `kNarrowWarpgroups`; onto a short key
    set the table's cut and the tile of keys by name)."""
    assert fwd_instantiation(dtype, d, kv_len=kv_len) == name
    src = (_build.CSRC / "flash_attn_fwd.cu").read_text()
    assert f"\n{name.split('<')[0]}(" in src, name
    template, args = name[:-1].split("<")
    if "short" in template:
        steps, keys = args.split(", ")
        assert (f"constexpr int kShortKeys = {SHORT_KEYS}, kShortFewKeys = "
                f"{SHORT_FEW_KEYS};") in src
        assert "    if (kv_len <= kShortKeys) {   // every key in one tile" in src
        assert f"return (int)launch_short_keys<{steps}>(" in src, name
        tile = "kShortFewKeys" if int(keys) == SHORT_FEW_KEYS else "kShortKeys"
        assert f"launch_short<KSTEPS, {tile}>(" in src
        return
    call = ("launch_wgmma" if "wgmma" in template else "launch_f32")
    if args == "3, 2":
        assert "constexpr int kNarrowWarpgroups = 2;" in src
        args = "3, kNarrowWarpgroups"
    assert f"{call}<{args}>(" in src, name


# the bf16 forward's short-key kernel (kv_len <= SHORT_KEYS, every key in
# one tile of 16 or 80) and its edges: kv_len at the cut and one past it
# (the streaming kernel), onto one key, 16, 17 and 77, a ragged Nq (past a
# 64-row tile, and under one), keys past kv_len, d = 40 / 80 / 160, and a
# negative scale: (b, h, n_q, n_k, kv_len, d, sm_scale)
SHORT_KEY_CASES = [
    (1, 2, 100, SHORT_KEYS, None, 40, None),
    (1, 2, 100, SHORT_KEYS + 1, None, 40, None),
    (2, 1, 70, 77, None, 80, None),
    (1, 1, 65, 96, SHORT_KEYS, 160, None),
    (1, 1, 65, 96, SHORT_KEYS + 1, 160, None),
    (1, 2, 130, 1, None, 80, None),
    (1, 2, 200, SHORT_FEW_KEYS, None, 160, None),
    (1, 1, 17, SHORT_FEW_KEYS + 1, None, 40, None),
    (1, 1, 33, 77, 70, 40, -0.2)]


@pytest.mark.parametrize("b,h,nq,nk,kv_len,d,scale", SHORT_KEY_CASES)
def test_mha_matches_jax_reference_at_the_short_key_cut(b, h, nq, nk, kv_len,
                                                        d, scale):
    """The port's plain version against the JAX reference on
    SHORT_KEY_CASES, output and LSE."""
    q, k, v = _qkv(b, h, nq, nk, d=d, seed=10)
    ref = np.asarray(jax_mha_reference(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), kv_len=kv_len,
                                       sm_scale=scale))
    ours, lse = mha(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), kv_len=kv_len, sm_scale=scale,
                    return_lse=True)
    assert ours.shape == (b, h, nq, d)
    assert np.abs(ours.numpy() - ref).max() <= TOL
    sc = d ** -0.5 if scale is None else scale
    s = np.einsum("bhqd,bhkd->bhqk", q * sc, k)[..., :kv_len or nk]
    ref_lse = np.asarray(jax.scipy.special.logsumexp(jnp.asarray(s), axis=-1))
    assert np.abs(lse.numpy() - ref_lse).max() <= TOL


@pytest.mark.parametrize("b,h,nq,nk,kv_len,d,scale",
                         [SHORT_KEY_CASES[i] for i in (0, 1, 5, 8)])
def test_mha_matches_jax_pallas_interpret_at_the_short_key_cut(
        b, h, nq, nk, kv_len, d, scale):
    q, k, v = _qkv(b, h, nq, nk, d=d, seed=11)
    ref = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             interpret=True, kv_len=kv_len, sm_scale=scale))
    ours = mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
               kv_len=kv_len, sm_scale=scale).numpy()
    assert np.abs(ours - ref).max() <= TOL


def test_backward_kernels_keep_head_dim_64():
    """The backward wrappers take head dim 64 and, like the forward, the
    UNet's 40, 80 and 160: no rule of their own."""
    stat = _OnCard((1, 2, 8), torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 40, 80, 160):
            q = _OnCard((1, 2, 8, d), dtype)
            _check_bwd(q, q, q, q, stat, stat, 8)


def test_one_key_gives_v_broadcast():
    # P = 1 on the only key: every query row's output is that key's value
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 3, 50, 1, d=40, seed=9))
    out = mha(q, k, v)
    torch.testing.assert_close(out, v.expand_as(out), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_size_one_dims_take_a_valid_stride(dtype):
    """k, v of a one-token context: the token dimension's stride is never
    read, so whatever torch gave it, the kernels get an aligned one; the
    other strides are checked as they are."""
    from amodal_depth_anything_tpu_torch.ops.flash_attention import (
        _vector_ready, kernel_strides)
    base = torch.zeros(2 * 8 * 40 + 64, dtype=dtype)
    k = base.as_strided((2, 8, 1, 40), (320, 40, 3, 1))   # odd stride, size 1
    assert kernel_strides(k) == (320, 40, 640)
    assert _vector_ready(k)
    one = base.as_strided((1, 1, 1, 40), (7, 5, 3, 1))
    assert kernel_strides(one) == (40, 40, 40) and _vector_ready(one)
    bad = base.as_strided((2, 8, 2, 40), (320, 41, 40, 1))  # a real stride
    assert not _vector_ready(bad)
