"""The port's token merging (`ops/token_merge.py`, the trunks' ToMe and the
heads' batch tiling) against the JAX package's.

Same seeded numpy inputs, float32: `tome_merge` gives the JAX indices and
unmerge map exactly and merged tokens <= 1e-6 of their max abs, duplicate
tokens included (more duplicate pairs than merges tie at cosine 1 to within
an ulp: there the last bits choose, both merges are lossless, and the
differing map entries are reported); the vitt trunk with `token_merge` and the
tiny amodal pipeline with `base_token_merge` / `amodal_token_merge` /
`head_batch_tile` <= 1e-4 of the JAX output's max abs. ToMe-SD in the UNet
is held in tests/test_torch_depthfm.py and through the DepthFM pipeline in
tests/test_torch_depthfm_pipeline.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.models.dinov2 import \
    dinov2_intermediate_layers
from amodal_depth_anything_tpu.ops import token_merge as jtm
from amodal_depth_anything_tpu_torch.ops.token_merge import (tome_apply,
                                                             tome_merge,
                                                             tome_unmerge)
from tests.test_torch_models import _close, _inputs, _jax_cfg, _t
from tests.test_torch_models import few_torch_threads  # noqa: F401
from tests.test_torch_serving_ckpt import (AMODAL_CFG, RAW_CFG, SIZE,
                                           amodal_inputs, amodal_params,
                                           port_amodal)

OP_TOL = 1e-6


def _tokens(seed, b=2, n=33, d=16, dups=0):
    """Random tokens; with `dups`, that many even-position tokens copy
    their odd neighbour (cosine-1.0 pairs: the matches, and ties)."""
    x = np.random.default_rng(seed).standard_normal((b, n, d)).astype(
        np.float32)
    even = 2 * (1 + np.arange(dups))
    x[:, even] = x[:, even + 1]
    return x


@pytest.mark.parametrize("case", ["random", "duplicates", "dup-ties"])
def test_tome_merge_matches_jax(case, record_property):
    dups, r = {"random": (0, 7), "duplicates": (4, 4),
               "dup-ties": (6, 3)}[case]     # 6 duplicate pairs, 3 merges
    x = _tokens(3, dups=dups)
    ref_m, ref_idx = jax.jit(jtm.tome_merge, static_argnums=1)(
        jnp.asarray(x), r)
    merged, idx = tome_merge(_t(x), r)
    if case == "dup-ties":
        # six cosine-1.0 scores for three merges: each package computes
        # them to within an ulp of 1, and those last bits, not a rule,
        # choose which three merge. Both merges are lossless; the differing
        # map entries are counted and reported.
        differ = int((idx.numpy() != np.asarray(ref_idx)).sum())
        record_property("tie_broken_map_entries", differ)
        for m, i in ((merged, idx), (torch.from_numpy(np.asarray(ref_m)),
                                     torch.from_numpy(np.asarray(ref_idx)))):
            np.testing.assert_allclose(tome_unmerge(m, i.long()).numpy(), x,
                                       rtol=1e-6, atol=1e-6)
        return
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    ref_m = np.asarray(ref_m)
    assert merged.shape == ref_m.shape == (2, 33 - r, 16)
    assert np.abs(merged.numpy() - ref_m).max() <= OP_TOL * \
        np.abs(ref_m).max()
    if case == "duplicates":   # merging duplicates loses nothing
        np.testing.assert_allclose(tome_unmerge(merged, idx).numpy(), x,
                                   rtol=1e-6, atol=1e-6)
    assert int(idx[0, 0]) == 0         # cls keeps slot 0


def test_tome_unmerge_and_apply_match_jax():
    x = _tokens(4, n=40, dups=2)
    _, idx = tome_merge(_t(x), 9)
    y = _tokens(5, n=40)              # other tokens, same assignment
    ref = jtm.tome_apply(jnp.asarray(y), jnp.asarray(idx.numpy(),
                                                     jnp.int32), 31)
    ours = tome_apply(_t(y), idx, 31)
    assert np.abs(ours.numpy() - np.asarray(ref)).max() <= OP_TOL * \
        np.abs(np.asarray(ref)).max()
    np.testing.assert_array_equal(
        tome_unmerge(ours, idx).numpy(),
        np.asarray(jtm.tome_unmerge(jnp.asarray(ours.numpy()),
                                    jnp.asarray(idx.numpy(), jnp.int32))))


def test_tome_merge_checks_r():
    x = _t(_tokens(0, n=10))
    for r in (0, 5):
        with pytest.raises(ValueError, match="out of range"):
            tome_merge(x, r)


def test_trunk_token_merge_matches_jax():
    from amodal_depth_anything_tpu_torch.convert.weights import \
        params_from_jax
    from amodal_depth_anything_tpu_torch.models.dinov2 import \
        DinoVisionTransformer
    cfg = AMODAL_CFG
    params = amodal_params(seed=3)[1]
    trunk = DinoVisionTransformer(cfg.vit)
    prefix = "encoder.pretrained."
    trunk.load_state_dict({k[len(prefix):]: v for k, v in
                           params_from_jax(params, cfg).items()
                           if k.startswith(prefix)}, strict=True)
    x, m, o = _inputs(2, 56, 70, seed=4)
    guide = np.concatenate([m, o], -1)
    tm = (1, 9)                        # after block 1, 21 -> 12 tokens
    ref = jax.jit(functools.partial(
        dinov2_intermediate_layers, cfg=_jax_cfg(cfg).vit, taps=cfg.taps,
        attn_impl="xla", token_merge=tm))(
            jax.tree.map(jnp.asarray, params["backbone"]), x=jnp.asarray(x),
            guide=jnp.asarray(guide))
    with torch.no_grad():
        ours = trunk.get_intermediate_layers(_t(x), _t(guide), cfg.taps,
                                             attn_impl="plain",
                                             token_merge=tm)
        plain = trunk.get_intermediate_layers(_t(x), _t(guide), cfg.taps,
                                              attn_impl="plain")
    for (tok, cls), (rtok, rcls) in zip(ours, ref):
        _close(tok, rtok)
        _close(cls, rcls)
    # taps up to the merge are those of the unmerged forward, bit for bit
    for (a, _), (b, _) in zip(ours[:2], plain[:2]):
        assert torch.equal(a, b)
    assert not torch.equal(ours[3][0], plain[3][0])


def test_pipeline_token_merge_and_head_tile_match_jax():
    from tests.test_torch_serving_ckpt import jax_amodal
    params = amodal_params(seed=8)
    img, msk = amodal_inputs(batch=4, seed=9)
    knobs = dict(base_token_merge=(1, 4), amodal_token_merge=(0, 6),
                 head_batch_tile=2)
    jp = jax_amodal(params)
    for k, v in knobs.items():
        setattr(jp, k, v)
    ref = jp(img, msk)
    pipe = port_amodal(params)
    for k, v in knobs.items():
        setattr(pipe, k, v)
    ours = pipe(img, msk)
    for a, b in zip(ours, ref):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    # the head's batch tiling alone is exact
    plain = port_amodal(params)
    tiled = port_amodal(params)
    tiled.head_batch_tile = 2
    for a, b in zip(tiled(img, msk), plain(img, msk)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not divisible"):
        tiled.head_batch_tile = 3
        tiled(img, msk)
    assert SIZE == 56 and RAW_CFG.raw and not AMODAL_CFG.raw
