"""The trainer's single-device memory knobs against the JAX package:
"adam-bf16mu" and "adafactor" (`train/state.py`) against the JAX
`make_optimizer` (optax, jitted as the JAX train step runs it) on a tree
with a factored dense kernel, a conv, a stacked leaf, a vector and a
scalar, under clipping and gradient accumulation; `head_tile` (the DPT head
over batch chunks, each recomputed in the backward) in a vitt train step
against the JAX trainer's loss and the port's untiled step; and the
adafactor step's static-buffer program and resume, bit for bit.

Tolerances: parameters 1e-5 after five updates; the stored bfloat16 first
moment code for code; the tiled step's loss and gradients 1e-4 of each
leaf's max abs against JAX, 1e-6 against the untiled port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.models import get_model as jax_get_model
from amodal_depth_anything_tpu.train.state import \
    make_optimizer as jax_make_optimizer
from amodal_depth_anything_tpu_torch.convert.weights import params_to_jax
from amodal_depth_anything_tpu_torch.models import get_model
from amodal_depth_anything_tpu_torch.models.amodal_dav2 import init_weights_
from amodal_depth_anything_tpu_torch.train import DiscriminativeTrainer
from amodal_depth_anything_tpu_torch.train.state import (Adafactor,
                                                         make_optimizer)
from tests.test_torch_models import few_torch_threads  # noqa: F401
from tests.test_torch_trainer import (_batches, _cfg, _jax_loss_and_grads,
                                      _leaves, sam_tree)

__all__ = ["sam_tree"]

STEPS = 10          # micro-steps: five updates under accumulation 2

# JAX leaf -> (port tensors, dimension order port -> JAX, stacked)
TREE = {"dense": ((384, 256), (1, 0)),          # JAX [in, out], port [out, in]
        "conv": ((3, 3, 128, 256), (2, 3, 1, 0)),  # HWIO <- OIHW
        "stack": ((2, 256, 160), (1, 0)),       # two blocks of [160, 256]
        "vec": ((64,), None),
        "scalar": ((), None)}


def _port_tensors(name, leaf):
    shape, dims = TREE[name]
    inv = None if dims is None else tuple(int(i) for i in np.argsort(dims))
    blocks = list(leaf) if name == "stack" else [leaf]
    out = []
    for b in blocks:
        t = torch.from_numpy(np.array(b))
        out.append((t.permute(*inv) if inv else t).contiguous())
    return out, [(dims, name if name == "stack" else None)] * len(out)


def _to_jax_leaf(name, tensors):
    _, dims = TREE[name]
    arrs = [(t.permute(*dims) if dims else t).numpy() for t in tensors]
    return np.stack(arrs) if name == "stack" else arrs[0]


def _inputs(seed=0):
    """Parameters, and gradients that are small integers times a power of
    two: every sum of squares is then exact in float32 in any order, so
    the clip's global norm is the same float on both sides (the stored
    bfloat16 moment can be held code for code). The norm is far above the
    clip's 0.01 except at steps 2 and 3, where it stays below."""
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(shape).astype(np.float32)
              for k, (shape, _) in TREE.items()}
    grads = [{k: (rng.integers(-8, 9, shape) *
                  (2.0 ** -24 if i in (2, 3) else 2.0 ** -3))
              .astype(np.float32) for k, (shape, _) in TREE.items()}
             for i in range(STEPS)]
    return params, grads


@pytest.mark.parametrize("name", ["adam-bf16mu", "adafactor"])
def test_optimizer_matches_jitted_optax(name):
    kw = dict(lr=1e-2, total_iter=50, final_ratio=0.01, warmup_steps=2,
              max_grad_norm=0.01, accumulation_steps=2, optimizer=name)
    p0, grads = _inputs()
    jtx = jax_make_optimizer(**kw)
    jparams = jax.tree.map(jnp.asarray, p0)
    jstate = jtx.init(jparams)

    @jax.jit
    def jstep(g, s, p):
        updates, s = jtx.update(g, s, p)
        return jax.tree.map(lambda a, u: a + u, p, updates), s

    names, tparams, layout = [], [], []
    for k in TREE:
        ts, lay = _port_tensors(k, p0[k])
        names += [k] * len(ts)
        tparams += ts
        layout += lay
    ttx = make_optimizer(**kw, layout=layout)
    assert isinstance(ttx, Adafactor) == (name == "adafactor")
    tstate = ttx.init(tparams)
    for g in grads:
        jparams, jstate = jstep(jax.tree.map(jnp.asarray, g), jstate,
                                jparams)
        tg = []
        for k in TREE:
            tg += _port_tensors(k, g[k])[0]
        ttx.update(tparams, tg, tstate)
    assert tstate["count"] == STEPS // 2
    moved = 0.0
    for k in TREE:
        ours = _to_jax_leaf(k, [t for n, t in zip(names, tparams) if n == k])
        ref = np.asarray(jparams[k])
        assert np.abs(ours - ref).max() <= 1e-5, k
        moved = max(moved, np.abs(ref - p0[k]).max())
    assert moved > 1e-3
    inner = jstate.inner_opt_state[1]
    if name == "adam-bf16mu":
        for k in TREE:
            mine = [m for n, m in zip(names, tstate["mu"]) if n == k]
            assert all(m.dtype == torch.bfloat16 for m in mine)
            ours = _to_jax_leaf(k, [m.view(torch.int16) for m in mine])
            ref = np.asarray(inner[0].mu[k]).view(np.int16)
            assert np.array_equal(ours, ref), k
    else:
        # the factored leaves: the same axes, the same moments
        plan = ttx.plan(tparams)[0]
        for k in ("dense", "conv", "stack"):
            idx = [i for i, n in enumerate(names) if n == k]
            fd = plan[idx[0]][0]
            assert fd is not None, k
            assert tuple(np.asarray(inner[0].v_row[k]).shape)[-1] == \
                tstate["v_row"][idx[0]].shape[-1] or k != "dense"
        for k in ("vec", "scalar"):
            idx = names.index(k)
            assert plan[idx][0] is None
            np.testing.assert_allclose(tstate["v"][idx].numpy(),
                                       np.asarray(inner[0].v[k]),
                                       rtol=1e-5)


def test_head_tile_step_matches_jax_and_the_untiled_step(sam_tree):
    """One vitt step with the head over chunks of one row: loss and every
    gradient leaf against the JAX model with `head_batch_tile=1`, and
    against the port's untiled step."""
    batch = _batches(sam_tree, 1)[0]
    jmodel = jax_get_model("AmodalDAv2", encoder="vitt")
    model = get_model("AmodalDAv2", encoder="vitt", device="cpu")
    # the port's seeded init with seeded noise on every leaf (biases, layer
    # scales and the guidance embed then carry gradients), handed to JAX:
    # the JAX init's compile would cost more than the step compared
    init_weights_(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    sd = {k: v + torch.from_numpy(
              0.05 * rng.standard_normal(v.shape).astype(np.float32))
          if v.is_floating_point() else v
          for k, v in model.state_dict().items()}
    jparams = params_to_jax(sd, model.cfg)
    tiled = DiscriminativeTrainer(_cfg(head_tile=1), model, None,
                                  device="cpu", params=sd)
    untiled = DiscriminativeTrainer(
        _cfg(), get_model("AmodalDAv2", encoder="vitt", device="cpu"), None,
        device="cpu", params=sd)
    loss, grads = tiled.loss_and_grads(tiled._device_batch(batch))
    loss0, grads0 = untiled.loss_and_grads(untiled._device_batch(batch))
    assert abs(float(loss) - float(loss0)) <= 1e-6
    for k, g in grads.items():
        assert (g - grads0[k]).abs().max() <= \
            1e-6 * max(1.0, grads0[k].abs().max()), k

    import amodal_depth_anything_tpu.train.trainer as jtrainer_mod

    jcfg = jtrainer_mod.TrainerConfig(loss_strategy="entire_target_object")
    tiled_jmodel = dataclasses.replace(
        jmodel, apply=lambda *a, **k: jmodel.apply(*a, head_batch_tile=1,
                                                   **k))
    ref_loss, ref_grads = jax.jit(lambda p: _jax_loss_and_grads(
        tiled_jmodel, jcfg, p, batch))(jparams)
    assert abs(float(loss) - float(ref_loss)) <= 1e-5
    ours = dict(_leaves(params_to_jax(grads, model.cfg)))
    for name, r in _leaves(ref_grads):
        assert np.abs(ours[name] - r).max() <= 1e-4 * np.abs(r).max(), name


def test_jax_param_layout_factors_the_jax_trees_axes():
    """`jax_param_layout` on a vits AmodalDAv2 (widths past the 128 of
    min_dim_size_to_factor): each tensor, permuted by its dims, has its JAX
    leaf's shape (a block of a stacked leaf: the leaf's without the block
    axis, the stack's blocks grouped), and Adafactor factors the axes optax
    picks on the JAX leaf."""
    from optax._src.factorized import _factored_dims

    from amodal_depth_anything_tpu_torch.convert.weights import (
        _leaf_map, jax_param_layout)

    model = get_model("AmodalDAv2", encoder="vits", device="cpu")
    layout = jax_param_layout(model)
    tree = dict(_leaves(params_to_jax(model.state_dict(), model.cfg)))
    paths = {key: ("/".join(path), layer is not None)
             for key, path, _, layer in _leaf_map(model.cfg)}
    params = dict(model.named_parameters())
    tx = make_optimizer(lr=1e-3, total_iter=10, optimizer="adafactor",
                        layout=[layout[k] for k in params])
    stacks, factored = {}, 0
    for (name, p), (fd, group) in zip(params.items(),
                                      tx.plan(list(params.values()))[0]):
        dims, stack = layout[name]
        t = p.permute(*dims) if dims else p
        path, stacked = paths[name]
        jshape = tree[path].shape
        assert jshape[int(stacked):] == tuple(t.shape), name
        assert (stack is not None) == stacked, name
        offset = int(stacked)
        if stacked:
            stacks.setdefault(group, []).append(name)
        ref = _factored_dims(jshape, True, 128)
        if ref is None:
            assert fd is None, name
            continue
        factored += 1
        perm = dims or tuple(range(p.dim()))
        assert fd == (perm[ref[0] - offset], perm[ref[1] - offset]), name
    # every stacked leaf: one group holding all of its blocks
    assert stacks and all(
        len(names) == tree["/".join(layout[names[0]][1])].shape[0]
        for names in stacks.values())
    assert factored > 20


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(lr=1e-4, total_iter=10, optimizer="sgd")


def test_head_tile_needs_a_model_with_the_knob():
    from amodal_depth_anything_tpu_torch.train import InvisibleStitchTrainer
    model = get_model("InvisibleStitch", tiny=True, device="cpu")
    with pytest.raises(ValueError, match="head_tile"):
        InvisibleStitchTrainer(_cfg(head_tile=1), model, None, device="cpu")


@pytest.mark.parametrize("optimizer", ["adafactor", "adam-bf16mu"])
def test_static_step_and_resume_are_bitwise(sam_tree, optimizer, tmp_path):
    """The static-buffer program (what a CUDA graph records on the card)
    equals the eager step, and a resume from a checkpoint equals the
    unbroken run, bit for bit."""
    from tests.test_torch_captured_steps import _equal, _state

    batches = _batches(sam_tree, 2)

    def trainer(captured):
        return DiscriminativeTrainer(
            _cfg(optimizer=optimizer, lr=1e-3, lr_warmup_steps=1,
                 head_tile=1),
            get_model("AmodalDAv2", encoder="vitt", device="cpu"), None,
            device="cpu", seed=3, captured=captured)

    eager, static = trainer(False), trainer(True)
    losses = []
    for i, b in enumerate(batches):
        if i == 1:
            eager.out_dir_ckpt = str(tmp_path)
            eager.save_checkpoint("one")
        losses.append(float(eager._train_step(eager._device_batch(b))))
    assert [float(static._train_step(static._device_batch(b)))
            for b in batches] == losses
    assert _equal(_state(eager), _state(static))
    resumed = trainer(True)
    resumed.load_checkpoint(str(tmp_path / "one"))
    assert [float(resumed._train_step(resumed._device_batch(b)))
            for b in batches[1:]] == losses[1:]
    assert _equal(_state(resumed), _state(static))
