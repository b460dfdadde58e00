"""`scripts/int8_layer_walk.py` of the port against the JAX package's.

Both walks run on the same seeded, noisy vitt pair (written as a proxy
checkpoint directory) at 28 px over one held-out scene, on the CPU: the
gate must reject a candidate there, so the walk has a choice to make. The
candidates, their order of cost and the kept set (blocks per trunk, the
head) must agree. Deltas agree to about 2e-3, not to 1e-4: the trunks' W8A8
activation codes on random weights flip on rounding boundaries between the
two float paths (`tests/test_torch_quant.py`)."""

import json

import jax
import numpy as np
import pytest

from amodal_depth_anything_tpu.models.amodal_dav2 import (
    DAV2Config, init_amodal_dav2)
from amodal_depth_anything_tpu.scripts import int8_layer_walk as jwalk
from amodal_depth_anything_tpu.scripts.train_proxy import save_params_npz
from amodal_depth_anything_tpu_torch.scripts import int8_layer_walk as walk
from tests.test_torch_models import few_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("walk_ckpt")
    for i, (name, cfg) in enumerate((
            ("raw_base", DAV2Config(encoder="vitt", guide_type="none",
                                    raw=True)),
            ("amodal", DAV2Config(encoder="vitt",
                                  guide_type="mask+observation")))):
        rng = np.random.default_rng(i)
        params = jax.tree.map(
            lambda a: np.asarray(a, np.float32) + 0.5 * rng.standard_normal(
                np.shape(a)).astype(np.float32),
            init_amodal_dav2(jax.random.PRNGKey(i), cfg))
        save_params_npz(str(root / f"{name}.npz"), params, dtype=np.float32)
    (root / "meta.json").write_text(json.dumps({"encoder": "vitt",
                                                "steps": 0}))
    return root


def test_layer_walk_keeps_the_jax_walks_set(ckpt, tmp_path, capsys):
    argv = ["--ckpt", str(ckpt), "--size", "28", "--eval-n", "1",
            "--corpus-dir", str(tmp_path / "scenes")]
    base, amodal = walk.main(argv + ["--device", "cpu", "--json-out",
                                     str(tmp_path / "port.json")])
    jbase, jamodal = jwalk.main(argv[:6] + ["--json-out",
                                            str(tmp_path / "jax.json")])
    out = capsys.readouterr().out
    assert "## Greedy walk" in out and "int8 layer coverage" in out
    mine = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert sorted(mine) == sorted(ref)
    np.testing.assert_array_equal(base, jbase)
    np.testing.assert_array_equal(amodal, jamodal)
    assert mine["base_mask"] == ref["base_mask"]
    assert mine["amodal_mask"] == ref["amodal_mask"]
    assert mine["head_int8"] == ref["head_int8"]
    # a candidate was reverted: the gate bound the walk
    assert not all(s["kept"] for s in ref["walk"])
    assert sorted((s["candidate"], s["kept"]) for s in mine["walk"]) == \
        sorted((s["candidate"], s["kept"]) for s in ref["walk"])
    for m, r in zip(mine["sensitivity"], ref["sensitivity"]):
        assert (m["trunk"], m["layer"]) == (r["trunk"], r["layer"])
        assert abs(m["max_abs"] - r["max_abs"]) <= 5e-3
    assert mine["final"]["pass"] and ref["final"]["pass"]
    assert mine["final"]["coverage"] == ref["final"]["coverage"]
