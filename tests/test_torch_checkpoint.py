"""The port's checkpoints (twin of the checkpoint half of
tests/test_checkpoint_serving.py): round trip with garbage collection and a
bf16 leaf, asynchronous save, temporary directories never taken for a
step, the plan-store pointer, and the layout against the reference's — a
checkpoint either package writes, the other restores."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as rck
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.plans.frozen import PLAN_FORMAT_VERSION
from repro_torch.plans.store import PlanStore


def _state():
    return {"params": {"a": torch.arange(12.0).reshape(3, 4),
                       "nested": {"b": torch.full((2, 2), 1.5,
                                                  dtype=torch.bfloat16)},
                       "layers": [{"w": torch.ones(2)},
                                  {"w": torch.zeros(3)}]},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_roundtrip_and_gc(tmp_path):
    d = str(tmp_path)
    state = _state()
    for s in [10, 20, 30, 40]:
        ck.save(d, s, state, keep=2)
    assert ck.all_steps(d) == [30, 40]
    assert ck.latest_step(d) == 40
    out = ck.restore(d, 40, state, device="cpu")
    assert torch.equal(out["params"]["a"], state["params"]["a"])
    b = out["params"]["nested"]["b"]
    assert b.dtype == torch.bfloat16 and torch.equal(
        b, state["params"]["nested"]["b"])
    assert [t["w"].shape for t in out["params"]["layers"]] == [(2,), (3,)]
    assert out["step"].dtype == torch.int32 and int(out["step"]) == 7
    with open(os.path.join(d, "step_40", "meta.json")) as f:
        meta = json.load(f)
    assert meta["step"] == 40 and "params/layers/1/w" in meta["keys"]
    with pytest.raises(KeyError):
        ck.restore(d, 40, {"params": {"missing": torch.ones(1)}})


def test_async_save(tmp_path):
    d = str(tmp_path)
    x = torch.ones(3)
    t = ck.save(d, 5, {"x": x}, async_=True)
    x.add_(1.0)  # the save took its host copy before returning
    t.join(timeout=60)
    assert not t.is_alive()
    assert ck.latest_step(d) == 5
    assert torch.equal(ck.restore(d, 5, {"x": x})["x"], torch.ones(3))


def test_tmp_dirs_never_visible(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, ".tmp_step_99"))  # a crashed save's leftover
    ck.save(d, 1, {"x": torch.ones(2)})
    assert ck.all_steps(d) == [1]
    assert ck.latest_step(str(tmp_path / "none")) is None


def test_plan_store_pointer(tmp_path):
    d = str(tmp_path / "ck")
    store_dir = str(tmp_path / "store")
    ck.save(d, 1, {"x": torch.ones(2)})
    assert ck.plan_store_pointer(d, 1) is None
    assert ck.open_plan_store(d, 1) is None
    ck.save(d, 2, {"x": torch.ones(2)}, plan_store=store_dir)
    ptr = ck.plan_store_pointer(d, 2)
    assert ptr == {"path": os.path.abspath(store_dir),
                   "format_version": PLAN_FORMAT_VERSION}
    store = PlanStore(store_dir)
    ck.save(d, 3, {"x": torch.ones(2)}, plan_store=store)
    assert ck.plan_store_pointer(d, 3) == store.manifest_pointer()
    assert ck.open_plan_store(d, 3).root == store.root
    meta_path = os.path.join(d, "step_3", "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["plan_store"]["format_version"] = PLAN_FORMAT_VERSION + 1
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="format version"):
        ck.plan_store_pointer(d, 3)


def test_checkpoints_cross_read_with_reference(tmp_path):
    """Same layout and key names: the reference restores what the port
    saved (bf16 as uint16 bit patterns included), and the port what the
    reference saved."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal((2, 5)).astype(np.float32)
    port_state = {"params": {"a": torch.tensor(a),
                             "b": torch.tensor(b).to(torch.bfloat16)}}
    ref_state = {"params": {"a": jnp.asarray(a),
                            "b": jnp.asarray(b, jnp.bfloat16)}}
    ck.save(str(tmp_path / "p"), 3, port_state)
    got = rck.restore(str(tmp_path / "p"), 3, jax.eval_shape(
        lambda: ref_state))
    np.testing.assert_array_equal(np.asarray(got["params"]["a"]), a)
    np.testing.assert_array_equal(
        np.asarray(got["params"]["b"]).astype(np.float32),
        port_state["params"]["b"].float().numpy())
    rck.save(str(tmp_path / "r"), 4, ref_state)
    back = ck.restore(str(tmp_path / "r"), 4, port_state, device="cpu")
    assert torch.equal(back["params"]["a"], port_state["params"]["a"])
    assert torch.equal(back["params"]["b"], port_state["params"]["b"])
