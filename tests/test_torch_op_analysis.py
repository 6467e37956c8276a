"""The dry run's measurement instrument (`repro_torch.launch.op_analysis`)
against the reference's HLO walker (`repro.launch.hlo_analysis`): the ring
model, the sharded-scan twin of `tests/test_hlo_analysis.py`, and the
counting hook of the hand-written kernels' registry entries (exact)."""
import json

import pytest
import torch

from conftest import run_subprocess

GROUPS = (1, 2, 4, 16)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("op", KINDS)
def test_ring_model_equals_reference(op, g):
    from repro.launch.hlo_analysis import _wire_bytes as ref
    from repro_torch.launch.op_analysis import COLLECTIVES, _wire_bytes

    assert COLLECTIVES == KINDS
    for in_b, out_b in ((4096, 4096 * g), (1000, 250), (0, 0)):
        assert _wire_bytes(op, in_b, out_b, g) == ref(op, in_b, out_b, g)


REF_SCAN = r"""
import json
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.launch.hlo_analysis import HloAnalysis
from repro.launch.mesh import make_mesh

mesh = make_mesh((4, 2), ("data", "model"))

def scanned(x, ws):
    def body(c, w):
        return jnp.tanh(c @ w), None
    y, _ = jax.lax.scan(body, x, ws)
    return jnp.sum(y)

x = jax.ShapeDtypeStruct((256, 512), jnp.bfloat16)
ws = jax.ShapeDtypeStruct((7, 512, 512), jnp.bfloat16)
with mesh:
    comp = jax.jit(
        scanned,
        in_shardings=(NamedSharding(mesh, P("data", None)),
                      NamedSharding(mesh, P(None, "data", "model"))),
    ).lower(x, ws).compile()
print("JSON" + json.dumps(HloAnalysis(comp.as_text(), 8).totals()))
"""


def test_sharded_scan_twin_equals_reference():
    """Rank 0 of a fake 4×2 world runs the reference test's scan with its
    gathers written out: each of the 7 steps all-gathers its weight slice
    over "data" and the carry over "model", then the sum is all-reduced
    over both axes. XLA's CPU backend gathers both in f32 (it legalizes
    the bf16 dot through f32), so the twin's tensors are f32."""
    import torch.distributed as dist

    from repro_torch.core.distributed import _all_gather
    from repro_torch.launch.mesh import fake_world
    from repro_torch.launch.op_analysis import OpAnalysis

    ref = json.loads(run_subprocess(REF_SCAN, devices=8).split("JSON", 1)[1])
    with fake_world(8, shape=(4, 2), axis_names=("data", "model"),
                    device_type="cpu") as mesh:
        gd, gm = mesh.get_group(0), mesh.get_group(1)
        x = torch.randn(64, 512)
        ws = torch.randn(7, 128, 256)
        with OpAnalysis(mesh) as an:
            c = x
            for i in range(7):
                w = _all_gather(ws[i], gd)               # (512, 256)
                y = torch.tanh(c @ w)                    # (64, 256)
                c = _all_gather(y.t(), gm).t()           # (64, 512)
            s = c.sum()
            dist.all_reduce(s, group=gm)
            dist.all_reduce(s, group=gd)
    t = an.totals()
    assert t["flops_per_device"] == 7 * 2 * 64 * 512 * 256 == \
        ref["flops_per_device"]
    got, want = t["collectives"]["all-gather"], ref["collectives"]["all-gather"]
    assert got["count"] == want["count"] == 14
    assert got["wire_bytes"] == want["wire_bytes"]
    assert got["in_bytes"] == want["in_bytes"]
    assert "all-reduce" in t["collectives"]
    assert not t["warnings"]
    assert an.wire_bytes_by_axis().keys() == {"data", "model"}


def _decay(n, seed):
    from repro_torch.core.spamm import algebraic_decay

    return torch.as_tensor(algebraic_decay(n, seed=seed))


@pytest.mark.parametrize("dtype,block_n", [("float32", 1), ("float32", 2),
                                           ("bfloat16", 1), ("int8", 1),
                                           ("int8", 2)])
def test_kernel_hook_counts_worklist_tile_products(dtype, block_n):
    from repro_torch.core import plan as P
    from repro_torch.kernels import ops
    from repro_torch.launch.op_analysis import OpAnalysis

    tile = 16
    a, b = _decay(128, 0), _decay(128, 1)
    p = P.plan(a, b, 0.5, tile=tile, block_n=block_n, backend="torch",
               compute_dtype=dtype)
    want = P.execute(p, a, b)
    with OpAnalysis() as an:
        got = P.execute(p, a, b)
    assert ops.analysis is None
    assert torch.equal(got, want)
    name = {"float32": "spamm_mm_worklist", "bfloat16":
            "spamm_mm_worklist_bf16", "int8": "spamm_mm_worklist_int8"}[dtype]
    k = an.totals()["kernels"][name]
    steps = int(p.valid_tiles)
    assert 0 < steps < p.total_tiles
    assert k["launches"] == 1 and k["tile_products"] == steps
    assert k["flops"] == steps * 2.0 * tile ** 3 * block_n
    assert k["dense_flops"] == 2.0 * 128 ** 3
    # the plain version's own ops are not recorded (the int8 quantization
    # adds bytes, no FLOPs)
    assert an.flops == k["flops"]


def test_kernel_hook_counts_dense_grid_and_get_norm():
    from repro_torch.core import plan as P
    from repro_torch.kernels import ops
    from repro_torch.launch.op_analysis import OpAnalysis

    tile = 16
    a, b = _decay(64, 2), _decay(64, 3)
    bk = ops.get_backend("torch")
    with OpAnalysis() as an:
        na, nb = bk.norms(a, tile), bk.norms(b, tile)
        pool = bk.pool_norms(na)
        mask = P.gate_mask(na, nb, 0.4)
        kidx, nvalid = ops.spamm_compact(mask)
        bk.matmul(a, b, mask, kidx, nvalid, tile, 1, torch.float32)
    k = an.totals()["kernels"]
    assert k["tile_norms"]["launches"] == 2
    assert k["tile_norms"]["flops"] == 2.0 * (a.numel() + b.numel())
    assert k["pool_norms"]["bytes"] == (na.numel() + pool.numel()) * 4
    assert k["spamm_mm"]["tile_products"] == int(nvalid.sum()) == \
        int(mask.sum())
    assert k["spamm_mm"]["dense_flops"] == 2.0 * 64 ** 3


def test_views_count_nothing_and_copies_are_staging():
    from repro_torch.launch.op_analysis import OpAnalysis

    x, y = torch.randn(32, 64), torch.randn(32, 64)
    nb = x.numel() * 4
    with OpAnalysis() as an:
        x.view(64, 32), x.t(), x[0], x.reshape(-1)
        e = torch.empty(8)
    assert an.bytes_hbm == 0 and e.numel() == 8
    with OpAnalysis() as an:
        x.clone()
    assert an.bytes_hbm == an.bytes_staging == 2 * nb
    with OpAnalysis() as an:
        x + y
    assert an.bytes_hbm == 3 * nb and an.bytes_staging == 0


def test_flops_of_einsum_conv_and_sdpa():
    import torch.nn.functional as F

    from repro_torch.launch.op_analysis import OpAnalysis

    q = torch.randn(2, 3, 16, 8)
    with OpAnalysis() as an:
        torch.einsum("bhqd,bhkd->bhqk", q, q)
    assert an.flops == 2 * 2 * 3 * 16 * 16 * 8
    x, w = torch.randn(2, 4, 32), torch.randn(6, 4, 3)
    with OpAnalysis() as an:
        out = F.conv1d(x, w)
    assert an.flops == 2 * out.numel() * 4 * 3
    with OpAnalysis() as an:
        F.scaled_dot_product_attention(q, q, q)
    assert an.flops == 4 * 2 * 3 * 16 * 16 * 8


def test_flops_are_recorded_by_operand_dtype():
    from repro_torch.core import plan as P
    from repro_torch.launch.op_analysis import OpAnalysis

    x = torch.randn(16, 32)
    tile = 16
    a, b = _decay(64, 6), _decay(64, 7)
    p = P.plan(a, b, 0.3, tile=tile, backend="torch",
               compute_dtype="bfloat16")
    with OpAnalysis() as an:
        x @ x.T
        x.bfloat16() @ x.T.bfloat16()
        P.execute(p, a, b)
    t = an.totals()
    mm = 2.0 * 16 * 32 * 16
    products = t["kernels"]["spamm_mm_worklist_bf16"]["flops"]
    assert products > 0
    assert t["flops_by_dtype"] == {"float32": mm, "bfloat16": mm + products}
    assert sum(t["flops_by_dtype"].values()) == t["flops_per_device"]


def test_analysis_raises_inside_a_graph_capture(monkeypatch):
    from repro_torch.kernels import ops
    from repro_torch.launch.op_analysis import OpAnalysis

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="graph capture"):
        with OpAnalysis():
            pass
    assert ops.analysis is None


def test_no_open_analysis_leaves_the_entries_alone(monkeypatch):
    """With no analysis open a registry entry calls its kernel and nothing
    else: no step count is read (the device is not touched)."""
    from repro_torch.core import plan as P
    from repro_torch.kernels import ops

    a, b = _decay(64, 4), _decay(64, 5)
    p = P.plan(a, b, 0.3, tile=16, backend="torch")

    def boom(flags):
        raise AssertionError("step count read with no analysis open")

    monkeypatch.setattr(ops, "_acc_steps", boom)
    assert ops.analysis is None
    P.execute(p, a, b)
