"""The port's bf16 and int8 gated GEMMs at tiles that are not multiples of
64 (16·odd, 32·odd) against the JAX reference, on the CPU.

On the card these tiles (from 48) run the `wgmma` kernels of
csrc/spamm_wgmma.cu (one 64-row band of a tile's rows a block, T % 64
live in the last, ⌈T/64⌉ K-chunks a step), held against the plain
versions (int8 bit for bit, bf16 within 1e-4) by
tests/test_torch_cuda.py. Here the plain versions, on the planner's own
T-level tables, are held against the reference at tiles 48 (3·16) and
96 (3·32), block_n 1 and 2, on small decay operands: int8
against its Pallas kernel in interpret mode, bf16 against its `jnp`
backend (its interpret path is an ulp off its own unfused result on this
jax, ROADMAP queue C). Both packages plan on the reference's normmaps at
one τ, so every structural table is exact; frozen ≡ eager bit for bit.

Tolerances, relative to the output's largest magnitude (as in
tests/test_torch_large_tiles.py): int8 1e-6 (XLA:CPU contracts `acc +
prod·b_scale` into one FMA where the port rounds twice); bf16 1e-5 against
the reference's bf16 product (products exact in f32, sums in another
order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as rplan
from repro.kernels import ops as rops
from repro.kernels import quantize as rquant
from repro.kernels import spamm_mm as rmm
from repro_torch.core import plan as tplan
from repro_torch.kernels import quantize as tquant
from repro_torch.kernels import spamm_mm as tmm
from repro_torch.plans.frozen import FrozenWeight

INT8_RTOL = 1e-6
BF16_REF_RTOL = 1e-5

# (tile, block_n, (m, k, n)): 2 × 3 × 2 tile products
CASES = [(48, 1, (96, 144, 96)), (48, 2, (96, 144, 192)),
         (96, 1, (192, 288, 192)), (96, 2, (192, 288, 384))]


def _decay(m, n, seed, scale=0.4):
    """|i−j|^-½ decay times Gaussian noise."""
    rng = np.random.default_rng(seed)
    d = np.abs(np.arange(m)[:, None] - np.arange(n)[None, :])
    base = (scale / (d ** 0.5 + 1)).astype(np.float32)
    return base * rng.standard_normal((m, n)).astype(np.float32)


def _ref_norms(x, tile, dtype):
    if dtype == "int8":
        return rops.int8_norms_and_scales(jnp.asarray(x), tile,
                                          backend="jnp")[0]
    return rops.tile_norms(rquant.quantized_view(jnp.asarray(x), dtype, tile),
                           tile, backend="jnp")


def _plans(a, b, tile, block_n, dtype, backend):
    """The reference's and the port's plans on the reference's `dtype`
    normmaps at the τ whose widened gate sits at the median norm product;
    asserts the structural tables equal. Returns (reference plan, port
    plan, τ)."""
    rna, rnb = (_ref_norms(x, tile, dtype) for x in (a, b))
    prods = np.asarray(rna)[:, None, :] * np.asarray(rnb).T[None]
    eps = rquant.gate_eps(dtype, tile)
    tau = float(np.median(prods)) / (1.0 - eps) ** 2
    rp = rplan.plan(None, None, tau, norm_a=rna, norm_b=rnb, tile=tile,
                    block_n=block_n, backend=backend, compute_dtype=dtype)
    p = tplan.plan(None, None, tau, norm_a=torch.as_tensor(np.array(rna)),
                   norm_b=torch.as_tensor(np.array(rnb)), tile=tile,
                   block_n=block_n, backend="torch", compute_dtype=dtype)
    assert 0 < int(p.valid_tiles) == int(rp.valid_tiles) < p.total_tiles
    np.testing.assert_array_equal(p.mask.numpy(), np.asarray(rp.mask))
    for name in ("step_i", "step_j", "step_k", "step_flags"):
        np.testing.assert_array_equal(getattr(p.work, name).numpy(),
                                      np.asarray(getattr(rp.work, name)),
                                      err_msg=name)
    return rp, p, tau


def _tables(w):
    return (w.step_i, w.step_j, w.step_k, w.step_flags, w.runs)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _frozen_equals_eager(p, ta, tb, tau, tile, block_n, dtype):
    fw = FrozenWeight.build(tb, tau, tile=tile, block_n=block_n,
                            backend="torch", compute_dtype=dtype)
    frozen = tplan.plan(ta, frozen_weight=fw.for_rows(ta.shape[0] // tile))
    assert torch.equal(tplan.execute(frozen, ta, tb),
                       tplan.execute(p, ta, tb))


@pytest.mark.parametrize("tile,block_n,shape", CASES)
def test_int8_worklist_matches_reference_at_odd_tiles(tile, block_n, shape):
    """int8: the same codes and T-level scales in both packages (exact);
    the port's plain int8 work-list against the reference's Pallas int8
    kernel in interpret mode on the shared tables; execute ≡ the plain
    call; frozen ≡ eager."""
    m, k, n = shape
    a, b = _decay(m, k, 11), _decay(k, n, 12)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    aq, a_s = tquant.quantize_tiles(ta, tile)
    bq, b_s = tquant.quantize_tiles(tb, tile)
    raq, ras = rquant.quantize_tiles(jnp.asarray(a), tile)
    rbq, rbs = rquant.quantize_tiles(jnp.asarray(b), tile)
    for mine, theirs in ((aq, raq), (a_s, ras), (bq, rbq), (b_s, rbs)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    _, p, tau = _plans(a, b, tile, block_n, "int8", "interpret")
    got = tmm.spamm_mm_worklist_int8_plain(aq, bq, a_s, b_s,
                                           *_tables(p.work), tile=tile,
                                           block_n=block_n)
    want = rmm.spamm_mm_worklist_int8(
        raq, rbq, ras, rbs,
        *(jnp.asarray(t.numpy()) for t in _tables(p.work)[:4]),
        tile=tile, block_n=block_n, interpret=True)
    assert float(got.abs().max()) > 0.0
    assert _rel(got, want) <= INT8_RTOL
    assert torch.equal(tplan.execute(p, ta, tb), got)
    _frozen_equals_eager(p, ta, tb, tau, tile, block_n, "int8")


@pytest.mark.parametrize("tile,block_n,shape", CASES)
def test_bf16_worklist_matches_reference_at_odd_tiles(tile, block_n, shape):
    """bf16: the port's plan executed (the plain bf16 work-list) against
    the reference's bf16 product (its jnp backend); the plain bf16
    work-list ≡ its f32 run on the bf16-rounded operands; frozen ≡
    eager."""
    m, k, n = shape
    a, b = _decay(m, k, 13), _decay(k, n, 14)
    rp, p, tau = _plans(a, b, tile, block_n, "bfloat16", "interpret")
    rj = rplan.plan(None, None, tau, norm_a=_ref_norms(a, tile, "bfloat16"),
                    norm_b=_ref_norms(b, tile, "bfloat16"), tile=tile,
                    block_n=block_n, backend="jnp", compute_dtype="bfloat16")
    np.testing.assert_array_equal(np.asarray(rj.mask), np.asarray(rp.mask))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    got = tplan.execute(p, ta, tb)
    want = np.asarray(rplan.execute(rj, jnp.asarray(a), jnp.asarray(b)))
    assert float(got.abs().max()) > 0.0
    assert _rel(got, want) <= BF16_REF_RTOL
    assert torch.equal(got, tmm.spamm_mm_worklist_plain(
        ta.bfloat16().float(), tb.bfloat16().float(), *_tables(p.work),
        tile=tile, block_n=block_n))
    _frozen_equals_eager(p, ta, tb, tau, tile, block_n, "bfloat16")
