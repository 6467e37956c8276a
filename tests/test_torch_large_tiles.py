"""The port's gated GEMMs at the reference's large tiles (128, 256, 512)
against the JAX reference, on the CPU.

The CUDA kernels walk a tile above 64 as K-chunks of a 64-wide sub-tile
on the planner's own T-level step tables; their plain versions, which the
card's kernels are held against bit for bit, are what runs here. Both
packages plan on the reference's normmaps at one τ (their f32 norm
products are the same, so is every gate decision), so the structural
tables must be exact:
step_i/j/k and step_flags, nvalid, and the dense grid's kidx. The
reference's Pallas kernels run in interpret mode as its own tests run
them, except bf16, whose interpret path is an ulp off its own unfused
result on this jax (ROADMAP queue C): there the reference is its `jnp`
backend, as in tests/test_torch_lowp.py.

Tolerances, relative to the output's largest magnitude:
  f32     1e-5 — f32 sums over K ≤ 1024 in another order (XLA's dot);
  int8    1e-6 — XLA:CPU contracts `acc + prod·b_scale` into one FMA where
          the port rounds twice (tests/test_torch_lowp.py's rule);
  bf16    1e-5 against the reference's bf16 product (products exact in
          f32, sums in another order); against the f32 product on the
          unrounded operands, the bound `kernels/quantize.py` documents:
          |x − bf16(x)| ≤ 2⁻⁸·|x| per operand, so each kept tile product
          moves by at most (2·2⁻⁸ + 2⁻¹⁶)·|A|·|B|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as rplan
from repro.kernels import ops as rops
from repro.kernels import quantize as rquant
from repro.kernels import ref as rref
from repro.kernels import spamm_mm as rmm
from repro_torch.core import plan as tplan
from repro_torch.kernels import quantize as tquant
from repro_torch.kernels import ref as tref
from repro_torch.kernels import spamm_mm as tmm

F32_RTOL = 1e-5
INT8_RTOL = 1e-6
BF16_REF_RTOL = 1e-5
BF16_EPS = 2.0 ** -8

# (tile, block_n, (m, k, n)): 24, 12 and 4 tile products
CASES = [(128, 1, (256, 512, 384)), (128, 2, (256, 512, 512)),
         (256, 1, (512, 768, 512)), (512, 1, (512, 1024, 1024))]


def _decay(m, n, seed, scale=0.4):
    """|i−j|^-½ decay times Gaussian noise (the reference's mixed-precision
    test operands)."""
    rng = np.random.default_rng(seed)
    d = np.abs(np.arange(m)[:, None] - np.arange(n)[None, :])
    base = (scale / (d ** 0.5 + 1)).astype(np.float32)
    return base * rng.standard_normal((m, n)).astype(np.float32)


def _operands(shape, seed):
    m, k, n = shape
    return _decay(m, k, seed), _decay(k, n, seed + 1)


def _ref_norms(x, tile, dtype):
    if dtype == "int8":
        return rops.int8_norms_and_scales(jnp.asarray(x), tile,
                                          backend="jnp")[0]
    return rops.tile_norms(rquant.quantized_view(jnp.asarray(x), dtype, tile),
                           tile, backend="jnp")


def _plans(a, b, tile, block_n, dtype, backend, gate_dtype=None):
    """The reference's and the port's plans at compute_dtype `gate_dtype`
    (default `dtype`) on the reference's `dtype` normmaps, at the τ whose
    widened gate sits at the median norm product (a low-precision plan
    widens τ by (1 − eps)²; at int8 and tiles ≥ 254 eps is 1 and the gate
    keeps every tile, as the reference's does); asserts the structural
    tables equal. Returns (reference plan, port plan, τ)."""
    gate_dtype = gate_dtype or dtype
    rna, rnb = (_ref_norms(x, tile, dtype) for x in (a, b))
    prods = np.asarray(rna)[:, None, :] * np.asarray(rnb).T[None]
    eps = rquant.gate_eps(gate_dtype, tile)
    tau = float(np.median(prods)) / max(1.0 - eps, 1e-3) ** 2
    rp = rplan.plan(None, None, tau, norm_a=rna, norm_b=rnb, tile=tile,
                    block_n=block_n, backend=backend,
                    compute_dtype=gate_dtype)
    p = tplan.plan(None, None, tau, norm_a=torch.as_tensor(np.array(rna)),
                   norm_b=torch.as_tensor(np.array(rnb)), tile=tile,
                   block_n=block_n, backend="torch", compute_dtype=gate_dtype)
    assert p.tau == float(np.asarray(rp.tau))
    assert 0 < int(p.valid_tiles) == int(rp.valid_tiles) <= p.total_tiles
    if eps < 1.0:
        assert int(p.valid_tiles) < p.total_tiles
    np.testing.assert_array_equal(p.nvalid.numpy(), np.asarray(rp.nvalid))
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


@pytest.mark.parametrize("tile,block_n,shape", CASES)
def test_f32_worklist_and_dense_grid_match_reference(tile, block_n, shape):
    """f32: the work-list plain against the reference's Pallas work-list in
    interpret mode, and the dense-grid plain against its Pallas dense-grid
    kernel on the same kidx/nvalid (kidx exact); in the port dense-grid ≡
    work-list bit for bit."""
    a, b = _operands(shape, 1)
    rp, p, _ = _plans(a, b, tile, block_n, "float32", "interpret")
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    got = tplan.execute(p, ta, tb)
    want = np.asarray(rplan.execute(rp, jnp.asarray(a), jnp.asarray(b)))
    assert _rel(got, want) <= F32_RTOL
    assert torch.equal(got, tmm.spamm_mm_worklist_plain(
        ta, tb, *_tables(p.work), tile=tile, block_n=block_n))

    kidx, nvalid = tref.spamm_compact_ref(p.mask)
    rkidx, rnvalid = rref.spamm_compact_ref(rp.mask)
    np.testing.assert_array_equal(kidx.numpy(), np.asarray(rkidx))
    np.testing.assert_array_equal(nvalid.numpy(), np.asarray(rnvalid))
    dense = tmm.spamm_mm_plain(ta, tb, kidx, nvalid, tile=tile,
                               block_n=block_n)
    rdense = rmm.spamm_mm(jnp.asarray(a), jnp.asarray(b), rkidx, rnvalid,
                          tile=tile, block_n=block_n, interpret=True)
    assert _rel(dense, rdense) <= F32_RTOL
    assert torch.equal(dense, got)


@pytest.mark.parametrize("tile,block_n,shape", CASES)
def test_int8_worklist_matches_reference(tile, block_n, shape):
    """int8: the same codes and T-level scales in both packages (exact), the
    port's plain int8 work-list against the reference's Pallas int8 kernel
    in interpret mode, on the int8 plan's tables (every tile at tiles ≥
    254, where the widened gate keeps all) and on the tables of an
    unwidened gate on the same int8 normmaps (about half the tiles);
    execute ≡ the plain call."""
    a, b = _operands(shape, 3)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    aq, a_s = tquant.quantize_tiles(ta, tile)
    bq, b_s = tquant.quantize_tiles(tb, tile)
    raq, ras = rquant.quantize_tiles(jnp.asarray(a), tile)
    rbq, rbs = rquant.quantize_tiles(jnp.asarray(b), tile)
    for mine, theirs in ((aq, raq), (a_s, ras), (bq, rbq), (b_s, rbs)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    for gate in ("int8", "float32"):
        rp, p, _ = _plans(a, b, tile, block_n, "int8", "interpret",
                          gate_dtype=gate)
        got = tmm.spamm_mm_worklist_int8_plain(aq, bq, a_s, b_s,
                                               *_tables(p.work), tile=tile,
                                               block_n=block_n)
        want = rmm.spamm_mm_worklist_int8(
            raq, rbq, ras, rbs, *(jnp.asarray(t.numpy()) for t in
                                  _tables(p.work)[:4]),
            tile=tile, block_n=block_n, interpret=True)
        assert _rel(got, want) <= INT8_RTOL
        if gate == "int8":
            assert torch.equal(tplan.execute(p, ta, tb), got)


def _masked_abs_product(a, b, mask, tile, block_n):
    """Σ over the kept k of |A[i, k]|·|B[k, j]| per output element, in f64:
    the scale of the bf16 rounding bound."""
    m, k = a.shape
    n = b.shape[1]
    tn = tile * block_n
    a4 = np.abs(a).astype(np.float64).reshape(m // tile, tile, k // tile,
                                              tile)
    b4 = np.abs(b).astype(np.float64).reshape(k // tile, tile, n // tn, tn)
    out = np.zeros((m // tile, tile, n // tn, tn))
    for i, j, kk in zip(*np.nonzero(mask)):
        out[i, :, j, :] += a4[i, :, kk, :] @ b4[kk, :, j, :]
    return out.reshape(m, n)


@pytest.mark.parametrize("tile,block_n,shape", CASES[:3])
def test_bf16_worklist_matches_reference(tile, block_n, shape):
    """bf16: against the reference's bf16 product (its jnp backend), and
    against the f32 product within the documented rounding bound; the
    plain bf16 work-list ≡ its f32 run on the bf16-rounded operands."""
    a, b = _operands(shape, 5)
    rp, p, tau = _plans(a, b, tile, block_n, "bfloat16", "interpret")
    rj = rplan.plan(None, None, tau, norm_a=_ref_norms(a, tile, "bfloat16"),
                    norm_b=_ref_norms(b, tile, "bfloat16"), tile=tile,
                    block_n=block_n, backend="jnp", compute_dtype="bfloat16")
    np.testing.assert_array_equal(np.asarray(rj.mask), np.asarray(rp.mask))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    got = tplan.execute(p, ta, tb)
    want = np.asarray(rplan.execute(rj, jnp.asarray(a), jnp.asarray(b)))
    assert _rel(got, want) <= BF16_REF_RTOL
    w = _tables(p.work)
    assert torch.equal(got, tmm.spamm_mm_worklist_plain(
        ta.bfloat16().float(), tb.bfloat16().float(), *w, tile=tile,
        block_n=block_n))
    f32 = tmm.spamm_mm_worklist_plain(ta, tb, *w, tile=tile, block_n=block_n)
    bound = (2 * BF16_EPS + BF16_EPS ** 2) * _masked_abs_product(
        a, b, p.mask.numpy(), tile, block_n)
    # plus the f32 rounding of two sums of ≤ K terms
    bound += 2e-6 * np.abs(f32.numpy()).max()
    assert (np.abs(got.numpy() - f32.numpy()) <= bound).all()
