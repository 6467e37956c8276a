"""The f32 work-list GEMM at a decode step's live rows (no card needed).

A call that says how many rows of A hold data (`rows=`, the others zero, a
decode step's tile padding) runs, on a CUDA tensor at a tile that is a
multiple of 64 and at most DECODE_MAX_ROWS rows, the decode kernel of
csrc/spamm_decode.cu. Here: the route rule, the decode launch's geometry
(every output column once), the source's constants against their Python
mirror, and the plain version, `execute` and the frozen gated linear with
`rows` threaded through, against the JAX reference (its Pallas kernel in
interpret mode).
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import module as rmodule
from repro.core import plan as rplan
from repro.kernels import ref as rref
from repro.plans.frozen import FrozenWeight as RFrozenWeight
from repro_torch.core import module as tmodule
from repro_torch.core import plan as tplan
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spamm_mm
from repro_torch.plans.frozen import FrozenWeight

SMS = 132                  # an H100 SXM
SMEM_PER_BLOCK = 232_448   # an H100's 227 KB a block can use
ALL_TILES = list(range(16, spamm_mm.MAX_CUDA_TILE + 1, 16))
# f32 GEMM over K ≤ 256: accumulation-order rounding (interpret-mode dots
# against the plain version's rank-1 updates)
MM_TOL = 1e-5
# τ sits in a gap of the norm products at least this wide (relative), so
# the few-ulp differences between the packages' norms cannot flip a tile
GAP_RTOL = 1e-4
K, N = 192, 256


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _decode_rows(rows, seed, tile=64):
    """`rows` live rows of K columns, zero-padded to one 64-row block (a
    multiple of the tile)."""
    x = np.zeros((max(64, tile), K), np.float32)
    x[:rows] = _rand((rows, K), seed)
    return x


def _gap_tau(x, w, tile):
    """A τ in the middle of the widest gap of the norm products between
    their 30th and 70th percentiles (products of the zero rows' tiles are
    0 and sit below every gap taken)."""
    na = np.asarray(rref.tile_norms_ref(jnp.asarray(x), tile))
    nb = np.asarray(rref.tile_norms_ref(jnp.asarray(w), tile))
    prods = np.unique(na[:, None, :] * nb.T[None])
    prods = prods[prods > 0]
    lo, hi = int(0.3 * prods.size), int(0.7 * prods.size)
    gaps = prods[lo + 1:hi] - prods[lo:hi - 1]
    g = int(np.argmax(gaps))
    a, b = prods[lo + g], prods[lo + g + 1]
    assert (b - a) / b > GAP_RTOL, (a, b)
    return float((a + b) / 2)


# -- the route and the launch ---------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_route_rule_sends_few_live_rows_at_multiples_of_64_to_decode(dtype):
    """f32 at a tile that is a multiple of 64 and 1 .. DECODE_MAX_ROWS live
    rows runs the decode kernel ("fma_decode"); 17 rows, every row (None),
    0 rows, the tiles walked with a sub-tile of 16 or 32, and bf16 and
    int8 at any rows stay on today's kernels; the geometry carries it."""
    assert spamm_mm.DECODE_MAX_ROWS == 16
    for tile in ALL_TILES:
        for rows in (None, 0, 1, 3, 4, 16, 17, 64):
            fam = spamm_mm.mma_family(tile, dtype, rows)
            decode = (dtype == torch.float32 and tile % 64 == 0
                      and rows is not None and 1 <= rows <= 16)
            assert (fam == "fma_decode") == decode, (tile, rows)
            assert spamm_mm.decode_route(rows, tile, dtype) == decode
            if not decode:
                assert fam == spamm_mm.mma_family(tile, dtype)
            geo = spamm_mm.launch_geometry(72, tile, dtype, SMS, rows=rows)
            assert geo["mma"] == fam
    with pytest.raises(ValueError, match="multiple of 16"):
        spamm_mm.mma_family(24, dtype, 4)


def _columns(geo, tile, block_n):
    """The output columns each gridDim.y index of a decode launch writes,
    by the kernel's index arithmetic (group, then column piece)."""
    width = geo["width"]
    pieces = tile // width
    cols = []
    for by in range(block_n * pieces):
        col0 = (by // pieces) * tile + (by % pieces) * width
        cols.append(range(col0, col0 + width))
    return cols


@pytest.mark.parametrize("block_n", [1, 2])
@pytest.mark.parametrize("tile", [64, 128, 256, 512])
def test_decode_geometry_covers_every_output_column_once(tile, block_n):
    """Each run's tile·block_n output columns are written by exactly one
    block; a block's RB rows × width columns by exactly one consumer
    thread each (thread t: row t / (width/CL), columns CL·(t % (width/CL))
    onwards, CL the columns a thread owns: 1 while RB·width fits
    DECODE_MAX_CONSUMERS threads, else 2 or 4); width 32 where that gives
    a block an SM, else 16; threads fit the step-list builder (≤ 160,
    whole warps) and the ring a block's shared memory."""
    for runs in (1, 8, 72, 288, 2304):
        for rows in range(1, spamm_mm.DECODE_MAX_ROWS + 1):
            geo = spamm_mm.launch_geometry(runs * block_n, tile,
                                           torch.float32, SMS, rows=rows)
            width, rb = geo["width"], geo["row_block"]
            assert width in spamm_mm.DECODE_WIDTHS
            assert width == (32 if runs * block_n * tile // 32 >= SMS
                             else 16)
            assert rb in spamm_mm.DECODE_ROW_BLOCKS and rb >= rows
            assert rb == min(r for r in spamm_mm.DECODE_ROW_BLOCKS
                             if r >= rows)
            cols = [c for piece in _columns(geo, tile, block_n)
                    for c in piece]
            assert sorted(cols) == list(range(tile * block_n))
            assert geo["blocks"] == runs * block_n * (tile // width)
            lanes = min(rb * width, spamm_mm.DECODE_MAX_CONSUMERS)
            cl = geo["columns_per_thread"]
            assert cl == rb * width // lanes and cl in (1, 2, 4)
            cpr = width // cl
            owned = [(t // cpr, cl * (t % cpr) + j) for t in range(lanes)
                     for j in range(cl)]
            assert sorted(owned) == [(r, c) for r in range(rb)
                                     for c in range(width)]
            assert geo["threads"] == max(32, lanes) + 32
            assert geo["threads"] % 32 == 0 and geo["threads"] <= 160
            assert geo["ring_bytes"] <= SMEM_PER_BLOCK
    # the serving shapes: w1 decode (288 runs), w2 decode (72 runs), wk
    # (8 runs)
    for runs, blocks in ((288, 576), (72, 144), (8, 32)):
        assert spamm_mm.launch_geometry(runs, 64, torch.float32, SMS,
                                        rows=4)["blocks"] == blocks


def _source(name):
    return (pathlib.Path(spamm_mm.__file__).parent / "csrc" / name
            ).read_text()


def test_decode_source_holds_the_python_mirror():
    """csrc/spamm_decode.cu's constants, stage formula, threads and the
    (row block, width) pairs it is built for are the ones
    kernels/spamm_mm.py routes and computes launches with; the build
    compiles it."""
    src = _source("spamm_decode.cu")

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kStagesDecode") == spamm_mm.DECODE_STAGES
    assert const("kMaxRows") == spamm_mm.DECODE_MAX_ROWS
    assert const("kMaxTile") == spamm_mm.MAX_CUDA_TILE
    assert const("kBand") == spamm_mm.WGMMA_BAND
    pairs = {(int(r), int(w)) for r, w in
             re.findall(r"SPAMM_DECODE_AT\((\d+), (\d+)\)", src)}
    assert pairs == {(r, w) for r in spamm_mm.DECODE_ROW_BLOCKS
                     for w in spamm_mm.DECODE_WIDTHS}
    assert ("rows <= 1 ? 1 : rows <= 2 ? 2 : rows <= 4 ? 4"
            in src and "rows <= 8 ? 8 : 16" in src)
    assert const("kMaxConsumers") == spamm_mm.DECODE_MAX_CONSUMERS
    for line in ("static constexpr int CONSUMERS = LANES < 32 ? 32 : LANES;",
                 "static constexpr int THREADS = CONSUMERS + 32;",
                 "RB * W < kMaxConsumers ? RB * W : kMaxConsumers;",
                 "static constexpr int CL = RB * W / LANES;",
                 "static constexpr int CPR = W / CL;",
                 "static constexpr int B_BYTES = kBand * W * 4;",
                 "static constexpr int A_BYTES = RB * kBand * 4;",
                 "static constexpr int STAGE = B_BYTES + A_BYTES;",
                 "constexpr int kDynamicBytes = kStagesDecode * D::STAGE + "
                 "128;"):
        assert line in src, line
    for rb in spamm_mm.DECODE_ROW_BLOCKS:
        for width in spamm_mm.DECODE_WIDTHS:
            geo = spamm_mm.decode_geometry(8 if width == 16 else 2304, 64,
                                           rb, SMS)
            assert geo["width"] == width
            stage = 64 * width * 4 + rb * 64 * 4
            assert geo["ring_bytes"] == const("kStagesDecode") * stage + 128
    from repro_torch.kernels import build

    assert "spamm_decode.cu" in build.SOURCES
    assert '#include "tma.cuh"' in src


def test_rows_outside_the_operand_raise():
    """`rows` is None or 0 .. the rows of a: the plain version refuses the
    rest; the CUDA wrapper refuses CPU tensors whatever the rows."""
    a, b = torch.zeros(64, 128), torch.zeros(128, 64)
    tables = [torch.zeros(1, dtype=torch.int32)] * 4
    runs = torch.tensor([0, 1], dtype=torch.int32)
    for bad in (-1, 65):
        with pytest.raises(ValueError, match="rows"):
            spamm_mm.spamm_mm_worklist_plain(a, b, *tables, runs, rows=bad)
    with pytest.raises(ValueError, match="CUDA"):
        spamm_mm.spamm_mm_worklist_cuda(a, b, *tables, runs, rows=4)


# -- against the reference --------------------------------------------------

ROWS = (1, 4, 16)


@pytest.mark.parametrize("tile", [16, 32, 64])
@pytest.mark.parametrize("rows", ROWS)
def test_plain_and_execute_at_live_rows_match_reference(rows, tile):
    """`rows` live rows of a 64-row block: the plain version with rows=
    and `execute(..., rows=)` on the torch backend against the reference's
    `execute` (interpret mode) on the same eager plan; rows from `rows` on
    are zero in both."""
    x = _decode_rows(rows, 10 + rows)
    w = _rand((K, N), 11)
    tau = _gap_tau(x, w, tile)
    rp = rplan.plan(jnp.asarray(x), jnp.asarray(w), tau, tile=tile,
                    backend="interpret")
    want = np.asarray(rplan.execute(rp, jnp.asarray(x), jnp.asarray(w)))
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    p = tplan.plan(xt, wt, tau, tile=tile, backend="torch")
    assert int(p.valid_tiles) == int(rp.valid_tiles)
    assert 0.0 < float(p.valid_fraction) < 1.0
    got = tplan.execute(p, xt, wt, rows=rows)
    np.testing.assert_allclose(got.numpy(), want, rtol=MM_TOL, atol=MM_TOL)
    assert not got[rows:].any() and not want[rows:].any()
    assert got[:rows].any()
    wk = p.work
    plain = spamm_mm.spamm_mm_worklist_plain(
        xt, wt, wk.step_i, wk.step_j, wk.step_k, wk.step_flags, wk.runs,
        tile=tile, rows=rows)
    assert torch.equal(plain, got)
    assert torch.equal(plain, tplan.execute(p, xt, wt))


def _spy_rows(monkeypatch):
    """A backend "spy_rows" of the plain entries that records the `rows`
    each work-list call receives."""
    import dataclasses

    seen = []
    base = tops.BACKENDS["torch"]

    def matmul_worklist(*args, rows=None, **kw):
        seen.append(rows)
        return base.matmul_worklist(*args, rows=rows, **kw)

    monkeypatch.setitem(tops.BACKENDS, "spy_rows", dataclasses.replace(
        base, name="spy_rows", matmul_worklist=matmul_worklist))
    return seen


@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("rows", ROWS)
def test_frozen_linear_at_live_rows_matches_reference(monkeypatch, rows,
                                                      tile):
    """The serving path: a decode activation of `rows` rows through
    `spamm_linear_frozen` (it pads to the tile and passes its rows to the
    backend's work-list GEMM) against the reference's frozen gated linear
    on the same weight and τ; the eager gated linear passes its rows too."""
    seen = _spy_rows(monkeypatch)
    x = _rand((rows, K), 20 + rows)
    w = _rand((K, N), 21)
    tau = _gap_tau(np.pad(x, ((0, tile - rows), (0, 0))), w, tile)
    rfw = RFrozenWeight.build(jnp.asarray(w), tau, tile=tile,
                              backend="interpret")
    want = np.asarray(rmodule.spamm_linear_frozen(
        jnp.asarray(x), jnp.asarray(w), rfw.for_rows(1)))
    fw = FrozenWeight.build(torch.as_tensor(w), tau, tile=tile,
                            backend="spy_rows")
    got = tmodule.spamm_linear_frozen(torch.as_tensor(x),
                                      torch.as_tensor(w), fw.for_rows(1))
    assert seen == [rows]
    assert got.shape == (rows, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=MM_TOL, atol=MM_TOL)
    eager = tmodule.spamm_linear(torch.as_tensor(x), torch.as_tensor(w),
                                 tau, tile=tile, backend="spy_rows")
    assert seen == [rows, rows]
    assert torch.equal(eager, got)
