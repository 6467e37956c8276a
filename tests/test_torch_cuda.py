"""The port's CUDA kernels on the card, against their plain versions.

Every test carries the `cuda` marker and skips without a GPU (a CUDA kernel
has no CPU mode). This file imports torch and the port only, so it runs on a
machine without JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import plan as P
from repro_torch.core import spamm as S
from repro_torch.device import f32_numerics
from repro_torch.kernels import getnorm, ref, spamm_mm
from repro_torch.kernels import quantize as Q
from repro_torch.plans.frozen import FrozenWeight

pytestmark = pytest.mark.cuda

# tile norms: f32 sums of ≤ 4096 squares in two orders
NORM_RTOL = 1e-5
# work-list GEMM: FMA (kernel) vs multiply-add (plain) over K ≤ 2560; bf16
# on the tensor cores vs sequential f32 sums, relative to the output's
# largest magnitude
MM_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(shape, seed, dev):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32), device=dev)


def _median_tau(a, b, tile):
    na, nb = getnorm.tile_norms_cuda(a, tile), getnorm.tile_norms_cuda(b, tile)
    return float((na[:, None, :] * nb.T[None]).flatten().median())


@pytest.mark.parametrize("tile", [16, 32, 64])
def test_tile_norms_kernel_matches_plain(dev, tile):
    for shape in ((4 * tile, 6 * tile), (tile, 3 * tile)):
        x = _rand(shape, 0, dev)
        before = getnorm.launches
        got = getnorm.tile_norms(x, tile)
        torch.cuda.synchronize()
        assert getnorm.launches == before + 1
        torch.testing.assert_close(got, getnorm.tile_norms_plain(x, tile),
                                   rtol=NORM_RTOL, atol=0)


@pytest.mark.parametrize("block_n", [1, 2])
@pytest.mark.parametrize("tile", [16, 32, 64])
def test_worklist_kernel_matches_plain(dev, tile, block_n):
    a = _rand((4 * tile, 6 * tile), 1, dev)
    b = _rand((6 * tile, 4 * tile), 2, dev)
    tau = _median_tau(a, b, tile)
    w = P.plan(a, b, tau, tile=tile, block_n=block_n, backend="cuda").work
    args = (a, b, w.step_i, w.step_j, w.step_k, w.step_flags, w.runs)
    before = spamm_mm.launches
    got = spamm_mm.spamm_mm_worklist(*args, tile=tile, block_n=block_n)
    torch.cuda.synchronize()
    assert spamm_mm.launches == before + 1
    want = spamm_mm.spamm_mm_worklist_plain(*args, tile=tile, block_n=block_n)
    torch.testing.assert_close(got, want, rtol=MM_TOL, atol=MM_TOL)


@pytest.mark.parametrize("block_n", [1, 2])
def test_frozen_equals_eager_bitwise_on_card(dev, block_n):
    tile = 64
    x = _rand((3 * tile, 5 * tile), 3, dev)
    w = _rand((5 * tile, 4 * tile), 4, dev)
    tau = _median_tau(x, w, tile)
    eager = P.plan(x, w, tau, tile=tile, block_n=block_n, backend="cuda")
    fw = FrozenWeight.build(w, tau, tile=tile, block_n=block_n,
                            backend="cuda")
    frozen = P.plan(x, frozen_weight=fw.for_rows(3))
    assert int(eager.valid_tiles) == int(frozen.valid_tiles)
    assert torch.equal(P.execute(eager, x, w), P.execute(frozen, x, w))


def test_tau0_equals_dense_product(dev):
    tile = 64
    x, w = _rand((128, 256), 5, dev), _rand((256, 192), 6, dev)
    fw = FrozenWeight.build(w, 0.0, tile=tile, backend="cuda")
    p = P.plan(x, frozen_weight=fw.for_rows(2))
    assert float(p.valid_fraction) == 1.0
    f32_numerics()
    torch.testing.assert_close(P.execute(p, x, w), x @ w, rtol=MM_TOL,
                               atol=MM_TOL)


def test_kernels_reject_what_they_do_not_take(dev):
    x = _rand((64, 128), 7, dev)
    with pytest.raises(TypeError):
        getnorm.tile_norms_cuda(x.double(), 64)
    with pytest.raises(ValueError):
        getnorm.tile_norms_cuda(x.t(), 64)          # not contiguous
    with pytest.raises(ValueError):                 # mma needs tile % 16
        getnorm.tile_norms_cuda(_rand((48, 96), 7, dev), 24, use_mxu=True)
    w = P.plan(x, x.t().contiguous(), 0.0, tile=64, backend="cuda").work
    tables = (w.step_i, w.step_j, w.step_k, w.step_flags, w.runs)
    with pytest.raises(ValueError):
        spamm_mm.spamm_mm_worklist_cuda(x, x.t().contiguous(), *tables,
                                        tile=48)
    with pytest.raises(TypeError):
        spamm_mm.spamm_mm_worklist_cuda(x.half(), x.t().contiguous().half(),
                                        *tables, tile=64)


@pytest.mark.parametrize("shape", [(8, 8), (5, 7), (255, 257), (3, 5, 7),
                                   (1, 1)])
def test_pool_norms_kernel_matches_plain(dev, shape):
    x = _rand(shape, 8, dev).abs()
    before = getnorm.pool_launches
    got = getnorm.pool_norms(x)
    torch.cuda.synchronize()
    assert getnorm.pool_launches == before + 1
    torch.testing.assert_close(got, getnorm.pool_norms_plain(x),
                               rtol=NORM_RTOL, atol=0)


def _dense_case(tile, block_n, dev, bsz=3):
    """Per-slice operands, the batched gate at τ = the median product and
    its compaction."""
    x = _rand((bsz, 2 * tile, 5 * tile), 9, dev)
    w = _rand((bsz, 5 * tile, 4 * tile), 10, dev)
    na = getnorm.tile_norms_cuda(x.reshape(-1, 5 * tile), tile).reshape(
        bsz, 2, 5)
    nb = getnorm.tile_norms_cuda(w.reshape(-1, 4 * tile), tile).reshape(
        bsz, 5, 4)
    tau = float((na[..., :, None, :] * nb.transpose(-1, -2)[..., None, :, :]
                 ).flatten().median())
    mask = P.gate_mask(na, nb, tau, block_n)
    kidx, nvalid = ref.spamm_compact_ref(mask)
    return x, w, tau, kidx, nvalid


@pytest.mark.parametrize("block_n", [1, 2])
@pytest.mark.parametrize("tile", [16, 32, 64])
def test_dense_grid_kernel_matches_plain_and_worklist(dev, tile, block_n):
    """The dense-grid kernel against its plain version, and bit for bit
    against the work-list kernel on each slice's own plan."""
    x, w, tau, kidx, nvalid = _dense_case(tile, block_n, dev)
    before = spamm_mm.dense_launches
    got = spamm_mm.spamm_mm(x, w, kidx, nvalid, tile=tile, block_n=block_n)
    torch.cuda.synchronize()
    assert spamm_mm.dense_launches == before + 1
    want = spamm_mm.spamm_mm_plain(x, w, kidx, nvalid, tile=tile,
                                   block_n=block_n)
    torch.testing.assert_close(got, want, rtol=MM_TOL, atol=MM_TOL)
    assert 0 < int(nvalid.sum()) < kidx.numel()
    for s in range(x.shape[0]):
        p = P.plan(x[s], w[s], tau, tile=tile, block_n=block_n,
                   backend="cuda")
        assert torch.equal(p.nvalid, nvalid[s])
        assert torch.equal(P.execute(p, x[s], w[s]), got[s])


def test_spamm_bmm_per_slice_on_card(dev):
    x, w, tau, _, _ = _dense_case(64, 1, dev)
    before = spamm_mm.dense_launches
    c, info = P.spamm_bmm(x, w, tau, tile=64, backend="cuda")
    torch.cuda.synchronize()
    assert spamm_mm.dense_launches == before + 1
    assert 0.0 < float(info.valid_fraction) < 1.0
    for s in range(x.shape[0]):
        assert torch.equal(c[s], S.spamm(x[s], w[s], tau, tile=64,
                                         backend="cuda")[0])


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_hier_plan_equals_flat_on_card(dev, levels):
    """Pyramids pooled by the kernel give the flat plan's tables and a
    bit-identical product."""
    a = _rand((5 * 64, 7 * 64), 11, dev)
    b = _rand((7 * 64, 6 * 64), 12, dev)
    tau = _median_tau(a, b, 64)
    flat = P.plan(a, b, tau, tile=64, backend="cuda")
    before = getnorm.pool_launches
    hier = P.plan(a, b, tau, tile=64, backend="cuda", levels=levels)
    assert getnorm.pool_launches == before + 2 * levels
    for name in flat.work._fields:
        assert torch.equal(getattr(flat.work, name),
                           getattr(hier.work, name)), name
    assert torch.equal(P.execute(flat, a, b), P.execute(hier, a, b))


def test_library_kernels_reject_what_they_do_not_take(dev):
    x = _rand((6, 8), 13, dev).abs()
    with pytest.raises(TypeError):
        getnorm.pool_norms_cuda(x.double())
    with pytest.raises(ValueError):
        getnorm.pool_norms_cuda(x.t())               # not contiguous
    a, w, _, kidx, nvalid = _dense_case(64, 1, dev)
    with pytest.raises(TypeError):
        spamm_mm.spamm_mm_cuda(a.half(), w.half(), kidx, nvalid, tile=64)
    with pytest.raises(TypeError):
        spamm_mm.spamm_mm_cuda(a, w, kidx.long(), nvalid, tile=64)
    with pytest.raises(ValueError):
        spamm_mm.spamm_mm_cuda(a, w.transpose(-1, -2).contiguous()
                               .transpose(-1, -2), kidx, nvalid, tile=64)


@pytest.mark.parametrize("tile", [16, 32, 64])
def test_tile_norms_quant_kernel_equals_unfused_on_card(dev, tile):
    """The fused int8 get-norm: scales equal to the quantizer's and norms
    equal to the f32 get-norm kernel on the dequantized matrix, bit for bit;
    within NORM_RTOL of the plain composition (another summation order)."""
    x = _rand((4 * tile, 6 * tile), 14, dev)
    x[:tile, :tile] = 0.0                  # an all-zero tile: scale 1e-30/127
    before = getnorm.quant_launches
    norms, scales = getnorm.tile_norms_quant(x, tile)
    torch.cuda.synchronize()
    assert getnorm.quant_launches == before + 1
    q, s = Q.quantize_tiles(x, tile)
    assert torch.equal(scales, s)
    assert torch.equal(norms, getnorm.tile_norms_cuda(
        Q.dequantize_tiles(q, s, tile), tile))
    pn, ps = getnorm.tile_norms_quant_plain(x, tile)
    assert torch.equal(scales, ps)
    torch.testing.assert_close(norms, pn, rtol=NORM_RTOL, atol=0)


def _offset_view(t):
    """A contiguous copy of t one element past a 16-byte aligned base: the
    get-norm kernels take their 4-byte load path on it."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("tile", [16, 24, 32, 48, 64])
def test_getnorm_pair_at_every_tile_and_load_path_on_card(dev, tile,
                                                          aligned):
    """tile_norms and the fused int8 get-norm at the templated tiles (16,
    32, 64) and at tiles the runtime-tile kernels take (24, 48), on 16-byte
    and on 4-byte loads, with an all-zero tile, at shapes that fill whole
    blocks and one that leaves part of a tile-16 block empty (5 tiles):
    within NORM_RTOL of the plain versions, fused ≡ unfused (on the same
    load path) and scales ≡ the quantizer's bit for bit, two calls
    bit-identical, one launch per call."""
    for shape in ((4 * tile, 6 * tile), (tile, 5 * tile),
                  (16 * tile, 36 * tile)):
        x = _rand(shape, 40 + tile, dev)
        x[:tile, tile:2 * tile] = 0.0
        if not aligned:
            x = _offset_view(x)
        before = (getnorm.launches, getnorm.quant_launches)
        got = getnorm.tile_norms_cuda(x, tile)
        again = getnorm.tile_norms_cuda(x, tile)
        norms, scales = getnorm.tile_norms_quant_cuda(x, tile)
        norms2, scales2 = getnorm.tile_norms_quant_cuda(x, tile)
        torch.cuda.synchronize()
        assert (getnorm.launches, getnorm.quant_launches) == (
            before[0] + 2, before[1] + 2)
        assert torch.equal(got, again)
        assert torch.equal(norms, norms2) and torch.equal(scales, scales2)
        assert float(got[0, 1]) == 0.0 and float(norms[0, 1]) == 0.0
        torch.testing.assert_close(got, getnorm.tile_norms_plain(x, tile),
                                   rtol=NORM_RTOL, atol=0)
        q, s = Q.quantize_tiles(x, tile)
        assert torch.equal(scales, s)
        dq = Q.dequantize_tiles(q, s, tile)
        if not aligned:
            dq = _offset_view(dq)
        assert torch.equal(norms, getnorm.tile_norms_cuda(dq, tile))
        pn, ps = getnorm.tile_norms_quant_plain(x, tile)
        assert torch.equal(scales, ps)
        torch.testing.assert_close(norms, pn, rtol=NORM_RTOL, atol=0)


def test_getnorm_entries_raise_on_what_they_do_not_take_on_card(dev):
    """On the card, as on the CPU (tests/test_torch_getnorm_launch.py):
    the same exception types, and no launch counted."""
    x = _rand((64, 96), 41, dev)
    counts = (getnorm.launches, getnorm.quant_launches, getnorm.pool_launches)
    for fn in (getnorm.tile_norms_cuda, getnorm.tile_norms_quant_cuda):
        for bad, exc in ((x.double(), TypeError), (x.bfloat16(), TypeError),
                         (x.t(), ValueError),
                         (x[:, :80].contiguous(), ValueError),
                         (x.cpu(), ValueError)):
            with pytest.raises(exc):
                fn(bad, 32)
    with pytest.raises(ValueError):
        getnorm.pool_norms_cuda(x[0])
    assert counts == (getnorm.launches, getnorm.quant_launches,
                      getnorm.pool_launches)


def _int8_args(a, b, tile, block_n=1):
    """Codes and scales of a and b with the step tables of their f32 plan
    at τ = the median product."""
    tau = _median_tau(a, b, tile)
    w = P.plan(a, b, tau, tile=tile, block_n=block_n, backend="cuda").work
    a_q, a_s = Q.quantize_tiles(a, tile)
    b_q, b_s = Q.quantize_tiles(b, tile)
    return (a_q, b_q, a_s, b_s, w.step_i, w.step_j, w.step_k, w.step_flags,
            w.runs)


def _int8_case(tile, block_n, dev):
    """_int8_args of two random operands."""
    return _int8_args(_rand((4 * tile, 6 * tile), 15, dev),
                      _rand((6 * tile, 4 * tile), 16, dev), tile, block_n)


@pytest.mark.parametrize("block_n", [1, 2])
@pytest.mark.parametrize("tile", [16, 32, 64])
def test_int8_worklist_kernel_equals_plain_on_card(dev, tile, block_n):
    """Exact int32 tile dots and the reference's scale order: kernel ≡
    plain bit for bit; against the f32 kernel on the dequantized operands
    within 1e-5 of the output's largest magnitude (the reference's bound:
    the f32 kernel rounds inside each tile dot)."""
    args = _int8_case(tile, block_n, dev)
    before = spamm_mm.int8_launches
    got = spamm_mm.spamm_mm_worklist_int8(*args, tile=tile, block_n=block_n)
    torch.cuda.synchronize()
    assert spamm_mm.int8_launches == before + 1
    want = spamm_mm.spamm_mm_worklist_int8_plain(*args, tile=tile,
                                                 block_n=block_n)
    assert torch.equal(got, want)
    a_q, b_q, a_s, b_s = args[:4]
    f32 = spamm_mm.spamm_mm_worklist_cuda(
        Q.dequantize_tiles(a_q, a_s, tile), Q.dequantize_tiles(b_q, b_s, tile),
        *args[4:], tile=tile, block_n=block_n)
    assert float((got - f32).abs().max()) <= 1e-5 * float(f32.abs().max())


def _max_rel(got, want):
    """Largest abs difference over the largest magnitude of `want`."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("block_n", [1, 2])
@pytest.mark.parametrize("tile", [16, 32, 64])
def test_bf16_worklist_kernel_on_card(dev, tile, block_n):
    """bf16 operands on the tensor cores: within MM_TOL of the output's
    largest magnitude against the f32 kernel on the bf16-rounded operands
    and against the plain version (the products are exact in f32, the MMA
    adds them in its own order); two launches give equal outputs."""
    a = _rand((4 * tile, 6 * tile), 17, dev)
    b = _rand((6 * tile, 4 * tile), 18, dev)
    tau = _median_tau(a, b, tile)
    w = P.plan(a, b, tau, tile=tile, block_n=block_n, backend="cuda").work
    tables = (w.step_i, w.step_j, w.step_k, w.step_flags, w.runs)
    ab, bb = a.bfloat16(), b.bfloat16()
    before = (spamm_mm.bf16_launches, spamm_mm.launches)
    got = spamm_mm.spamm_mm_worklist(ab, bb, *tables, tile=tile,
                                     block_n=block_n)
    again = spamm_mm.spamm_mm_worklist(ab, bb, *tables, tile=tile,
                                       block_n=block_n)
    torch.cuda.synchronize()
    assert (spamm_mm.bf16_launches, spamm_mm.launches) == (before[0] + 2,
                                                           before[1])
    assert torch.equal(got, again)
    f32 = spamm_mm.spamm_mm_worklist_cuda(ab.float(), bb.float(), *tables,
                                          tile=tile, block_n=block_n)
    plain = spamm_mm.spamm_mm_worklist_plain(ab, bb, *tables, tile=tile,
                                             block_n=block_n)
    assert _max_rel(got, f32) <= MM_TOL
    assert _max_rel(got, plain) <= MM_TOL
    assert float(got.abs().max()) > 0.0


def _decode_case(tile, dev, gk=40, gn=4, seed=27):
    """A decode step as the gated GEMMs see it: 4 real rows zero-padded to
    one row tile, a long k-list (gk tiles) and gn output columns: few runs,
    so the wrapper splits their blocks into column slices."""
    x = torch.zeros(tile, gk * tile, device=dev)
    x[:4] = _rand((4, gk * tile), seed, dev)
    w = _rand((gk * tile, gn * tile), seed + 1, dev)
    return x, w, _median_tau(x, w, tile)


@pytest.mark.parametrize("tile", [32, 64])
def test_decode_column_split_f32_on_card(dev, tile):
    """At decode shapes the column split is taken; the kernel stays within
    MM_TOL of its plain version, frozen ≡ eager and dense-grid ≡ work-list
    bit for bit (each slice walks the same steps in the same order)."""
    x, w, tau = _decode_case(tile, dev)
    fw = FrozenWeight.build(w, tau, tile=tile, backend="cuda")
    frozen = P.plan(x, frozen_weight=fw.for_rows(1))
    assert 0.0 < float(frozen.valid_fraction) < 1.0
    wk = frozen.work
    args = (x, w, wk.step_i, wk.step_j, wk.step_k, wk.step_flags, wk.runs)
    got = spamm_mm.spamm_mm_worklist_cuda(*args, tile=tile)
    geo = dict(spamm_mm.last_geometry)
    assert geo["column_slices"] == tile // 16 > 1
    assert geo["blocks"] == (wk.runs.numel() - 1) * geo["column_slices"]
    want = spamm_mm.spamm_mm_worklist_plain(*args, tile=tile)
    torch.testing.assert_close(got, want, rtol=MM_TOL, atol=MM_TOL)
    eager = P.plan(x, w, tau, tile=tile, backend="cuda")
    c = P.execute(eager, x, w)
    assert torch.equal(P.execute(frozen, x, w), c)
    kidx, nvalid = ref.spamm_compact_ref(eager.mask)
    dense = spamm_mm.spamm_mm_cuda(x, w, kidx, nvalid, tile=tile)
    assert spamm_mm.last_geometry["column_slices"] == tile // 16
    assert torch.equal(dense, c)


@pytest.mark.parametrize("rows", [1, 4, 16, 17])
@pytest.mark.parametrize("tile", [64, 128])
def test_decode_kernel_at_live_rows_on_card(dev, tile, rows):
    """f32 with `rows` live rows of a row tile: 1, 4 and 16 run the decode
    kernel ("fma_decode", counted in `decode_launches`), 17 the 64-row
    kernel. On the live rows the call is bit for bit the 64-row kernel on
    every row, the other rows stay zero; within MM_TOL of the plain version;
    frozen ≡ eager through `execute(rows=)`; the call captured in a CUDA
    graph and replayed ≡ eager."""
    gk, gn = 40, 4
    x = torch.zeros(tile, gk * tile, device=dev)
    x[:rows] = _rand((rows, gk * tile), 41 + rows, dev)
    w = _rand((gk * tile, gn * tile), 42, dev)
    tau = _median_tau(x, w, tile)
    fw = FrozenWeight.build(w, tau, tile=tile, backend="cuda")
    frozen = P.plan(x, frozen_weight=fw.for_rows(1))
    assert 0.0 < float(frozen.valid_fraction) < 1.0
    wk = frozen.work
    args = (x, w, wk.step_i, wk.step_j, wk.step_k, wk.step_flags, wk.runs)
    every_row = spamm_mm.spamm_mm_worklist_cuda(*args, tile=tile)
    decode = rows <= spamm_mm.DECODE_MAX_ROWS
    before = (spamm_mm.launches, spamm_mm.decode_launches)
    got = spamm_mm.spamm_mm_worklist_cuda(*args, tile=tile, rows=rows)
    geo = dict(spamm_mm.last_geometry)
    torch.cuda.synchronize()
    assert (spamm_mm.launches, spamm_mm.decode_launches) == (
        before[0] + (not decode), before[1] + decode)
    assert geo["mma"] == ("fma_decode" if decode else "fma")
    assert torch.equal(got[:rows], every_row[:rows])
    assert not got[rows:].any()
    plain = spamm_mm.spamm_mm_worklist_plain(*args, tile=tile, rows=rows)
    torch.testing.assert_close(got, plain, rtol=MM_TOL, atol=MM_TOL)
    eager = P.plan(x, w, tau, tile=tile, backend="cuda")
    assert torch.equal(P.execute(frozen, x, w, rows=rows),
                       P.execute(eager, x, w, rows=rows))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        spamm_mm.spamm_mm_worklist_cuda(*args, tile=tile, rows=rows)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = spamm_mm.spamm_mm_worklist_cuda(*args, tile=tile,
                                                   rows=rows)
    captured.fill_(float("nan"))
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, got)


@pytest.mark.parametrize("tile", [32, 64])
def test_decode_column_split_bf16_on_card(dev, tile):
    """bf16 at decode shapes: frozen ≡ eager bit for bit through the split
    launch, within MM_TOL of the plain version."""
    x, w, tau = _decode_case(tile, dev, seed=29)
    eager = P.plan(x, w, tau, tile=tile, backend="cuda",
                   compute_dtype="bfloat16")
    fw = FrozenWeight.build(w, tau, tile=tile, backend="cuda",
                            compute_dtype="bfloat16")
    frozen = P.plan(x, frozen_weight=fw.for_rows(1))
    before = spamm_mm.bf16_launches
    c = P.execute(frozen, x, w)
    assert spamm_mm.bf16_launches == before + 1
    assert spamm_mm.last_geometry["column_slices"] == tile // 16
    assert torch.equal(P.execute(eager, x, w), c)
    wk = frozen.work
    plain = spamm_mm.spamm_mm_worklist_plain(
        x.bfloat16(), w.bfloat16(), wk.step_i, wk.step_j, wk.step_k,
        wk.step_flags, wk.runs, tile=tile)
    assert _max_rel(c, plain) <= MM_TOL


def _flag_tables(tile, gk, dev, seed=31):
    """Hand-made step tables for a (tile, 2·tile) output over gk k tiles.
    Run 0, block (0, 0): 600 steps cycling over k, about half with ACC (a
    longer list than one shared-memory chunk), INIT on the first flagged
    step, FLUSH on the last, flag-0 steps between. Run 1, block (0, 1): 40
    flag-0 steps and a trailing FLUSH, which writes the zeroed accumulator."""
    rng = np.random.default_rng(seed)
    s0, s1 = 600, 41
    k0 = np.arange(s0) % gk
    f0 = np.where(rng.random(s0) < 0.5, spamm_mm.STEP_ACC, 0)
    on = np.flatnonzero(f0)
    f0[on[0]] |= spamm_mm.STEP_INIT
    f0[on[-1]] |= spamm_mm.STEP_FLUSH
    f1 = np.zeros(s1, np.int64)
    f1[-1] = spamm_mm.STEP_FLUSH
    cols = [np.zeros(s0 + s1, np.int64),
            np.r_[np.zeros(s0), np.ones(s1)],
            np.r_[k0, rng.integers(0, gk, s1)], np.r_[f0, f1]]
    tables = [torch.as_tensor(c.astype(np.int32), device=dev) for c in cols]
    runs = torch.tensor([0, s0, s0 + s1], dtype=torch.int32, device=dev)
    return (*tables, runs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [16, 32, 64])
def test_worklist_flag_patterns_on_card(dev, tile, dtype):
    """A run longer than one step-list chunk with flag-0 steps between its
    ACC steps, and a run of flag-0 steps ending in a lone FLUSH: the kernel
    against its plain version (the lone-FLUSH block stays zero)."""
    gk = 5
    tables = _flag_tables(tile, gk, dev)
    a = _rand((tile, gk * tile), 32, dev).to(dtype)
    b = _rand((gk * tile, 2 * tile), 33, dev).to(dtype)
    got = spamm_mm.spamm_mm_worklist_cuda(a, b, *tables, tile=tile)
    want = spamm_mm.spamm_mm_worklist_plain(a, b, *tables, tile=tile)
    torch.cuda.synchronize()
    assert _max_rel(got, want) <= MM_TOL
    assert float(got[:, :tile].abs().max()) > 0.0
    assert not bool(got[:, tile:].any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frozen_empty_pair_on_card(dev, dtype):
    """A frozen segment with no active step (its row tile is all zeros)
    gets one INIT|FLUSH and writes zeros; the rest ≡ eager bit for bit."""
    tile = 64
    x = _rand((3 * tile, 5 * tile), 34, dev)
    x[tile:2 * tile] = 0.0
    w = _rand((5 * tile, 4 * tile), 35, dev)
    tau = _median_tau(x, w, tile)
    fw = FrozenWeight.build(w, tau, tile=tile, backend="cuda",
                            compute_dtype=dtype)
    frozen = P.plan(x, frozen_weight=fw.for_rows(3))
    flags = frozen.work.step_flags
    both = spamm_mm.STEP_INIT | spamm_mm.STEP_FLUSH
    assert bool(((flags & both) == both).logical_and(
        (flags & spamm_mm.STEP_ACC) == 0).any())
    c = P.execute(frozen, x, w)
    assert not bool(c[tile:2 * tile].any())
    eager = P.plan(x, w, tau, tile=tile, backend="cuda", compute_dtype=dtype)
    assert torch.equal(P.execute(eager, x, w), c)


def test_kernels_raise_on_misaligned_operands(dev):
    """The 16-byte copies need 16-byte aligned operands: an offset view
    raises, for every operand of both GEMMs, f32 and bf16."""
    tile = 64
    a = _rand((tile, 2 * tile), 36, dev)
    b = _rand((2 * tile, tile), 37, dev)
    tables = P.plan(a, b, 0.0, tile=tile, backend="cuda").work
    tables = (tables.step_i, tables.step_j, tables.step_k,
              tables.step_flags, tables.runs)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16
        return view

    for dt in (torch.float32, torch.bfloat16):
        at, bt = a.to(dt), b.to(dt)
        for args in ((shifted(at), bt), (at, shifted(bt))):
            with pytest.raises(ValueError, match="aligned"):
                spamm_mm.spamm_mm_worklist_cuda(*args, *tables, tile=tile)
    kidx = torch.zeros(1, 1, 2, dtype=torch.int32, device=dev)
    nvalid = torch.ones(1, 1, dtype=torch.int32, device=dev)
    for args in ((shifted(a), b), (a, shifted(b))):
        with pytest.raises(ValueError, match="aligned"):
            spamm_mm.spamm_mm_cuda(*args, kidx, nvalid, tile=tile)


def test_pipeline_stages_match_the_library(dev):
    lib = spamm_mm._lib()
    assert lib.spamm_mm_stages(0) == spamm_mm.PIPELINE_STAGES[torch.float32]
    assert lib.spamm_mm_stages(1) == spamm_mm.PIPELINE_STAGES[torch.bfloat16]
    assert lib.spamm_mm_stages(2) == spamm_mm.PIPELINE_STAGES[torch.int8]



@pytest.mark.parametrize("case", ["decode", "prefill"])
@pytest.mark.parametrize("block_n", [1, 2])
@pytest.mark.parametrize("tile", [16, 32, 64])
def test_int8_worklist_every_column_slice_count_on_card(dev, monkeypatch,
                                                        tile, block_n, case):
    """The tensor-core int8 kernel ≡ its plain version bit for bit at every
    column-slice count its tile allows, forced through the SM count the
    slice rule sees, on few runs (a decode step: 4 real rows in one row
    tile) and on many; two launches are equal and `last_geometry` records
    each launch."""
    if case == "decode":
        a, _, _ = _decode_case(tile, dev, gk=12, gn=4 * block_n, seed=61)
    else:
        a = _rand((4 * tile, 6 * tile), 62, dev)
    b = _rand((a.shape[1], 4 * block_n * tile), 63, dev)
    args = _int8_args(a, b, tile, block_n)
    kw = {"tile": tile, "block_n": block_n}
    want = spamm_mm.spamm_mm_worklist_int8_plain(*args, **kw)
    assert float(want.abs().max()) > 0.0
    blocks = (args[-1].numel() - 1) * block_n
    most = min(spamm_mm.MAX_COLUMN_SLICES, tile // 16)
    sms_for = {1: 1, most: 10 ** 6}
    if most == 4:
        sms_for[2] = blocks
    for slices, sms in sms_for.items():
        monkeypatch.setattr(spamm_mm, "_num_sms", lambda _dev, s=sms: s)
        before = spamm_mm.int8_launches
        got = spamm_mm.spamm_mm_worklist_int8_cuda(*args, **kw)
        geo = dict(spamm_mm.last_geometry)
        again = spamm_mm.spamm_mm_worklist_int8_cuda(*args, **kw)
        torch.cuda.synchronize()
        assert spamm_mm.int8_launches == before + 2
        assert geo["column_slices"] == slices
        assert geo["blocks"] == blocks * slices
        if tile == 64:
            assert geo["mma"] == "wgmma"
            assert geo["threads"] == spamm_mm.WGMMA_THREADS
            assert geo["stages"] == spamm_mm.WGMMA_STAGES
        else:
            assert geo["mma"] == "mma.sync"
            assert geo["threads"] == 2 * tile
            assert geo["stages"] == spamm_mm.PIPELINE_STAGES[torch.int8]
        assert torch.equal(got, want), (slices, float((got - want).abs().max()))
        assert torch.equal(got, again)


def test_int8_kernel_raises_on_misaligned_codes(dev):
    """The 16-byte copies need 16-byte aligned codes: an int8 view that
    starts 4 bytes past a boundary (the old kernel's 4-byte alignment)
    raises ValueError, for either operand."""
    tile = 64
    args = _int8_args(_rand((tile, 2 * tile), 64, dev),
                      _rand((2 * tile, tile), 65, dev), tile)
    a_q, b_q = args[:2]

    def shifted(t):
        buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=dev)
        view = buf[4:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 == 4
        return view

    for codes in ((shifted(a_q), b_q), (a_q, shifted(b_q))):
        with pytest.raises(ValueError, match="aligned"):
            spamm_mm.spamm_mm_worklist_int8_cuda(*codes, *args[2:], tile=tile)
    with pytest.raises(ValueError, match="contiguous"):
        spamm_mm.spamm_mm_worklist_int8_cuda(a_q, b_q.t().contiguous().t(),
                                             *args[2:], tile=tile)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_plan_execute_take_a_transposed_weight_on_card(dev, dtype):
    """plan() and execute() on a transposed (non-contiguous) weight on the
    card: the same plan and output as the contiguous call, bit for bit,
    through the kernels (which themselves refuse strided operands)."""
    tile = 64
    x = _rand((2 * tile, 5 * tile), 66, dev)
    w = _rand((3 * tile, 5 * tile), 67, dev).t()
    assert not w.is_contiguous()
    # the median product at the widened gate: part of the tiles survive
    tau = _median_tau(x, w.contiguous(), tile) / (
        1.0 - Q.gate_eps(dtype, tile)) ** 2
    before = (getnorm.launches + getnorm.quant_launches, spamm_mm.launches
              + spamm_mm.bf16_launches + spamm_mm.int8_launches)
    p = P.plan(x, w, tau, tile=tile, backend="cuda", compute_dtype=dtype)
    c = P.execute(p, x, w)
    torch.cuda.synchronize()
    assert (getnorm.launches + getnorm.quant_launches, spamm_mm.launches
            + spamm_mm.bf16_launches + spamm_mm.int8_launches) == (
        before[0] + 2, before[1] + 1)
    wc = w.contiguous()
    ref = P.plan(x, wc, tau, tile=tile, backend="cuda", compute_dtype=dtype)
    for mine, theirs in zip(p.work, ref.work):
        assert torch.equal(mine, theirs)
    assert 0.0 < float(p.valid_fraction) < 1.0
    assert torch.equal(c, P.execute(ref, x, wc))


def test_lowp_kernels_reject_what_they_do_not_take(dev):
    args = _int8_case(64, 1, dev)
    a_q, b_q, a_s, b_s, *tables = args
    with pytest.raises(TypeError):               # mixed operand types
        spamm_mm.spamm_mm_worklist_cuda(a_q.float().bfloat16(), b_q.float(),
                                        *tables, tile=64)
    with pytest.raises(TypeError):               # codes must be int8
        spamm_mm.spamm_mm_worklist_int8_cuda(a_q.float(), b_q, a_s, b_s,
                                             *tables, tile=64)
    with pytest.raises(ValueError):              # b_scale per fine tile
        spamm_mm.spamm_mm_worklist_int8_cuda(a_q, b_q, a_s, b_s[:, :1],
                                             *tables, tile=64)
    with pytest.raises(ValueError):
        spamm_mm.spamm_mm_worklist_int8_cuda(a_q, b_q, a_s, b_s, *tables,
                                             tile=48)
    with pytest.raises(TypeError):
        getnorm.tile_norms_quant_cuda(a_q, 64)
    with pytest.raises(ValueError):              # mma needs tile % 16
        getnorm.tile_norms_quant_cuda(a_s.new_zeros(48, 96), 24,
                                      use_mxu=True)


@pytest.mark.parametrize("block_n", [1, 2])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_frozen_lowp_equals_eager_on_card(dev, dtype, block_n):
    """Low-precision frozen ≡ eager bit for bit on the card, through the
    fused get-norm and the int8 / bf16 work-list kernels."""
    tile = 64
    x = _rand((3 * tile, 5 * tile), 19, dev)
    w = _rand((5 * tile, 4 * tile), 20, dev)
    tau = _median_tau(x, w, tile)
    counts = (getnorm.quant_launches, spamm_mm.int8_launches,
              spamm_mm.bf16_launches)
    eager = P.plan(x, w, tau, tile=tile, block_n=block_n, backend="cuda",
                   compute_dtype=dtype)
    fw = FrozenWeight.build(w, tau, tile=tile, block_n=block_n,
                            backend="cuda", compute_dtype=dtype)
    frozen = P.plan(x, frozen_weight=fw.for_rows(3))
    assert frozen.tau == eager.tau < tau
    assert int(eager.valid_tiles) == int(frozen.valid_tiles) > 0
    c = P.execute(frozen, x, w)
    assert torch.equal(P.execute(eager, x, w), c)
    torch.cuda.synchronize()
    if dtype == "int8":
        assert getnorm.quant_launches == counts[0] + 4
        assert spamm_mm.int8_launches == counts[1] + 2
    else:
        assert spamm_mm.bf16_launches == counts[2] + 2


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_lowp_gate_keeps_every_f32_tile_on_card(dev, dtype):
    tile = 64
    a = _rand((4 * tile, 6 * tile), 21, dev)
    b = _rand((6 * tile, 5 * tile), 22, dev)
    tau = _median_tau(a, b, tile)
    f32 = P.plan(a, b, tau, tile=tile, backend="cuda").mask
    low = P.plan(a, b, tau, tile=tile, backend="cuda",
                 compute_dtype=dtype).mask
    assert bool((low | ~f32).all())


def test_spamm_int8_valid_ratio_on_card(dev):
    """spamm(valid_ratio, compute_dtype="int8"): the search on the fused
    kernel's norms reaches its ratio within the search's tolerance."""
    n = 1024
    a = torch.as_tensor(S.algebraic_decay(n, seed=0), device=dev)
    b = torch.as_tensor(S.algebraic_decay(n, seed=1), device=dev)
    before = (getnorm.quant_launches, spamm_mm.int8_launches)
    c, info = S.spamm(a, b, valid_ratio=0.3, tile=64, compute_dtype="int8")
    torch.cuda.synchronize()
    assert abs(float(info.valid_fraction) - 0.3) <= 0.01
    assert (getnorm.quant_launches, spamm_mm.int8_launches) == (
        before[0] + 2, before[1] + 1)
    assert bool(torch.isfinite(c).all())


# ---------------------------------------------------------------------------
# the tensor-core get-norm (use_mxu=True, paper Eq. 3-4)
# ---------------------------------------------------------------------------

def _mxu_operand(kind, shape, seed, dev):
    """A random operand, or one whose magnitudes decay away from the
    diagonal over four orders of magnitude (tile norms far apart)."""
    x = _rand(shape, seed, dev)
    if kind == "decaying":
        m, n = shape
        d = (torch.arange(m, device=dev)[:, None] * (n / m)
             - torch.arange(n, device=dev)[None, :]).abs()
        x = x * torch.exp(-d * (9.0 / max(m, n)))
    return x.contiguous()


@pytest.mark.parametrize("kind", ["random", "decaying"])
@pytest.mark.parametrize("tile", [16, 32, 64])
def test_mxu_tile_norms_kernels_match_plain(dev, tile, kind):
    """Both tensor-core kernels against their plain versions within
    NORM_RTOL (the TF32 hi/lo split keeps about 2^-22 per element), with
    non-square tile grids; scales bit for bit; each launch counted apart
    from the CUDA-core variant."""
    for shape in ((3 * tile, 5 * tile), (tile, 4 * tile)):
        x = _mxu_operand(kind, shape, 23, dev)
        before = (getnorm.launches, getnorm.mxu_launches,
                  getnorm.quant_launches, getnorm.quant_mxu_launches)
        got = getnorm.tile_norms(x, tile, use_mxu=True)
        norms, scales = getnorm.tile_norms_quant(x, tile, use_mxu=True)
        torch.cuda.synchronize()
        assert (getnorm.launches, getnorm.mxu_launches,
                getnorm.quant_launches, getnorm.quant_mxu_launches) == (
            before[0], before[1] + 1, before[2], before[3] + 1)
        torch.testing.assert_close(
            got, getnorm.tile_norms_plain(x, tile, use_mxu=True),
            rtol=NORM_RTOL, atol=0)
        pn, ps = getnorm.tile_norms_quant_plain(x, tile, use_mxu=True)
        torch.testing.assert_close(norms, pn, rtol=NORM_RTOL, atol=0)
        assert torch.equal(scales, ps)


@pytest.mark.parametrize("tile", [16, 32, 64])
def test_mxu_fused_equals_unfused_on_card(dev, tile):
    """Fused ≡ unfused bit for bit under use_mxu=True: both kernels sum
    through one device function."""
    x = _rand((4 * tile, 6 * tile), 24, dev)
    x[:tile, :tile] = 0.0
    norms, scales = getnorm.tile_norms_quant_cuda(x, tile, use_mxu=True)
    q, s = Q.quantize_tiles(x, tile)
    assert torch.equal(scales, s)
    assert torch.equal(norms, getnorm.tile_norms_cuda(
        Q.dequantize_tiles(q, s, tile), tile, use_mxu=True))
    assert float(norms[0, 0]) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_frozen_equals_eager_with_mxu_norms_on_card(dev, dtype):
    """Frozen ≡ eager bit for bit when both sides take the tensor-core
    norms."""
    tile = 64
    x = _rand((3 * tile, 5 * tile), 25, dev)
    w = _rand((5 * tile, 4 * tile), 26, dev)
    tau = _median_tau(x, w, tile)
    eager = P.plan(x, w, tau, tile=tile, backend="cuda", use_mxu_norm=True,
                   compute_dtype=dtype)
    fw = FrozenWeight.build(w, tau, tile=tile, backend="cuda", use_mxu=True,
                            compute_dtype=dtype)
    frozen = P.plan(x, frozen_weight=fw.for_rows(3), use_mxu_norm=True)
    assert torch.equal(frozen.norm_a, eager.norm_a)
    assert torch.equal(fw.levels[0], eager.norm_b)
    assert 0 < int(eager.valid_tiles) == int(frozen.valid_tiles)
    assert torch.equal(P.execute(eager, x, w), P.execute(frozen, x, w))



@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("tile", [16, 32, 48, 64, 80])
def test_mxu_pair_at_every_tile_and_load_path_on_card(dev, tile, aligned):
    """The tensor-core pair at the templated tiles (16, 32, 64) and at tiles
    the runtime-tile kernels take (48, 80), on 16-byte and on 4-byte loads,
    with an all-zero tile, at non-square grids and at grids that leave part
    of a packed block empty (5 tiles: at tile 16 the second of two
    four-tile blocks, at tile 32 the third of three two-tile blocks):
    within NORM_RTOL of the plain versions, scales ≡ the quantizer's, fused
    ≡ unfused bit for bit, two calls bit-identical, one launch per call;
    the one-float-offset view gives the aligned view's bits (4-byte loads
    fill the same registers as 16-byte ones)."""
    for shape in ((4 * tile, 6 * tile), (tile, 5 * tile), (3 * tile, 7 * tile),
                  (16 * tile, 36 * tile)):
        x = _rand(shape, 60 + tile, dev)
        x[:tile, tile:2 * tile] = 0.0
        if not aligned:
            x = _offset_view(x)
        before = (getnorm.mxu_launches, getnorm.quant_mxu_launches)
        got = getnorm.tile_norms_cuda(x, tile, use_mxu=True)
        again = getnorm.tile_norms_cuda(x, tile, use_mxu=True)
        norms, scales = getnorm.tile_norms_quant_cuda(x, tile, use_mxu=True)
        norms2, scales2 = getnorm.tile_norms_quant_cuda(x, tile, use_mxu=True)
        torch.cuda.synchronize()
        assert (getnorm.mxu_launches, getnorm.quant_mxu_launches) == (
            before[0] + 2, before[1] + 2)
        assert torch.equal(got, again)
        assert torch.equal(norms, norms2) and torch.equal(scales, scales2)
        assert float(got[0, 1]) == 0.0 and float(norms[0, 1]) == 0.0
        torch.testing.assert_close(
            got, getnorm.tile_norms_plain(x, tile, use_mxu=True),
            rtol=NORM_RTOL, atol=0)
        q, s = Q.quantize_tiles(x, tile)
        assert torch.equal(scales, s)
        dq = Q.dequantize_tiles(q, s, tile)
        if not aligned:
            dq = _offset_view(dq)
        assert torch.equal(norms, getnorm.tile_norms_cuda(dq, tile,
                                                          use_mxu=True))
        pn, ps = getnorm.tile_norms_quant_plain(x, tile, use_mxu=True)
        assert torch.equal(scales, ps)
        torch.testing.assert_close(norms, pn, rtol=NORM_RTOL, atol=0)
        if not aligned:
            xa = x.contiguous().clone()
            assert xa.data_ptr() % 16 == 0
            assert torch.equal(got, getnorm.tile_norms_cuda(xa, tile,
                                                            use_mxu=True))
            assert torch.equal(norms, getnorm.tile_norms_quant_cuda(
                xa, tile, use_mxu=True)[0])


def test_mxu_templated_kernels_equal_the_runtime_tile_kernels_on_card(dev):
    """The templated tensor-core kernels (tiles 16, 32, 64) against the
    runtime-tile ones at the same tile, on both load paths: the library
    built with every tile sent to `*_mxu_any_*` (the ablation's
    mxu_runtime variant) gives the same norms and scales bit for bit."""
    from repro_torch.kernels import build
    from repro_torch.launch import ablate_getnorm as A

    table = A.variants((build.CSRC / "getnorm.cu").read_text())
    libs = A.build_variants(["mxu_runtime"], table)
    cases = []
    for tile in (16, 32, 64):
        x = _rand((3 * tile, 5 * tile), 70 + tile, dev)
        x[tile:2 * tile, :tile] = 0.0
        cases += [(x, tile), (_offset_view(x), tile)]
    want = [(getnorm.tile_norms_cuda(x, t, use_mxu=True),
             *getnorm.tile_norms_quant_cuda(x, t, use_mxu=True))
            for x, t in cases]
    try:
        A.use_library(libs["mxu_runtime"])
        got = [(getnorm.tile_norms_cuda(x, t, use_mxu=True),
                *getnorm.tile_norms_quant_cuda(x, t, use_mxu=True))
               for x, t in cases]
        torch.cuda.synchronize()
    finally:
        getnorm._LIB = None
    for (x, t), g, w in zip(cases, got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b), (t, x.data_ptr() % 16)


# ---------------------------------------------------------------------------
# the serving engine's step graphs (reduced starcoder2-7b, tile 16)
# ---------------------------------------------------------------------------

GRAPH_TILE = 16
GRAPH_MIX = (5, 16, 23, 9, 12, 30)


@pytest.fixture(scope="module")
def served():
    """Reduced starcoder2-7b on the card (random weights, seed 0) and a τ
    at the median of the gate products of a τ = 0 chunked run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.models import model as M

    cfg = get_config("starcoder2-7b").reduced()
    pcfg = ParallelConfig(compute_dtype="float32", attn_q_chunk=8)
    params = M.init_params(cfg, pcfg, 0, device="cuda")
    products = []
    orig = P._plan_frozen

    def recording(a, fp, **kw):
        p = orig(a, fp, **kw)
        prod = p.norm_a[fp.step_i, fp.step_k] * fp.nbmax[fp.step_k, fp.step_j]
        products.append(prod[fp.step_real].cpu())
        return p

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(P, "_plan_frozen", recording)
        eng = _graph_engine(cfg, pcfg, params, 0.0, "float32", "chunked")
        eng.cuda_graphs = False
        _graph_run(eng, _graph_prompts(cfg, "chunked"))
    tau = float(torch.cat(products).median())
    return cfg, pcfg, params, tau


def _graph_prompts(cfg, plane):
    lengths = (16,) * 3 if plane == "wave" else GRAPH_MIX
    rng = np.random.default_rng(5)
    return [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in lengths]


def _graph_engine(cfg, pcfg, params, tau, dtype, plane, max_slots=2,
                  obs=None):
    from repro_torch.configs import SpammConfig
    from repro_torch.serving.engine import Engine

    sc = SpammConfig(enable=True, tau=tau, tile=GRAPH_TILE, dtype=dtype)
    kw = ({} if plane == "wave"
          else {"prefill_chunk": GRAPH_TILE, "max_slots": max_slots})
    return Engine(cfg, pcfg, params, max_len=64, spamm_cfg=sc, obs=obs,
                  **kw)


def _timing_free(sp):
    """A wave's spamm stats without its host-clock measurements: no
    latency block, and of the cost residual only the predicted seconds."""
    sp = {k: v for k, v in sp.items() if k != "latency"}
    if "cost_residual" in sp:
        sp["cost_residual"] = {ph: c["predicted_s"]
                               for ph, c in sp["cost_residual"].items()}
    return sp


def _graph_run(eng, prompts, max_new=4):
    """One wave: tokens, the logits of every decode and chunk step, the
    spamm stats, and each launch counter's growth."""
    from repro_torch.serving import graphs as G
    from repro_torch.serving.engine import Request

    logits = []
    orig = G.StepGraph.__call__

    def logged(self, **values):
        out = orig(self, **values)
        logits.append(out["logits"].clone())
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(G.StepGraph, "__call__", logged)
        before = G.read_counters()
        reqs = [Request(prompt=p, max_new_tokens=max_new) for p in prompts]
        toks = [o.tolist() for o in eng.generate(reqs)]
        torch.cuda.synchronize()
        counts = [a - b for a, b in zip(G.read_counters(), before)]
    return toks, logits, reqs[0].out["spamm"], counts


@pytest.mark.parametrize("plane", ["wave", "chunked"])
@pytest.mark.parametrize("dtype,gated", [("float32", False),
                                         ("float32", True),
                                         ("int8", True),
                                         ("bfloat16", True)],
                         ids=["f32-tau0", "f32", "int8", "bf16"])
def test_graphed_engine_equals_eager_on_card(served, plane, dtype, gated):
    """One engine serves a wave eagerly, then as CUDA graphs (the first
    graphed wave captures, the second only replays): tokens, the logits of
    every decode and chunk step and the spamm stats bit for bit, and every
    kernel launch counter grows as in the eager wave."""
    cfg, pcfg, params, tau = served
    eng = _graph_engine(cfg, pcfg, params, tau if gated else 0.0, dtype,
                        plane)
    prompts = _graph_prompts(cfg, plane)
    eng.cuda_graphs = False
    _graph_run(eng, prompts)
    eager = _graph_run(eng, prompts)
    eng.cuda_graphs = True
    captured = _graph_run(eng, prompts)
    replayed = _graph_run(eng, prompts)
    stats = eng.graph_stats()
    assert stats["captures"] == (2 if plane == "chunked" else 1)
    assert stats["pool_bytes"] is None or stats["pool_bytes"] > 0
    sp = eager[2]
    if gated:
        assert 0.0 < sp["decode_valid_fraction"] < 1.0
    for run in (captured, replayed):
        assert run[0] == eager[0]
        assert len(run[1]) == len(eager[1])
        for got, want in zip(run[1], eager[1]):
            assert torch.equal(got, want)
        assert _timing_free(run[2]) == _timing_free(sp)
        assert run[3] == eager[3]
    assert sum(eager[3]) > 0


@pytest.mark.parametrize("plane", ["wave", "chunked"])
def test_obs_on_and_off_graphed_bit_identical_on_card(served, plane):
    """Graphed waves with obs on and with obs=False: tokens, every step's
    logits and launch counts bit for bit, the same gating stats (obs=False
    has no latency block and no cost channel), the same device nodes per
    replayed step (labels and cost terms are host values), no span off;
    and the graphed per_layer is the eager one's."""
    cfg, pcfg, params, tau = served
    prompts = _graph_prompts(cfg, plane)
    engines = {"on": _graph_engine(cfg, pcfg, params, tau, "float32", plane),
               "off": _graph_engine(cfg, pcfg, params, tau, "float32", plane,
                                    obs=False)}
    runs = {}
    for name, eng in engines.items():
        _graph_run(eng, prompts)                  # captures
        runs[name] = _graph_run(eng, prompts)     # replays
    on, off = runs["on"], runs["off"]
    assert on[0] == off[0] and on[3] == off[3] and len(on[1]) == len(off[1])
    for a, b in zip(on[1], off[1]):
        assert torch.equal(a, b)
    assert "latency" in on[2] and "cost_residual" in on[2]
    assert "latency" not in off[2] and "cost_residual" not in off[2]
    assert off[2] == {k: v for k, v in on[2].items()
                      if k not in ("latency", "cost_residual")}
    assert engines["off"].obs.tracer.events == []
    keys = [k for k in engines["on"]._steps if k[1]]
    assert keys and keys == [k for k in engines["off"]._steps if k[1]]
    for k in keys:
        nodes = [engines[n]._steps[k].nodes() for n in ("on", "off")]
        assert nodes[0] == nodes[1] > 0, (k, nodes)
    engines["on"].cuda_graphs = False
    eager = _graph_run(engines["on"], prompts)
    assert eager[2]["per_layer"] == on[2]["per_layer"]
    assert len(on[2]["per_layer"]) == cfg.num_layers


def test_graph_captures_bounded_by_ladder_on_card(served):
    """A sweep of six (batch, prompt length) shapes through one graphed
    chunked engine captures at most len(bucket_ladder(6, 1)) graphs per
    step kind."""
    from repro_torch.core.cost import bucket_ladder

    cfg, pcfg, params, tau = served
    eng = _graph_engine(cfg, pcfg, params, tau, "float32", "chunked",
                        max_slots=None)
    rng = np.random.default_rng(8)
    shapes = [(1, 5), (2, 16), (3, 23), (4, 9), (5, 12), (6, 30)]
    for b, plen in shapes:
        prompts = [rng.integers(1, cfg.vocab, plen).astype(np.int32)
                   for _ in range(b)]
        toks, *_ = _graph_run(eng, prompts, max_new=2)
        assert all(len(t) == 2 for t in toks)
    ladder = len(bucket_ladder(6, 1))
    assert eng.trace_counts["prefill"] <= ladder
    assert eng.trace_counts["decode"] <= ladder
    assert eng.graph_stats()["captures"] == sum(eng.trace_counts.values())


def test_capture_with_a_host_sync_raises_on_card(served):
    """A gated op that reads a value on the host (`.item()`) runs eagerly,
    but makes the capture fail, and the failure raises: nothing falls back
    to the eager step. In a child process, so a failed capture cannot
    touch the other tests' CUDA context."""
    import os
    import subprocess
    import sys

    code = """
import numpy as np, torch
from repro_torch.configs import ParallelConfig, SpammConfig, get_config
from repro_torch.core import plan as P
from repro_torch.models import model as M
from repro_torch.serving.engine import Engine, Request
orig = P._frozen_step_flags
def syncing(fp, active):
    active.sum().item()
    return orig(fp, active)
P._frozen_step_flags = syncing
cfg = get_config("starcoder2-7b").reduced()
pcfg = ParallelConfig(compute_dtype="float32", attn_q_chunk=8)
params = M.init_params(cfg, pcfg, 0)
eng = Engine(cfg, pcfg, params, max_len=64,
             spamm_cfg=SpammConfig(enable=True, tau=0.0, tile=16))
reqs = lambda: [Request(prompt=np.arange(1, 17, dtype=np.int32),
                        max_new_tokens=3)]
eng.cuda_graphs = False
print("EAGER", len(eng.generate(reqs())[0]))
eng.cuda_graphs = True
try:
    eng.generate(reqs())
except Exception as e:
    print("RAISED", type(e).__name__)
else:
    print("NO ERROR")
"""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert "EAGER 3" in res.stdout, res.stdout + res.stderr
    assert "RAISED" in res.stdout, res.stdout + res.stderr


# ---------------------------------------------------------------------------
# calibration, padded N at the tuner's block_n, autotuned serving
# ---------------------------------------------------------------------------

def test_calibrate_on_card(dev):
    """The card's sweep at a caller's serving shapes: calibrated; finite,
    positive coefficients (a column NNLS zeroes keeps its nominal value);
    every sample timed and predicted finitely; the device gate rate over
    the sweep's gated shapes. Without a sweep it raises."""
    from repro_torch.core import cost

    sweep = cost.CardSweep({"wq": (1024, 1024), "w1": (1024, 4096),
                            "w2": (4096, 1024)}, prefill_rows=256,
                           decode_rows=4)
    report = {}
    c = cost.calibrate("cuda", sweep=sweep, report=report)
    assert c.calibrated
    vals = np.asarray(c[:5], np.float64)
    assert np.isfinite(vals).all() and (vals > 0).all()
    assert all(np.isfinite(s["predicted_s"]) for s in report["samples"])
    assert report["backend"] == "cuda"
    assert report["device_kind"] == torch.cuda.get_device_name(0)
    kinds = [s["kind"] for s in report["samples"]]
    assert kinds.count("getnorm") == 2 + len(cost.CUDA_NORM_SQUARES)
    assert kinds.count("frozen_worklist") == 2 * 2 * len(
        cost.CUDA_TAU_QUANTILES)
    assert all(s["shape"][1:] == [1024, 4096] for s in report["samples"]
               if s["kind"] == "frozen_worklist")
    assert all(s["measured_s"] > 0 for s in report["samples"])
    assert len(report["gate"]) == 2 * len(sweep.gemms)
    assert 1 <= report["columns_kept"] <= 4
    with pytest.raises(ValueError, match="sweep"):
        cost.calibrate("cuda")


@pytest.mark.parametrize("block_n", [2, 4])
def test_frozen_worklist_on_a_padded_n_equals_plain_on_card(dev, block_n):
    """codeqwen1.5-7b's w1 width: d_ff 13440 is 210 tiles of 64, so block_n
    2 fits and 4 pads to 212 tiles. The frozen gated GEMM (kernel) equals
    the same plan through the plain work-list, and the padded columns of
    the output are zero."""
    from repro_torch.core import module as Mod

    tile, k, n = 64, 512, 13440
    x = _rand((2 * tile, k), 20, dev)
    w = _rand((k, n), 21, dev).mul_(k ** -0.5)
    tau = _median_tau(x, w, tile)
    fw = FrozenWeight.build(w, tau, tile=tile, block_n=block_n,
                            backend="cuda")
    assert fw.padded == (k, -(-n // (tile * block_n)) * tile * block_n)
    fp = fw.for_rows(x.shape[0] // tile)
    p = P.plan(x, frozen_weight=fp)
    assert 0.0 < float(p.valid_fraction) < 1.0
    wp = P.pad_to_tile(w, tile, tile * block_n).contiguous()
    w_ = p.work
    args = (x, wp, w_.step_i, w_.step_j, w_.step_k, w_.step_flags, w_.runs)
    before = spamm_mm.launches
    got = spamm_mm.spamm_mm_worklist(*args, tile=tile, block_n=block_n)
    torch.cuda.synchronize()
    assert spamm_mm.launches == before + 1
    want = spamm_mm.spamm_mm_worklist_plain(*args, tile=tile,
                                            block_n=block_n)
    torch.testing.assert_close(got, want, rtol=MM_TOL, atol=MM_TOL)
    assert not got[:, n:].any()
    y = Mod.spamm_linear_frozen(x, w, fp)
    assert y.shape == (x.shape[0], n) and torch.equal(y, got[:, :n])


def test_autotuned_serving_graphed_equals_eager_on_card(dev, tmp_path):
    """Reduced codeqwen1.5-7b (SwiGLU, QKV bias) frozen at the tuner's
    picks (a profile under which they differ from the defaults): one
    engine serves the wave eagerly, then as CUDA graphs, bit for bit, on
    both planes; every artifact is frozen at its tuned block_n."""
    from repro_torch.configs import ParallelConfig, SpammConfig, get_config
    from repro_torch.core import cost
    from repro_torch.models import model as M
    from repro_torch.plans.precompute import frozen_leaves
    from repro_torch.serving.engine import Engine

    cfg = get_config("codeqwen1.5-7b").reduced()
    pcfg = ParallelConfig(compute_dtype="float32", attn_q_chunk=8)
    params = M.init_params(cfg, pcfg, 0, device="cuda")
    prof = cost.CostProfile()
    prof.put("cuda", cost.CostCoeffs(1e9, 1e9, 1e-12, 1e-6, 1e15,
                                     calibrated=True))
    path = prof.save(str(tmp_path / "profile.json"))
    for plane in ("wave", "chunked"):
        sc = SpammConfig(enable=True, tau=1.9, tile=GRAPH_TILE,
                         autotune=True, tune_profile=path)
        kw = ({} if plane == "wave"
              else {"prefill_chunk": GRAPH_TILE, "max_slots": 2})
        eng = Engine(cfg, pcfg, params, max_len=64, spamm_cfg=sc, **kw)
        prompts = _graph_prompts(cfg, plane)
        eng.cuda_graphs = False
        _graph_run(eng, prompts)
        eager = _graph_run(eng, prompts)
        eng.cuda_graphs = True
        _graph_run(eng, prompts)
        graphed = _graph_run(eng, prompts)
        fws = list(frozen_leaves(eng._fw_tree))
        assert len(fws) == 7 * cfg.num_layers
        assert all(fw.tuned is not None and fw.block_n == fw.tuned.block_n
                   for fw in fws)
        assert sum(eng.gm_histogram.values()) > 0
        assert graphed[0] == eager[0] and len(graphed[1]) == len(eager[1])
        for got, want in zip(graphed[1], eager[1]):
            assert torch.equal(got, want)
        assert _timing_free(graphed[2]) == _timing_free(eager[2])
        assert graphed[3] == eager[3] and sum(eager[3]) > 0


# ---------------------------------------------------------------------------
# the MoE block and the MoE family's engine (reduced qwen2-moe-a2.7b)
# ---------------------------------------------------------------------------

def _moe_case(dev, tokens, seed=0):
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MoE

    cfg = get_config("qwen2-moe-a2.7b").reduced()
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = MoE.moe_params(gen, cfg.moe, cfg.d_model, torch.float32, dev)
    x = torch.randn(2, tokens, cfg.d_model, generator=gen, device=dev)
    return cfg, MoE, p, x


@pytest.mark.parametrize("tokens", [1, 16])
def test_moe_dispatch_graphed_equals_eager_on_card(dev, tokens):
    """The routing tables, the load-balance loss and the dense block's
    output of one CUDA graph, replayed on new inputs copied into its static
    input, equal an eager call on those inputs bit for bit (no host read
    inside: the capture would raise), and two eager calls agree (the
    combine has a fixed order)."""
    cfg, MoE, p, x = _moe_case(dev, tokens)
    m = cfg.moe
    cap = MoE.capacity(x.shape[0] * x.shape[1], m)

    def body(xs):
        xt = xs.reshape(-1, cfg.d_model)
        return (*MoE._dispatch(xt, p["router"], m, cap),
                *MoE.moe_block(p, xs, m, cfg.act))

    static = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body(static)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = body(static)
    for seed in (1, 2):
        _, _, _, new = _moe_case(dev, tokens, seed)
        static.copy_(new)
        g.replay()
        eager = body(new)
        again = body(new)
        torch.cuda.synchronize()
        for a, b, c in zip(outs, eager, again):
            assert torch.equal(a, b) and torch.equal(b, c)
    assert outs[6].shape == x.shape and torch.isfinite(outs[6]).all()


@pytest.mark.parametrize("plane", ["wave", "chunked"])
@pytest.mark.parametrize("bmm", [None, True, False],
                         ids=["dense", "moe_bmm", "per_expert"])
def test_moe_engine_graphed_equals_eager_on_card(dev, plane, bmm):
    """Reduced qwen2-moe-a2.7b: one engine serves a wave eagerly, then with
    its steps captured, bit for bit (tokens, every step's logits, stats,
    launches). Decode steps are captured; chunk steps are captured with
    SpAMM off and run eagerly with SpAMM on, as `out["graphs"]` reports;
    with moe_bmm the dense-grid kernel runs in every gated prefill."""
    from repro_torch.configs import ParallelConfig, SpammConfig, get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine

    cfg = get_config("qwen2-moe-a2.7b").reduced()
    pcfg = ParallelConfig(compute_dtype="float32", attn_q_chunk=8)
    params = M.init_params(cfg, pcfg, 0, device="cuda")
    sc = (None if bmm is None else
          SpammConfig(enable=True, tau=12.0, tile=GRAPH_TILE, moe_bmm=bmm))
    kw = ({} if plane == "wave"
          else {"prefill_chunk": GRAPH_TILE, "max_slots": 2})
    eng = Engine(cfg, pcfg, params, max_len=64, spamm_cfg=sc, **kw)
    prompts = _graph_prompts(cfg, plane)
    eng.cuda_graphs = False
    _graph_run(eng, prompts)
    eager = _graph_run(eng, prompts)
    eng.cuda_graphs = True
    _graph_run(eng, prompts)
    graphed = _graph_run(eng, prompts)
    assert eng.step_graphs == {"decode": True, "chunk": bmm is None}
    caps = [k for k, s in eng._steps.items() if k[1] and s.capture]
    kinds = {k[0][0] for k in caps}
    assert "wave" in kinds or "slots" in kinds
    assert ("chunk" in kinds) == (plane == "chunked" and bmm is None)
    assert graphed[0] == eager[0] and len(graphed[1]) == len(eager[1])
    for got, want in zip(graphed[1], eager[1]):
        assert torch.equal(got, want)
    if bmm is not None:
        assert _timing_free(graphed[2]) == _timing_free(eager[2])
        assert 0.0 < graphed[2]["valid_fraction"] < 1.0
    assert graphed[3] == eager[3]
    dense_launches = graphed[3][-1]         # spamm_mm.dense_launches
    assert (dense_launches > 0) == bool(bmm)


def test_valid_fractions_divide_exactly_on_card(dev):
    """A valid fraction is the reference's correctly rounded f32 quotient
    on the card too (a CUDA tensor divided by a Python number is multiplied
    by its reciprocal: 42240 · fl(1/42240) < 1): n / n is 1 for every tile
    count tried, and spamm_bmm at τ = 0 on qwen2-moe-a2.7b's expert grid
    (60 × 1 × 22 × 32 = 42240 tiles) keeps every tile at fraction 1."""
    counts = range(1, 50_001, 7)
    got = torch.stack([P._fraction(torch.tensor(n, device=dev), n)
                       for n in counts])
    assert bool((got == 1.0).all())
    assert float(P._fraction(torch.tensor(12345, device=dev), 42240)) == \
        float(np.float32(12345) / np.float32(42240))
    x = _rand((60, 64, 2048), 40, dev)
    w = _rand((60, 2048, 1408), 41, dev)
    _, info = P.spamm_bmm(x, w, 0.0, tile=64)
    assert float(info.valid_fraction) == 1.0


# the recurrent families (reduced): mamba2-1.3b's SSM stack, recurrentgemma's
# hybrid at 3 layers and at 5 (one group plus a two-layer tail)
RECURRENT = {"mamba2": ("mamba2-1.3b", None),
             "recurrentgemma": ("recurrentgemma-9b", None),
             "recurrentgemma_tail": ("recurrentgemma-9b", 5)}
# the card's f32 run against the CPU's plain run of the same model: matmuls
# blocked and transcendentals rounded differently, relative to the output's
# largest magnitude (the bound the CPU tests hold against the reference)
DEVICE_RTOL = 1e-5


def _recurrent_model(name, device):
    import dataclasses

    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.models import model as M

    arch, layers = RECURRENT[name]
    cfg = get_config(arch).reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    pcfg = ParallelConfig(compute_dtype="float32", attn_q_chunk=8)
    return cfg, pcfg, M.init_params(cfg, pcfg, 0, device=device)


def _median_gate_tau(eng, prompts):
    """The median of every gate product an eager wave at the engine's τ
    evaluates."""
    products = []
    orig = P._plan_frozen

    def recording(a, fp, **kw):
        p = orig(a, fp, **kw)
        prod = p.norm_a[fp.step_i, fp.step_k] * fp.nbmax[fp.step_k, fp.step_j]
        products.append(prod[fp.step_real].cpu())
        return p

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(P, "_plan_frozen", recording)
        _graph_run(eng, prompts)
    return float(torch.cat(products).median())


@pytest.mark.parametrize("name", list(RECURRENT))
def test_recurrent_engine_graphed_equals_eager_on_card(dev, name):
    """A recurrent stack's decode step replayed as a CUDA graph ≡ the same
    step run eagerly, bit for bit (tokens, every step's logits, stats,
    launches): the step writes its recurrent state and conv history into
    the static cache in place, so the replays carry it. The cache's state
    tensors stay the same buffers, and a wave leaves them as the eager wave
    did. The hybrid stack gates at the median product τ; mamba2 has no
    gated GEMM, so its wave launches no get-norm or work-list kernel."""
    from repro_torch.configs import SpammConfig
    from repro_torch.serving.engine import Engine

    cfg, pcfg, params = _recurrent_model(name, "cuda")
    prompts = _graph_prompts(cfg, "wave")
    sc = SpammConfig(enable=True, tau=0.0, tile=GRAPH_TILE)
    tau = 12.0
    if name != "mamba2":
        probe = Engine(cfg, pcfg, params, max_len=64, spamm_cfg=sc)
        probe.cuda_graphs = False
        tau = _median_gate_tau(probe, prompts)
    eng = Engine(cfg, pcfg, params, max_len=64,
                 spamm_cfg=SpammConfig(enable=True, tau=tau,
                                       tile=GRAPH_TILE))
    eng.cuda_graphs = False
    _graph_run(eng, prompts)
    eager = _graph_run(eng, prompts)
    cache = eng._caches[("wave", len(prompts))]["layers"]
    state_of = [{k: v for k, v in c.items() if k in ("state", "h", "conv")}
                for c in cache]
    after_eager = [{k: v.clone() for k, v in c.items()} for c in state_of]
    ptrs = [{k: v.data_ptr() for k, v in c.items()} for c in state_of]
    eng.cuda_graphs = True
    _graph_run(eng, prompts)
    graphed = _graph_run(eng, prompts)
    assert eng.graph_stats()["captures"] == 1
    assert graphed[0] == eager[0] and len(graphed[1]) == len(eager[1]) > 0
    for got, want in zip(graphed[1], eager[1]):
        assert torch.equal(got, want)
    assert _timing_free(graphed[2]) == _timing_free(eager[2])
    assert graphed[3] == eager[3]
    assert any(c for c in state_of)
    for c, want, ptr in zip(state_of, after_eager, ptrs):
        assert {k: v.data_ptr() for k, v in c.items()} == ptr
        for k, v in c.items():
            assert torch.equal(v, want[k]), k
            assert bool(v.ne(0).any()), k
    sp = graphed[2]
    if name == "mamba2":
        assert sp["gated_gemms"] == sp["decode_gated_gemms"] == 0
        assert sum(graphed[3]) == 0
    else:
        assert 0.0 < sp["decode_valid_fraction"] < 1.0
        assert sum(graphed[3]) > 0


@pytest.mark.parametrize("name", list(RECURRENT))
def test_recurrent_card_run_matches_the_cpu_plain_run(dev, name):
    """The same reduced model (weights made on the CPU, copied to the card)
    through the prefill step and three decode steps on the card and on the
    CPU (the plain versions): logits and every layer's cache within
    DEVICE_RTOL."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine

    cfg, pcfg, params = _recurrent_model(name, "cpu")

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, d) for v in tree]
        return tree.to(d)

    cparams = to(params, dev)
    prompts = torch.as_tensor(np.random.default_rng(7).integers(
        1, cfg.vocab, size=(2, 24)).astype(np.int32))
    pre, dec = M.make_prefill_step(cfg, pcfg), M.make_decode_step(cfg, pcfg)

    def close(got, want):
        got, want = got.cpu().float(), want.float()
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= DEVICE_RTOL, err

    def padded(cache, p, d):
        """The prefill's caches in the engine's decode cache."""
        return Engine(cfg, pcfg, p, max_len=64, device=d)._pad_cache(
            cache, M.init_cache(cfg, pcfg, 2, 64, device=d))

    with torch.inference_mode():
        cache, logits = pre(params, {"tokens": prompts})
        ccache, clogits = pre(cparams, {"tokens": prompts.to(dev)})
        close(clogits, logits)
        cache = padded(cache, params, "cpu")
        ccache = padded(ccache, cparams, dev)
        tok = logits.argmax(-1)[:, None]
        for t in range(3):
            logits, cache = dec(params, tok, cache, 24 + t)
            clogits, ccache = dec(cparams, tok.to(dev), ccache, 24 + t)
            close(clogits, logits)
            for a, b in zip(ccache["layers"], cache["layers"]):
                for k in a:
                    close(a[k], b[k])
            tok = logits.argmax(-1)[:, None]


# ---------------------------------------------------------------------------
# training: the gated GEMM's backward products on the card
# ---------------------------------------------------------------------------

def _spamm_counts():
    return getnorm.launches, spamm_mm.launches


@pytest.mark.parametrize("block_n", [1, 2])
def test_backward_products_on_transposed_views_on_card(dev, block_n):
    """bwd="spamm" on the card: the dx product g @ wᵀ (B a transposed view
    of the weight) and the dW product xᵀ @ g (A a transposed view of the
    activations), each against the work-list kernel's plain version on the
    same operands and plan; the Function's launches (forward 2 get-norms +
    1 work-list, backward 1 + 2) and its gradients against the same
    Function on the CPU with the plain versions. N = 200 pads to the
    forward's tile·block_n grid."""
    from repro_torch.core import module as mod

    f32_numerics()
    tile = 64
    x = _rand((256, 384), 40, dev) * 0.1
    w = _rand((384, 200), 41, dev) * 0.05
    g = _rand((256, 200), 42, dev) * 0.1
    nx = getnorm.tile_norms_cuda(x, tile)
    nw = getnorm.tile_norms_cuda(P.pad_to_tile(w, tile, tile * block_n)
                                 .contiguous(), tile)
    gp = P.pad_to_tile(g, tile, tile * block_n).contiguous()
    ng = getnorm.tile_norms_cuda(gp, tile)
    dx_prods = (ng[:, None, :] * nw[None]).flatten()
    dw_prods = (nx.T[:, None, :] * ng.T[None]).flatten()
    wp = P.pad_to_tile(w, tile, tile * block_n)
    p_dx = P.plan(gp, None, float(dx_prods.median()), norm_b=nw.T, tile=tile,
                  backend="cuda")
    p_dw = P.plan(None, None, float(dw_prods.median()), norm_a=nx.T,
                  norm_b=ng, tile=tile, backend="cuda")
    for p, a, b in ((p_dx, gp, wp.T), (p_dw, x.T, gp)):
        assert not (a.is_contiguous() and b.is_contiguous())
        assert 0.0 < float(p.valid_fraction) < 1.0
        got = P.execute(p, a, b)
        wk = p.work
        want = spamm_mm.spamm_mm_worklist_plain(
            a.contiguous(), b.contiguous(), wk.step_i, wk.step_j, wk.step_k,
            wk.step_flags, wk.runs, tile=tile)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=MM_TOL, atol=MM_TOL)
        assert torch.equal(got, P.execute(p, a, b))  # deterministic

    tau = float(torch.cat([dx_prods, dw_prods]).median())
    grads = []
    for d in (dev, torch.device("cpu")):
        xs = x.detach().to(d).requires_grad_()
        ws = w.detach().to(d).requires_grad_()
        before = _spamm_counts()
        y = mod.spamm_linear(xs, ws, tau, tile, "auto", "spamm", block_n)
        y.backward(g.to(d))
        if d.type == "cuda":
            torch.cuda.synchronize()
            n0, m0 = _spamm_counts()
            assert (n0 - before[0], m0 - before[1]) == (3, 3)
        grads.append((y.detach().cpu(), xs.grad.cpu(), ws.grad.cpu()))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=MM_TOL, atol=MM_TOL)


def test_tau0_spamm_train_step_equals_dense_on_card(dev):
    """One train step of a reduced starcoder2-7b at its full width's tile
    (64) on the card: τ = 0 with bwd="spamm" against SpAMM off from the
    same parameters — the loss within 1e-5, the moments (the clipped
    gradients) within 1e-3 of each leaf's largest magnitude, the updated
    parameters too except where a gradient is within 1e-3 of 0 (AdamW's
    normalized step can take either sign there; it stays ≤ 2·lr) — and 3
    get-norm and 3 work-list launches per gated GEMM (remat "none")."""
    import dataclasses

    from repro_torch import tree as T
    from repro_torch.configs import (ParallelConfig, SpammConfig,
                                     TrainConfig, get_config)
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamW

    f32_numerics()
    cfg = dataclasses.replace(get_config("starcoder2-7b").reduced(),
                              d_model=128, d_ff=256, head_dim=32)
    pcfg = ParallelConfig(remat="none", loss_chunk=64)
    opt = AdamW(TrainConfig(lr=1e-3, warmup=1, total_steps=4))
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        1, cfg.vocab, size=(2, 129)).astype(np.int32), device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = []
    for sc in (None, SpammConfig(enable=True, tau=0.0, tile=64,
                                 backend="cuda", bwd="spamm")):
        params = M.init_params(cfg, pcfg, 0, device=dev)
        state = opt.init(params)
        before = _spamm_counts()
        params, state, met = M.make_train_step(cfg, pcfg, opt,
                                               spamm_cfg=sc)(
            params, state, batch, 0)
        torch.cuda.synchronize()
        after = _spamm_counts()
        out.append((params, state, met,
                    (after[0] - before[0], after[1] - before[1])))
    (p0, s0, m0, c0), (p1, s1, m1, c1) = out
    gated = int(m1["spamm_gated_gemms"])
    assert gated == 6 * cfg.num_layers and c0 == (0, 0)
    assert c1 == (3 * gated, 3 * gated)
    assert float(m1["spamm_valid_fraction"]) == 1.0
    assert abs(float(m1["loss"]) - float(m0["loss"])) <= 1e-5 * float(
        m0["loss"])
    for got, want in ((s1["mu"], s0["mu"]), (s1["nu"], s0["nu"])):
        for a, b in zip(T.leaves(got), T.leaves(want)):
            err = float((a - b).abs().max() / b.abs().max().clamp(
                min=1e-30))
            assert err <= 1e-3, err
    for a, b, m in zip(T.leaves(p1), T.leaves(p0), T.leaves(s0["mu"])):
        d = (a.detach() - b.detach()).abs()
        off = d > 1e-3 * b.abs().max()
        small = m.abs() < 1e-3 * m.abs().max()
        assert bool(small[off].all()) and float(d.max()) <= 2e-3


# ---------------------------------------------------------------------------
# the multi-GPU slice on one card
# ---------------------------------------------------------------------------

def test_rowpart_on_a_one_rank_nccl_mesh_equals_flat_on_card(dev):
    """spamm_rowpart and spamm_2d on a 1×1 mesh over NCCL (world size 1:
    the collectives run on the card) ≡ the flat spamm() bit for bit."""
    from repro_torch.core import distributed as D
    from repro_torch.launch import mesh as MS

    a = torch.as_tensor(S.exponential_decay(512, lam=0.6, seed=0), device=dev)
    b = torch.as_tensor(S.exponential_decay(512, lam=0.6, seed=1), device=dev)
    c_flat, info = S.spamm(a, b, 0.02, tile=64)
    MS.init_group("nccl", rank=0, world_size=1, addr="localhost",
                  port=MS.free_port(), device=torch.device("cuda", 0))
    try:
        mesh = MS.make_host_mesh(backend="nccl", device_type="cuda")
        for sched in ("contiguous", "cyclic", "equal_work", "auto"):
            c, frac = D.spamm_rowpart(a, b, 0.02, mesh, tile=64,
                                      schedule=sched)
            assert torch.equal(c, c_flat), sched
            assert float(frac) == float(info.valid_fraction)
        c2, _ = D.spamm_2d(a, b, 0.02, mesh, tile=64)
        assert torch.equal(c2, c_flat)
    finally:
        MS.destroy_group()


def _sharded(served, **kw):
    from repro_torch.configs import SpammConfig
    from repro_torch.serving.engine import Engine

    cfg, pcfg, params, tau = served
    return Engine(cfg, pcfg, params, max_len=64,
                  spamm_cfg=SpammConfig(enable=True, tau=tau,
                                        tile=GRAPH_TILE), **kw)


def _shard_prompts(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, 16).astype(np.int32)
            for _ in range(b)]


def test_sharded_engine_graphed_equals_eager_and_unsharded_on_card(served):
    """Engine(mesh_devices=2, devices=[cuda:0] × 2): graphed ≡ eager
    (tokens, every shard step's logits, stats, launches) ≡ the unsharded
    engine's tokens, each shard's decode step one capture."""
    cfg = served[0]
    prompts = _shard_prompts(cfg, 4 * GRAPH_TILE, 7)
    ref = _graph_run(_sharded(served), prompts)
    eng = _sharded(served, mesh_devices=2,
                   devices=[torch.device("cuda", 0)] * 2)
    eng.cuda_graphs = False
    _graph_run(eng, prompts)           # freezes the weights
    eager = _graph_run(eng, prompts)
    eng.cuda_graphs = True
    captured = _graph_run(eng, prompts)
    replayed = _graph_run(eng, prompts)
    assert eng.graph_stats()["captures"] == 2
    assert eager[0] == ref[0]
    for run in (captured, replayed):
        assert run[0] == eager[0]
        assert len(run[1]) == len(eager[1])
        for got, want in zip(run[1], eager[1]):
            assert torch.equal(got, want)
        assert _timing_free(run[2]) == _timing_free(eager[2])
        assert run[3] == eager[3]


def test_sharded_recut_without_recapture_on_card(served, monkeypatch):
    """Re-cuts between and within waves (every engine step, drift
    threshold 1.0; the embedding's hot/cold rows put the probe's norm
    products at 4τ and τ/25, and a growing share of each wave's prompts
    is hot) move requests between the shards and copy the new tables into
    the captured steps: the capture count stays one per shard and width,
    tokens ≡ unsharded."""
    from repro_torch import tree as T
    from repro_torch.core.schedule import ReshardConfig
    from repro_torch.serving.engine import Engine

    cfg, pcfg, params, tau = served
    params = T.map_(torch.clone, params)
    emb = params["embed"]["embedding"]
    base = (float(getnorm.tile_norms_cuda(emb[:(cfg.vocab // 16) * 16],
                                          16).median())
            * float(getnorm.tile_norms_cuda(params["unembed"]["kernel"],
                                            16).median()))
    half = cfg.vocab // 2
    scale = torch.full((cfg.vocab, 1), 0.04 * tau / base, device="cuda")
    scale[half:] = 4 * tau / base
    emb.mul_(scale)
    served = (cfg, pcfg, params, tau)
    moves = []
    orig = Engine._refresh_shard

    def refresh(self):
        src = orig(self)
        if src is not None:
            moves.append(tuple(int(x) for x in self._shard["offs_g"]))
        return src

    monkeypatch.setattr(Engine, "_refresh_shard", refresh)
    ref = _sharded(served)
    eng = _sharded(served, mesh_devices=2,
                   devices=[torch.device("cuda", 0)] * 2,
                   reshard_cfg=ReshardConfig(every=1, drift_threshold=1.0,
                                             probe_window=8))
    caps = []
    for seed, b in ((1, 4), (2, 6), (3, 6), (4, 6)):
        rng = np.random.default_rng(seed)
        hot = b * GRAPH_TILE * seed // 8
        prompts = [rng.integers(half, cfg.vocab, 16).astype(np.int32)
                   if i < hot else
                   rng.integers(1, half, 16).astype(np.int32)
                   for i in range(b * GRAPH_TILE)]
        assert _graph_run(eng, prompts)[0] == _graph_run(ref, prompts)[0]
        caps.append(eng.graph_stats()["captures"])
    assert caps == [2, 4, 4, 4], caps
    assert len(moves) >= 2, (moves, eng._resharder.history)


# ---------------------------------------------------------------------------
# the gated GEMMs at tiles above 64: K-chunked sub-tile walks
# ---------------------------------------------------------------------------

LARGE_TILES = (128, 256, 512)


def _refined(mask, r, block_n, dev):
    """Step tables and runs of the same gate at the sub-tile (tile / r,
    block_n 1): every kept T-level (i, j, k) becomes its r × r·block_n
    output sub-blocks, each with the r sub-tile k's of k in ascending order
    — the same fmaf (f32) and k16 (bf16) order per element as the chunked
    walk, so the sub-tile kernel on these tables is its oracle bit for
    bit."""
    m = mask.cpu().numpy()
    fine = np.repeat(np.repeat(np.repeat(m, r, 0), r * block_n, 1), r, 2)
    ii, jj, kk = np.nonzero(fine)
    work, _ = P.compact_from_triples(ii, jj, kk, gm=fine.shape[0],
                                     gn=fine.shape[1], gk=fine.shape[2])
    return tuple(torch.as_tensor(getattr(work, n), device=dev)
                 for n in ("step_i", "step_j", "step_k", "step_flags",
                           "runs"))


def _large_case(tile, block_n, dev, seed, gm=2, gk=3, gn=2):
    a = _rand((gm * tile, gk * tile), seed, dev)
    b = _rand((gk * tile, gn * block_n * tile), seed + 1, dev)
    p = P.plan(a, b, _median_tau(a, b, tile), tile=tile, block_n=block_n,
               backend="cuda")
    assert 0.0 < float(p.valid_fraction) < 1.0
    w = p.work
    return a, b, p, (w.step_i, w.step_j, w.step_k, w.step_flags, w.runs)


@pytest.mark.parametrize("block_n", [1, 2])
@pytest.mark.parametrize("tile", LARGE_TILES)
def test_large_tile_f32_worklist_and_dense_grid_on_card(dev, tile, block_n):
    """Rows 2 and 6 at tile T > 64: the chunked f32 kernel within MM_TOL of
    its plain version (fmaf against multiply-add) and bit for bit the
    tile-64 kernel on the refined tables; the dense-grid kernel ≡ the
    work-list kernel bit for bit; the launch geometry has T/64 row bands
    and column sub-blocks."""
    a, b, p, tables = _large_case(tile, block_n, dev, 70)
    kw = {"tile": tile, "block_n": block_n}
    before = (spamm_mm.launches, spamm_mm.dense_launches)
    got = spamm_mm.spamm_mm_worklist(a, b, *tables, **kw)
    geo = dict(spamm_mm.last_geometry)
    kidx, nvalid = ref.spamm_compact_ref(p.mask)
    dense = spamm_mm.spamm_mm(a, b, kidx, nvalid, **kw)
    torch.cuda.synchronize()
    assert (spamm_mm.launches, spamm_mm.dense_launches) == (before[0] + 1,
                                                            before[1] + 1)
    r = tile // 64
    assert (geo["sub_tile"], geo["row_bands"],
            geo["column_sub_blocks"]) == (64, r, r)
    assert geo["blocks"] == ((tables[4].numel() - 1) * block_n * r * r
                             * geo["column_slices"])
    assert float(got.abs().max()) > 0.0
    assert _max_rel(got, spamm_mm.spamm_mm_worklist_plain(a, b, *tables,
                                                          **kw)) <= MM_TOL
    fine = spamm_mm.spamm_mm_worklist_cuda(
        a, b, *_refined(p.mask, r, block_n, dev), tile=64)
    assert torch.equal(got, fine)
    assert torch.equal(dense, got)
    assert _max_rel(dense, spamm_mm.spamm_mm_plain(a, b, kidx, nvalid,
                                                   **kw)) <= MM_TOL


@pytest.mark.parametrize("block_n", [1, 2])
@pytest.mark.parametrize("tile", LARGE_TILES)
def test_large_tile_bf16_worklist_on_card(dev, tile, block_n):
    """Row 2 bf16 at T > 64: within MM_TOL of the f32 kernel on the rounded
    operands and of its plain version, deterministic, and bit for bit the
    tile-64 bf16 kernel on the refined tables (the f32 fragments carry
    across the chunks in the same k16 order)."""
    a, b, p, tables = _large_case(tile, block_n, dev, 72)
    ab, bb = a.bfloat16(), b.bfloat16()
    kw = {"tile": tile, "block_n": block_n}
    before = spamm_mm.bf16_launches
    got = spamm_mm.spamm_mm_worklist(ab, bb, *tables, **kw)
    again = spamm_mm.spamm_mm_worklist(ab, bb, *tables, **kw)
    torch.cuda.synchronize()
    assert spamm_mm.bf16_launches == before + 2
    assert torch.equal(got, again)
    f32 = spamm_mm.spamm_mm_worklist_cuda(ab.float(), bb.float(), *tables,
                                          **kw)
    assert _max_rel(got, f32) <= MM_TOL
    assert _max_rel(got, spamm_mm.spamm_mm_worklist_plain(
        ab, bb, *tables, **kw)) <= MM_TOL
    fine = spamm_mm.spamm_mm_worklist_cuda(
        ab, bb, *_refined(p.mask, tile // 64, block_n, dev), tile=64)
    assert torch.equal(got, fine)


@pytest.mark.parametrize("block_n", [1, 2])
@pytest.mark.parametrize("tile", LARGE_TILES)
def test_large_tile_int8_worklist_equals_plain_on_card(dev, tile, block_n):
    """Row 5 at T > 64: one s32 dot over all T columns of a step, scaled
    once by the step's T-tile scales: ≡ the plain version bit for bit,
    and within 1e-5 of the f32 kernel on the dequantized operands."""
    a = _rand((2 * tile, 3 * tile), 74, dev)
    b = _rand((3 * tile, 2 * block_n * tile), 75, dev)
    args = _int8_args(a, b, tile, block_n)
    kw = {"tile": tile, "block_n": block_n}
    before = spamm_mm.int8_launches
    got = spamm_mm.spamm_mm_worklist_int8(*args, **kw)
    torch.cuda.synchronize()
    assert spamm_mm.int8_launches == before + 1
    assert spamm_mm.last_geometry["row_bands"] == tile // 64
    want = spamm_mm.spamm_mm_worklist_int8_plain(*args, **kw)
    assert float(want.abs().max()) > 0.0
    assert torch.equal(got, want)
    a_q, b_q, a_s, b_s = args[:4]
    f32 = spamm_mm.spamm_mm_worklist_cuda(
        Q.dequantize_tiles(a_q, a_s, tile), Q.dequantize_tiles(b_q, b_s, tile),
        *args[4:], **kw)
    assert float((got - f32).abs().max()) <= 1e-5 * float(f32.abs().max())


@pytest.mark.parametrize("tile", [80, 96, 192])
def test_other_sub_tiles_on_card(dev, tile):
    """Tiles walked with a 16- or 32-wide sub-tile (80 = 5·16, 96 = 3·32)
    and 192 = 3·64: f32 ≡ the sub-tile kernel on the refined tables, int8
    ≡ plain, bit for bit."""
    a, b, p, tables = _large_case(tile, 1, dev, 76)
    sub = spamm_mm.sub_tile(tile)
    got = spamm_mm.spamm_mm_worklist_cuda(a, b, *tables, tile=tile)
    assert spamm_mm.last_geometry["sub_tile"] == sub
    fine = spamm_mm.spamm_mm_worklist_cuda(
        a, b, *_refined(p.mask, tile // sub, 1, dev), tile=sub)
    assert torch.equal(got, fine)
    args = _int8_args(a, b, tile)
    assert torch.equal(spamm_mm.spamm_mm_worklist_int8_cuda(*args, tile=tile),
                       spamm_mm.spamm_mm_worklist_int8_plain(*args,
                                                             tile=tile))


# the wgmma kernels (csrc/spamm_wgmma.cu): bf16 and int8 at every tile that
# is a multiple of 64
WGMMA_TILES = (64, 128, 256, 512)


def _force_slices(monkeypatch, blocks, slices):
    """Make `column_slices` pick `slices` for a launch of `blocks` blocks
    (1, 2 or 4) by the SM count it sees."""
    sms = {1: 0, 2: blocks, 4: 10 ** 6}[slices]
    monkeypatch.setattr(spamm_mm, "_num_sms", lambda _dev, s=sms: s)


@pytest.mark.parametrize("block_n", [1, 2])
@pytest.mark.parametrize("tile", WGMMA_TILES)
def test_wgmma_int8_equals_plain_at_every_tile_and_slice_count_on_card(
        dev, monkeypatch, tile, block_n):
    """Row 5 on `wgmma`: ≡ the plain version bit for bit at tiles 64–512,
    block_n 1 and 2, and 1, 2 and 4 column slices; the launches count the
    wgmma kernel and `last_geometry` names its family."""
    a = _rand((2 * tile, 3 * tile), 90, dev)
    b = _rand((3 * tile, 2 * block_n * tile), 91, dev)
    args = _int8_args(a, b, tile, block_n)
    kw = {"tile": tile, "block_n": block_n}
    want = spamm_mm.spamm_mm_worklist_int8_plain(*args, **kw)
    assert float(want.abs().max()) > 0.0
    bands = tile // 64
    pieces = tile // max(w for w in (16, 32, 64, 128, 256) if tile % w == 0 and
                         w <= spamm_mm.WGMMA_MAX_WIDTH[torch.int8])
    blocks = (args[-1].numel() - 1) * block_n * bands * pieces
    for slices in (1, 2, 4):
        _force_slices(monkeypatch, blocks, slices)
        before = spamm_mm.int8_launches
        got = spamm_mm.spamm_mm_worklist_int8(*args, **kw)
        geo = dict(spamm_mm.last_geometry)
        torch.cuda.synchronize()
        assert spamm_mm.int8_launches == before + 1
        assert (geo["mma"], geo["column_slices"]) == ("wgmma", slices)
        assert geo["blocks"] == blocks * slices
        assert torch.equal(got, want), (slices,
                                        float((got - want).abs().max()))


@pytest.mark.parametrize("tile", WGMMA_TILES)
def test_wgmma_bf16_tolerance_determinism_frozen_on_card(dev, tile):
    """Row 2 bf16 on `wgmma`: within MM_TOL of the output's largest
    magnitude against the plain version, two launches bit-equal, frozen ≡
    eager bit for bit."""
    x = _rand((2 * tile, 3 * tile), 92, dev)
    w = _rand((3 * tile, 2 * tile), 93, dev)
    tau = _median_tau(x, w, tile)
    eager = P.plan(x, w, tau, tile=tile, backend="cuda",
                   compute_dtype="bfloat16")
    wk = eager.work
    tables = (wk.step_i, wk.step_j, wk.step_k, wk.step_flags, wk.runs)
    xb, wb = x.bfloat16(), w.bfloat16()
    before = spamm_mm.bf16_launches
    got = spamm_mm.spamm_mm_worklist(xb, wb, *tables, tile=tile)
    assert spamm_mm.last_geometry["mma"] == "wgmma"
    again = spamm_mm.spamm_mm_worklist(xb, wb, *tables, tile=tile)
    torch.cuda.synchronize()
    assert spamm_mm.bf16_launches == before + 2
    assert torch.equal(got, again)
    assert float(got.abs().max()) > 0.0
    assert _max_rel(got, spamm_mm.spamm_mm_worklist_plain(
        xb, wb, *tables, tile=tile)) <= MM_TOL
    fw = FrozenWeight.build(w, tau, tile=tile, backend="cuda",
                            compute_dtype="bfloat16")
    frozen = P.plan(x, frozen_weight=fw.for_rows(2))
    assert torch.equal(P.execute(frozen, x, w), P.execute(eager, x, w))


@pytest.mark.parametrize("tile", [192, 320])
def test_wgmma_at_odd_multiples_of_64_on_card(dev, tile):
    """Tiles 3·64 and 5·64 run `wgmma` in pieces of 64 columns (the widest
    power of two dividing them), each cut into the launch's slices: bf16
    within MM_TOL of its plain version, int8 ≡ plain bit for bit."""
    a, b, _, tables = _large_case(tile, 1, dev, 94)
    ab, bb = a.bfloat16(), b.bfloat16()
    got = spamm_mm.spamm_mm_worklist_cuda(ab, bb, *tables, tile=tile)
    geo = spamm_mm.last_geometry
    assert (geo["mma"], geo["column_sub_blocks"]) == ("wgmma", tile // 64)
    assert geo["width"] * geo["column_slices"] == 64
    assert _max_rel(got, spamm_mm.spamm_mm_worklist_plain(
        ab, bb, *tables, tile=tile)) <= MM_TOL
    args = _int8_args(a, b, tile)
    assert torch.equal(spamm_mm.spamm_mm_worklist_int8_cuda(*args, tile=tile),
                       spamm_mm.spamm_mm_worklist_int8_plain(*args,
                                                             tile=tile))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_wgmma_captured_replay_equals_eager_on_card(dev, dtype):
    """A CUDA graph of a `wgmma` launch (its tensor maps captured by value)
    replays to the eager output bit for bit, on new operand values in the
    same buffers too."""
    tile = 64
    a = _rand((2 * tile, 4 * tile), 95, dev)
    b = _rand((4 * tile, 2 * tile), 96, dev)
    if dtype == "int8":
        args = _int8_args(a, b, tile)

        def call():
            return spamm_mm.spamm_mm_worklist_int8_cuda(*args, tile=tile)
    else:
        w = P.plan(a, b, _median_tau(a, b, tile), tile=tile,
                   backend="cuda").work
        args = (a.bfloat16(), b.bfloat16(), w.step_i, w.step_j, w.step_k,
                w.step_flags, w.runs)

        def call():
            return spamm_mm.spamm_mm_worklist_cuda(*args, tile=tile)
    eager = call()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = call()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    args[0].copy_(args[0].flip(0))
    g.replay()
    fresh = call()
    torch.cuda.synchronize()
    assert not torch.equal(fresh, eager)
    assert torch.equal(out, fresh)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_wgmma_raises_on_misaligned_operands_on_card(dev, dtype):
    """TMA needs 16-byte aligned bases: a contiguous view 4 bytes off a
    boundary raises ValueError before any launch, for either operand."""
    tile = 64
    a = _rand((tile, 2 * tile), 97, dev)
    b = _rand((2 * tile, tile), 98, dev)
    if dtype == "int8":
        args = list(_int8_args(a, b, tile))
        fn = spamm_mm.spamm_mm_worklist_int8_cuda
    else:
        w = P.plan(a, b, 0.0, tile=tile, backend="cuda").work
        args = [a.bfloat16(), b.bfloat16(), w.step_i, w.step_j, w.step_k,
                w.step_flags, w.runs]
        fn = spamm_mm.spamm_mm_worklist_cuda

    def shifted(t):
        pad = 4 // t.element_size()
        buf = torch.empty(t.numel() + pad, dtype=t.dtype, device=dev)
        view = buf[pad:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 == 4
        return view

    before = (spamm_mm.bf16_launches, spamm_mm.int8_launches)
    for i in (0, 1):
        bad = list(args)
        bad[i] = shifted(bad[i])
        with pytest.raises(ValueError, match="aligned"):
            fn(*bad, tile=tile)
    assert (spamm_mm.bf16_launches, spamm_mm.int8_launches) == before


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_wgmma_max_width_maps_and_mma_sync_counts_on_card(dev, dtype):
    """At tile 128 a launch capped at max_width 32 runs column pieces of
    32 and agrees with the plain version as the default width does (int8
    bit for bit, bf16 within 1e-4); the same operands again after their
    contents change in place (the host's cached tensor maps, keyed by
    address and shape) agree with the plain version on the new contents;
    only the launches at tile 32 (`mma.sync`) add to the mma_sync
    counters."""
    fam = {"bfloat16": "bf16", "int8": "int8"}[dtype]

    def case(tile):
        a = _rand((2 * tile, 3 * tile), 91, dev)
        b = _rand((3 * tile, 2 * tile), 92, dev)
        if dtype == "int8":
            return (list(_int8_args(a, b, tile)),
                    spamm_mm.spamm_mm_worklist_int8_cuda,
                    spamm_mm.spamm_mm_worklist_int8_plain)
        w = P.plan(a, b, _median_tau(a, b, tile), tile=tile,
                   backend="cuda").work
        return ([a.bfloat16(), b.bfloat16(), w.step_i, w.step_j, w.step_k,
                 w.step_flags, w.runs], spamm_mm.spamm_mm_worklist_cuda,
                spamm_mm.spamm_mm_worklist_plain)

    def agrees(got, want):
        return (torch.equal(got, want) if dtype == "int8"
                else _max_rel(got, want) <= 1e-4)

    def counts():
        return (getattr(spamm_mm, f"{fam}_launches"),
                getattr(spamm_mm, f"{fam}_mma_sync_launches"))

    args, fn, plain = case(128)
    before = counts()
    default = fn(*args, tile=128)
    pieces = spamm_mm.last_geometry["column_sub_blocks"]
    capped = fn(*args, tile=128, max_width=32)
    geo = dict(spamm_mm.last_geometry)
    want = plain(*args, tile=128)
    assert geo["mma"] == "wgmma" and geo["column_sub_blocks"] == 4 > pieces
    assert geo["width"] <= 32
    assert agrees(default, want) and agrees(capped, want)
    args[0].copy_(args[0].flip(0))
    again = fn(*args, tile=128)
    assert agrees(again, plain(*args, tile=128))
    assert not torch.equal(again, default)
    assert counts() == (before[0] + 3, before[1])
    args, fn, plain = case(32)
    got = fn(*args, tile=32)
    assert spamm_mm.last_geometry["mma"] == "mma.sync"
    assert agrees(got, plain(*args, tile=32))
    assert counts() == (before[0] + 4, before[1] + 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("tile", LARGE_TILES)
def test_large_tile_frozen_equals_eager_on_card(dev, tile, dtype):
    """Frozen ≡ eager bit for bit at T > 64, at every dtype."""
    x = _rand((2 * tile, 3 * tile), 78, dev)
    w = _rand((3 * tile, 2 * tile), 79, dev)
    tau = _median_tau(x, w, tile)
    eager = P.plan(x, w, tau, tile=tile, backend="cuda", compute_dtype=dtype)
    fw = FrozenWeight.build(w, tau, tile=tile, backend="cuda",
                            compute_dtype=dtype)
    frozen = P.plan(x, frozen_weight=fw.for_rows(2))
    assert int(eager.valid_tiles) == int(frozen.valid_tiles) > 0
    c = P.execute(frozen, x, w)
    assert float(c.abs().max()) > 0.0
    assert torch.equal(P.execute(eager, x, w), c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_large_tile_flag_patterns_on_card(dev, dtype):
    """At tile 128: a run of 600 steps (more than one 256-entry step-list
    chunk) with flag-0 steps between its ACC steps, and a run of flag-0
    steps ending in a lone FLUSH, against the plain version (the
    lone-FLUSH block stays zero); int8 on the same tables bit for bit."""
    tile, gk = 128, 5
    tables = _flag_tables(tile, gk, dev)
    a = _rand((tile, gk * tile), 80, dev)
    b = _rand((gk * tile, 2 * tile), 81, dev)
    got = spamm_mm.spamm_mm_worklist_cuda(a.to(dtype), b.to(dtype), *tables,
                                          tile=tile)
    want = spamm_mm.spamm_mm_worklist_plain(a.to(dtype), b.to(dtype),
                                            *tables, tile=tile)
    torch.cuda.synchronize()
    assert _max_rel(got, want) <= MM_TOL
    assert float(got[:, :tile].abs().max()) > 0.0
    assert not bool(got[:, tile:].any())
    a_q, a_s = Q.quantize_tiles(a, tile)
    b_q, b_s = Q.quantize_tiles(b, tile)
    q = spamm_mm.spamm_mm_worklist_int8_cuda(a_q, b_q, a_s, b_s, *tables,
                                             tile=tile)
    assert torch.equal(q, spamm_mm.spamm_mm_worklist_int8_plain(
        a_q, b_q, a_s, b_s, *tables, tile=tile))
    assert not bool(q[:, tile:].any())


# the `wgmma` kernels (csrc/spamm_wgmma.cu) at the tiles from 48 that are
# not multiples of 64: a last band of T % 64 live rows, a last K-chunk of
# T % 64, a last column piece reaching past the tile
BAND_TILES = (48, 80, 96, 208)


def _band_case(tile, block_n, case, dev, seed):
    """(a, b) of a prefill (3 × 3 row and k tiles) or a decode step (4
    real rows in one row tile, 6 k tiles), 2·block_n column tiles."""
    if case == "decode":
        a = torch.zeros(tile, 6 * tile, device=dev)
        a[:4] = _rand((4, 6 * tile), seed, dev)
    else:
        a = _rand((3 * tile, 3 * tile), seed, dev)
    return a, _rand((a.shape[1], 2 * block_n * tile), seed + 1, dev)


def _band_width(blocks, tile, dtype, sms):
    """The width a `wgmma` launch of `blocks` (run, group) pairs picks on
    `sms` SMs at such a tile: at 0 the rule's own, at 10⁶ the narrowest
    (16)."""
    return spamm_mm.wgmma_geometry(blocks, tile, dtype, sms)["width"]


@pytest.mark.parametrize("case", ["prefill", "decode"])
@pytest.mark.parametrize("block_n", [1, 2])
@pytest.mark.parametrize("tile", BAND_TILES)
def test_wgmma_band_int8_equals_plain_at_every_width_on_card(
        dev, monkeypatch, tile, block_n, case):
    """Row 5 on the `wgmma` kernel at a tile that is not a multiple of 64:
    ≡ the plain version bit for bit at the width rule's own width and at
    the narrowest (16; forced through the SM count the rule sees), on a
    prefill and on a decode step; two launches are equal; the launches
    count the int8 wrapper and not its `mma.sync` kernels, the geometry
    names its family, ⌈T/64⌉ bands and ⌈T/width⌉ pieces."""
    a, b = _band_case(tile, block_n, case, dev, 110)
    args = _int8_args(a, b, tile, block_n)
    kw = {"tile": tile, "block_n": block_n}
    want = spamm_mm.spamm_mm_worklist_int8_plain(*args, **kw)
    assert float(want.abs().max()) > 0.0
    pairs = (args[-1].numel() - 1) * block_n
    for sms in (0, 10 ** 6):
        width = _band_width(pairs, tile, torch.int8, sms)
        assert width == 16 or not sms
        monkeypatch.setattr(spamm_mm, "_num_sms", lambda _dev, s=sms: s)
        before = (spamm_mm.int8_launches, spamm_mm.int8_mma_sync_launches)
        got = spamm_mm.spamm_mm_worklist_int8(*args, **kw)
        geo = dict(spamm_mm.last_geometry)
        again = spamm_mm.spamm_mm_worklist_int8(*args, **kw)
        torch.cuda.synchronize()
        assert (spamm_mm.int8_launches, spamm_mm.int8_mma_sync_launches) == (
            before[0] + 2, before[1])
        assert (geo["mma"], geo["width"]) == ("wgmma", width)
        assert geo["row_bands"] == -(-tile // 64)
        assert geo["blocks"] == pairs * geo["row_bands"] * -(-tile // width)
        assert torch.equal(got, want), (width,
                                        float((got - want).abs().max()))
        assert torch.equal(got, again)


@pytest.mark.parametrize("case", ["prefill", "decode"])
@pytest.mark.parametrize("block_n", [1, 2])
@pytest.mark.parametrize("tile", BAND_TILES)
def test_wgmma_band_bf16_tolerance_determinism_frozen_on_card(
        dev, monkeypatch, tile, block_n, case):
    """Row 2 bf16 on the `wgmma` kernel at a tile that is not a multiple of
    64, at the width rule's own width and the
    narrowest: within MM_TOL of the output's largest magnitude against the
    plain version, two launches bit-equal; frozen ≡ eager bit for bit at
    bf16 and int8 through plan and execute."""
    x, w = _band_case(tile, block_n, case, dev, 112)
    tau = _median_tau(x, w, tile)
    eager = P.plan(x, w, tau, tile=tile, block_n=block_n, backend="cuda",
                   compute_dtype="bfloat16")
    wk = eager.work
    tables = (wk.step_i, wk.step_j, wk.step_k, wk.step_flags, wk.runs)
    xb, wb = x.bfloat16(), w.bfloat16()
    kw = {"tile": tile, "block_n": block_n}
    plain = spamm_mm.spamm_mm_worklist_plain(xb, wb, *tables, **kw)
    assert float(plain.abs().max()) > 0.0
    pairs = (wk.runs.numel() - 1) * block_n
    for sms in (0, 10 ** 6):
        width = _band_width(pairs, tile, torch.bfloat16, sms)
        assert width == 16 or not sms
        monkeypatch.setattr(spamm_mm, "_num_sms", lambda _dev, s=sms: s)
        before = (spamm_mm.bf16_launches, spamm_mm.bf16_mma_sync_launches)
        got = spamm_mm.spamm_mm_worklist(xb, wb, *tables, **kw)
        geo = dict(spamm_mm.last_geometry)
        again = spamm_mm.spamm_mm_worklist(xb, wb, *tables, **kw)
        torch.cuda.synchronize()
        assert (spamm_mm.bf16_launches, spamm_mm.bf16_mma_sync_launches) == (
            before[0] + 2, before[1])
        assert (geo["mma"], geo["width"]) == ("wgmma", width)
        assert torch.equal(got, again)
        assert _max_rel(got, plain) <= MM_TOL, width
    monkeypatch.undo()
    gm = x.shape[0] // tile
    for dtype in ("bfloat16", "int8"):
        eager = P.plan(x, w, tau, tile=tile, block_n=block_n, backend="cuda",
                       compute_dtype=dtype)
        fw = FrozenWeight.build(w, tau, tile=tile, block_n=block_n,
                                backend="cuda", compute_dtype=dtype)
        frozen = P.plan(x, frozen_weight=fw.for_rows(gm))
        c = P.execute(frozen, x, w)
        assert spamm_mm.last_geometry["mma"] == "wgmma"
        assert float(c.abs().max()) > 0.0
        assert torch.equal(P.execute(eager, x, w), c), dtype


@pytest.mark.parametrize("tile", [48, 80])
def test_wgmma_band_flag_patterns_on_card(dev, tile):
    """A run longer than one step-list chunk with flag-0 steps between its
    ACC steps, and a run of flag-0 steps ending in a lone FLUSH: bf16
    within MM_TOL of the plain version, int8 ≡ plain bit for bit, the
    lone-FLUSH block zero."""
    gk = 5
    tables = _flag_tables(tile, gk, dev)
    a = _rand((tile, gk * tile), 118, dev)
    b = _rand((gk * tile, 2 * tile), 119, dev)
    ab, bb = a.bfloat16(), b.bfloat16()
    got = spamm_mm.spamm_mm_worklist_cuda(ab, bb, *tables, tile=tile)
    assert spamm_mm.last_geometry["mma"] == "wgmma"
    want = spamm_mm.spamm_mm_worklist_plain(ab, bb, *tables, tile=tile)
    assert _max_rel(got, want) <= MM_TOL
    assert float(got[:, :tile].abs().max()) > 0.0
    assert not bool(got[:, tile:].any())
    a_q, a_s = Q.quantize_tiles(a, tile)
    b_q, b_s = Q.quantize_tiles(b, tile)
    q = spamm_mm.spamm_mm_worklist_int8_cuda(a_q, b_q, a_s, b_s, *tables,
                                             tile=tile)
    assert spamm_mm.last_geometry["mma"] == "wgmma"
    assert torch.equal(q, spamm_mm.spamm_mm_worklist_int8_plain(
        a_q, b_q, a_s, b_s, *tables, tile=tile))
    assert not bool(q[:, tile:].any())


@pytest.mark.parametrize("tile", [48, 96])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_wgmma_band_captured_replay_equals_eager_on_card(dev, dtype, tile):
    """A CUDA graph of a `wgmma` launch at such a tile (its four tensor
    maps captured by
    value) replays to the eager output bit for bit, on new operand values
    in the same buffers too."""
    a = _rand((2 * tile, 4 * tile), 114, dev)
    b = _rand((4 * tile, 2 * tile), 115, dev)
    if dtype == "int8":
        args = _int8_args(a, b, tile)

        def call():
            return spamm_mm.spamm_mm_worklist_int8_cuda(*args, tile=tile)
    else:
        w = P.plan(a, b, _median_tau(a, b, tile), tile=tile,
                   backend="cuda").work
        args = (a.bfloat16(), b.bfloat16(), w.step_i, w.step_j, w.step_k,
                w.step_flags, w.runs)

        def call():
            return spamm_mm.spamm_mm_worklist_cuda(*args, tile=tile)
    eager = call()
    assert spamm_mm.last_geometry["mma"] == "wgmma"
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = call()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    args[0].copy_(args[0].flip(0))
    g.replay()
    fresh = call()
    torch.cuda.synchronize()
    assert not torch.equal(fresh, eager)
    assert torch.equal(out, fresh)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_wgmma_band_raises_on_misaligned_operands_on_card(dev, dtype):
    """TMA needs 16-byte aligned bases at tile 48 too: a
    contiguous view 4 bytes off a boundary raises ValueError before any
    launch, for either operand."""
    tile = 48
    a = _rand((tile, 2 * tile), 116, dev)
    b = _rand((2 * tile, tile), 117, dev)
    if dtype == "int8":
        args = list(_int8_args(a, b, tile))
        fn = spamm_mm.spamm_mm_worklist_int8_cuda
    else:
        w = P.plan(a, b, 0.0, tile=tile, backend="cuda").work
        args = [a.bfloat16(), b.bfloat16(), w.step_i, w.step_j, w.step_k,
                w.step_flags, w.runs]
        fn = spamm_mm.spamm_mm_worklist_cuda

    def shifted(t):
        pad = 4 // t.element_size()
        buf = torch.empty(t.numel() + pad, dtype=t.dtype, device=dev)
        view = buf[pad:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 == 4
        return view

    before = (spamm_mm.bf16_launches, spamm_mm.int8_launches)
    for i in (0, 1):
        bad = list(args)
        bad[i] = shifted(bad[i])
        with pytest.raises(ValueError, match="aligned"):
            fn(*bad, tile=tile)
    assert (spamm_mm.bf16_launches, spamm_mm.int8_launches) == before


def test_large_tile_kernels_raise_on_what_they_do_not_take(dev):
    """A tile that is not a multiple of 16 (24) or is above 512 (576)
    raises on CUDA tensors, in every wrapper, before any launch."""
    for tile in (24, 576):
        a = _rand((tile, 2 * tile), 82, dev)
        b = _rand((2 * tile, tile), 83, dev)
        w = P.plan(a, b, 0.0, tile=tile, backend="torch").work
        tables = (w.step_i, w.step_j, w.step_k, w.step_flags, w.runs)
        tables = tuple(t.to(dev) for t in tables)
        before = (spamm_mm.launches, spamm_mm.int8_launches,
                  spamm_mm.dense_launches)
        with pytest.raises(ValueError, match="multiple of 16"):
            spamm_mm.spamm_mm_worklist_cuda(a, b, *tables, tile=tile)
        a_q, a_s = Q.quantize_tiles(a, tile)
        b_q, b_s = Q.quantize_tiles(b, tile)
        with pytest.raises(ValueError, match="multiple of 16"):
            spamm_mm.spamm_mm_worklist_int8_cuda(a_q, b_q, a_s, b_s, *tables,
                                                 tile=tile)
        kidx = torch.zeros(1, 1, 2, dtype=torch.int32, device=dev)
        nvalid = torch.ones(1, 1, dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="multiple of 16"):
            spamm_mm.spamm_mm_cuda(a, b, kidx, nvalid, tile=tile)
        assert (spamm_mm.launches, spamm_mm.int8_launches,
                spamm_mm.dense_launches) == before


def _tp_engine_cases(dev):
    """The cases of `Engine(ctx=)` on two ranks of the card(s), each with
    the unsharded engine's tokens and graphs on `dev`: reduced
    starcoder2-7b on the wave plane and on the chunked plane, and reduced
    qwen2-moe-a2.7b's wave with its experts split tp and ep, all gated at
    τ = 0 at tile 16."""
    import dataclasses

    from repro_torch.configs import ParallelConfig, SpammConfig, get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    pcfg = ParallelConfig(compute_dtype="float32", attn_q_chunk=16,
                          fsdp=False)
    rng = np.random.default_rng(0)
    dense = get_config("starcoder2-7b").reduced()
    moe = get_config("qwen2-moe-a2.7b").reduced()
    wave = list(rng.integers(1, dense.vocab, size=(4, 16)).astype(np.int32))
    mixed = [rng.integers(1, dense.vocab, n).astype(np.int32)
             for n in (5, 16, 23, 9)]
    moe_wave = list(rng.integers(1, moe.vocab, size=(4, 16)).astype(
        np.int32))
    cases = {"wave": (dense, wave, {}, {}),
             "chunked": (dense, mixed, dict(prefill_chunk=16, max_slots=2),
                         {})}
    for impl in ("tp", "ep"):
        cfg = dataclasses.replace(moe, moe=dataclasses.replace(moe.moe,
                                                               impl=impl))
        cases[f"moe_{impl}"] = (cfg, moe_wave, {}, dict(moe_bmm=True))
    out = {}
    for name, (cfg, prompts, kw, skw) in cases.items():
        spamm = SpammConfig(enable=True, tau=0.0, tile=16, **skw)
        eng = Engine(cfg, pcfg, M.init_params(cfg, pcfg, 0, device=dev,
                                              model_axis_size=2),
                     max_len=64, spamm_cfg=spamm, device=dev, **kw)
        reqs = [Request(prompt=p, max_new_tokens=4) for p in prompts]
        want = [o.tolist() for o in eng.generate(reqs)]
        out[name] = (dict(cfg=cfg, pcfg=pcfg, seed=0, spamm=spamm,
                          prompts=prompts, max_new=4, kw=kw),
                     want, reqs[0].out["graphs"])
    return out


def test_tp_engine_on_gloo_ranks_of_one_card_on_card(dev):
    """`Engine(ctx=)` on 2 gloo ranks sharing cuda:0, on both planes and
    for MoE tp and ep: the unsharded engine's tokens, with the steps eager
    whatever `cuda_graphs` asks and the reason reported."""
    import torch_dist_workers as W
    from repro_torch.launch.mesh import spawn_ranks

    cases = _tp_engine_cases(dev)
    ranks = spawn_ranks(W.engine_tp_on_card, 2, backend="gloo",
                        devices=[torch.device("cuda", 0)] * 2,
                        args=({n: c[0] for n, c in cases.items()}, "gloo"),
                        timeout_s=300)
    for r in ranks:
        for name, (_, want, _) in cases.items():
            for graphs in (True, False):
                got = r[name][graphs]
                assert "error" not in got, (name, graphs, got)
                assert got["tokens"] == want, (name, graphs)
                g = got["graphs"]
                assert g["decode"] is False and g["chunk"] is False
                assert "gloo" in g["eager"]


def test_tp_engine_on_nccl_ranks_of_two_cards_on_card(dev):
    """Under nccl (one rank per card), on both planes and for MoE tp and
    ep: the steps are captured with their collectives inside, as the
    unsharded engine's are on one card, and give its tokens, graphed and
    eager."""
    if torch.cuda.device_count() < 2:
        pytest.skip(f"an nccl model group needs two cards; "
                    f"{torch.cuda.device_count()} visible")
    import torch_dist_workers as W
    from repro_torch.launch.mesh import spawn_ranks

    cases = _tp_engine_cases(dev)
    ranks = spawn_ranks(W.engine_tp_on_card, 2, backend="nccl",
                        devices=[torch.device("cuda", i) for i in range(2)],
                        args=({n: c[0] for n, c in cases.items()}, "nccl"),
                        timeout_s=300)
    for r in ranks:
        for name, (_, want, one_card) in cases.items():
            for graphs in (True, False):
                got = r[name][graphs]
                assert "error" not in got, (name, graphs, got)
                assert got["tokens"] == want, (name, graphs)
                assert got["graphs"] == (one_card if graphs else
                                         {"decode": False, "chunk": False})
            assert r[name][True]["graphs"]["decode"] is True
            assert r[name][True]["captures"] > 0

