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
from repro_torch.plans.frozen import FrozenWeight

pytestmark = pytest.mark.cuda

# tile norms: f32 sums of ≤ 4096 squares in two orders
NORM_RTOL = 1e-5
# work-list GEMM: FMA (kernel) vs multiply-add (plain) over K ≤ 384
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
    with pytest.raises(NotImplementedError):
        getnorm.tile_norms_cuda(x, 64, use_mxu=True)
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
