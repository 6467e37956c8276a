"""The port's kernel modules against the JAX reference.

The plain PyTorch versions of `tile_norms` and `spamm_mm_worklist` take the
same numpy inputs (and, for the GEMM, the same step tables from the
reference's `compact_from_triples`) as the reference's Pallas kernels run in
interpret mode. The CUDA kernels themselves only run on a card: their tests
are in test_torch_cuda.py (no JAX import, so they also run where JAX is
not installed).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as rplan
from repro.kernels import getnorm as rgetnorm
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels import spamm_mm as rmm
from repro_torch.kernels import getnorm as tgetnorm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spamm_mm as tmm

# f32 tile norms: the reductions sum in different orders, a few ulps apart
NORM_RTOL = 1e-6
# f32 GEMM over ≤ 4 tile products of depth 16: accumulation-order rounding
MM_TOL = 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape,tile,use_mxu", [
    ((64, 96), 16, False), ((128, 64), 32, False), ((64, 96), 16, True),
    ((128, 64), 32, True), ((96, 160), 32, True)])
def test_tile_norms_plain_matches_reference(shape, tile, use_mxu):
    x = _rand(shape, 0)
    want = np.asarray(rgetnorm.tile_norms(jnp.asarray(x), tile,
                                          use_mxu=use_mxu, interpret=True))
    got = tgetnorm.tile_norms_plain(torch.as_tensor(x), tile,
                                    use_mxu=use_mxu).numpy()
    np.testing.assert_allclose(got, want, rtol=NORM_RTOL)
    np.testing.assert_allclose(
        got, np.asarray(rref.tile_norms_ref(jnp.asarray(x), tile)),
        rtol=NORM_RTOL)
    # `auto` on a CPU tensor is the plain version
    assert torch.equal(tops.tile_norms(torch.as_tensor(x), tile,
                                       use_mxu=use_mxu),
                       torch.as_tensor(got))


def test_tile_norms_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tgetnorm.tile_norms_plain(torch.zeros(30, 32), 16)
    with pytest.raises(ValueError):
        tgetnorm.tile_norms_cuda(torch.zeros(32, 32), 16)  # not a CUDA tensor


def _mask(kind, gm, gnb, gk, seed):
    if kind == "empty":
        return np.zeros((gm, gnb, gk), bool)
    if kind == "full":
        return np.ones((gm, gnb, gk), bool)
    return np.random.default_rng(seed).random((gm, gnb, gk)) < 0.5


@pytest.mark.parametrize("block_n", [1, 2])
@pytest.mark.parametrize("kind", ["random", "empty", "full"])
def test_spamm_mm_worklist_plain_matches_reference(kind, block_n):
    tile, m, k, n = 16, 32, 64, 64
    gm, gk, gnb = m // tile, k // tile, n // (tile * block_n)
    a, b = _rand((m, k), 1), _rand((k, n), 2)
    ii, jj, kk = np.nonzero(_mask(kind, gm, gnb, gk, 3))
    work, _ = rplan.compact_from_triples(ii, jj, kk, gm=gm, gn=gnb, gk=gk)
    want = np.asarray(rmm.spamm_mm_worklist(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(work.step_i),
        jnp.asarray(work.step_j), jnp.asarray(work.step_k),
        jnp.asarray(work.step_flags), tile=tile, block_n=block_n,
        interpret=True))
    t = [torch.as_tensor(np.asarray(x)) for x in
         (work.step_i, work.step_j, work.step_k, work.step_flags,
          work.offsets)]
    got = tmm.spamm_mm_worklist_plain(torch.as_tensor(a), torch.as_tensor(b),
                                      *t, tile=tile, block_n=block_n).numpy()
    np.testing.assert_allclose(got, want, rtol=MM_TOL, atol=MM_TOL)
    if kind == "empty":
        assert not got.any()
    # output tiles the work-list never visits stay exactly zero
    visited = np.zeros((gm, gnb), bool)
    visited[ii, jj] = True
    tiles = got.reshape(gm, tile, gnb, tile * block_n)
    assert not tiles.transpose(0, 2, 1, 3)[~visited].any()


def test_spamm_mm_worklist_plain_honours_flags():
    """Padding steps (no bits) inside a run are skipped, and a run whose
    steps carry no ACC bit flushes explicit zeros."""
    tile = 16
    a, b = torch.as_tensor(_rand((16, 32), 4)), torch.as_tensor(_rand((32, 16), 5))
    si = torch.zeros(4, dtype=torch.int32)
    sj = torch.zeros(4, dtype=torch.int32)
    sk = torch.tensor([0, 1, 1, 1], dtype=torch.int32)
    fl = torch.tensor([tmm.STEP_INIT | tmm.STEP_ACC,
                       tmm.STEP_ACC | tmm.STEP_FLUSH, 0, 0], dtype=torch.int32)
    runs = torch.tensor([0, 4], dtype=torch.int32)
    got = tmm.spamm_mm_worklist_plain(a, b, si, sj, sk, fl, runs, tile=tile)
    torch.testing.assert_close(got, a @ b, rtol=MM_TOL, atol=MM_TOL)
    fl0 = torch.tensor([tmm.STEP_INIT, 0, 0, tmm.STEP_FLUSH], dtype=torch.int32)
    assert not tmm.spamm_mm_worklist_plain(a, b, si, sj, sk, fl0, runs,
                                           tile=tile).any()


def test_register_backend_matches_reference():
    """`register_backend`, the twin of the reference's extension hook: a
    registered backend resolves by name in both packages and drives a
    plan (here the plain entries under a new name: the same tables and
    product as the "torch" backend); VALID_BACKENDS, a tuple fixed at
    import in both, is left as it was."""
    from repro_torch.core import plan as tplan

    valid, rvalid = tops.VALID_BACKENDS, rops.VALID_BACKENDS
    mine = dataclasses.replace(tops.get_backend("torch"), name="plain_copy")
    rmine = dataclasses.replace(rops.get_backend("jnp"), name="plain_copy")
    try:
        tops.register_backend(mine)
        rops.register_backend(rmine)
        assert tops.get_backend("plain_copy") is mine
        assert rops.get_backend("plain_copy") is rmine
        assert tops.resolve_backend("plain_copy", "cpu") == "plain_copy"
        assert (tops.VALID_BACKENDS, rops.VALID_BACKENDS) == (valid, rvalid)
        a, b = (torch.as_tensor(_rand((64, 64), s)) for s in (40, 41))
        p = tplan.plan(a, b, 0.5, tile=16, backend="plain_copy")
        q = tplan.plan(a, b, 0.5, tile=16, backend="torch")
        assert p.backend == "plain_copy"
        for x, y in zip(p.work, q.work):
            assert torch.equal(x, y)
        assert torch.equal(tplan.execute(p, a, b), tplan.execute(q, a, b))
    finally:
        tops.BACKENDS.pop("plain_copy", None)
        rops.BACKENDS.pop("plain_copy", None)
