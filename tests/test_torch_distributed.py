"""The port's distributed SpAMM (`repro_torch.core.distributed`) on CPU
ranks over gloo: a 4-rank 1-D mesh and a 2×2 mesh, each one spawn (a few
seconds), against the port's flat `spamm()` (bit for bit under every row
schedule at f32) and the JAX reference (`repro.core.distributed`'s
scheduling decisions and strip tables on the same V; `spamm_2d` within
the reference test's 1e-4 of the reference's flat product)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as RD
from repro.core import spamm as rspamm
from repro_torch.core import distributed as D
from repro_torch.core import plan as tplan
from repro_torch.core import schedule as S
from repro_torch.core import spamm as tspamm
from repro_torch.launch.mesh import spawn_ranks

import torch_dist_workers as W

N, TILE, TAU = 256, 32, 0.02
RAGGED = 288            # 9 tile rows over 4 ranks
SCHEDULES = ("contiguous", "cyclic", "equal_work", "auto")
ATOL_2D = 1e-4


def _operands():
    banded = tspamm.exponential_decay(N, lam=0.6, seed=0)
    skewed = banded * np.exp(-np.arange(N) / N * 4)[:, None]
    aliased = banded.copy()
    for r in range(0, N, 4 * TILE):     # hot tile rows at the cyclic stride
        aliased[r:r + TILE] *= 8.0
    b = tspamm.exponential_decay(N, lam=0.6, seed=1)
    ragged = tspamm.exponential_decay(RAGGED, lam=0.6, seed=2)[:, :N]
    return ({"banded": banded, "skewed": skewed.astype(np.float32),
             "aliased": aliased}, b, ragged)


MATS, B, RAGGED_A = _operands()
ROW_JOBS = (
    [(name, sched, None, "float32") for name in MATS for sched in SCHEDULES]
    + [("banded", "equal_work", np.array([0, 1, 2, 5, 8]), "float32"),
       ("banded", "contiguous", None, "int8"),
       ("banded", "contiguous", None, "bfloat16"),
       ("ragged", "equal_work", None, "float32"),
       ("ragged", "auto", None, "float32")])


def _a(name):
    return RAGGED_A if name == "ragged" else MATS[name]


@pytest.fixture(scope="module")
def rowpart():
    """Every rank's results of the 4-rank spawn."""
    jobs = [(_a(name), B, TAU, TILE, sched, offs, dtype)
            for name, sched, offs, dtype in ROW_JOBS]
    return spawn_ranks(W.rowpart_jobs, 4, backend="gloo",
                       args=(jobs, 4))


@pytest.fixture(scope="module")
def mesh2d():
    jobs = [(MATS["banded"], B, TAU, TILE, sched, None)
            for sched in ("contiguous", "equal_work", "auto")]
    jobs.append((RAGGED_A, B, TAU, TILE, "equal_work", None))
    return spawn_ranks(W.mesh_2d_jobs, 4, backend="gloo", args=(jobs,))


def _flat(a, dtype="float32"):
    c, info = tspamm.spamm(torch.from_numpy(a), torch.from_numpy(B), TAU,
                           tile=TILE, backend="torch", compute_dtype=dtype)
    return c.numpy(), float(info.valid_fraction)


@pytest.mark.parametrize("job", range(len(ROW_JOBS)),
                         ids=["-".join(str(x) for x in (j[0], j[1], j[3]))
                              + ("-frozen" if j[2] is not None else "")
                              for j in ROW_JOBS])
def test_rowpart_equals_flat_bit_for_bit(rowpart, job):
    """C comes back whole on every rank and equals the flat product bit
    for bit, whatever the row schedule (gating and each output tile's k
    order do not depend on the other rows), low precision included."""
    name, sched, offs, dtype = ROW_JOBS[job]
    want, _ = _flat(_a(name), dtype)
    c0, f0 = rowpart[0][job]
    assert np.array_equal(c0, want), (name, sched, dtype,
                                      np.abs(c0 - want).max())
    for r in rowpart[1:]:
        assert np.array_equal(r[job][0], c0) and r[job][1] == f0


def test_rowpart_fraction_weights_real_rows(rowpart):
    """The mean valid fraction: each rank's fraction of its (clamp-padded)
    strip, averaged over uniform strips and weighted by the real strip
    widths over variable ones, as the reference computes it."""
    for job, (name, sched, offs, dtype) in enumerate(ROW_JOBS):
        if dtype != "float32":
            continue
        a = torch.from_numpy(_a(name))
        gm = a.shape[0] // TILE
        sched, offs = (D._pick_schedule(a, torch.from_numpy(B), TAU, 4,
                                        tile=TILE, backend="torch",
                                        sched_levels=3, offsets=offs,
                                        schedule=sched)
                       if offs is not None
                       or sched in ("auto", "equal_work")
                       else (sched, None))
        if sched == "equal_work":
            perm, _ = S.strip_tables(offs, gm, 4)
            strips = np.split(perm, 4)
            w = np.diff(offs) / gm
        else:
            order = S.device_permutation(4, gm, sched)
            strips = np.split(order, 4)
            w = np.full(4, 0.25)
        fracs = [float(tplan.plan(a.reshape(gm, TILE, -1)[
            torch.as_tensor(rows)].reshape(-1, a.shape[1]),
            torch.from_numpy(B), TAU, tile=TILE,
            backend="torch").valid_fraction) for rows in strips]
        want = float(np.dot(fracs, w))
        assert rowpart[0][job][1] == pytest.approx(want, rel=1e-6), job
        if sched != "equal_work" or len(set(np.diff(offs))) == 1:
            assert want == pytest.approx(_flat(_a(name))[1], rel=1e-6)


def test_lowp_gates_are_supersets_of_the_f32_gate():
    """Each rank's int8 and bf16 plans (its strip, the widened τ) keep
    every (i, j, k) the f32 plan keeps."""
    a = torch.from_numpy(MATS["banded"])
    b = torch.from_numpy(B)
    for rows in np.split(np.arange(N // TILE), 4):
        loc = a.reshape(-1, TILE, N)[torch.as_tensor(rows)].reshape(-1, N)

        def triples(dtype):
            p = tplan.plan(loc, b, TAU, tile=TILE, backend="torch",
                           compute_dtype=dtype)
            w = p.work
            counts = np.diff(w.offsets.numpy())
            return set(zip(np.repeat(w.rows.numpy(), counts),
                           np.repeat(w.cols.numpy(), counts),
                           w.klist.numpy()))

        f32 = triples("float32")
        for dtype in ("int8", "bfloat16"):
            assert f32 <= triples(dtype), dtype


@pytest.mark.parametrize("name", list(MATS) + ["ragged"])
def test_schedule_decisions_equal_reference(name):
    """On the reference's V: the port's auto pick, offsets and clamp-pad
    strip tables equal the reference's `_pick_schedule`/`_strip_tables`;
    the port's own estimate gives the same V."""
    a = _a(name)
    gm = a.shape[0] // TILE
    rv, lv, _ = RD._work_estimate(jnp.asarray(a), jnp.asarray(B), TAU, 4,
                                  tile=TILE, backend="jnp", sched_levels=3)
    v, tlv, tgm = D._work_estimate(torch.from_numpy(a), torch.from_numpy(B),
                                   TAU, 4, tile=TILE, backend="torch",
                                   sched_levels=3)
    assert (tlv, tgm) == (lv, gm)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    rsched, roffs = RD._pick_schedule(jnp.asarray(a), jnp.asarray(B), TAU,
                                      4, tile=TILE, backend="jnp",
                                      sched_levels=3)
    sched = S.auto_schedule(np.asarray(rv), 4, level=lv, fine_rows=gm)
    if sched != "equal_work" and gm % 4:
        sched = "equal_work"
    assert sched == rsched
    tsched, toffs = D._pick_schedule(torch.from_numpy(a),
                                     torch.from_numpy(B), TAU, 4, tile=TILE,
                                     backend="torch", sched_levels=3)
    assert tsched == rsched
    if roffs is not None:
        np.testing.assert_array_equal(toffs, roffs)
        for got, want in zip(S.strip_tables(toffs, gm, 4),
                             RD._strip_tables(roffs, gm, 4)):
            np.testing.assert_array_equal(got, want)
    else:
        assert toffs is None


def test_auto_picks_equal_reference_test():
    """The reference test's picks (`test_distributed_spamm.py`): banded
    decay → contiguous; a top-heavy A → cyclic (n 512, tile 64, 4 ranks)."""
    n, tile = 512, 64
    a = tspamm.exponential_decay(n, lam=0.6, seed=0)
    b = tspamm.exponential_decay(n, lam=0.6, seed=1)
    heavy = a.copy()
    heavy[n // 4:] *= 1e-4
    for x, want in ((a, "contiguous"), (heavy, "cyclic")):
        got = D._resolve_schedule(torch.from_numpy(x), torch.from_numpy(b),
                                  TAU, 4, tile=tile, backend="torch",
                                  sched_levels=3)
        ref = RD._resolve_schedule(jnp.asarray(x), jnp.asarray(b), TAU, 4,
                                   tile=tile, backend="jnp", sched_levels=3)
        assert got == ref == want


def test_2d_mesh_within_reference_tolerance(mesh2d):
    """spamm_2d on a 2×2 mesh (each rank gates its k-slice; partials
    reduce-scattered over "model") within 1e-4 of the reference's flat
    product; rowpart over the mesh's "data" axis stays bit for bit; the
    re-shard device count resolves from the mesh's batch axes."""
    res, rowpart_c, resolved = mesh2d[0]
    a = MATS["banded"]
    ref, _ = rspamm.spamm(jnp.asarray(a), jnp.asarray(B), TAU, tile=TILE,
                          backend="jnp")
    ref_r, _ = rspamm.spamm(jnp.asarray(RAGGED_A), jnp.asarray(B), TAU,
                            tile=TILE, backend="jnp")
    for (c, frac), want in zip(res, [ref] * 3 + [ref_r]):
        np.testing.assert_allclose(c, np.asarray(want), atol=ATOL_2D)
    _, flat_frac = _flat(a)
    assert res[0][1] == pytest.approx(flat_frac, rel=1e-6)
    assert np.array_equal(rowpart_c[0], _flat(a)[0])
    assert resolved == [2, 4]
    for other in mesh2d[1:]:
        for (c, f), (c0, f0) in zip(other[0], res):
            assert np.array_equal(c, c0) and f == f0
