"""Distributed SpAMM over a `torch.distributed` device mesh (paper §3.4 +
§3.5.1; twin of `repro.core.distributed`).

`spamm_rowpart` is the paper's multi-GPU scheme: C row-partitioned across
the ranks of one mesh axis, B replicated. `spamm_2d` goes beyond it
(SUMMA-style): rows over `row_axis`, the contraction dimension over
`col_axis`; each rank gates its local k-slice (the global gate decomposes
per k, so the union is the flat gate) and the partial products are summed
by a reduce-scatter over `col_axis`.

The call is SPMD: every rank passes the same global `a` and `b` (as every
device of the reference's mesh sees the global array), plans and executes
its own strip with `core.plan.plan`/`execute` on its own device, and gets
the whole C and the mean valid fraction back: the strips are all-gathered
(clamp-padded strips, then the real rows kept). The scheduling decision is
made from the global operands on every rank alike, so the ranks agree
without talking.

Row-strip schedules: 'contiguous' (uniform strips in storage order, §3.4),
'cyclic' (uniform strips of strided tile rows, §3.5.1), 'equal_work'
(variable-width contiguous strips of equal predicted work, from
`schedule.equal_work_partition`, or the frozen table `offsets=`, which
always routes here) and 'auto' (`schedule.auto_schedule` on a coarse
norm-pyramid estimate). Results are the same under any partition: gating
and each output tile's k order do not depend on the other rows.

Collectives: the module's only calls into `torch.distributed` are
`_all_gather` and `_reduce_scatter`, on the operands' own tensors, through
`repro_torch.compat` (the collectives' names moved between torch
versions): NCCL
for ranks on their own cards, gloo for CPU ranks or several ranks on one
card (gloo takes CUDA tensors for both collectives and stages them
through host memory itself).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import compat
from repro_torch.core import plan as _plan
from repro_torch.core import schedule as _schedule


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `x` concatenated along dim 0 in group-rank order."""
    x = x.contiguous()
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    compat.all_gather_single(out, x, group=group)
    return out


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's `x` over `group`, split along dim 0 into
    group-size chunks; rank r keeps chunk r."""
    x = x.contiguous()
    n = dist.get_world_size(group)
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    compat.reduce_scatter_single(out, x, op=dist.ReduceOp.SUM,
                                 group=group)
    return out


def _axis(mesh, axis):
    """(size, this rank's index, process group) of one mesh axis, or of a
    tuple of axes taken as one (row-major, the first the slowest: the
    reference's ("pod", "data") row axis)."""
    if isinstance(axis, (tuple, list)):
        if len(axis) > 1:
            flat = mesh[tuple(axis)]._flatten()
            return flat.size(0), flat.get_local_rank(0), flat.get_group(0)
        axis = axis[0]
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.size(dim), mesh.get_local_rank(dim), mesh.get_group(dim)


# ---------------------------------------------------------------------------
# scheduling
# ---------------------------------------------------------------------------

def _work_estimate(a, b, tau, num_devices, *, tile, backend,
                   sched_levels: int):
    """Coarse work estimate V for scheduling: (v, level, gm), V at the
    coarsest pyramid level (≤ sched_levels) that still gives every rank at
    least two coarse rows."""
    gm = a.shape[0] // tile
    lv = 0
    while lv < sched_levels and (gm >> (lv + 1)) >= 2 * num_devices:
        lv += 1
    pyr_a = _plan.NormPyramid.build(a, lv, tile=tile, backend=backend)
    pyr_b = _plan.NormPyramid.build(b, lv, tile=tile, backend=backend)
    return _schedule.v_matrix(pyr_a, pyr_b, tau, level=lv), lv, gm


def _pick_schedule(a, b, tau, num_devices, *, tile, backend,
                   sched_levels: int, offsets=None, schedule: str = "auto"):
    """The scheduling decision shared by `spamm_rowpart` and `spamm_2d`:
    (schedule, offsets). A supplied `offsets` table is the decision
    (equal_work). Otherwise `auto_schedule` picks from the coarse
    estimate, escalating to equal_work on ragged grids (gm % ranks != 0),
    and an equal_work pick (or `schedule="equal_work"`) cuts its offsets
    from the same estimate."""
    gm = a.shape[0] // tile
    if offsets is not None:
        return "equal_work", offsets
    v, lv, _ = _work_estimate(a, b, tau, num_devices, tile=tile,
                              backend=backend, sched_levels=sched_levels)
    if schedule == "auto":
        schedule = _schedule.auto_schedule(v, num_devices, level=lv,
                                           fine_rows=gm)
        if schedule != "equal_work" and gm % num_devices != 0:
            schedule = "equal_work"
    if schedule == "equal_work":
        offsets = _schedule.equal_work_partition(v, num_devices, level=lv,
                                                 fine_rows=gm)
    return schedule, offsets


def _resolve_schedule(a, b, tau, num_devices, *, tile, backend,
                      sched_levels: int, allow_equal_work: bool = True) -> str:
    """The "auto" pick as a bare name (diagnostics and tests)."""
    v, lv, gm = _work_estimate(a, b, tau, num_devices, tile=tile,
                               backend=backend, sched_levels=sched_levels)
    return _schedule.auto_schedule(v, num_devices, level=lv, fine_rows=gm,
                                   allow_equal_work=allow_equal_work)


def _row_layout(a, b, tau, nrow: int, me: int, *, tile, backend,
                sched_levels, schedule, offsets):
    """This rank's tile rows and how the gathered strips come back:
    (rows, restore, weights). `restore` indexes the gathered (ranks ×
    width) tile rows back into C's order; `weights` are the ranks'
    fraction weights (their real strip widths over gm; uniform: None)."""
    gm = a.shape[0] // tile
    if offsets is not None or schedule in ("auto", "equal_work"):
        schedule, offsets = _pick_schedule(a, b, tau, nrow, tile=tile,
                                           backend=backend,
                                           sched_levels=sched_levels,
                                           offsets=offsets, schedule=schedule)
    if schedule == "equal_work":
        perm, keep = _schedule.strip_tables(offsets, gm, nrow)
        w = perm.shape[0] // nrow
        widths = np.diff(np.asarray(offsets, np.float64))
        return (perm[me * w:(me + 1) * w], np.flatnonzero(keep),
                widths / widths.sum())
    if schedule not in ("contiguous", "cyclic", "pre_permuted"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if gm % nrow:
        raise ValueError(f"{gm} tile rows over {nrow} ranks: ragged grids "
                         f"need schedule='equal_work'")
    w = gm // nrow
    if schedule == "cyclic":
        perm = _schedule.device_permutation(nrow, gm, schedule)
        return perm[me * w:(me + 1) * w], np.argsort(perm), None
    return np.arange(me * w, (me + 1) * w), None, None


def _check_operands(a, b, tile, block_n):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad operands {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape
    if m % tile or k % tile or b.shape[1] % (tile * block_n):
        raise ValueError(f"{tuple(a.shape)} @ {tuple(b.shape)} not divisible "
                         f"by tile {tile} (block_n {block_n})")


def _local_spamm(a_loc, b, tau, tile, backend, block_n,
                 compute_dtype="float32"):
    """One rank's gated product of its strip: the flat call path's
    `plan()` + `execute()` (compute_dtype ≠ f32 quantizes the replicated B
    per tile, which equals quantize-once-then-broadcast)."""
    p = _plan.plan(a_loc, b, tau, tile=tile, backend=backend, block_n=block_n,
                   compute_dtype=compute_dtype)
    return _plan.execute(p, a_loc, b), p.valid_fraction.reshape(1).float()


def _fraction(fracs: torch.Tensor, weights) -> torch.Tensor:
    """The mean valid fraction: plain over uniform strips, weighted by the
    real strip widths over variable ones."""
    if weights is None:
        return fracs.mean()
    w = torch.as_tensor(weights, dtype=torch.float32, device=fracs.device)
    return (fracs * w).sum()


def spamm_rowpart(a: torch.Tensor, b: torch.Tensor, tau, mesh, *,
                  axis: str = "data", tile: int = 64, backend: str = "auto",
                  block_n: int = 1, schedule: str = "contiguous",
                  sched_levels: int = 3, offsets=None,
                  compute_dtype: str = "float32"):
    """Paper §3.4: C row-partitioned over the ranks of `axis`, B
    replicated. a (M, K), b (K, N), dims divisible by tile (N by
    tile·block_n). `schedule` is one of the module docstring's, or
    'pre_permuted' (A stored already permuted: the contiguous strips).
    The uniform schedules need M/tile divisible by the axis size;
    'equal_work' takes ragged grids. A non-None `offsets` table
    always takes the equal_work path. compute_dtype (float32 | bfloat16 |
    int8) runs each rank's gated GEMM in low precision under the widened
    gate.

    Returns (C, mean valid fraction), both whole on every rank (under
    equal_work the mean weights each rank's fraction by its real strip
    width)."""
    _check_operands(a, b, tile, block_n)
    m = a.shape[0]
    ndev, me, group = _axis(mesh, axis)
    gm = m // tile
    rows, restore, weights = _row_layout(
        a, b, tau, ndev, me, tile=tile, backend=backend,
        sched_levels=sched_levels, schedule=schedule, offsets=offsets)
    a_loc = a.reshape(gm, tile, -1)[torch.as_tensor(rows, device=a.device)]
    c_loc, frac = _local_spamm(a_loc.reshape(-1, a.shape[1]), b, tau, tile,
                               backend, block_n, compute_dtype)
    c = _all_gather(c_loc, group)
    fracs = _all_gather(frac, group)
    if restore is not None:
        c = c.reshape(-1, tile, c.shape[1])[
            torch.as_tensor(restore, device=c.device)]
    return c.reshape(m, -1), _fraction(fracs, weights)


def _local_spamm_psum(a_loc, b_loc, tau, tile, backend, block_n, col_group,
                      compute_dtype="float32"):
    """One rank's partial product on its k-slice, summed over `col_group`
    with a reduce-scatter along N: rank q keeps column block q."""
    p = _plan.plan(a_loc, b_loc, tau, tile=tile, backend=backend,
                   block_n=block_n, compute_dtype=compute_dtype)
    c_part = _plan.execute(p, a_loc, b_loc)
    ncol = dist.get_world_size(col_group)
    rows, n = c_part.shape
    blocks = c_part.reshape(rows, ncol, n // ncol).transpose(0, 1)
    c = _reduce_scatter(blocks.reshape(ncol * rows, n // ncol), col_group)
    return c, p.valid_fraction.reshape(1).float()


def spamm_2d(a: torch.Tensor, b: torch.Tensor, tau, mesh, *,
             row_axis: str = "data", col_axis: str = "model", tile: int = 64,
             backend: str = "auto", block_n: int = 1,
             schedule: str = "contiguous", sched_levels: int = 3,
             offsets=None, compute_dtype: str = "float32"):
    """Beyond-paper SUMMA-style 2-D SpAMM: A's rows over `row_axis` (one
    axis, or a tuple of axes taken as one) and its K over `col_axis`, B's
    K over `col_axis`; each rank gates its local k-slice (exact), the
    partials are reduce-scattered over `col_axis` along N, and the blocks
    are all-gathered back. schedule='auto', 'equal_work' and `offsets=`
    vary the row partition as in `spamm_rowpart` (only the row grid may
    be ragged); compute_dtype as there.

    Returns (C, mean valid fraction), both whole on every rank."""
    _check_operands(a, b, tile, block_n)
    m, k = a.shape
    nrow, r, row_group = _axis(mesh, row_axis)
    ncol, q, col_group = _axis(mesh, col_axis)
    gm = m // tile
    if (k // tile) % ncol or b.shape[1] % (ncol * tile * block_n):
        raise ValueError(f"K = {k} and N = {b.shape[1]} must split into "
                         f"{ncol} whole tiles")
    rows, restore, weights = _row_layout(
        a, b, tau, nrow, r, tile=tile, backend=backend,
        sched_levels=sched_levels, schedule=schedule, offsets=offsets)
    kw = k // ncol
    a_loc = a.reshape(gm, tile, k)[torch.as_tensor(rows, device=a.device)]
    a_loc = a_loc.reshape(-1, k)[:, q * kw:(q + 1) * kw]
    c_blk, frac = _local_spamm_psum(a_loc, b[q * kw:(q + 1) * kw], tau, tile,
                                    backend, block_n, col_group,
                                    compute_dtype)
    # column blocks of this row strip, then the row strips
    rows_loc, nb = c_blk.shape
    c_row = _all_gather(c_blk, col_group).reshape(ncol, rows_loc, nb)
    c_row = c_row.transpose(0, 1).reshape(rows_loc, ncol * nb)
    c = _all_gather(c_row, row_group)
    fracs = _all_gather(_all_gather(frac, col_group).mean().reshape(1),
                        row_group)
    if restore is not None:
        c = c.reshape(-1, tile, c.shape[1])[
            torch.as_tensor(restore, device=c.device)]
    return c.reshape(m, -1), _fraction(fracs, weights)
