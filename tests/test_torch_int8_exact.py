"""The contract of the int8 work-list GEMM, pinned on the CPU.

`spamm_mm_worklist_int8_plain` is what the tensor-core kernel is held to,
bit for bit, on the card. Here the plain version is held to a composition
written out in numpy: for each run, in table order, INIT zeroes an f32
accumulator, ACC takes the exact integer tile dot (int64) and adds
(f32(dot) · a_scale[i, k]) · b_scale[k, fine j] with three f32 roundings in
that order, FLUSH writes the accumulator. Any order of the integer sum is
exact, so this is the whole of the kernel's numerics.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import plan as P
from repro_torch.kernels import getnorm, spamm_mm
from repro_torch.kernels import quantize as Q


def _rand(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _numpy_composition(a_q, b_q, a_s, b_s, tables, tile, block_n):
    si, sj, sk, sf, runs = (t.numpy().astype(np.int64) for t in tables)
    aq, bq = a_q.numpy().astype(np.int64), b_q.numpy().astype(np.int64)
    sa, sb = a_s.numpy(), b_s.numpy()
    m, n = aq.shape[0], bq.shape[1]
    tn = tile * block_n
    out = np.zeros((m, n), np.float32)
    largest = 0
    for p in range(runs.size - 1):
        acc = np.zeros((tile, tn), np.float32)
        for s in range(runs[p], runs[p + 1]):
            i, j, k, f = si[s], sj[s], sk[s], sf[s]
            if f & spamm_mm.STEP_INIT:
                acc = np.zeros((tile, tn), np.float32)
            if f & spamm_mm.STEP_ACC:
                at = aq[i * tile:(i + 1) * tile, k * tile:(k + 1) * tile]
                bt = bq[k * tile:(k + 1) * tile, j * tn:(j + 1) * tn]
                dot = at @ bt                                  # exact, int64
                largest = max(largest, int(np.abs(dot).max()))
                scale_b = np.repeat(sb[k, j * block_n:(j + 1) * block_n],
                                    tile)[None, :]
                term = (dot.astype(np.float32) * sa[i, k]) * scale_b
                acc = acc + term.astype(np.float32)
            if f & spamm_mm.STEP_FLUSH:
                out[i * tile:(i + 1) * tile, j * tn:(j + 1) * tn] = acc
    return out, largest


@pytest.mark.parametrize("block_n", [1, 2])
def test_int8_plain_is_the_exact_dot_scaled_in_order(block_n):
    """Tile 64, the serving tile: the plain int8 work-list equals the numpy
    composition bit for bit, and every tile dot fits the s32 accumulator
    with room (|dot| ≤ 64·127² < 2²²)."""
    tile = 64
    a = _rand((2 * tile, 5 * tile), 41)
    b = _rand((5 * tile, 2 * tile * block_n), 42)
    na, nb = getnorm.tile_norms_plain(a, tile), getnorm.tile_norms_plain(
        b, tile)
    tau = float((na[:, None, :] * nb.T[None]).flatten().median())
    work = P.plan(a, b, tau, tile=tile, block_n=block_n,
                  backend="torch").work
    tables = (work.step_i, work.step_j, work.step_k, work.step_flags,
              work.runs)
    acc = (work.step_flags & spamm_mm.STEP_ACC) != 0
    assert 0 < int(acc.sum()) < acc.numel()
    a_q, a_s = Q.quantize_tiles(a, tile)
    b_q, b_s = Q.quantize_tiles(b, tile)
    got = spamm_mm.spamm_mm_worklist_int8_plain(a_q, b_q, a_s, b_s, *tables,
                                                tile=tile, block_n=block_n)
    want, largest = _numpy_composition(a_q, b_q, a_s, b_s, tables, tile,
                                       block_n)
    assert 0 < largest <= tile * 127 ** 2 < 2 ** 22
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).max() > 0
