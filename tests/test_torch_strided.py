"""plan() and execute() on operands of any strides (CPU, spy backend).

The CUDA kernels take contiguous operands that start on a 16-byte boundary
and raise on anything else; the library entry points own the copy. A spy
backend (the plain versions, recording every tensor it is handed) shows
that `plan(a, w.t())` and `execute` hand the backend only contiguous,
aligned tensors, at f32, bf16 and int8, and that the results equal those
of the contiguous call bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import plan as P
from repro_torch.kernels import getnorm
from repro_torch.kernels import ops as kops

TILE = 16


def _rand(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _offset(x):
    """A contiguous copy of x that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 4, dtype=x.dtype)
    view = buf[1:1 + x.numel()].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.fixture
def spy(monkeypatch):
    """Registers backend "spy": the plain versions, each asserting that
    every tensor argument is contiguous and 16-byte aligned."""
    seen = []

    def watch(fn):
        def wrapped(*args, **kw):
            for x in (*args, *kw.values()):
                if isinstance(x, torch.Tensor):
                    seen.append(x)
                    assert x.is_contiguous(), tuple(x.stride())
                    assert x.data_ptr() % 16 == 0, x.data_ptr() % 16
            return fn(*args, **kw)
        return wrapped

    base = kops.BACKENDS["torch"]
    fields = ("norms", "norms_quant", "pool_norms", "matmul_worklist",
              "matmul_worklist_int8", "matmul")
    backend = dataclasses.replace(
        base, name="spy", **{f: watch(getattr(base, f)) for f in fields})
    monkeypatch.setitem(kops.BACKENDS, "spy", backend)
    return seen


def _operands():
    a = _rand((3 * TILE, 5 * TILE), 51)
    w_t = _rand((4 * TILE, 5 * TILE), 52)       # stored (N, K): w = w_t.t()
    na = getnorm.tile_norms_plain(a, TILE)
    nb = getnorm.tile_norms_plain(w_t.t().contiguous(), TILE)
    tau = float((na[:, None, :] * nb.T[None]).flatten().median())
    return a, w_t.t(), tau


@pytest.mark.parametrize("layout", ["transposed", "offset"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_plan_execute_take_any_strides(spy, dtype, layout):
    a, w, tau = _operands()
    assert not w.is_contiguous()
    if layout == "offset":
        a, w = _offset(a), _offset(w.contiguous())
    p = P.plan(a, w, tau, tile=TILE, backend="spy", compute_dtype=dtype)
    c = P.execute(p, a, w)
    assert len(spy) >= 4       # the two get-norms and the GEMM's operands
    ref = P.plan(a.contiguous().clone(), w.contiguous().clone(), tau,
                 tile=TILE, backend="torch", compute_dtype=dtype)
    for mine, theirs in zip(p.work, ref.work):       # the work-list tables
        assert torch.equal(mine, theirs)
    assert 0.0 < float(p.valid_fraction) < 1.0
    assert torch.equal(c, P.execute(ref, a.contiguous().clone(),
                                    w.contiguous().clone()))
    assert float(c.abs().max()) > 0.0


def test_kernel_operand_copies_only_what_the_kernels_refuse():
    x = _rand((TILE, 2 * TILE), 53)
    assert P.kernel_operand(x) is x
    assert P.kernel_operand(None) is None
    for view in (x.t(), _offset(x)):
        got = P.kernel_operand(view)
        assert got is not view and got.is_contiguous()
        assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
