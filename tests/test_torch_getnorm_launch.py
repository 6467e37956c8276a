"""The get-norm entries' launch path, on the CPU: every `*_cuda` entry of
`repro_torch.kernels.getnorm` raises on what its kernel does not take, with
the same exception type as before, before it touches the kernel library;
a well-formed input goes on to the library; the CPU dispatchers take the
plain versions and never touch it.

A CPU tensor is refused by the device check, which comes first. To reach
the checks behind it here, where there is no card, a tensor subclass
reports `is_cuda`; `getnorm._lib` is replaced by a function that raises,
so a check that let an input through shows as that error.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import getnorm


class _ReachedLibrary(Exception):
    pass


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that passes the entries' device check."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def no_library(monkeypatch):
    def refuse():
        raise _ReachedLibrary

    monkeypatch.setattr(getnorm, "_lib", refuse)


def _rand(shape, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _counts():
    return (getnorm.launches, getnorm.quant_launches, getnorm.mxu_launches,
            getnorm.quant_mxu_launches, getnorm.pool_launches)


ENTRIES = {
    "tile_norms": lambda x, t: getnorm.tile_norms_cuda(x, t),
    "tile_norms_mxu": lambda x, t: getnorm.tile_norms_cuda(x, t,
                                                           use_mxu=True),
    "tile_norms_quant": lambda x, t: getnorm.tile_norms_quant_cuda(x, t),
    "tile_norms_quant_mxu": lambda x, t: getnorm.tile_norms_quant_cuda(
        x, t, use_mxu=True),
}

# (input, tile, exception) of each case; the tile 32 inputs are 64×96
CASES = {
    "cpu_tensor": (lambda: _rand((64, 96)), 32, ValueError),
    "float64": (lambda: _rand((64, 96)).double().as_subclass(_ClaimsCuda), 32,
                TypeError),
    "int8": (lambda: _rand((64, 96)).to(torch.int8).as_subclass(_ClaimsCuda),
             32, TypeError),
    "bfloat16": (lambda: _rand((64, 96)).bfloat16().as_subclass(_ClaimsCuda),
                 32, TypeError),
    "not_contiguous": (lambda: _rand((96, 64)).as_subclass(_ClaimsCuda).t(),
                       32, ValueError),
    "not_divisible": (lambda: _rand((64, 80)).as_subclass(_ClaimsCuda), 32,
                      ValueError),
    "not_2d": (lambda: _rand((2, 64, 96)).as_subclass(_ClaimsCuda), 32,
               ValueError),
    "tile_0": (lambda: _rand((64, 96)).as_subclass(_ClaimsCuda), 0,
               ValueError),
    # 65536 row tiles: past the grid's y limit of the one-block-per-tile
    # kernels
    "grid_rows": (lambda: _rand((65536, 1)).as_subclass(_ClaimsCuda), 1,
                  ValueError),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_raises_before_the_library(no_library, entry, case):
    make, tile, exc = CASES[case]
    x = make()
    before = _counts()
    with pytest.raises(exc):
        ENTRIES[entry](x, tile)
    assert _counts() == before


@pytest.mark.parametrize("entry", ["tile_norms_mxu", "tile_norms_quant_mxu"])
def test_tensor_core_entries_refuse_a_tile_off_the_mma_shape(no_library,
                                                             entry):
    x = _rand((48, 96)).as_subclass(_ClaimsCuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        ENTRIES[entry](x, 24)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_a_well_formed_input_reaches_the_library(no_library, entry):
    """The checks let a contiguous 2-D float32 matrix through at a tile
    that divides it: the entry then asks for the library, without
    counting a launch."""
    x = _rand((64, 96)).as_subclass(_ClaimsCuda)
    before = _counts()
    with pytest.raises(_ReachedLibrary):
        ENTRIES[entry](x, 32)
    assert _counts() == before


POOL_CASES = {
    "cpu_tensor": (lambda: _rand((6, 8)).abs(), ValueError),
    "float64": (lambda: _rand((6, 8)).abs().double().as_subclass(_ClaimsCuda),
                TypeError),
    "not_contiguous": (lambda: _rand((8, 6)).abs().as_subclass(
        _ClaimsCuda).t(), ValueError),
    "not_2d": (lambda: _rand((8,)).abs().as_subclass(_ClaimsCuda),
               ValueError),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_entry_raises_before_the_library(no_library, case):
    make, exc = POOL_CASES[case]
    before = _counts()
    with pytest.raises(exc):
        getnorm.pool_norms_cuda(make())
    assert _counts() == before


@pytest.mark.parametrize("shape", [(6, 8), (3, 5, 7)])
def test_pool_entry_reaches_the_library(no_library, shape):
    with pytest.raises(_ReachedLibrary):
        getnorm.pool_norms_cuda(_rand(shape).abs().as_subclass(_ClaimsCuda))


@pytest.mark.parametrize("tile", [16, 24, 32, 64])
def test_cpu_dispatch_takes_the_plain_versions(no_library, tile):
    """On a CPU tensor the dispatchers run the plain versions and leave the
    library and the launch counts alone."""
    x = _rand((2 * tile, 3 * tile), seed=tile)
    x[:tile, :tile] = 0.0
    before = _counts()
    assert torch.equal(getnorm.tile_norms(x, tile),
                       getnorm.tile_norms_plain(x, tile))
    norms, scales = getnorm.tile_norms_quant(x, tile)
    pn, ps = getnorm.tile_norms_quant_plain(x, tile)
    assert torch.equal(norms, pn) and torch.equal(scales, ps)
    nm = getnorm.tile_norms_plain(x, tile)
    assert torch.equal(getnorm.pool_norms(nm), getnorm.pool_norms_plain(nm))
    assert _counts() == before


def _ablation_variants():
    from repro_torch.kernels import build
    from repro_torch.launch import ablate_getnorm

    return ablate_getnorm.variants((build.CSRC / "getnorm.cu").read_text())


@pytest.mark.parametrize("name", sorted(_ablation_variants()))
def test_ablation_variant_changes_the_source_where_it_says(name):
    """Each variant of launch/ablate_getnorm.py finds its anchors in the
    kernel source (it raises otherwise) and changes it, but the baseline;
    its check and the pair it times are among those the ablation knows."""
    src, check, pair = _ablation_variants()[name]
    from repro_torch.kernels import build

    assert (src == (build.CSRC / "getnorm.cu").read_text()) == (
        name == "baseline")
    assert check in ("bits", "rtol", None)
    assert pair in ("cuda_core", "mxu", "both")
