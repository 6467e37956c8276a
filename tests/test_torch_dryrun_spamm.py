"""The SpAMM-at-scale dry run (`repro_torch.launch.dryrun_spamm`) at
N = 1024, tile 64, as rank 0 of a fake 2×2 world (2×2×2 for the
multi-pod variant) on the CPU: τ calibration against the reference's,
the operands against numpy's decay matrix, and each variant's rank-0
product, tile products and dense FLOPs against the flat library call;
then each variant again at the default tile, the reference's 128.

Tolerances: the calibrated ratio within 0.01 of the reference's (the
τ-search stops within its own tolerance of 0.01 and sums the mean norm
product in another order than XLA); τ fed the reference's normmap equal
to the reference's τ; everything else exact (bit for bit)."""
import numpy as np
import pytest
import torch

N, TILE, RATIO = 1024, 64, 0.10
MESH = {False: ((2, 2), ("data", "model")),
        True: ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def ref_calibration():
    import jax.numpy as jnp

    from repro.core import spamm as rcs
    from repro.kernels import ref
    from repro.launch.dryrun_spamm import calibrate_tau

    na = ref.tile_norms_ref(jnp.asarray(rcs.algebraic_decay(N, seed=0)), TILE)
    return calibrate_tau(N, TILE, RATIO), np.array(na)


def test_calibrate_tau_matches_reference(ref_calibration):
    from repro_torch.launch.dryrun_spamm import calibrate_tau

    (ref_tau, ref_ratio), ref_norms = ref_calibration
    tau, ratio = calibrate_tau(N, TILE, RATIO, device="cpu")
    assert abs(ratio - ref_ratio) <= 0.01
    assert abs(ratio - RATIO) <= 0.01
    # fed the reference's normmap, the search lands on the reference's τ
    tau_r, ratio_r = calibrate_tau(N, TILE, RATIO,
                                   norms=torch.as_tensor(ref_norms))
    assert tau_r == ref_tau and ratio_r == ref_ratio


def test_decay_operand_equals_numpy():
    from repro_torch.core.spamm import algebraic_decay
    from repro_torch.launch.dryrun_spamm import decay_operand

    a = decay_operand(N, device="cpu", rows=300)
    assert torch.equal(a, torch.as_tensor(algebraic_decay(N)))
    # unsigned: the signed matrix's tile norms exactly
    from repro_torch.kernels.getnorm import tile_norms_plain

    signed = torch.as_tensor(algebraic_decay(N, seed=0))
    assert torch.equal(tile_norms_plain(a, TILE),
                       tile_norms_plain(signed, TILE))


@pytest.fixture(scope="module")
def operand():
    from repro_torch.launch.dryrun_spamm import calibrate_tau, decay_operand

    tau, ratio = calibrate_tau(N, TILE, RATIO, device="cpu")
    return decay_operand(N, device="cpu"), tau, ratio


@pytest.mark.parametrize("name", ["rowpart_contiguous", "rowpart_cyclic",
                                  "2d_psum_scatter", "2d_bf16",
                                  "2d_multipod"])
def test_variant_rank0_equals_flat_spamm(operand, name):
    from repro_torch.core import plan as P
    from repro_torch.core.spamm import spamm
    from repro_torch.launch import dryrun_spamm as DS

    a, tau, ratio = operand
    kind, _, dtype, multi = DS.VARIANTS[name]
    out, loc = DS.run_variant(name, a, tau, ratio, tile=TILE,
                              mesh_shape=MESH[multi], verbose=False)
    # rank 0's own product ≡ the flat library call on its operands
    c, _ = spamm(loc["a"], loc["b"], tau, tile=TILE, compute_dtype=dtype)
    assert torch.equal(c, loc["product"])
    p = P.plan(loc["a"], loc["b"], tau, tile=TILE, compute_dtype=dtype)
    assert out["tile_products"] == int(p.valid_tiles) > 0
    rows = 4 if multi else 2
    cols = 2 if kind == "2d" else 1
    assert loc["a"].shape == (N // rows, N // cols)
    worklist = ("spamm_mm_worklist_bf16" if dtype == "bfloat16"
                else "spamm_mm_worklist")
    k = out["kernels"][worklist]
    assert k["launches"] == 1
    assert k["dense_flops"] == 2.0 * (N // rows) * (N // cols) * N
    assert out["roofline"]["compute_dense_s"] == \
        k["dense_flops"] / DS.PEAK_FLOPS[dtype]
    assert out["rank_valid_fraction"] == k["flops"] / k["dense_flops"]
    assert out["memory"]["argument_bytes"] == \
        2 * N * N * (2 if dtype == "bfloat16" else 4)
    # the result all-gather's wire bytes: the ring model on C's bytes
    ag = out["collectives"]["all-gather"]
    want = N * N * 4 * (rows - 1) / rows + 4 * (rows - 1)
    if kind == "2d":
        want += (N // rows) * N * 4 * (cols - 1) / cols + 4 * (cols - 1)
        rs = out["collectives"]["reduce-scatter"]
        assert rs["wire_bytes"] == (N // rows) * N * 4 * (cols - 1) / cols
    assert ag["wire_bytes"] == want


def test_rowpart_cuts_differ_in_rank0_work(operand):
    """§3.5.1's point: rank 0's own share of the work differs between the
    contiguous and the cyclic cut (it is what `compute_effective_s`
    counts, where the reference scales dense by one global ratio). Over 4
    row ranks rank 0's contiguous strip is the matrix's edge, its cyclic
    tile rows are spread over it (over 2 the two cuts are symmetric)."""
    from repro_torch.launch import dryrun_spamm as DS

    a, tau, ratio = operand
    fr = {s: DS.run_variant(f"rowpart_{s}", a, tau, ratio, tile=TILE,
                            mesh_shape=((4, 1), ("data", "model")),
                            verbose=False)[0]["tile_products"]
          for s in ("contiguous", "cyclic")}
    assert fr["contiguous"] < fr["cyclic"]


@pytest.fixture(scope="module")
def operand_default_tile():
    from repro_torch.launch.dryrun_spamm import calibrate_tau, decay_operand

    tau, ratio = calibrate_tau(N, DEFAULT_TILE, RATIO, device="cpu")
    return decay_operand(N, device="cpu"), tau, ratio


DEFAULT_TILE = 128


def test_default_tile_is_the_references():
    import inspect

    from repro.launch import dryrun_spamm as RDS
    from repro_torch.launch import dryrun_spamm as DS

    assert inspect.signature(DS.run_variant).parameters["tile"].default \
        == DEFAULT_TILE
    assert "default=128" in inspect.getsource(RDS.main)
    assert "default=128" in inspect.getsource(DS.main)


def test_calibrate_tau_at_the_default_tile_matches_reference():
    """At N = 1024 a tile-128 normmap has 8 × 8 tiles (512 products): the
    search stops where the reference's does, above the 0.01 band around
    the target that finer normmaps reach."""
    from repro.launch.dryrun_spamm import calibrate_tau as rcalibrate
    from repro_torch.launch.dryrun_spamm import calibrate_tau

    ref_tau, ref_ratio = rcalibrate(N, DEFAULT_TILE, RATIO)
    tau, ratio = calibrate_tau(N, DEFAULT_TILE, RATIO, device="cpu")
    assert abs(ratio - ref_ratio) <= 0.01
    assert abs(tau - ref_tau) <= 1e-5 * ref_tau


@pytest.mark.parametrize("name", ["rowpart_contiguous", "rowpart_cyclic",
                                  "2d_psum_scatter", "2d_bf16",
                                  "2d_multipod"])
def test_variant_at_the_default_tile_equals_flat_spamm(operand_default_tile,
                                                        name):
    """`run_variant` with no tile runs at 128: rank 0's product ≡ flat
    `spamm()` at tile 128 bit for bit, and its counted tile products = the
    plan's real steps at tile 128."""
    from repro_torch.core import plan as P
    from repro_torch.core.spamm import spamm
    from repro_torch.launch import dryrun_spamm as DS

    a, tau, ratio = operand_default_tile
    kind, _, dtype, multi = DS.VARIANTS[name]
    out, loc = DS.run_variant(name, a, tau, ratio, mesh_shape=MESH[multi],
                              verbose=False)
    assert out["tile"] == DEFAULT_TILE
    c, _ = spamm(loc["a"], loc["b"], tau, tile=DEFAULT_TILE,
                 compute_dtype=dtype)
    assert torch.equal(c, loc["product"])
    p = P.plan(loc["a"], loc["b"], tau, tile=DEFAULT_TILE,
               compute_dtype=dtype)
    assert out["tile_products"] == int(p.valid_tiles) > 0
    worklist = ("spamm_mm_worklist_bf16" if dtype == "bfloat16"
                else "spamm_mm_worklist")
    k = out["kernels"][worklist]
    assert k["launches"] == 1
    assert k["flops"] == 2.0 * DEFAULT_TILE ** 3 * out["tile_products"]
