"""The host rules of the port's SpAMM GEMM launches (no card needed).

`column_slices` splits the output blocks of a launch into column slices
when the blocks alone give fewer than two per SM; `launch_geometry` adds
the threads and ring stages the kernels are built with; `_check_aligned`
refuses operands the kernels' 16-byte copies cannot read.
"""
import pytest
import torch

from repro_torch.kernels import spamm_mm

SMS = 132  # an H100 SXM


@pytest.mark.parametrize("tile,most", [(16, 1), (32, 2), (64, 4)])
def test_column_slices_below_threshold_split_up_to_the_tile_limit(tile,
                                                                  most):
    """Few runs (a decode step's wk/wv: 8) take the most slices a tile
    allows: a slice keeps at least 16 columns, and at most 4."""
    assert spamm_mm.column_slices(8, tile, SMS) == most
    assert spamm_mm.column_slices(1, tile, SMS) == most


@pytest.mark.parametrize("tile", [16, 32, 64])
def test_column_slices_at_or_above_threshold_do_not_split(tile):
    """Two blocks per SM or more (prefill, decode w1's 288 runs) launch
    one block per run."""
    for blocks in (2 * SMS, 288, 2304):
        assert spamm_mm.column_slices(blocks, tile, SMS) == 1


@pytest.mark.parametrize("tile", [32, 64])
def test_column_slices_double_until_two_blocks_per_sm(tile):
    """Just below the threshold one doubling suffices; a decode step's 72
    runs (wq/wo/w2) need 4 at tile 64."""
    assert spamm_mm.column_slices(2 * SMS - 1, tile, SMS) == 2
    assert spamm_mm.column_slices(72, 64, SMS) == 4
    for blocks in range(1, 3 * SMS):
        s = spamm_mm.column_slices(blocks, tile, SMS)
        assert s in (1, 2, 4) and s <= tile // 16
        assert blocks * s >= 2 * SMS or s == min(4, tile // 16)
        if s > 1:
            assert blocks * (s // 2) < 2 * SMS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("tile", [16, 32, 64])
@pytest.mark.parametrize("blocks", [8, 72, 2304])
def test_launch_geometry_covers_every_output(tile, blocks, dtype):
    """Blocks = (run, group) pairs × slices; the threads of a block own
    its tile × width outputs exactly (f32: whole float4s; bf16 and int8:
    one warp per 16 rows, m16n8 accumulators of 4 outputs a thread)."""
    geo = spamm_mm.launch_geometry(blocks, tile, dtype, SMS)
    s = geo["column_slices"]
    assert s == spamm_mm.column_slices(blocks, tile, SMS)
    assert geo["blocks"] == blocks * s
    assert geo["stages"] == spamm_mm.PIPELINE_STAGES[dtype] >= 2
    width = tile // s
    assert width >= 16 and tile % s == 0
    threads = geo["threads"]
    assert threads % 32 == 0 and threads <= 128
    per_thread = tile * width // threads
    assert per_thread * threads == tile * width
    assert per_thread % 4 == 0
    if dtype != torch.float32:
        assert threads == 32 * (tile // 16)
        assert width % 16 == 0    # two n8 blocks per B ldmatrix.x4


def test_check_aligned_refuses_offset_views():
    buf = torch.zeros(64 * 65)
    spamm_mm._check_aligned((("a", buf[:64 * 64].view(64, 64)),))
    spamm_mm._check_aligned((("a", buf[64:].view(64, 64)),))   # 256 B in
    with pytest.raises(ValueError, match="aligned"):
        spamm_mm._check_aligned((("a", buf[1:64 * 64 + 1].view(64, 64)),))
    half = torch.zeros(64 * 64 + 8, dtype=torch.bfloat16)
    spamm_mm._check_aligned((("b", half[8:].view(64, 64)),))   # 16 B in
    with pytest.raises(ValueError, match="b must be 16-byte aligned"):
        spamm_mm._check_aligned((("b", half[4:4 + 64 * 64].view(64, 64)),))


# -- tiles above 64: a sub-tile of 64, 32 or 16, R = tile / sub row bands
# and column sub-blocks per output block --------------------------------

LARGE = {80: 16, 96: 32, 128: 64, 192: 64, 256: 64, 512: 64}
SMEM_PER_BLOCK = 232_448   # an H100's 227 KB a block can use


@pytest.mark.parametrize("tile", list(LARGE))
def test_sub_tile_is_the_largest_template_tile_dividing_the_tile(tile):
    sub = spamm_mm.sub_tile(tile)
    assert sub == LARGE[tile] and tile % sub == 0
    assert all(tile % s for s in spamm_mm.SUB_TILES if s > sub)
    for t in (16, 32, 64):
        assert spamm_mm.sub_tile(t) == t


@pytest.mark.parametrize("tile", [0, 8, 24, 40, 100, 520, 1024])
def test_tiles_the_kernels_do_not_take_raise(tile):
    with pytest.raises(ValueError, match="multiple of 16 from 16 to 512"):
        spamm_mm.sub_tile(tile)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("tile", list(LARGE))
@pytest.mark.parametrize("blocks", [1, 8, 72, 2304])
def test_launch_geometry_at_large_tiles(tile, blocks, dtype):
    """Each (run, group) pair's T × T output block is R row bands × R
    column sub-blocks of the sub-tile, each cut into the slices the
    sub-tile's rule gives on the R²-fold launch; threads and stages are the
    sub-tile's; gridDim.y (block_n × R × slices) stays ≤ 65535 at block_n
    4; the ring fits a block's shared memory and does not grow with T."""
    geo = spamm_mm.launch_geometry(blocks, tile, dtype, SMS)
    sub = LARGE[tile]
    r = tile // sub
    assert (geo["sub_tile"], geo["row_bands"],
            geo["column_sub_blocks"]) == (sub, r, r)
    s = geo["column_slices"]
    assert s == spamm_mm.column_slices(blocks * r * r, sub, SMS)
    assert geo["blocks"] == blocks * r * r * s
    sub_geo = spamm_mm.launch_geometry(blocks * r * r, sub, dtype, SMS)
    for key in ("column_slices", "threads", "stages", "ring_bytes"):
        assert geo[key] == sub_geo[key], key
    assert 4 * r * s <= spamm_mm.MAX_GRID_Y
    assert geo["ring_bytes"] <= SMEM_PER_BLOCK


def test_ring_bytes_by_the_kernels_stage_formulas():
    """(TILE·(TILE+4) + TILE·W)·4 f32, (TILE·(TILE+8) + TILE·(W+8))·2 bf16,
    TILE·LDA + TILE·W + 16 int8 (LDA: TILE padded to an odd number of
    16-byte units), times the ring depth: at sub-tile 64, one slice."""
    ring = {d: spamm_mm.ring_bytes(64, 64, d)
            for d in (torch.float32, torch.bfloat16, torch.int8)}
    assert ring == {torch.float32: 2 * (64 * 68 + 64 * 64) * 4,
                    torch.bfloat16: 3 * (64 * 72 + 64 * 72) * 2,
                    torch.int8: 4 * (64 * 80 + 64 * 64 + 16)}
    assert spamm_mm.ring_bytes(16, 16, torch.int8) == 4 * (16 * 16 + 256
                                                           + 16)


def test_kernel_source_holds_the_same_tile_rule():
    """kMaxTile and the dispatched (sub-tile, slices) pairs of
    csrc/spamm_mm.cu are the host rule's."""
    import pathlib
    import re

    src = (pathlib.Path(spamm_mm.__file__).parent / "csrc"
           / "spamm_mm.cu").read_text()
    assert f"constexpr int kMaxTile = {spamm_mm.MAX_CUDA_TILE};" in src
    pairs = set(re.findall(r"sub_ == (\d+) && \(slices\) == (\d+)", src))
    want = {(str(s), str(n)) for s in spamm_mm.SUB_TILES
            for n in (1, 2, 4) if n <= min(spamm_mm.MAX_COLUMN_SLICES,
                                           s // 16)}
    assert pairs == want
