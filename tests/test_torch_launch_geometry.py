"""The host rules of the port's SpAMM GEMM launches (no card needed).

`column_slices` splits the output blocks of a launch into column slices
when the blocks alone give fewer than two per SM; `launch_geometry` adds
the threads and ring stages the kernels are built with; `_check_aligned`
refuses operands the kernels' 16-byte copies cannot read.
"""
import re

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
    its tile × width outputs exactly (f32: whole float4s; bf16 and int8 on
    `mma.sync`: one warp per 16 rows, m16n8 accumulators of 4 outputs a
    thread; on `wgmma` at tile 64: one consumer warpgroup of 128 threads
    holding the REGS accumulators each that the kernels declare, beside
    one producer warp)."""
    geo = spamm_mm.launch_geometry(blocks, tile, dtype, SMS)
    s = geo["column_slices"]
    assert s == spamm_mm.column_slices(blocks, tile, SMS)
    assert geo["blocks"] == blocks * s
    width = tile // s
    assert geo["width"] == width >= 16 and tile % s == 0
    threads = geo["threads"]
    if geo["mma"] == "wgmma":
        assert (dtype, tile) != (torch.float32, 64)
        assert threads == spamm_mm.WGMMA_THREADS == 128 + 32
        assert geo["stages"] == spamm_mm.WGMMA_STAGES >= 2
        assert geo["row_bands"] * spamm_mm.WGMMA_BAND == tile
        consumers = threads - 32
        regs = re.findall(r"static constexpr int REGS = W / (\d+);",
                          _source("spamm_wgmma.cu"))
        assert len(regs) == 2                       # bf16, int8
        for per in regs:                            # 64 rows × width
            assert spamm_mm.WGMMA_BAND * width == consumers * (
                width // int(per))
        assert width % 16 == 0
        return
    assert geo["stages"] == spamm_mm.PIPELINE_STAGES[dtype] >= 2
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
    4; the ring fits a block's shared memory and does not grow with T. On
    `wgmma` (bf16, int8) at multiples of 64 the column sub-blocks are
    pieces of the widest power-of-two width up to WGMMA_MAX_WIDTH that
    divides T, cut into the slices of that width's rule; at 80 and 96
    ⌈T/64⌉ row bands and ⌈T/width⌉ column pieces."""
    geo = spamm_mm.launch_geometry(blocks, tile, dtype, SMS)
    sub = LARGE[tile]
    r = tile // sub
    s = geo["column_slices"]
    if geo["mma"] == "wgmma" and tile % 64:
        # bf16 and int8 at 80 and 96: ⌈T/64⌉ bands, ⌈T/width⌉ pieces
        assert dtype != torch.float32
        assert (geo["row_bands"], s) == (-(-tile // 64), 1)
        assert geo["column_sub_blocks"] == -(-tile // geo["width"])
        assert 4 * geo["column_sub_blocks"] <= spamm_mm.MAX_GRID_Y
        assert geo["ring_bytes"] <= SMEM_PER_BLOCK
        return
    assert (geo["sub_tile"], geo["row_bands"]) == (sub, r)
    if geo["mma"] == "wgmma":
        base = max(w for w in (16, 32, 64, 128, 256)
                   if w <= spamm_mm.WGMMA_MAX_WIDTH[dtype] and tile % w == 0)
        pieces = tile // base
        assert geo["column_sub_blocks"] == pieces
        assert s == spamm_mm.column_slices(blocks * r * pieces, base, SMS)
        assert geo["width"] * s == base and tile % geo["width"] == 0
        assert geo["blocks"] == blocks * r * pieces * s
        assert 4 * pieces * s <= spamm_mm.MAX_GRID_Y
        item = 2 if dtype == torch.bfloat16 else 1
        extra = 0 if dtype == torch.bfloat16 else 2 * 64 * geo["width"]
        assert geo["ring_bytes"] == spamm_mm.wgmma_ring_bytes(
            tile, geo["width"], dtype) == spamm_mm.WGMMA_STAGES * (
                64 * 64 + 64 * geo["width"]) * item + extra + 1024
    else:
        assert geo["column_sub_blocks"] == r
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
    16-byte units), times the ring depth, for the `mma.sync` and CUDA-core
    kernels; for the `wgmma` kernels (bf16 and int8) at tile 64 the ring
    of (64·64 + 64·W)-element stages, int8's two transposed-B buffers of
    64·W bytes and 1024 bytes of alignment room."""
    assert spamm_mm.ring_bytes(64, 64, torch.float32) == 2 * (64 * 68
                                                              + 64 * 64) * 4
    assert spamm_mm.ring_bytes(32, 32, torch.bfloat16) == 3 * (
        32 * 40 + 32 * 40) * 2
    assert spamm_mm.ring_bytes(16, 16, torch.int8) == 4 * (16 * 16 + 256
                                                           + 16)
    assert spamm_mm.ring_bytes(32, 16, torch.int8) == 4 * (32 * 48 + 32 * 16
                                                           + 16)
    assert spamm_mm.wgmma_ring_bytes(64, 64, torch.bfloat16) == (
        4 * (64 * 64 + 64 * 64) * 2 + 1024)
    assert spamm_mm.wgmma_ring_bytes(64, 16, torch.int8) == (
        4 * (64 * 64 + 64 * 16) + 2 * 16 * 64 + 1024)


def _source(name):
    import pathlib

    return (pathlib.Path(spamm_mm.__file__).parent / "csrc" / name
            ).read_text()


def test_kernel_source_holds_the_same_tile_rule():
    """kMaxTile and the dispatched (sub-tile, slices) pairs of
    csrc/spamm_mm.cu are the host rule's: every pair for f32 and the
    dense grid (SPAMM_DISPATCH), the tiles 16 and 32 only, each its own
    sub-tile, for the `mma.sync` bf16 and int8 kernels (SPAMM_DISPATCH_MMA;
    the tiles from WGMMA_LOWEST_TILE are the `wgmma` kernels')."""
    src = _source("spamm_mm.cu")
    assert f"constexpr int kMaxTile = {spamm_mm.MAX_CUDA_TILE};" in src
    macros = dict(re.findall(r"#define (SPAMM_DISPATCH\w*)\(F, tile, slices, "
                             r"\.\.\.\)(.*?)while \(0\)", src, re.S))
    assert set(macros) == {"SPAMM_DISPATCH", "SPAMM_DISPATCH_MMA"}
    pairs = {name: set(re.findall(r"(?:sub_|\(tile\)) == (\d+) && "
                                  r"\(slices\) == (\d+)", body))
             for name, body in macros.items()}
    want = {(str(s), str(n)) for s in spamm_mm.SUB_TILES
            for n in (1, 2, 4) if n <= min(spamm_mm.MAX_COLUMN_SLICES,
                                           s // 16)}
    assert pairs["SPAMM_DISPATCH"] == want
    assert pairs["SPAMM_DISPATCH_MMA"] == {p for p in want
                                           if p[0] != str(
                                               spamm_mm.WGMMA_BAND)}
    assert all(int(t) < spamm_mm.WGMMA_LOWEST_TILE
               for t, _ in pairs["SPAMM_DISPATCH_MMA"])
    assert src.count("SPAMM_DISPATCH_MMA(worklist_") == 2


# -- the instruction families: `wgmma` (csrc/spamm_wgmma.cu) for bf16 and
# int8 at every tile from 48, `mma.sync` at 16 and 32 --------------------

ALL_TILES = list(range(16, spamm_mm.MAX_CUDA_TILE + 1, 16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_route_rule_multiples_of_64_go_to_wgmma(dtype):
    """bf16 and int8: every multiple of 64 runs `wgmma`, and so do the
    other 16·odd and 32·odd tiles from 48; 16 and 32 `mma.sync`; f32
    always the CUDA cores; the launch geometry carries the family."""
    for tile in ALL_TILES:
        fam = spamm_mm.mma_family(tile, dtype)
        if dtype == torch.float32:
            want = "fma"
        elif tile % 64 == 0:
            want = "wgmma"
        else:
            want = "mma.sync" if tile < 48 else "wgmma"
        assert fam == want, tile
        assert spamm_mm.launch_geometry(8, tile, dtype, SMS)["mma"] == fam
    for odd in (1, 3, 5, 7):
        for unit in (16, 32):
            if odd * unit <= spamm_mm.MAX_CUDA_TILE:
                assert spamm_mm.mma_family(odd * unit, torch.int8) == (
                    "mma.sync" if odd == 1 else "wgmma")
    with pytest.raises(ValueError, match="multiple of 16"):
        spamm_mm.mma_family(24, dtype)


def _wgmma_widths(src, macro):

    return {int(w) for w in re.findall(rf"{macro}\((\d+)\)", src)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_wgmma_ring_fits_a_block_at_every_tile_and_width(dtype):
    """Every width a `wgmma` launch picks at tiles 64–512 (any block count)
    is one the kernel is built for and divides the tile, and every width
    it is built for keeps the dynamic shared memory within a block's
    227 KB at every tile it takes."""
    src = _source("spamm_wgmma.cu")
    built = _wgmma_widths(src, "SPAMM_BF16_AT" if dtype == torch.bfloat16
                          else "SPAMM_INT8_AT")
    assert tuple(sorted(built)) == spamm_mm.WGMMA_WIDTHS[dtype]
    assert max(built) == max(spamm_mm.WGMMA_MAX_WIDTH[dtype],
                             spamm_mm.WGMMA_MAX_WIDTH_ODD[dtype])
    assert min(built) == 16
    for width in built:
        for tile in range(48, spamm_mm.MAX_CUDA_TILE + 1, 16):
            assert spamm_mm.wgmma_ring_bytes(tile, width, dtype) <= \
                SMEM_PER_BLOCK
    for tile in range(64, spamm_mm.MAX_CUDA_TILE + 1, 64):
        for blocks in (1, 8, 72, 288, 2304):
            geo = spamm_mm.launch_geometry(blocks, tile, dtype, SMS)
            assert geo["width"] in built and tile % geo["width"] == 0
            assert geo["ring_bytes"] <= SMEM_PER_BLOCK


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_wgmma_max_width_caps_the_pieces_and_the_table_is_fixed(dtype):
    """`max_width` narrows a `wgmma` block's column pieces below the widest
    the kernels are built for (the ablation's width variants pass it); by
    default the geometry is the widest's; the table of widest widths
    cannot be changed at run time."""
    for tile in (128, 256, 512):
        for cap in (16, 32, 64):
            geo = spamm_mm.launch_geometry(2304, tile, dtype, SMS,
                                           max_width=cap)
            assert (geo["width"], geo["column_sub_blocks"]) == (
                cap, tile // cap)
        assert spamm_mm.launch_geometry(2304, tile, dtype, SMS) == \
            spamm_mm.launch_geometry(2304, tile, dtype, SMS,
                                     spamm_mm.WGMMA_MAX_WIDTH[dtype])
    with pytest.raises(TypeError):
        spamm_mm.WGMMA_MAX_WIDTH[dtype] = 128


def test_wgmma_source_holds_the_python_mirror():
    """csrc/spamm_wgmma.cu's constants and stage formulas are the ones
    kernels/spamm_mm.py computes launches with: ring depth, threads, band,
    widest widths, largest tile, the stage, the transposed-B buffers and
    the dynamic shared memory of a launch."""
    src = _source("spamm_wgmma.cu")

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kStagesWgmma") == spamm_mm.WGMMA_STAGES
    assert const("kBand") == spamm_mm.WGMMA_BAND
    assert const("kMaxTile") == spamm_mm.MAX_CUDA_TILE
    assert "constexpr int kThreads = kConsumers + 32;" in src
    assert const("kConsumers") + 32 == spamm_mm.WGMMA_THREADS
    assert const("kMaxWidthBf16") == spamm_mm.WGMMA_MAX_WIDTH[torch.bfloat16]
    assert const("kMaxWidthInt8") == spamm_mm.WGMMA_MAX_WIDTH[torch.int8]
    assert ("return kStagesWgmma * stage_layout(tile, P::ELEM, W).stage + "
            "P::EXTRA +\n         (tile % kBand ? P::ZERO : 0) + 1024;") in src
    assert "static constexpr int EXTRA = 0;" in src            # bf16
    assert "static constexpr int EXTRA = 2 * W * kBand;" in src  # int8
    for dtype, item in ((torch.bfloat16, 2), (torch.int8, 1)):
        for width in (16, 32, 64, 128):
            # at a multiple of 64 a stage is the 64 × 64 A chunk and the
            # 64 × width B chunk, and no zero region is allocated
            st = (64 * 64 + 64 * width) * item
            extra = 0 if dtype == torch.bfloat16 else 2 * width * 64
            for tile in (64, 128, 512):
                assert spamm_mm.stage_layout(tile, width, dtype)["stage"] \
                    == st
                assert spamm_mm.wgmma_ring_bytes(tile, width, dtype) == (
                    const("kStagesWgmma") * st + extra + 1024)


def test_wgmma_ablation_variants_change_the_source_where_they_say():
    """Each source variant of launch/ablate_wgmma.py finds its anchors in
    csrc/spamm_wgmma.cu and differs from it; the width variants launch at
    widths the kernels take (so an edit that breaks one fails here, not on
    the card)."""
    from repro_torch.launch import ablate_wgmma

    src = _source("spamm_wgmma.cu")
    table = ablate_wgmma.variants(src)
    rebuilt = {"narrow", "int8_w32", "baseline"}
    for name, (text, _) in table.items():
        assert (text == src) == (name in rebuilt), name
    for name, (rule, _) in ablate_wgmma.widths().items():
        built = _wgmma_widths(table[name][0], "SPAMM_INT8_AT") | \
            _wgmma_widths(table[name][0], "SPAMM_BF16_AT")
        assert set(rule.values()) <= built, name


# -- the `wgmma` kernels at every tile from 48: bands of a tile's rows (the
# last one part-filled where T is not a multiple of 64), pieces of a column
# group (the last one reaching past it where the width does not divide T)

BAND_TILES = [t for t in ALL_TILES if t % 64 and t >= 48]
WGMMA_TILES = [t for t in ALL_TILES if t >= 48]


def _band_cover(geo, tile, block_n):
    """How often each element of one (run, super column) output block is
    stored by the blocks of the launch `geo`: band b stores rows 64·b ..
    64·b + live, piece p of group g the columns of the piece that lie in
    the group."""
    hits = torch.zeros(tile, tile * block_n, dtype=torch.int32)
    width = geo["width"]
    for band in range(geo["row_bands"]):
        live = min(64, tile - 64 * band)
        for g in range(block_n):
            for p in range(geo["column_sub_blocks"] * geo["column_slices"]):
                c0 = g * tile + p * width
                valid = min(width, tile - p * width)
                hits[64 * band:64 * band + live, c0:c0 + valid] += 1
    return hits


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("block_n", [1, 2])
def test_band_launch_covers_every_output_once(dtype, block_n):
    """At every tile the `wgmma` kernels take (48 to 512), block_n 1 and 2,
    and launches of few and many blocks (the width rule's own width and
    the narrower ones a decode step takes), the blocks of a (run, super
    column) store every element of its T × T·block_n output once; a piece
    is one of the widths the kernels are built for, the last piece lies in
    its group; the ring fits a block's 227 KB; gridDim.y fits."""
    for tile in WGMMA_TILES:
        seen = set()
        for sms in (0, 1, SMS, 10 ** 6):
            pairs = 36 * block_n
            geo = spamm_mm.launch_geometry(pairs, tile, dtype, sms)
            assert geo["mma"] == "wgmma"
            width = geo["width"]
            seen.add(width)
            assert width in spamm_mm.WGMMA_WIDTHS[dtype]
            assert width <= (spamm_mm.WGMMA_MAX_WIDTH_ODD if tile % 64
                             else spamm_mm.WGMMA_MAX_WIDTH)[dtype]
            assert geo["row_bands"] == -(-tile // 64)
            assert geo["last_band_rows"] == tile % 64
            pieces = geo["column_sub_blocks"] * geo["column_slices"]
            assert pieces == -(-tile // width)
            assert 0 < geo["last_piece_columns"] <= width
            assert geo["last_piece_columns"] % 16 == 0
            assert geo["blocks"] == pairs * geo["row_bands"] * pieces
            assert block_n * pieces <= spamm_mm.MAX_GRID_Y
            assert geo["ring_bytes"] == spamm_mm.wgmma_ring_bytes(
                tile, width, dtype) <= SMEM_PER_BLOCK
            assert bool((_band_cover(geo, tile, block_n) == 1).all()), (
                tile, width)
        if tile % 64:   # a launch of too few blocks takes the narrowest
            assert 16 in seen


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_band_width_rule_and_max_width(dtype):
    """The width loads the fewest columns a band and step, ⌈T/w⌉·(64 + w):
    at 48 one piece of 64 bf16 (48 int8), at 96 one of 128 bf16 (96
    int8); `max_width` caps it; every width the kernels are built for keeps
    the ring within 227 KB at every tile."""
    def width(tile, **kw):
        return spamm_mm.launch_geometry(4224, tile, dtype, SMS,
                                        **kw)["width"]

    bf16 = dtype == torch.bfloat16
    assert width(48) == (64 if bf16 else 48)
    assert width(96) == (128 if bf16 else 96)
    assert width(96, max_width=32) == 32
    assert width(48, max_width=16) == 16
    for w in spamm_mm.WGMMA_WIDTHS[dtype]:
        for tile in BAND_TILES:
            assert spamm_mm.wgmma_ring_bytes(tile, w, dtype) <= SMEM_PER_BLOCK


def test_band_source_holds_the_python_mirror():
    """csrc/spamm_wgmma.cu's `wgmma` kernels are built at the widths of
    WGMMA_WIDTHS, take up to kMaxWidthOddBf16, kMaxWidthOddInt8 =
    WGMMA_MAX_WIDTH_ODD at a tile that is not a multiple of 64 and the
    tiles from kMinTile = WGMMA_LOWEST_TILE, and lay out their ring as
    `stage_layout` and `wgmma_ring_bytes` mirror (the source's formulas,
    line for line; the mirror's bytes at tiles 48 and 80, by hand)."""
    src = _source("spamm_wgmma.cu")

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    for dtype, macro in ((torch.bfloat16, "SPAMM_BF16_AT"),
                         (torch.int8, "SPAMM_INT8_AT")):
        assert tuple(sorted(_wgmma_widths(src, macro))) == \
            spamm_mm.WGMMA_WIDTHS[dtype]
    assert const("kMaxWidthOddBf16") == \
        spamm_mm.WGMMA_MAX_WIDTH_ODD[torch.bfloat16]
    assert const("kMaxWidthOddInt8") == \
        spamm_mm.WGMMA_MAX_WIDTH_ODD[torch.int8]
    assert const("kMinTile") == spamm_mm.WGMMA_LOWEST_TILE
    assert "tile >= kMinTile && tile <= kMaxTile &&" in src
    for line in (
            "l.a_row = kBand * elem;",
            "l.b_rows = tile < kBand ? tile : kBand;",
            "l.b_at = round1024(l.b_rows * l.a_row);",
            "const int reach = kBand * l.a_row;",
            "const int end = l.b_at + l.b_rows * w * elem;",
            "l.stage = round1024(end > reach ? end : reach);",
            "static constexpr int EXTRA = 2 * W * kBand;",
            "static constexpr int ZERO = 32 * W > 2048 ? 32 * W : 2048;",
            "static constexpr int ZERO = 2048;",
            "return kStagesWgmma * stage_layout(tile, P::ELEM, W).stage + "
            "P::EXTRA +"):
        assert line in src, line
    bf16, int8 = torch.bfloat16, torch.int8
    for key, stage in (((48, 64, bf16), 12288), ((80, 128, bf16), 24576),
                       ((48, 48, int8), 6144), ((80, 96, int8), 10240)):
        assert spamm_mm.stage_layout(*key)["stage"] == stage, key
    assert spamm_mm.wgmma_ring_bytes(48, 48, int8) == (
        const("kStagesWgmma") * 6144 + 2 * 48 * 64 + 2048 + 1024)
    assert spamm_mm.wgmma_ring_bytes(80, 128, bf16) == (
        const("kStagesWgmma") * 24576 + 4096 + 1024)
    assert spamm_mm.wgmma_ring_bytes(80, 16, bf16) == (
        const("kStagesWgmma") * 10240 + 2048 + 1024)

