"""Step-table bucketing and the GEMM-byte count (twins of
`repro.core.cost.bucket`/`bucket_ladder`/`gemm_bytes`).

The rest of the reference's cost model (flop counts, calibration,
autotuner) is not ported yet (ROADMAP queue A).
"""
from __future__ import annotations

from repro_torch.kernels import quantize as kquant


def bucket(n: int, minimum: int = 16) -> int:
    """Pad a step count to a power-of-two bucket of at least `minimum`, so
    step tables take one of O(log n) lengths."""
    return max(minimum, 1 << max(n - 1, 0).bit_length())


def bucket_ladder(n_max: int, minimum: int = 16) -> list:
    """Every bucket `bucket(n, minimum)` can return for n in [1, n_max]."""
    lo = bucket(1, minimum)
    hi = bucket(max(int(n_max), 1), minimum)
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * 2)
    return out


def gemm_bytes(valid_tiles, pairs, tile: int, block_n: int, dtype):
    """GEMM bytes the executed work-list moves: per real step one (tile,
    tile) A block and one (tile, tile·block_n) B block at the compute
    dtype's itemsize, plus one f32 (tile, tile·block_n) output flush per
    active output pair. Python floats or float tensors (pure arithmetic)."""
    isize = kquant.dtype_itemsize(dtype)
    t2 = float(tile * tile)
    return (valid_tiles * (t2 * (1 + block_n) * isize)
            + pairs * (t2 * block_n * 4.0))
