"""Step-table bucketing, the GEMM-byte count and the autotuner's record
(twins of `repro.core.cost.bucket`/`bucket_ladder`/`gemm_bytes`/
`TunedParams`).

The rest of the reference's cost model (flop counts, calibration, the
autotuner `tune_weight`) is not ported yet (ROADMAP queue A item 8): a plan
store written with tuned artifacts loads here (`TunedParams.from_manifest`),
but nothing in the port tunes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

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


class TunedParams(NamedTuple):
    """One weight's tuned blocking parameters and their provenance, as the
    reference's autotuner records them in a plan artifact's manifest."""
    block_n: int
    levels: int
    bucket: int              # work-list bucket floor (`bucket(minimum=)`)
    predicted_us: float      # predicted per-call time at the tuned params
    default_predicted_us: float  # same model at the configured defaults
    profile_key: str         # coefficients used ("interpret/cpu", ...)

    def as_manifest(self) -> dict:
        return dict(self._asdict())

    @classmethod
    def from_manifest(cls, d: Optional[dict]) -> Optional["TunedParams"]:
        if d is None:
            return None
        return cls(block_n=int(d["block_n"]), levels=int(d["levels"]),
                   bucket=int(d["bucket"]),
                   predicted_us=float(d["predicted_us"]),
                   default_predicted_us=float(d["default_predicted_us"]),
                   profile_key=str(d["profile_key"]))
