"""Synthetic decay-matrix workload config (paper SS4.1) for examples/benches."""
from dataclasses import dataclass


@dataclass(frozen=True)
class SynthConfig:
    n: int = 4096
    tile: int = 64
    decay: str = "algebraic"   # algebraic | exponential
    c: float = 0.1
    lam: float = 0.1
    valid_ratio: float = 0.1


CONFIG = SynthConfig()
