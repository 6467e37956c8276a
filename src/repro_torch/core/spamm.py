"""SpAMM core — the paper's library call (twin of `repro.core.spamm`).

Functional API over the plan/execute pipeline (`repro_torch.core.plan`):
  * arbitrary (M, K) @ (K, N) shapes (zero-padded to tile multiples, paper
    §3 "the matrices are padded with zeros"), un-padded on return;
  * τ- or valid-ratio-driven gating (ratio → τ via core.tau_search);
  * the original recursive Algorithm 1 as an oracle (paper §3.1 claims
    re-design ≡ recursion);
  * valid-ratio counting that never materializes the O(gm·gn·gk) product
    tensor (sorted normmap + searchsorted);
  * the paper's decay-matrix generators (numpy, as in the reference).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import plan as _plan
from repro_torch.core.plan import SpammInfo, pad_to_tile  # re-exported API


def count_valid(norm_a: torch.Tensor, norm_b: torch.Tensor,
                tau) -> torch.Tensor:
    """#{(i,j,k): na[i,k]·nb[k,j] >= tau} without the product tensor: one
    sort of norm_b's rows, then per (i, k) a binary search for the first
    nb[k, :] >= tau / na[i, k]. Summed exactly in int64 (the reference's
    jax_enable_x64 branch; its int32 and f32 branches are exact or
    approximate forms of the same count). Returns a 0-d int64 tensor on the
    normmaps' device.

    The test divides where the gate multiplies, so at exact ties the count
    can differ from the gate's; the reference behaves the same."""
    gm, gk = norm_a.shape
    gk2, gn = norm_b.shape
    assert gk == gk2, (norm_a.shape, norm_b.shape)
    tau = float(np.float32(float(tau)))
    sorted_nb = torch.sort(norm_b, dim=1).values                  # (gk, gn)
    # threshold per (i, k): nb >= tau / na (na == 0 handled below)
    thr = (torch.tensor(tau, dtype=torch.float32, device=norm_a.device)
           / torch.clamp(norm_a, min=1e-38))                      # (gm, gk)
    first = torch.searchsorted(sorted_nb, thr.T.contiguous(), side="left")
    counts = gn - first                                           # (gk, gm)
    # na == 0: every product is 0, valid iff tau <= 0
    counts = torch.where((norm_a <= 0.0).T, gn if tau <= 0.0 else 0, counts)
    return counts.sum(dtype=torch.int64)


def valid_ratio_of(norm_a: torch.Tensor, norm_b: torch.Tensor,
                   tau) -> torch.Tensor:
    """Paper §3.5.2: valid ratio = Σ V[i,j] / BDIM³ (generalized to
    gm·gn·gk), as f32 count / f32 total (a 0-d f32 tensor)."""
    gm, gk = norm_a.shape
    gn = norm_b.shape[1]
    total = torch.tensor(float(gm) * float(gk) * float(gn),
                         dtype=torch.float32, device=norm_a.device)
    return count_valid(norm_a, norm_b, tau).to(torch.float32) / total


def spamm(a: torch.Tensor, b: torch.Tensor, tau=None, *, valid_ratio=None,
          tile: int = 64, block_n: int = 1, backend: str = "auto",
          use_mxu_norm: bool = False, out_dtype=None,
          compute_dtype: str = "float32"):
    """C ≈ A @ B with norm-gated tile skipping. Returns (C, SpammInfo).

    Exactly one of `tau` / `valid_ratio` must be given. Arbitrary shapes are
    zero-padded to tile multiples (N to tile·block_n) and the result is
    un-padded. One-shot plan + execute; to reuse the gating phase, build the
    plan once with `repro_torch.core.plan.plan` and call `execute` per
    product."""
    m, k = a.shape
    k2, n = b.shape
    assert k == k2, (a.shape, b.shape)
    ap = pad_to_tile(a, tile).contiguous()
    bp = pad_to_tile(b, tile, tile * block_n).contiguous()
    p = _plan.plan(ap, bp, tau, valid_ratio=valid_ratio, tile=tile,
                   block_n=block_n, backend=backend,
                   use_mxu_norm=use_mxu_norm, compute_dtype=compute_dtype)
    c = _plan.execute(p, ap, bp, out_dtype=out_dtype)[:m, :n]
    frac = p.valid_fraction
    return c, SpammInfo(tau=p.tau, valid_fraction=frac,
                        effective_flops=frac * (2.0 * m * k * n))


def recursive_spamm(a: np.ndarray, b: np.ndarray, tau: float,
                    leaf: int) -> np.ndarray:
    """Paper Algorithm 1, verbatim quad-tree recursion (numpy, test oracle).

    Square matrices with N a power-of-two multiple of `leaf`."""
    n = a.shape[0]
    assert a.shape == b.shape == (n, n)

    def fnorm(x):
        return float(np.sqrt(np.sum(np.asarray(x, np.float64) ** 2)))

    def rec(ab, bb):
        nn = ab.shape[0]
        if nn == leaf:
            return np.asarray(ab, np.float64) @ np.asarray(bb, np.float64)
        h = nn // 2
        c = np.zeros((nn, nn), np.float64)
        for i in (0, 1):
            for j in (0, 1):
                acc = np.zeros((h, h), np.float64)
                for k in (0, 1):
                    asub = ab[i * h:(i + 1) * h, k * h:(k + 1) * h]
                    bsub = bb[k * h:(k + 1) * h, j * h:(j + 1) * h]
                    if fnorm(asub) * fnorm(bsub) >= tau:
                        acc += rec(asub, bsub)
                c[i * h:(i + 1) * h, j * h:(j + 1) * h] = acc
        return c

    return rec(a, b)


def algebraic_decay(n: int, c: float = 0.1, lam: float = 0.1,
                    seed=None) -> np.ndarray:
    """a_ij = c / (|i-j|^lam + 1); with seed, sign-randomized (keeps
    |a_ij|)."""
    d = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :]).astype(np.float64)
    m = (c / (d ** lam + 1.0)).astype(np.float32)
    if seed is not None:
        rng = np.random.default_rng(seed)
        m = m * rng.choice(np.float32([-1.0, 1.0]), size=m.shape)
    return m


def exponential_decay(n: int, c: float = 1.0, lam: float = 0.9,
                      seed=None) -> np.ndarray:
    """|a_ij| <= c·lam^|i-j| (ergo-style matrices in §4.3.1 decay this
    way)."""
    d = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :]).astype(np.float64)
    m = (c * np.power(lam, d)).astype(np.float32)
    if seed is not None:
        rng = np.random.default_rng(seed)
        m = m * rng.uniform(0.5, 1.0, size=m.shape).astype(np.float32)
        m = m * rng.choice(np.float32([-1.0, 1.0]), size=m.shape)
    return m
