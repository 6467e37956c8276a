"""valid-ratio → τ search (paper §3.5.2), flat and coarse-first (twin of
`repro.core.tau_search`).

Users of non-scientific applications give `valid_ratio` (the fraction of
tile products executed) instead of the threshold τ. Per the paper: binary
search over [0, k·ave], where ave is the mean norm product and k the
expansion coefficient, starting at 1 and incremented while the upper bound
cannot meet the demand; iteration count and tolerance are user-bounded.

Each `lax.while_loop` of the reference is a plain Python loop here: the
ratio of a candidate τ is counted on the normmaps' device
(`core.spamm.valid_ratio_of`) and read to the host once per iteration; the
bracket arithmetic runs on the host in numpy float32, step for step the
reference's f32 arithmetic (mid = 0.5·(lo+hi), k·ave with an f32 k that
counts up, f32 count / f32 total). The mean norm product sums in another
order than XLA's, so a τ found here may differ from the reference's by a
few ulps.

`search_tau_pyramid` brackets τ on the COARSEST normmaps first, then
bisects on the fine level inside that bracket. By the pyramid invariant
ratio_fine(τ) ≤ ratio_coarse(τ), so the coarse τ (inflated by its
tolerance) upper-bounds the fine answer.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import spamm as _spamm

f32 = np.float32


class TauSearchResult(NamedTuple):
    tau: float              # float32 value
    achieved_ratio: float   # float32 value
    iterations: int


def _mean_norm_product(norm_a: torch.Tensor, norm_b: torch.Tensor) -> f32:
    """mean_{i,j,k} na[i,k]·nb[k,j] without the product tensor:
    (1/(gm·gn·gk)) Σ_k (Σ_i na[i,k])(Σ_j nb[k,j]). Zero iff every product
    is zero — the degenerate-operand guard both searches share."""
    gm, gk = norm_a.shape
    gn = norm_b.shape[1]
    total = torch.tensor(gm * gn * gk, dtype=torch.float32,
                         device=norm_a.device)
    return f32((torch.sum(torch.sum(norm_a, 0) * torch.sum(norm_b, 1))
                / total).item())


def _ratio(norm_a, norm_b, tau) -> f32:
    return f32(_spamm.valid_ratio_of(norm_a, norm_b, tau).item())


def _bisect(norm_a, norm_b, target, lo, hi, tol, max_iters):
    """Binary search for ratio(τ) ≈ target on [lo, hi], tracking the best
    candidate seen. Returns (tau, achieved_ratio, iterations)."""
    mid = f32(0.5) * (lo + hi)
    best_tau, best_r = mid, _ratio(norm_a, norm_b, mid)
    it = 1
    # hi > lo guards the degenerate bracket: all-zero operands give [0, 0]
    # and fp midpoints eventually collapse the bracket — either way further
    # ratio() evaluations cannot move, so stop
    while hi > lo and it < max_iters and abs(best_r - target) > tol:
        mid = f32(0.5) * (lo + hi)
        r = _ratio(norm_a, norm_b, mid)
        if abs(r - target) < abs(best_r - target):
            best_tau, best_r = mid, r
        # ratio too high → τ too small → move lo up
        if r > target:
            lo = mid
        else:
            hi = mid
        it += 1
    return best_tau, best_r, it


def search_tau(norm_a: torch.Tensor, norm_b: torch.Tensor, target_ratio, *,
               tol: float = 0.01, max_iters: int = 20):
    """Find τ s.t. valid_ratio(τ) ≈ target_ratio. Returns (tau, result).

    valid_ratio is monotone non-increasing in τ; ratio(0)=1, ratio(∞)=0."""
    target, tol = f32(target_ratio), f32(tol)
    ave = _mean_norm_product(norm_a, norm_b)
    # expand the upper bound: k ← k+1 until ratio(k·ave) <= target (paper).
    # ave == 0 (all-zero operands): every product is 0 and ratio(k·0) = 1
    # forever — keep the [0, 0] bracket, i.e. τ = 0
    k, exp_iters = f32(1.0), 0
    while (ave > 0.0 and k < 1024.0
           and _ratio(norm_a, norm_b, k * ave) > target):
        k, exp_iters = k + f32(1.0), exp_iters + 1
    tau, r, iters = _bisect(norm_a, norm_b, target, f32(0.0), k * ave, tol,
                            max_iters)
    res = TauSearchResult(tau=float(tau), achieved_ratio=float(r),
                          iterations=iters + exp_iters)
    return float(tau), res


def search_tau_pyramid(pyr_a, pyr_b, target_ratio, *, tol: float = 0.01,
                       max_iters: int = 20, coarse_iters: int = 12):
    """Coarse-first τ-search over NormPyramids. Returns (tau, result).

    Phase 1 runs the full §3.5.2 search (expansion + bisection) on the
    coarsest normmaps, with the looser of the caller's tolerance and 2 %.
    Phase 2 bisects on the FINE normmaps inside [0, 1.25·τ_coarse]; a
    doubling guard (at most 8 rounds) covers the coarse-tolerance edge."""
    na_f, nb_f = pyr_a.levels[0], pyr_b.levels[0]
    na_c, nb_c = pyr_a.levels[-1], pyr_b.levels[-1]
    target = f32(target_ratio)
    tau_c, res_c = search_tau(na_c, nb_c, target,
                              tol=max(f32(tol), f32(0.02)),
                              max_iters=coarse_iters)
    # mirror of search_tau's degenerate guard: with an all-zero fine mean
    # product no doubling can bring ratio(hi) below the target
    ave_f = _mean_norm_product(na_f, nb_f)
    hi = max(f32(tau_c) * f32(1.25), f32(1e-30)) if ave_f > 0.0 else f32(0.0)
    g_iters = 0
    while (ave_f > 0.0 and g_iters < 8
           and _ratio(na_f, nb_f, hi) > target):
        hi, g_iters = hi * f32(2.0), g_iters + 1
    tau, r, iters = _bisect(na_f, nb_f, target, f32(0.0), hi, f32(tol),
                            max_iters)
    res = TauSearchResult(tau=float(tau), achieved_ratio=float(r),
                          iterations=iters + g_iters + res_c.iterations)
    return float(tau), res
