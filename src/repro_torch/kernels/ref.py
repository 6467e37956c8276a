"""Plain-PyTorch oracles for the cuSpAMM kernels (paper §3.2, §3.3).

Twin of `repro.kernels.ref`: the ground truth the kernels' plain versions
and the planner are held against.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def tile_norms_ref(x: torch.Tensor, tile: int) -> torch.Tensor:
    """Per-tile Frobenius norms (paper Eq. 2, the `normmap`).

    x: (M, K), M % tile == 0 and K % tile == 0 (pad upstream).
    Returns (M//tile, K//tile) float32 norms.
    """
    m, k = x.shape
    x4 = x.float().reshape(m // tile, tile, k // tile, tile)
    return torch.sqrt(torch.einsum("itjs,itjs->ij", x4, x4))


def pool_norms_ref(normmap: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """One norm-pyramid coarsening step: sqrt-of-sumsq `factor`×`factor`
    pooling of a normmap. A coarse tile's squared norm is exactly the sum of
    its sub-tiles' squared norms, so the coarse entry upper-bounds every
    descendant tile norm. Leading batch dims are allowed; the trailing two
    dims are zero-padded to `factor` multiples."""
    g1, g2 = normmap.shape[-2:]
    p1, p2 = (-g1) % factor, (-g2) % factor
    if p1 or p2:
        normmap = F.pad(normmap, (0, p2, 0, p1))
    c1, c2 = (g1 + p1) // factor, (g2 + p2) // factor
    sq = (normmap * normmap).reshape(*normmap.shape[:-2], c1, factor, c2,
                                     factor)
    return torch.sqrt(sq.sum(dim=(-3, -1)))


def spamm_mask_ref(norm_a: torch.Tensor, norm_b: torch.Tensor,
                   tau) -> torch.Tensor:
    """bitmap[..., i, j, k] = normA[..., i,k] * normB[..., k,j] >= tau (paper
    Alg. 2 lines 3-8). Leading batch dims broadcast. Returns (..., gm, gn,
    gk) bool."""
    prod = norm_a[..., :, None, :] * norm_b.transpose(-1, -2)[..., None, :, :]
    return prod >= tau


def spamm_matmul_ref(a: torch.Tensor, b: torch.Tensor, tau,
                     tile: int) -> torch.Tensor:
    """Reference SpAMM: C[i,j] = sum_k bitmap[i,j,k] * A[i,k] @ B[k,j].

    a: (M, K), b: (K, N); M, K, N divisible by `tile`. A dense blocked
    einsum with the mask applied — mathematically identical to skipping the
    products. Returns (M, N) float32."""
    m, k = a.shape
    n = b.shape[1]
    gm, gk, gn = m // tile, k // tile, n // tile
    mask = spamm_mask_ref(tile_norms_ref(a, tile), tile_norms_ref(b, tile),
                          tau)
    a4 = a.float().reshape(gm, tile, gk, tile)
    b4 = b.float().reshape(gk, tile, gn, tile)
    out = torch.einsum("ijk,ipks,ksjq->ipjq", mask.float(), a4, b4)
    return out.reshape(m, n)


def spamm_compact_ref(mask: torch.Tensor):
    """Compact valid-k lists (the paper's `map_offset`, Fig. 3b).

    mask: (..., gm, gn, gk) bool (leading batch dims allowed, as the
    reference maps it over a batch). Returns (kidx, nvalid): kidx (..., gm,
    gn, gk) int32 whose first nvalid entries are the valid k's in ascending
    order, padding slots repeating the last valid k (0 when none); nvalid
    (..., gm, gn) int32 (the paper's validNum)."""
    gk = mask.shape[-1]
    ks = torch.arange(gk, dtype=torch.int32, device=mask.device)
    nvalid = mask.sum(dim=-1, dtype=torch.int32)
    sentinel = torch.where(mask, ks, torch.full_like(ks, gk))
    kidx = torch.sort(sentinel, dim=-1).values
    last = torch.gather(kidx, -1,
                        (nvalid - 1).clamp(min=0)[..., None].long())
    last = torch.where(nvalid[..., None] > 0, last, torch.zeros_like(last))
    return torch.where(ks < nvalid[..., None], kidx, last).int(), nvalid
