"""Plain-PyTorch oracles for the two cuSpAMM kernels (paper §3.2, §3.3).

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
    """bitmap[i, j, k] = normA[i,k] * normB[k,j] >= tau (paper Alg. 2
    lines 3-8). Returns (gm, gn, gk) bool."""
    prod = norm_a[:, None, :] * norm_b.transpose(0, 1)[None, :, :]
    return prod >= tau


def spamm_compact_ref(mask: torch.Tensor):
    """Compact valid-k lists (the paper's `map_offset`, Fig. 3b).

    mask: (gm, gn, gk) bool. Returns (kidx, nvalid): kidx (gm, gn, gk)
    int32 whose first nvalid entries are the valid k's in ascending order,
    padding slots repeating the last valid k (0 when none); nvalid (gm, gn)
    int32 (the paper's validNum)."""
    gm, gn, gk = mask.shape
    ks = torch.arange(gk, dtype=torch.int32, device=mask.device)
    nvalid = mask.sum(dim=-1, dtype=torch.int32)
    sentinel = torch.where(mask, ks[None, None, :],
                           torch.full_like(ks, gk)[None, None, :])
    kidx = torch.sort(sentinel, dim=-1).values
    last = torch.gather(kidx, -1,
                        (nvalid - 1).clamp(min=0)[..., None].long())
    last = torch.where(nvalid[..., None] > 0, last, torch.zeros_like(last))
    t = ks[None, None, :]
    return torch.where(t < nvalid[..., None], kidx, last).int(), nvalid
