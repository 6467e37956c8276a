"""Data pipeline of the port (twin of `repro.data.pipeline`): the
deterministic synthetic token stream and the paper's decay-matrix
workloads (§4.1 synthesized, §4.3 ergo / VGG-like).

The token stream is numpy, seeded per (seed, step), so a restart from a
checkpoint resumes at exactly the batch it would have seen (the data state
is just `step`) and its tokens are bit for bit the reference's. For a
frontend arch the batch carries `embeds` drawn from a `torch.Generator`
seeded from (seed, step) on the CPU and moved to the device, so CPU and
card runs see the same embeds; the reference draws them with
`jax.random`, so these numbers differ from its (a stated departure).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import spamm as core_spamm
from repro_torch.device import resolve_device


@dataclasses.dataclass
class SyntheticLM:
    """Zipf-ish synthetic token stream with next-token labels, as tensors
    on `device` (the card unless asked otherwise)."""

    cfg: ModelConfig
    global_batch: int
    seq_len: int
    seed: int = 0
    device: str = "cuda"

    def tokens_at(self, step: int) -> np.ndarray:
        """(global_batch, seq_len + 1) int32: the reference's stream."""
        rng = np.random.default_rng((self.seed, step))
        v = self.cfg.vocab
        # zipf-like marginal over vocab with a repeating n-gram structure so
        # the LM has something learnable
        base = rng.zipf(1.3, size=(self.global_batch, self.seq_len + 1)) % (
            v - 2)
        period = 1 + (np.arange(self.seq_len + 1) % 17)
        return ((base + period[None, :]) % (v - 2)).astype(np.int32) + 1

    def batch_at(self, step: int) -> dict:
        dev = resolve_device(self.device)
        toks = torch.from_numpy(self.tokens_at(step))
        labels = toks[:, 1:].to(dev)
        if self.cfg.frontend:
            gen = torch.Generator().manual_seed(hash((self.seed, step))
                                                % (2 ** 31))
            embeds = 0.02 * torch.randn(
                (self.global_batch, self.seq_len, self.cfg.d_model),
                generator=gen, dtype=torch.float32)
            return {"embeds": embeds.to(dev), "labels": labels}
        return {"tokens": toks[:, :-1].to(dev), "labels": labels}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


# ---------------------------------------------------------------------------
# paper workloads
# ---------------------------------------------------------------------------

def synthesized_decay(n: int, seed: int = 0) -> np.ndarray:
    """Paper §4.1: a_ij = 0.1 / (|i-j|^0.1 + 1), sign-randomized."""
    return core_spamm.algebraic_decay(n, c=0.1, lam=0.1, seed=seed)


def ergo_like(n: int, lam: float = 0.7, seed: int = 0) -> np.ndarray:
    """Exponential-decay matrices standing in for the ergo §4.3.1 matrices
    (the real ones come from ErgoSCF water-cluster runs; same decay law)."""
    return core_spamm.exponential_decay(n, c=1.0, lam=lam, seed=seed)


def vgg_im2col_shapes():
    """Paper §4.3.2: (M, K, N) of conv21 and conv31 after im2col."""
    return {"conv21": (128, 576, 25_600), "conv31": (256, 1_152, 6_400)}


def relu_sparse_matrix(m: int, n: int, sparsity: float = 0.55, seed: int = 0):
    """Near-sparse activation-like matrix (paper §1: ReLU ⇒ >50% zeros)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, n)).astype(np.float32)
    thresh = np.quantile(x, sparsity)
    return np.maximum(x - thresh, 0.0)
