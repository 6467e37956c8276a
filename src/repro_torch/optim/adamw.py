"""AdamW of the port (twin of `repro.optim.adamw`): moments in f32, a
global-norm clip, linear warm-up then cosine decay, bias correction, and
the optional int8 gradient compression with error feedback
(`distributed.compression.Int8EF`) at the update boundary.

The reference's update, formula for formula: delta = m̂ / (√n̂ + 1e-8) +
wd·p, p ← p − lr·delta (weight decay inside the delta, not decoupled as
in `torch.optim.AdamW`). The update writes the parameters and moments in
place under `no_grad`; the scalars (clip scale, learning rate, bias
corrections) are 0-d f32 tensors on the parameters' device, so a step
reads nothing back to the host.

Over a mesh (`ctx`, a `transformer.NetCtx` with the leaves' placements:
each rank passes its shards of the parameters, gradients and moments) the
update is the same elementwise; the global norm sums each parameter's squares once —
a shard's on every rank, a leaf replicated over an axis only on that
axis's rank 0 — and adds them over the mesh.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.configs.base import TrainConfig


class AdamW(NamedTuple):
    tcfg: TrainConfig
    compression: Optional[object] = None  # distributed.compression.Int8EF

    def init(self, params) -> dict:
        """{"mu", "nu"} (and "ef" with compression): f32 zeros shaped like
        `params`, on its devices."""
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        state = {"mu": T.map_(zeros, params), "nu": T.map_(zeros, params)}
        if self.compression is not None:
            state["ef"] = T.map_(zeros, params)
        return state

    def lr_at(self, step) -> torch.Tensor:
        """Learning rate at `step` (a number or 0-d tensor), in f32 on the
        CPU: warm-up to `lr` over `warmup` steps, then cosine to 0 at
        `total_steps`."""
        t = self.tcfg
        f32 = torch.float32
        step = torch.as_tensor(step, dtype=f32)
        warm = torch.clamp(step / max(t.warmup, 1), max=1.0)
        prog = torch.clamp((step - t.warmup) / max(t.total_steps - t.warmup,
                                                   1), 0.0, 1.0)
        return t.lr * warm * 0.5 * (1.0 + torch.cos(
            torch.tensor(math.pi, dtype=f32) * prog))

    @torch.no_grad()
    def update(self, params, grads, state, step, *, ctx=None):
        """One step on the trees `params`, `grads` (same structure) and
        `state`; params and moments are written in place. Returns (params,
        state, global grad norm as a 0-d f32 tensor). Over a mesh, `ctx`
        (a `transformer.NetCtx` with the placements)."""
        t = self.tcfg
        grads = T.map_(lambda g: g.float(), grads)
        if self.compression is not None:
            grads, state = self.compression.apply(grads, state, ctx=ctx)
        flat_g = T.leaves(grads)
        dev = flat_g[0].device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        if ctx is None:
            for g in flat_g:
                total = total + (g * g).sum()
        else:
            for g, spec in T.pairs(grads, ctx.specs):
                if _owns(spec, ctx):
                    total = total + (g * g).sum()
            for ax in ctx.mesh.mesh_dim_names:
                if ctx.size(ax) > 1:
                    dist.all_reduce(total, group=ctx.group(ax))
        gnorm = torch.sqrt(total)
        scale = torch.clamp(t.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        step_f = torch.as_tensor(step, dtype=torch.float32) + 1.0
        lr = self.lr_at(step_f).to(dev)
        bc1 = (1.0 - torch.tensor(t.b1, dtype=torch.float32) ** step_f).to(dev)
        bc2 = (1.0 - torch.tensor(t.b2, dtype=torch.float32) ** step_f).to(dev)
        for p, g, mu, nu in zip(T.leaves(params), flat_g,
                                T.leaves(state["mu"]), T.leaves(state["nu"])):
            g = g * scale
            mu.copy_(t.b1 * mu + (1.0 - t.b1) * g)
            nu.copy_(t.b2 * nu + (1.0 - t.b2) * g * g)
            p32 = p.float()
            delta = ((mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8)
                     + t.weight_decay * p32)
            p.copy_(p32 - lr * delta)
        return params, state, gnorm


def split_axes(spec) -> set:
    """The mesh axes a placement cuts its leaf over."""
    out = set()
    for entry in spec:
        if entry is not None:
            out.update(entry if isinstance(entry, tuple) else (entry,))
    return out


def _owns(spec, ctx) -> bool:
    """Whether this rank counts the leaf's shard in a sum over the mesh:
    on every axis the leaf is replicated over, the rank is that axis's
    rank 0."""
    cut = split_axes(spec)
    return all(ctx.index(ax) == 0 for ax in ctx.mesh.mesh_dim_names
               if ax not in cut)
