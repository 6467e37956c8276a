"""Batched serving engine of the port: the WAVE plane of
`repro.serving.engine` (one-shot prefill of an equal-length batch, then
lockstep greedy decode until every sequence finishes), unsharded.

Frozen plans: with SpAMM on, the engine freezes every gated weight once
(`plans.precompute.freeze_tree`, through the SpAMM context's
`WeightPlanCache`) and specializes the frozen artifacts per activation row
grid (`_frozen_for`, cached in `_fp_cache`), so prefill and every decode
step only read device-resident step tables. With a plan store
(`plan_store=`, populated offline by `launch.precompute_plans`) the freeze
is a pure load: no planning pass, no get-norm on the weights. The chunked
mixed-length plane, the pod-sharded mode, re-sharding and the observability
bundle are not ported yet (ROADMAP queue A); mixed-length batches raise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import module as spmod
from repro_torch.device import f32_numerics, resolve_device
from repro_torch.models import model as M


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    out: Optional[dict] = None   # set by Engine.generate: {"tokens",
                                 # "spamm" (gating stats or None),
                                 # "latency" (host wall-clock of the wave)}


class Engine:
    """Greedy serving of equal-length request waves on `device` (the card
    unless asked otherwise). `spamm_cfg` (SpammConfig or SpammContext)
    turns on norm-gated GEMMs in prefill and decode, both through frozen
    plans. `plan_store` (a `plans.store.PlanStore` or its root directory)
    is the persistent tier the frozen artifacts load from."""

    def __init__(self, cfg: ModelConfig, pcfg: ParallelConfig, params, *,
                 max_len: int = 512, spamm_cfg=None, plan_store=None,
                 device="cuda"):
        self.device = resolve_device(device)
        f32_numerics()
        emb = params["embed"]["embedding"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params lie on {emb.device}, engine device is "
                             f"{self.device}")
        self.cfg, self.pcfg, self.params = cfg, pcfg, params
        self.max_len = max_len
        self.spamm_ctx = spmod.as_context(spamm_cfg)
        self._gated = self.spamm_ctx is not None and self.spamm_ctx.enable
        if isinstance(plan_store, str):
            from repro_torch.plans.store import PlanStore

            plan_store = PlanStore(plan_store)
        self.plan_store = plan_store
        if self._gated and plan_store is not None:
            self.spamm_ctx.cache.store = plan_store
        self._fw_tree = None     # params-shaped tree of FrozenWeight
        self._fp_cache: dict = {}  # row-tile grid gm → FrozenPlan tree
        self._prefill = M.make_prefill_step(cfg, pcfg,
                                            spamm_cfg=self.spamm_ctx)
        self._decode = M.make_decode_step(cfg, pcfg,
                                          spamm_cfg=self.spamm_ctx)

    # -- frozen-plan assembly ------------------------------------------------
    def _frozen_for(self, rows: int) -> dict:
        """The FrozenPlan tree for a step whose gated GEMMs see `rows`
        flattened activation rows — built once per row-tile grid."""
        if not self._gated:
            return {}
        tile = self.spamm_ctx.cfg.tile
        gm = (rows + tile - 1) // tile
        hit = self._fp_cache.get(gm)
        if hit is not None:
            return hit
        self._ensure_fw_tree()
        return self._assemble_frozen(gm)

    def _assemble_frozen(self, gm: int) -> dict:
        def specialize(node):
            if isinstance(node, dict):
                return {k: specialize(v) for k, v in node.items()}
            if isinstance(node, list):
                return [specialize(v) for v in node]
            return node.for_rows(gm)

        tree = specialize(self._fw_tree)
        self._fp_cache[gm] = tree
        return tree

    def _ensure_fw_tree(self):
        """Freeze the weight-side gating artifacts once, through the
        context's cache and the plan store (a warm store makes it a load)."""
        if self._fw_tree is None:
            from repro_torch.plans.precompute import freeze_tree

            self._fw_tree, _ = freeze_tree(
                self.params, self.spamm_ctx.cfg, cache=self.spamm_ctx.cache,
                store=self.plan_store)

    def _pad_cache(self, cache):
        """Grow the prefill's KV caches to the engine's slot budget:
        max_len, or the sliding window when that is smaller."""
        target = (min(self.max_len, self.cfg.sliding_window)
                  if self.cfg.sliding_window else self.max_len)

        def grow(c):
            return {n: (F.pad(t, (0, 0, 0, 0, 0, target - t.shape[1]))
                        if n in ("k", "v") and t.shape[1] < target else t)
                    for n, t in c.items()}

        return {"layers": [grow(c) for c in cache["layers"]]}

    def _spamm_stats(self, taps, store0=None) -> dict:
        """Per-wave gating stats: mean valid fraction and gated-GEMM count
        per phase, the configured compute dtype, the GEMM bytes moved per
        phase (sums over the frozen GEMMs' taps), and with a plan store its
        hits and misses during this wave (deltas from `store0`, the
        counters at the wave's start: a warm second wave reports 0/0)."""
        pre = [t.value for t in taps if t.phase != "decode"]
        dec = [t.value for t in taps if t.phase == "decode"]
        pre_b = [t.nbytes for t in taps
                 if t.phase != "decode" and t.nbytes is not None]
        dec_b = [t.nbytes for t in taps
                 if t.phase == "decode" and t.nbytes is not None]
        stats = {
            "valid_fraction": float(np.mean(pre)) if pre else None,
            "gated_gemms": len(pre),
            "decode_valid_fraction": float(np.mean(dec)) if dec else None,
            "decode_gated_gemms": len(dec),
            "compute_dtype": self.spamm_ctx.cfg.dtype,
            "gemm_bytes_moved": float(np.sum(pre_b)) if pre_b else None,
            "decode_gemm_bytes_moved": (float(np.sum(dec_b)) if dec_b
                                        else None),
        }
        if store0 is not None:
            stats["plan_store_hits"] = self.plan_store.hits - store0[0]
            stats["plan_store_misses"] = self.plan_store.misses - store0[1]
        return stats

    # -- dispatch ------------------------------------------------------------
    def generate(self, requests: List[Request]) -> List[np.ndarray]:
        """Greedy-decode an equal-length batch of prompts. Raises on empty
        prompts, prompts longer than max_len - 1, and mixed lengths (the
        chunked plane that serves them is not ported yet)."""
        if not requests:
            raise ValueError("empty batch")
        plens = [len(r.prompt) for r in requests]
        if min(plens) < 1:
            raise ValueError("empty prompt")
        if max(plens) > self.max_len - 1:
            raise ValueError(
                f"prompt of {max(plens)} tokens does not fit "
                f"max_len={self.max_len} (a sequence needs at least one "
                f"decode slot)")
        if len(set(plens)) > 1:
            raise NotImplementedError(
                "mixed-length prompts need the chunked-prefill plane "
                "(ROADMAP queue A: chunked plane); pad client-side to one "
                "length")
        return self._generate_wave(requests)

    def _generate_wave(self, requests: List[Request]) -> List[np.ndarray]:
        """Lockstep wave: prefill the whole batch, decode until every
        sequence finishes. Latency is read at the loop's own blocking
        point (copying the step's tokens to the host), no extra syncs:
        TTFT from wave start (plan assembly included) to the first token on
        the host, one decode latency per later step."""
        b = len(requests)
        plen = len(requests[0].prompt)
        toks = np.stack([r.prompt for r in requests]).astype(np.int32)
        store0 = (None if self.plan_store is None
                  else (self.plan_store.hits, self.plan_store.misses))
        t_wave0 = time.perf_counter()
        frozen_pre = self._frozen_for(b * plen)
        frozen_dec = self._frozen_for(b)
        outs = [[] for _ in range(b)]
        ttft_s, decode_lat, taps = None, [], []
        if self._gated:
            self.spamm_ctx.begin_stats()
            self.spamm_ctx.set_phase("prefill")
        try:
            with torch.inference_mode():
                cache, logits = self._prefill(
                    self.params,
                    {"tokens": torch.as_tensor(toks, device=self.device)},
                    frozen_pre)
                cache = self._pad_cache(cache)
                cur = logits.argmax(dim=-1).to(torch.int32)
                pos = plen
                done = np.zeros(b, bool)
                budget = max(r.max_new_tokens for r in requests)
                if self._gated:
                    self.spamm_ctx.set_phase("decode")
                t_step = None
                for _ in range(budget):
                    vis = cur.cpu().numpy()   # blocks on the previous step
                    now = time.perf_counter()
                    if t_step is None:
                        ttft_s = now - t_wave0
                    else:
                        decode_lat.append(now - t_step)
                    for i, r in enumerate(requests):
                        if not done[i]:
                            outs[i].append(int(vis[i]))
                            if ((r.eos_id is not None
                                 and int(vis[i]) == r.eos_id)
                                    or len(outs[i]) >= r.max_new_tokens):
                                done[i] = True
                    if done.all() or pos >= self.max_len - 1:
                        break
                    t_step = time.perf_counter()
                    logits, cache = self._decode(self.params, cur[:, None],
                                                 cache, pos, frozen_dec)
                    cur = logits.argmax(dim=-1).to(torch.int32)
                    pos += 1
        finally:
            if self._gated:
                taps = self.spamm_ctx.end_stats()
                self.spamm_ctx.set_phase("prefill")
        spamm_meta = self._spamm_stats(taps, store0) if self._gated else None
        latency = {"ttft_s": ttft_s, "decode_steps": len(decode_lat),
                   "decode_mean_s": (float(np.mean(decode_lat))
                                     if decode_lat else None),
                   "decode_p50_s": (float(np.median(decode_lat))
                                    if decode_lat else None)}
        results = [np.asarray(o, np.int32) for o in outs]
        for r, toks_out in zip(requests, results):
            r.out = {"tokens": toks_out, "spamm": spamm_meta,
                     "latency": latency}
        return results
