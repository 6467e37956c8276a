"""SpAMM as a drop-in GEMM for the model zoo (twin of `repro.core.module`).

`maybe_spamm_matmul` is the hook every eligible GEMM of the models calls:
dense `x @ w` when SpAMM is off, the frozen work-list path when a
`FrozenPlan` is given, the eager plan/execute path otherwise. Only the
forward exists here: the gated GEMMs refuse tensors that need gradients
(the `torch.autograd.Function` with dense|spamm backward waits for the
training slice, ROADMAP queue A).

`SpammContext` carries the config, a `WeightPlanCache` shared by the
eager gated GEMMs of a model (the weight's padding and normmap or pyramid
are computed once), and the gating telemetry. Each gated GEMM appends a
labelled tap: its valid fraction as a DEVICE tensor (no host sync per
GEMM), a frozen one also the GEMM bytes its plan moves at the configured
compute dtype (`SpammPlan.bytes_moved`), and host labels — the phase, the
GEMM's site ("wq", "w1", ...), the layer the stack's loop set
(`set_layer`; -1 outside a labelled region) and, with cost taps armed
(`enable_cost_taps`), the static part of the GEMM's predicted time
(`cost.predict_plan_static`, from shapes). `end_stats()` moves the whole
wave's values to the host in one transfer and finishes each prediction
there (`cost.finish_plan_time_s`). Every gated GEMM honours `cfg.dtype`.
A step captured in a CUDA graph taps while it is captured, once
(`record`); each replay then appends its taps as one device block with
the labels kept from the capture (`tap_block`), so a graphed wave drains
one labelled tap per gated GEMM per step, as an eager one does, and the
labels add no graph node.

`spamm_bmm_linear` is the batched gated GEMM for per-slice weights (the MoE
grouped-FFN shape), forward only.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import cost as _cost
from repro_torch.core import plan as _plan
from repro_torch.core.plan import WeightPlanCache, pad_to_tile


class Tap(NamedTuple):
    """One telemetry event from a gated GEMM: its phase, the valid
    fraction, the GEMM bytes moved (None where not tapped), the GEMM's site
    label (None where unlabelled), its layer (-1 outside a labelled
    region) and its predicted seconds (None unless cost taps are armed)."""
    phase: str
    value: float
    nbytes: Optional[float] = None
    site: Optional[str] = None
    layer: int = -1
    predicted_s: Optional[float] = None


class TapLabel(NamedTuple):
    """The host labels of one tap, fixed when the GEMM runs (or is
    captured): phase, site, layer and the `cost.predict_plan_static`
    output (or None)."""
    phase: str
    site: Optional[str] = None
    layer: int = -1
    cost: Optional[tuple] = None


class _Block(NamedTuple):
    """A replayed step's taps: (n,) valid fractions, (m,) bytes of the
    taps flagged in `has_nbytes`, and each tap's label."""
    values: Any
    nbytes: Any
    has_nbytes: tuple
    labels: tuple


class SpammContext:
    """The SpammConfig, a WeightPlanCache for the eager gated GEMMs, and the
    per-wave labelled gating taps. Create one per model/engine, not per
    call."""

    __slots__ = ("cfg", "cache", "_pending", "_collect", "_phase", "_layer",
                 "cost_coeffs")

    def __init__(self, cfg: Any, cache: Optional[WeightPlanCache] = None):
        self.cfg = cfg
        self.cache = cache if cache is not None else WeightPlanCache()
        self._pending: list = []
        self._collect = False
        self._phase = "prefill"
        self._layer = None
        self.cost_coeffs = None

    def __repr__(self):
        return f"SpammContext({self.cfg!r}, cache={len(self.cache)} entries)"

    @property
    def enable(self) -> bool:
        return bool(getattr(self.cfg, "enable", False))

    def begin_stats(self):
        """Start collecting per-GEMM valid fractions."""
        self._pending = []
        self._collect = True

    def set_phase(self, phase: str):
        """Tag subsequent taps ("prefill" | "decode")."""
        self._phase = phase

    def set_layer(self, layer: Optional[int]):
        """Tag subsequent taps with a layer index (a Python int: the stack
        is a Python loop, so in a capture the label is static); None
        clears it."""
        self._layer = layer

    def swap_layer(self, layer: Optional[int]) -> Optional[int]:
        """Set the layer label and return the previous one."""
        prev, self._layer = self._layer, layer
        return prev

    def enable_cost_taps(self, coeffs):
        """Arm the cost channel: a frozen gated GEMM records the static
        part of its predicted time beside its tap, and `end_stats` finishes
        it with `coeffs` (a `cost.CostCoeffs`, host floats). Arm before the
        first capture of a step: a replay reuses the capture's labels."""
        self.cost_coeffs = coeffs

    def label(self, site: Optional[str] = None, cost=None) -> TapLabel:
        """The labels a tap taken now carries."""
        return TapLabel(self._phase, site,
                        -1 if self._layer is None else int(self._layer), cost)

    def tap(self, valid_fraction, nbytes=None, site: Optional[str] = None,
            cost=None):
        """Record one gated GEMM's valid fraction and, optionally, the GEMM
        bytes it moves (0-d tensors, left on their device) with the current
        phase and layer, `site` and the static cost terms `cost`; no-op
        unless collecting."""
        if self._collect:
            self._pending.append((self.label(site, cost), valid_fraction,
                                  nbytes))

    def tap_block(self, values, nbytes=None, has_nbytes=(), labels=None):
        """Record len(values) taps at once: `values` an (n,) f32 device
        tensor of valid fractions, `nbytes` an (m,) one of the bytes of the
        taps flagged in `has_nbytes` (n bools, m True), `labels` their n
        `TapLabel`s (None: the current phase and layer, no site). No-op
        unless collecting."""
        if self._collect:
            if labels is None:
                labels = (self.label(),) * len(has_nbytes)
            self._pending.append(_Block(values, nbytes, tuple(has_nbytes),
                                        tuple(labels)))

    @contextlib.contextmanager
    def record(self):
        """Collect the taps of the enclosed calls into the yielded list of
        (label, valid_fraction, nbytes), whether or not a wave is
        collecting, and keep them out of the wave's stats."""
        saved = (self._pending, self._collect)
        got: list = []
        self._pending, self._collect = got, True
        try:
            yield got
        finally:
            self._pending, self._collect = saved

    def end_stats(self) -> list:
        """Stop collecting and drain: `Tap` events since `begin_stats`, the
        values read from the device in one transfer; with cost taps armed,
        each frozen GEMM's prediction finished from its drained values."""
        pending, self._pending = self._pending, []
        self._collect = False
        if not pending:
            return []
        blocks = [e if isinstance(e, _Block)
                  else _Block(e[1], e[2], (e[2] is not None,), (e[0],))
                  for e in pending]
        flat = [torch.as_tensor(x).detach().float().reshape(-1)
                for blk in blocks for x in (blk.values, blk.nbytes)
                if x is not None]
        vals = iter(torch.cat(flat).cpu().tolist())
        coeffs = self.cost_coeffs
        taps = []
        for blk in blocks:
            vf = [next(vals) for _ in blk.has_nbytes]
            nb = [next(vals) if h else None for h in blk.has_nbytes]
            for lab, v, b in zip(blk.labels, vf, nb):
                pred = (_cost.finish_plan_time_s(lab.cost, v, b, coeffs)
                        if lab.cost is not None and coeffs is not None
                        and b is not None else None)
                taps.append(Tap(lab.phase, v, b, lab.site, lab.layer, pred))
        return taps


def as_context(spamm_cfg) -> Optional[SpammContext]:
    """None / SpammConfig / SpammContext → Optional[SpammContext]."""
    if spamm_cfg is None or isinstance(spamm_cfg, SpammContext):
        return spamm_cfg
    return SpammContext(spamm_cfg)


def _flatten_pad(x: torch.Tensor, tile: int):
    lead = tuple(x.shape[:-1])
    k = x.shape[-1]
    m = 1
    for s in lead:
        m *= s
    x2 = x.reshape(m, k)
    return pad_to_tile(x2, tile).contiguous(), (lead, m, k)


def _forward_only(*tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the port's gated GEMMs are forward-only; the autograd Function "
            "(bwd dense|spamm) waits for the training slice (ROADMAP queue A)")


def _fwd_impl(x, w, tau, tile, backend, block_n, ctx=None, levels=0,
              compute_dtype="float32"):
    """Plan + execute one gated GEMM eagerly; returns (y, plan). With a
    context, the weight side comes from its cache (levels > 0: the cached
    weight pyramid, the activation's pooled by the backend's kernel)."""
    _forward_only(x, w)
    xp, (lead, m, k) = _flatten_pad(x, tile)
    n = w.shape[-1]
    if ctx is not None:
        p, wp = ctx.cache.plan_for(xp, w, tau, tile=tile, block_n=block_n,
                                   backend=backend, levels=levels,
                                   compute_dtype=compute_dtype)
    else:
        wp = pad_to_tile(w, tile, tile * block_n).contiguous()
        p = _plan.plan(xp, wp, tau, tile=tile, block_n=block_n,
                       backend=backend, levels=levels,
                       compute_dtype=compute_dtype)
    c = _plan.execute(p, xp, wp)
    return c[:m, :n].reshape(*lead, n).to(x.dtype), p


def spamm_linear(x: torch.Tensor, w: torch.Tensor, tau, tile: int = 64,
                 backend: str = "auto", block_n: int = 1, levels: int = 0,
                 compute_dtype: str = "float32") -> torch.Tensor:
    """y[..., n] = SpAMM(x[..., k] @ w[k, n], tau), forward only. Output
    dtype follows x."""
    return _fwd_impl(x, w, tau, tile, backend, block_n, None, levels,
                     compute_dtype)[0]


def spamm_bmm_linear(x: torch.Tensor, w: torch.Tensor,
                     spamm_ctx: SpammContext) -> torch.Tensor:
    """Batched gated GEMM for per-slice weights (B, K, N) — the MoE grouped
    FFN shape — through `core.plan.spamm_bmm` with the config's τ, forward
    only; taps the batch's valid fraction at site "moe_bmm"."""
    _forward_only(x, w)
    cfg = spamm_ctx.cfg
    c, info = _plan.spamm_bmm(x, w, cfg.tau, tile=cfg.tile,
                              block_n=cfg.block_n, backend=cfg.backend,
                              cache=spamm_ctx.cache, levels=cfg.levels)
    spamm_ctx.tap(info.valid_fraction, site="moe_bmm")
    return c.to(x.dtype)


def spamm_linear_frozen(x: torch.Tensor, w: torch.Tensor, fp,
                        ctx: Optional[SpammContext] = None,
                        site: Optional[str] = None) -> torch.Tensor:
    """Gated GEMM with a frozen weight side (the serving path): the
    activation get-norm, the device-side gate over the frozen step tables,
    then the work-list kernel at the plan's compute dtype. Bit-identical to
    `spamm_linear` with the same config. Taps the valid fraction and the
    GEMM bytes moved, labelled with `site`; with cost taps armed, also the
    static terms of the predicted time (host floats from the plan's
    shapes: no device op)."""
    tile = fp.tile
    xp, (lead, m, k) = _flatten_pad(x, tile)
    n = w.shape[-1]
    p = _plan.plan(xp, frozen_weight=fp)
    if ctx is not None:
        cost = (_cost.predict_plan_static(p, ctx.cost_coeffs)
                if ctx.cost_coeffs is not None else None)
        ctx.tap(p.valid_fraction, p.bytes_moved(), site=site, cost=cost)
    wp = pad_to_tile(w, tile, tile * fp.block_n).contiguous()
    c = _plan.execute(p, xp, wp)
    return c[:m, :n].reshape(*lead, n).to(x.dtype)


def maybe_spamm_matmul(x: torch.Tensor, w: torch.Tensor, spamm_cfg: Any,
                       frozen=None, require_frozen: bool = False,
                       site: Optional[str] = None) -> torch.Tensor:
    """Dense when SpAMM is off; the frozen path when `frozen` (a FrozenPlan)
    is given; the eager plan/execute path otherwise. `require_frozen=True`
    (the decode contract) stays dense when no frozen plan exists for this
    site. `site` labels the tap ("wq", "w1", ...)."""
    ctx = as_context(spamm_cfg)
    if ctx is None or not ctx.enable or (require_frozen and frozen is None):
        return x @ w
    if frozen is not None:
        return spamm_linear_frozen(x, w, frozen, ctx, site=site)
    cfg = ctx.cfg
    y, p = _fwd_impl(x, w, cfg.tau, cfg.tile, cfg.backend, cfg.block_n, ctx,
                     cfg.levels, cfg.dtype)
    ctx.tap(p.valid_fraction, site=site)
    return y
