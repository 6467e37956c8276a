"""SpAMM as a drop-in GEMM for the model zoo (twin of `repro.core.module`).

`maybe_spamm_matmul` is the hook every eligible GEMM of the models calls:
dense `x @ w` when SpAMM is off, the frozen work-list path when a
`FrozenPlan` is given, the eager plan/execute path otherwise. The eager
gated GEMM is a `torch.autograd.Function` (`spamm_linear`, the reference's
`custom_vjp`) with two backward modes:

  * bwd="dense": exact dense gradients in f32 (`torch.matmul`, as the
    reference computes them outside any Pallas kernel);
  * bwd="spamm": gradients gated with plans derived from the forward
    plan's normmaps — dx = g @ wᵀ gated by norms(g)·norms(w)ᵀ, dw = xᵀ @ g
    gated by norms(x)ᵀ·norms(g) — through the get-norm and work-list
    kernels. The forward's normmaps are saved, not recomputed.

Gradients ignore the compute dtype and τ gets a zero gradient, as in the
reference. A weight that requires grad (a trainable parameter, updated in
place every step) bypasses the `WeightPlanCache`, as the reference's traced
weights do. The frozen path and the batched MoE path stay forward-only, as
in the reference: they refuse tensors that need gradients.

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
labels add no graph node. The training stack collects its taps through a
trace buffer instead (`begin_trace_buffer`): the valid fractions of one
forward, as device tensors, which a recomputation under remat never
reaches.

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
from repro_torch.kernels import ops as kops


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
                 "_trace_buffer", "cost_coeffs", "_frac_reduce")

    def __init__(self, cfg: Any, cache: Optional[WeightPlanCache] = None):
        self.cfg = cfg
        self.cache = cache if cache is not None else WeightPlanCache()
        self._pending: list = []
        self._collect = False
        self._phase = "prefill"
        self._layer = None
        self._trace_buffer: Optional[list] = None
        self.cost_coeffs = None
        self._frac_reduce = None

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
        """Tag subsequent taps ("prefill" | "decode" | "train")."""
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

    def begin_trace_buffer(self):
        """Open the training stack's buffer: until it is drained, a tap
        appends only its valid fraction (a device tensor) to it."""
        self._trace_buffer = []

    def drain_trace_buffer(self) -> list:
        """Close the buffer and return the fractions tapped since it was
        opened."""
        buf, self._trace_buffer = (self._trace_buffer or []), None
        return buf

    def suspend_trace_buffer(self) -> Optional[list]:
        """Close the buffer for a region whose taps the training stats
        leave out (a MoE block's, as in the reference) and return it for
        `resume_trace_buffer`."""
        buf, self._trace_buffer = self._trace_buffer, None
        return buf

    def resume_trace_buffer(self, buf: Optional[list]):
        self._trace_buffer = buf

    def swap_fraction_reduce(self, fn):
        """Set the map a tap applies to its valid fraction before recording
        it (a GEMM split over model ranks reports the whole product's,
        `models.parallel.split_matmul`); None clears it. Returns the
        previous one."""
        prev, self._frac_reduce = self._frac_reduce, fn
        return prev

    def tap(self, valid_fraction, nbytes=None, site: Optional[str] = None,
            cost=None):
        """Record one gated GEMM's valid fraction and, optionally, the GEMM
        bytes it moves (0-d tensors, left on their device) with the current
        phase and layer, `site` and the static cost terms `cost`. With a
        trace buffer open the fraction goes there instead; otherwise a
        no-op unless collecting."""
        if self._frac_reduce is not None and (
                self._trace_buffer is not None or self._collect):
            valid_fraction = self._frac_reduce(valid_fraction)
        if self._trace_buffer is not None:
            self._trace_buffer.append(valid_fraction)
            return
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
            "this gated GEMM is forward-only, as in the reference (frozen "
            "plans serve inference; training MoE keeps dense grads); train "
            "through spamm_linear / maybe_spamm_matmul")


def _fwd_impl(x, w, tau, tile, backend, block_n, ctx=None, levels=0,
              compute_dtype="float32"):
    """Plan + execute one gated GEMM eagerly; returns (y, plan). With a
    context, the weight side comes from its cache (levels > 0: the cached
    weight pyramid, the activation's pooled by the backend's kernel)."""
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
    c = _plan.execute(p, xp, wp, rows=m)
    return c[:m, :n].reshape(*lead, n).to(x.dtype), p


class _SpammLinear(torch.autograd.Function):
    """(y, valid_fraction) of one gated GEMM, differentiable in x and w —
    the reference's `_spamm_linear_stats` custom_vjp. The fraction is an
    output (non-differentiable) so that callers tap it outside the
    Function; the forward's normmaps are saved for bwd="spamm"."""

    @staticmethod
    def forward(ctx, x, w, tau, tile, backend, bwd, block_n, sctx, levels,
                compute_dtype):
        if bwd not in ("dense", "spamm"):
            raise ValueError(f"bwd={bwd!r}")
        y, p = _fwd_impl(x, w, tau, tile, backend, block_n, sctx, levels,
                         compute_dtype)
        frac = p.valid_fraction
        ctx.mark_non_differentiable(frac)
        ctx.save_for_backward(x, w, p.norm_a, p.norm_b)
        ctx.statics = (tau, tile, backend, bwd, block_n)
        return y, frac

    @staticmethod
    def backward(ctx, g, _g_frac):
        # f32 whatever the forward's compute dtype; the fraction's
        # cotangent is discarded
        x, w, norm_x, norm_w = ctx.saved_tensors
        tau, tile, backend, bwd, block_n = ctx.statics
        need_dx, need_dw, need_tau = ctx.needs_input_grad[:3]
        lead = x.shape[:-1]
        k, n = w.shape
        m = x.numel() // k
        g2 = g.reshape(m, n).float()
        x2 = x.reshape(m, k).float()
        w32 = w.float()
        dx = dw = None
        if bwd == "dense":
            if need_dx:
                dx = (g2 @ w32.T).reshape(*lead, k).to(x.dtype)
            if need_dw:
                dw = (x2.T @ g2).to(w.dtype)
        else:
            # g and w pad N to tile·block_n, the column grid of the
            # forward's weight normmap
            gp = pad_to_tile(g2, tile, tile * block_n).contiguous()
            if need_dx:
                # dx = g @ wᵀ gated by norms(g)·norms(w)ᵀ: the forward
                # bitmap with its (k, j) axes transposed
                wp = pad_to_tile(w32, tile, tile * block_n)
                p_dx = _plan.plan(gp, None, tau, norm_b=norm_w.T, tile=tile,
                                  backend=backend)
                norm_g = p_dx.norm_a
                dx = (_plan.execute(p_dx, gp, wp.T)[:m, :k]
                      .reshape(*lead, k).to(x.dtype))
            else:
                norm_g = kops.get_backend(backend).norms(gp, tile)
            if need_dw:
                # dw = xᵀ @ g gated by norms(x)ᵀ·norms(g)
                xp = pad_to_tile(x2, tile)
                p_dw = _plan.plan(None, None, tau, norm_a=norm_x.T,
                                  norm_b=norm_g, tile=tile, backend=backend)
                dw = _plan.execute(p_dw, xp.T, gp)[:k, :n].to(w.dtype)
        dtau = torch.zeros_like(tau) if need_tau else None
        return dx, dw, dtau, None, None, None, None, None, None, None


def spamm_linear(x: torch.Tensor, w: torch.Tensor, tau, tile: int = 64,
                 backend: str = "auto", bwd: str = "dense", block_n: int = 1,
                 ctx: Optional[SpammContext] = None, levels: int = 0,
                 compute_dtype: str = "float32") -> torch.Tensor:
    """y[..., n] = SpAMM(x[..., k] @ w[k, n], tau), differentiable in x
    and w (`bwd` "dense" | "spamm"). Output dtype follows x. `ctx`
    supplies the WeightPlanCache (not used for a weight that requires
    grad); `compute_dtype` selects the forward GEMM's operands."""
    return _SpammLinear.apply(x, w, tau, tile, backend, bwd, block_n, ctx,
                              levels, compute_dtype)[0]


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
    _forward_only(x, w)
    tile = fp.tile
    xp, (lead, m, k) = _flatten_pad(x, tile)
    n = w.shape[-1]
    p = _plan.plan(xp, frozen_weight=fp)
    if ctx is not None:
        cost = (_cost.predict_plan_static(p, ctx.cost_coeffs)
                if ctx.cost_coeffs is not None else None)
        ctx.tap(p.valid_fraction, p.bytes_moved(), site=site, cost=cost)
    wp = pad_to_tile(w, tile, tile * fp.block_n).contiguous()
    c = _plan.execute(p, xp, wp, rows=m)
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
    y, frac = _SpammLinear.apply(x, w, cfg.tau, cfg.tile, cfg.backend,
                                 cfg.bwd, cfg.block_n, ctx, cfg.levels,
                                 cfg.dtype)
    ctx.tap(frac, site=site)
    return y
