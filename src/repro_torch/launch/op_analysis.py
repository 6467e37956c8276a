"""Op-level roofline counter for the dry run (twin of
`repro.launch.hlo_analysis`).

The reference walks the optimized HLO text because XLA's
`cost_analysis()` counts a while-loop body once: it has to find trip
counts and multiply. Eager torch has no compiled program to parse and
nothing to multiply: every iteration of a Python loop dispatches its ops
again. So the twin is a `TorchDispatchMode` (`OpAnalysis`, a context
manager) that records every aten and c10d op that runs while it is open,
with the real tensors' shapes, and no trip counts or HLO parsing exist
here.

  * FLOPs: the dots (`mm`, `addmm`, `bmm`, `baddbmm`, `mv`, `dot`,
    `_scaled_mm`, `_int_mm`; `matmul`, `einsum` and `linear` reach these
    as they decompose), convolutions (and their backward) and SDPA, each
    also recorded under its operands' dtype (`flops_by_dtype`): a card
    runs an f32 product at a fifteenth of a bf16 one's rate, so a roofline
    prices each dtype at its own peak.
  * HBM bytes: each op that launches a kernel adds its unique operand
    bytes plus its output bytes (the reference's no-fusion-reuse model).
    Views add 0, and so do ops that launch nothing (`empty`, `detach`,
    `.item()`). Copies, casts, concatenation, padding, indexing and fills
    are "staging" (the reference's `_MOVE_OPS`).
  * Collectives: the c10d ops that `torch.distributed` dispatches count
    under the reference's kind names, with their operand bytes and the
    ring model's wire bytes (`_wire_bytes`, the reference's formula). The
    group size comes from the op's own process group argument, so the
    reference's `_group_size` (which reads `replica_groups` out of HLO
    text) has no counterpart. `OpAnalysis(mesh)` maps each group to its
    mesh axis, which the dry run's per-axis link rates read.
  * The port's hand-written kernels launch through ctypes, where no
    dispatch mode sees them. Their registry entries (`kernels.ops`) report
    each launch to the open analysis (`OpAnalysis.kernel`): executed tile
    products (2·tile³·block_n FLOPs each, the step table's real steps),
    the dense-equivalent product and the operand bytes. The aten ops a
    kernel's wrapper (or its plain version on the CPU) runs inside are not
    recorded, so a kernel counts the same on the CPU and on the card.

Everything is per rank: the analysis sees this rank's shards. Opening an
analysis inside a CUDA graph capture raises (counting a kernel reads its
step count from the device).
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# c10d op → (kind, index of the input argument, index of the output one)
_C10D_OPS = {
    "_allgather_base_": ("all-gather", 1, 0),
    "allgather_": ("all-gather", 1, 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 1, 0),
    "allreduce_": ("all-reduce", 0, 0),
    "allreduce_coalesced_": ("all-reduce", 0, 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "reduce_scatter_": ("reduce-scatter", 1, 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 0),
    "alltoall_base_": ("all-to-all", 1, 0),
    "alltoall_": ("all-to-all", 1, 0),
    "send": ("collective-permute", 0, 0),
}
_C10D_FREE = {"barrier", "monitored_barrier_", "recv_", "recv_any_source_"}

# ops that launch no kernel
_NO_KERNEL = {
    "empty", "empty_strided", "new_empty", "new_empty_strided",
    "empty_like", "detach", "lift_fresh", "_local_scalar_dense", "set_",
    "resize_", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "record_stream", "_has_compatible_shallow_copy_type",
}

# data movement, casts and fills: the reference's `_MOVE_OPS`
_MOVE_OPS = {
    "_to_copy", "copy_", "clone", "cat", "stack", "constant_pad_nd", "flip",
    "roll", "repeat", "slice_scatter", "select_scatter", "index_select",
    "index", "index_put_", "gather", "zeros", "ones", "full", "arange",
    "zeros_like", "ones_like", "full_like", "fill_", "zero_",
}

_DOTS = {"mm": (0, 1), "_int_mm": (0, 1), "_scaled_mm": (0, 1),
         "addmm": (1, 2), "bmm": (0, 1), "baddbmm": (1, 2), "mv": (0, 1),
         "addmv": (1, 2), "dot": (0, 1), "vdot": (0, 1)}


def _wire_bytes(op: str, in_bytes: int, out_bytes: int, g: int) -> float:
    """Per-rank wire-byte estimate under a ring model (the reference's)."""
    if g <= 1:
        return 0.0
    if op == "all-gather":
        return float(out_bytes) * (g - 1) / g
    if op == "all-reduce":
        return 2.0 * in_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return float(in_bytes) * (g - 1) / g
    if op == "all-to-all":
        return float(in_bytes) * (g - 1) / g
    if op == "collective-permute":
        return float(in_bytes)
    return 0.0


def _tensors(x):
    """The tensors in x (a tensor or nested lists and tuples of them)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor):
    return (t.data_ptr(), t.dtype, tuple(t.shape), tuple(t.stride()))


def _unique_bytes(ts) -> int:
    seen, total = set(), 0
    for t in ts:
        k = _key(t)
        if k not in seen:
            seen.add(k)
            total += _nbytes(t)
    return total


def _dot_flops(name: str, args) -> float:
    i, j = _DOTS[name]
    a, b = args[i], args[j]
    if name in ("dot", "vdot"):
        return 2.0 * a.shape[0]
    if name in ("mv", "addmv"):
        return 2.0 * a.shape[0] * a.shape[1]
    if a.dim() == 3:                                   # bmm / baddbmm
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


def _conv_flops(x, w, out, transposed: bool) -> float:
    """2 · (MACs of one output element, or one input element when
    transposed) · elements."""
    per = w.shape[1] * math.prod(w.shape[2:])
    return 2.0 * (x.numel() if transposed else out.numel()) * per


def _sdpa_flops(name: str, args) -> float:
    """The two products of attention, q (B, H, Sq, D) against k (B, H, Sk,
    D): 4·B·H·Sq·Sk·D forward, twice that backward (dq, dk, dv, dp)."""
    q, k = (args[1], args[2]) if "backward" in name else (args[0], args[1])
    b, h, sq, d = q.shape
    f = 4.0 * b * h * sq * k.shape[-2] * d
    return 2.0 * f if "backward" in name else f


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _flops(name: str, args, out) -> float:
    if name in _DOTS:
        return _dot_flops(name, args)
    if name in ("convolution", "_convolution"):
        return _conv_flops(args[0], args[1], out, bool(args[6]))
    if name == "convolution_backward":
        grad, x, w = args[0], args[1], args[2]
        f = _conv_flops(x, w, grad, bool(args[7]))
        mask = args[10]
        return f * (int(bool(mask[0])) + int(bool(mask[1])))
    if "scaled_dot_product" in name:
        return _sdpa_flops(name, args)
    return 0.0


def _is_view(func) -> bool:
    """Whether an op returns a view of an input (aliased, not written)."""
    for r in func._schema.returns:
        info = r.alias_info
        if info is not None and not info.is_write:
            return True
    return False


def _process_group(args):
    """The process group among an op's arguments (c10d ops take it boxed
    as a ScriptObject), or None."""
    for a in args:
        if isinstance(a, dist.ProcessGroup):
            return a
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a)
            except RuntimeError:
                continue
    return None


def _axis_names(mesh) -> Dict[str, str]:
    """{process group name: mesh axis} of a DeviceMesh."""
    if mesh is None:
        return {}
    return {mesh.get_group(d).group_name: name
            for d, name in enumerate(mesh.mesh_dim_names)}


class OpAnalysis(TorchDispatchMode):
    """Records the ops of what runs inside `with OpAnalysis(mesh) as an:`
    (see the module docstring); `totals()` gives the reference's keys."""

    def __init__(self, mesh=None, axes=None):
        super().__init__()
        # {process group name: axis}: the mesh's axes, plus `axes` (groups
        # of flattened axes)
        self.axis_of = {**_axis_names(mesh), **(axes or {})}
        self.warnings: List[str] = []
        self.flops = 0.0
        self.flops_by_dtype: Dict[str, float] = defaultdict(float)
        self.bytes_hbm = 0.0
        self.bytes_staging = 0.0
        self.collectives: List[dict] = []
        self.byte_contribs: Dict[str, float] = defaultdict(float)
        self.kernels: Dict[str, dict] = {}
        # (kind, input tensor) of the first collective: a rank's own data
        # before any exchange (under a fake group, what comes out of a
        # collective is not data)
        self.first_collective = None
        self._quiet = 0

    # -- the context ---------------------------------------------------
    def __enter__(self):
        from repro_torch.kernels import ops

        if (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError("OpAnalysis cannot open inside a CUDA graph "
                               "capture: counting a kernel reads its step "
                               "count from the device")
        if ops.analysis is not None:
            raise RuntimeError("an OpAnalysis is already open")
        ops.analysis = self
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.analysis = None
        return super().__exit__(*exc)

    # -- aten and c10d ops ---------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._quiet:
            self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out):
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "c10d":
            self._collective(name, args)
            return
        if name in _NO_KERNEL or _is_view(func):
            return
        f = _flops(name, args, out)
        if f:
            self.flops += f
            # the product's first operand: a dot's, a convolution's input,
            # attention's q (a backward's grad has the same dtype)
            x = args[_DOTS[name][0]] if name in _DOTS else args[0]
            self.flops_by_dtype[_dtype_name(x.dtype)] += f
        b = float(_unique_bytes(_tensors((args, list(kwargs.values()))))
                  + _unique_bytes(_tensors(out)))
        self.bytes_hbm += b
        if name in _MOVE_OPS:
            self.bytes_staging += b
        shape = tuple(out.shape) if isinstance(out, torch.Tensor) else ""
        self.byte_contribs[f"{name} {str(shape)[:40]}"] += b

    def _collective(self, name, args):
        if name in _C10D_FREE:
            return
        if name not in _C10D_OPS:
            self.warnings.append(f"c10d.{name}: not counted")
            return
        kind, i_in, i_out = _C10D_OPS[name]
        if self.first_collective is None:
            self.first_collective = (kind, next(_tensors(args[i_in])))
        in_b = _unique_bytes(_tensors(args[i_in]))
        out_b = _unique_bytes(_tensors(args[i_out]))
        pg = _process_group(args)
        if pg is None:
            self.warnings.append(f"c10d.{name}: no process group; "
                                 f"using the world's size")
            g, axis = dist.get_world_size(), None
        else:
            g, axis = pg.size(), self.axis_of.get(pg.group_name)
        self.collectives.append({
            "op": kind, "mult": 1.0, "in_bytes": in_b, "out_bytes": out_b,
            "group": g, "axis": axis,
            "wire_bytes": _wire_bytes(kind, in_b, out_b, g)})

    # -- the hand-written kernels --------------------------------------
    def quiet(self, call: Callable):
        """call() with nothing recorded (a kernel wrapper's own ops, the
        analysis's own reads)."""
        self._quiet += 1
        try:
            return call()
        finally:
            self._quiet -= 1

    def kernel(self, name: str, call: Callable, operands, *, flops: float,
               products: Optional[Callable[[], int]] = None,
               product_flops: float = 0.0,
               dense_flops: Optional[float] = None,
               dtype: torch.dtype = torch.float32):
        """Run one kernel launch `call()` and record it under `name`: its
        operand bytes (`operands`, unique) plus its output's; `flops` for a
        kernel without tile products (a get-norm), else `products()` real
        tile products (read from the device) of `product_flops` each, beside
        `dense_flops`, the dense product's; the FLOPs under `dtype`, the
        operands' (a get-norm's f32)."""
        out = self.quiet(call)
        n = int(self.quiet(products)) if products is not None else 0
        if products is not None:
            flops = n * product_flops
        b = float(_unique_bytes(_tensors(operands))
                  + _unique_bytes(_tensors(out)))
        rec = self.kernels.setdefault(name, {
            "launches": 0, "tile_products": 0, "flops": 0.0,
            "dense_flops": 0.0, "bytes": 0.0})
        rec["launches"] += 1
        rec["tile_products"] += n
        rec["flops"] += flops
        rec["dense_flops"] += flops if dense_flops is None else dense_flops
        rec["bytes"] += b
        self.flops += flops
        self.flops_by_dtype[_dtype_name(dtype)] += flops
        self.bytes_hbm += b
        self.byte_contribs[f"kernel {name}"] += b
        return out

    # -- results -------------------------------------------------------
    def collective_summary(self) -> dict:
        agg = defaultdict(lambda: {"count": 0.0, "in_bytes": 0.0,
                                   "wire_bytes": 0.0})
        for c in self.collectives:
            a = agg[c["op"]]
            a["count"] += c["mult"]
            a["in_bytes"] += c["mult"] * c["in_bytes"]
            a["wire_bytes"] += c["wire_bytes"]
        return dict(agg)

    def wire_bytes_by_axis(self) -> dict:
        """{mesh axis (None: a group of no axis): wire bytes}."""
        out = defaultdict(float)
        for c in self.collectives:
            out[c["axis"]] += c["wire_bytes"]
        return dict(out)

    def top_bytes(self, k=15):
        return sorted(self.byte_contribs.items(), key=lambda x: -x[1])[:k]

    def totals(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "hbm_bytes_per_device": self.bytes_hbm,
            "hbm_staging_bytes_per_device": self.bytes_staging,
            "hbm_math_bytes_per_device": self.bytes_hbm - self.bytes_staging,
            "collective_wire_bytes_per_device": sum(
                c["wire_bytes"] for c in self.collectives),
            "collectives": self.collective_summary(),
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "warnings": self.warnings[:20],
        }
