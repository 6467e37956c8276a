"""Captured engine steps: the port's counterpart of the reference's
`jax.jit` per step shape.

A `StepGraph` is one engine step (a decode step, or one chunk of chunked
prefill) at one static shape, bound to static buffers it owns or is given:
its host inputs (tokens, positions, `last_idx`), the KV cache it writes in
place, and its outputs (the logits and their argmax tokens). `body()` runs
the step on those buffers and returns the outputs.

On a CUDA device with `capture=True`, the first call warms the step up on
a side stream (lazy initialisations stay outside the graph), then captures
`body()` once into a `torch.cuda.CUDAGraph` in the engine's graph memory
pool; every call copies its inputs into the static buffers and replays.
Anything that needs the host inside the step (a sync, a host read, a
copy from host memory) makes the capture fail, and the failure raises:
nothing falls back to running the step eagerly. With `capture=False` (the
CPU, or an engine built with `cuda_graphs=False`), every call runs
`body()` eagerly on the same buffers. A captured step keeps its graph's
topology beside the instantiated graph, so `nodes()` reads the exact count
of device nodes (kernels, copies, fills) a replay runs from the driver.

Python runs only at capture, so two things Python counts are carried over
to replays. The kernel wrappers' launch counters (`kernels.getnorm`,
`kernels.spamm_mm`) grow during the capture; the step keeps that growth
and adds it at each replay, so a graphed step reports the launches an
eager one does. The SpAMM context's taps are recorded during the capture
(their tensors become graph outputs in the pool), and so are their host
labels — phase, site, layer and the static cost terms — in capture order;
each replay appends a device-side copy of the values as one block with
those labels (`SpammContext.tap_block`), with no host read. A replay runs
no Python, so labels read at replay time would be whatever ran last; the
capture's are the step's own.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

# the kernel wrappers' launch counters: (module, attribute)
_COUNTERS = (
    ("getnorm", ("launches", "quant_launches", "mxu_launches",
                 "quant_mxu_launches", "pool_launches")),
    ("spamm_mm", ("launches", "decode_launches", "bf16_launches",
                  "int8_launches", "bf16_mma_sync_launches",
                  "int8_mma_sync_launches", "dense_launches")),
)


def _counter_refs():
    from repro_torch.kernels import getnorm, spamm_mm

    mods = {"getnorm": getnorm, "spamm_mm": spamm_mm}
    return [(mods[m], n) for m, names in _COUNTERS for n in names]


def read_counters() -> list:
    """Every kernel launch counter, in `_COUNTERS` order."""
    return [getattr(m, n) for m, n in _counter_refs()]


def _set_counters(values):
    for (m, n), v in zip(_counter_refs(), values):
        setattr(m, n, v)


def _add_counters(delta):
    for (m, n), d in zip(_counter_refs(), delta):
        if d:
            setattr(m, n, getattr(m, n) + d)


class StepGraph:
    """One engine step at one static shape (see the module docstring).

    `body` takes no arguments: it reads `inputs` (name → static tensor) and
    the cache it closes over, and returns a dict of output tensors.
    `pool` is the engine's graph pool of the step's device
    (`torch.cuda.graph_pool_handle()`), shared by its graphs there;
    `spamm_ctx` the engine's SpAMM context (or None). `device` is the card
    the step runs on: a captured step captures, replays and stages under
    `torch.cuda.device(device)`, so a step of another card than the
    current one records its own streams (None: the current card)."""

    def __init__(self, body: Callable[[], Dict[str, torch.Tensor]],
                 inputs: Dict[str, torch.Tensor], *, capture: bool,
                 pool=None, spamm_ctx=None, device=None):
        self.body = body
        self.inputs = inputs
        self.capture = capture
        self.pool = pool
        self.spamm_ctx = spamm_ctx
        self.device = device
        self.outputs: Optional[Dict[str, torch.Tensor]] = None
        self.capture_s: Optional[float] = None
        self._graph = None
        self._launches = None      # counter growth during the capture
        self._taps = None          # (values, nbytes, has_nbytes, labels)
        self._host: Dict[str, torch.Tensor] = {}
        self._staged = None        # event after the last host-to-device copy

    def __call__(self, **values) -> Dict[str, torch.Tensor]:
        """Copy `values` (name → numpy array, int or tensor) into the
        static inputs, run the step, return its outputs. The outputs are
        the step's static buffers: the next call overwrites them."""
        if not self.capture:
            self._stage(values)
            self.outputs = self.body()
            return self.outputs
        with (contextlib.nullcontext() if self.device is None
              else torch.cuda.device(self.device)):
            self._stage(values)
            if self._graph is None:
                self._capture()
            self._graph.replay()
        _add_counters(self._launches)
        if self._taps is not None:
            vals, nbytes, has, labels = self._taps
            self.spamm_ctx.tap_block(
                vals.clone(), None if nbytes is None else nbytes.clone(),
                has, labels)
        return self.outputs

    def nodes(self) -> Optional[int]:
        """Device nodes of the captured graph (the CUDA driver's
        `cuGraphGetNodes`), or None before a capture."""
        if self._graph is None:
            return None
        import ctypes

        get_nodes = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
        get_nodes.argtypes = (ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_size_t))
        get_nodes.restype = ctypes.c_int
        n = ctypes.c_size_t(0)
        rc = get_nodes(self._graph.raw_cuda_graph(), None, ctypes.byref(n))
        if rc != 0:
            raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
        return n.value

    def _stage(self, values):
        """Host values reach the card through pinned staging buffers and
        asynchronous copies; a scalar is a fill, a tensor a device copy."""
        if self._staged is not None:
            self._staged.synchronize()     # the last copy left the staging
        for name, v in values.items():
            buf = self.inputs[name]
            if isinstance(v, torch.Tensor):
                buf.copy_(v.reshape(buf.shape))
            elif np.ndim(v) == 0:
                buf.fill_(int(v))
            elif not buf.is_cuda:
                buf.copy_(torch.from_numpy(
                    np.ascontiguousarray(v, dtype=np.int32)).reshape(
                        buf.shape))
            else:
                host = self._host.get(name)
                if host is None:
                    host = torch.empty(buf.shape, dtype=buf.dtype,
                                       pin_memory=True)
                    self._host[name] = host
                host.numpy()[...] = np.asarray(v).reshape(buf.shape)
                buf.copy_(host, non_blocking=True)
        if self._host:
            self._staged = torch.cuda.Event()
            self._staged.record()

    def _capture(self):
        t0 = time.perf_counter()
        before = read_counters()
        ctx = self.spamm_ctx
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with _recording(ctx), torch.cuda.stream(side):
            self.body()
        torch.cuda.current_stream().wait_stream(side)
        _set_counters(before)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with _recording(ctx) as taps:
            with torch.cuda.graph(graph, pool=self.pool):
                self.outputs = self.body()
                self._taps = _stack_taps(taps)
        graph.instantiate()
        after = read_counters()
        self._launches = [a - b for a, b in zip(after, before)]
        _set_counters(before)
        self._graph = graph
        self.capture_s = time.perf_counter() - t0


def _recording(ctx):
    """The context's `record()` (taps kept out of the wave), or a stand-in
    without a context."""
    return ctx.record() if ctx is not None else contextlib.nullcontext([])


def _stack_taps(taps):
    """The recorded taps as (values (n,), nbytes (m,) or None, has_nbytes,
    labels) — the stacks are device ops, so inside a capture they become
    graph nodes; the labels are host values — or None."""
    if not taps:
        return None
    vals = torch.stack([torch.as_tensor(v).float().reshape(())
                        for _, v, _ in taps])
    has = tuple(b is not None for _, _, b in taps)
    nb = [torch.as_tensor(b).float().reshape(()) for _, _, b in taps
          if b is not None]
    labels = tuple(lab for lab, _, _ in taps)
    return vals, (torch.stack(nb) if nb else None), has, labels


def pool_bytes(pool) -> Optional[int]:
    """Bytes of the device memory segments that belong to a graph pool (a
    private pool keeps its segments while its graphs live, so this is also
    its peak), or None where the allocator does not report pools."""
    total, seen = 0, False
    for seg in torch.cuda.memory_snapshot():
        pid = seg.get("segment_pool_id")
        if pid is None:
            continue
        seen = True
        if tuple(pid) == tuple(pool):
            total += int(seg["total_size"])
    return total if seen else None
