"""Checkpoints of the port (twin of `repro.checkpoint.checkpoint`):
atomic, optionally asynchronous, restart from the latest.

Layout: <dir>/step_<N>/arrays.npz + meta.json, written into a temporary
directory and renamed into place, so a crashed save is never taken for a
complete one; `keep` bounds how many steps stay. Keys follow the port's
tree ("params/layers/<i>/mix/wq", `repro_torch.tree.flatten_with_paths`).
npz has no bfloat16: such leaves are stored as their uint16 bit patterns
and restored by the dtype of the `like` tree. `restore` loads onto a given
device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as T


def _to_savable(x) -> np.ndarray:
    """A host copy of x (never a view of a CPU tensor, which the caller may
    go on updating in place); bf16 as its uint16 bit patterns."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return np.array(x.view(torch.int16).numpy().view(np.uint16))
        return np.array(x.numpy())
    return np.array(x)


def _from_saved(arr: np.ndarray, like, device, cut=None) -> torch.Tensor:
    dtype = like.dtype if isinstance(like, torch.Tensor) else None
    if dtype == torch.bfloat16 and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if cut is not None:
        t = cut(t)
    return t.to(device=device, dtype=dtype)


def save(ckpt_dir: str, step: int, state: dict, *, keep: int = 3,
         async_: bool = False, plan_store=None
         ) -> Optional[threading.Thread]:
    """Save `state` (a tree of tensors or arrays) as step `step`. The host
    copy is taken before returning, so an async save (`async_`: the write
    runs in a thread, which is returned) sees the values of the call.

    `plan_store` (a `plans.store.PlanStore` or its directory path) records
    the frozen-plan store's pointer beside the weights, so a restored
    server finds its plans (`plan_store_pointer`, `open_plan_store`)."""
    flat = {k: _to_savable(v) for k, v in T.flatten_with_paths(state)}
    store_ptr = None
    if plan_store is not None:
        if isinstance(plan_store, str):
            from repro_torch.plans.frozen import PLAN_FORMAT_VERSION

            store_ptr = {"path": os.path.abspath(plan_store),
                         "format_version": PLAN_FORMAT_VERSION}
        else:
            store_ptr = plan_store.manifest_pointer()

    def _write():
        tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
        final = os.path.join(ckpt_dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        meta = {"step": step, "keys": sorted(flat)}
        if store_ptr is not None:
            meta["plan_store"] = store_ptr
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _gc(ckpt_dir: str, keep: int):
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                out.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def plan_store_pointer(ckpt_dir: str, step: int) -> Optional[dict]:
    """The plan-store pointer a checkpoint was saved with, or None:
    {"path": <store dir>, "format_version": <int>}. Raises if the recorded
    format version is not the one this code reads, so a restored server
    never executes stale plans."""
    path = os.path.join(ckpt_dir, f"step_{step}", "meta.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        meta = json.load(f)
    ptr = meta.get("plan_store")
    if ptr is None:
        return None
    from repro_torch.plans.frozen import PLAN_FORMAT_VERSION

    if ptr.get("format_version") != PLAN_FORMAT_VERSION:
        raise ValueError(
            f"checkpoint step {step} points at a plan store written with "
            f"format version {ptr.get('format_version')!r}; this build "
            f"reads {PLAN_FORMAT_VERSION} — re-run precompute_plans")
    return ptr


def open_plan_store(ckpt_dir: str, step: int):
    """PlanStore from a checkpoint's pointer, or None when it has none."""
    ptr = plan_store_pointer(ckpt_dir, step)
    if ptr is None:
        return None
    from repro_torch.plans.store import PlanStore

    return PlanStore(ptr["path"])


def restore(ckpt_dir: str, step: int, like: Any, device=None, *,
            cut=None) -> Any:
    """Step `step` in the structure of `like` (a tree of tensors: their
    dtypes, and their device unless `device` is given). `cut` (a dict
    {path: fn}) keeps fn(saved leaf) of the leaves it names, on the host
    before the move to the device (a rank's shard: the saved leaf is read
    whole, one leaf at a time). Raises KeyError when a leaf of `like` is
    not in the checkpoint."""
    path = os.path.join(ckpt_dir, f"step_{step}", "arrays.npz")
    cut = cut or {}
    with np.load(path) as data:
        flat = dict(T.flatten_with_paths(like))
        got = {k: _from_saved(data[k], leaf,
                              device if device is not None
                              else getattr(leaf, "device", "cpu"),
                              cut.get(k))
               for k, leaf in flat.items()}

    def build(node, prefix=""):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, f"{prefix}{i}/")
                              for i, v in enumerate(node))
        return got[prefix[:-1]]

    return build(like)
