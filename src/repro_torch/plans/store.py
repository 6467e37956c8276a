"""PlanStore: content-addressed on-disk store of FrozenWeight artifacts
(twin of `repro.plans.store`, in the same on-disk format).

Layout:  <root>/<key>/manifest.json + arrays.npz, written to a tmp dir and
moved into place with `os.rename`, so a crashed put is never taken for a
complete artifact. Each put writes its own tmp dir, so several processes
(tensor-parallel ranks that hold one shard) may put one key at once; the
move into place runs under an exclusive lock on `<root>/.put.lock`, so the
first writer's artifact stays and the others drop their copy. A complete
artifact is never removed, so a reader may load it while writers race. A
root-level STORE_FORMAT.json marker records the format version.

The key is a content address: sha256 over the weight's fingerprint and the
full gating config echo (τ, tile, block_n, levels, resolved backend,
get-norm variant, compute dtype, format version). Changing the weight or
any config field changes the key, so a stale artifact is a clean miss,
never a wrong-plan hit. A load re-validates the manifest: a format-version
mismatch or a backend outside the port's registry (`cuda`, `torch`) raises
`PlanStoreError`. The reference package records its own backends (`jnp`,
`interpret`, `pallas`), so an artifact written by one package is refused by
the other, as the reference refuses a backend it lacks. Opening a root that
holds artifacts but no marker (a store older than compute-dtype keying), or
a marker of another version, refuses at open time.
"""
from __future__ import annotations

import fcntl
import hashlib
import json
import os
import shutil
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.core.cost import TunedParams
from repro_torch.kernels import ops as kops
from repro_torch.kernels import quantize as kquant
from repro_torch.plans.frozen import PLAN_FORMAT_VERSION, FrozenWeight

_MARKER = "STORE_FORMAT.json"
_PUT_LOCK = ".put.lock"


class PlanStoreError(RuntimeError):
    """An on-disk plan artifact is incompatible with the running code."""


def fingerprint(w: torch.Tensor) -> str:
    """Content fingerprint of a weight matrix: sha256 over dtype, shape and
    raw bytes, equal to the reference's for the same values (a CUDA tensor
    is copied to the host first)."""
    a = w.detach().cpu().numpy()
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def fingerprints(ws) -> list:
    """`fingerprint` of each weight, in order, hashed on a few threads
    (sha256 and the device-to-host copies release the GIL; a full-size
    model is tens of GB of weights)."""
    ws = list(ws)
    if len(ws) < 2:
        return [fingerprint(w) for w in ws]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(fingerprint, ws))


def _config_echo(tau, tile, block_n, levels, backend, use_mxu, dtype) -> dict:
    if backend == "auto":
        raise ValueError("a store key needs the resolved backend: resolve "
                         "'auto' by the weight's device first "
                         "(kernels.ops.resolve_backend)")
    return {
        # through f32: artifacts carry τ as float32, queries often pass the
        # Python double, and both must address the same key
        "tau": float(np.float32(tau)),
        "tile": int(tile),
        "block_n": int(block_n),
        "levels": int(levels),
        "backend": str(backend),
        "use_mxu": bool(use_mxu),
        "dtype": kquant.canonical_dtype(dtype),
    }


class PlanStore:
    """Content-addressed FrozenWeight artifacts on disk.

    `get`/`put` address by (weight fingerprint × config echo); `hits`/
    `misses` count lookups (a warm start has misses only while first
    populating). A `WeightPlanCache` with its `store` attribute set uses
    this as the persistent tier below its in-memory map."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._check_format()
        self.hits = 0
        self.misses = 0

    def _check_format(self):
        """Refuse, at open time, a root written under another format:
        the version is part of every key, so its artifacts would read as
        misses and a warm start would silently re-freeze beside them. A
        fresh root gets the current marker."""
        mpath = os.path.join(self.root, _MARKER)
        # listed before the marker is looked for: a process of this format
        # writes the marker before its first artifact
        keys = self.keys()
        if os.path.isfile(mpath):
            with open(mpath) as f:
                fmt = json.load(f).get("format_version")
            if fmt != PLAN_FORMAT_VERSION:
                raise PlanStoreError(
                    f"plan store at {self.root!r} was written with format "
                    f"version {fmt!r}; this build reads version "
                    f"{PLAN_FORMAT_VERSION} — re-run precompute_plans into "
                    "a fresh root")
            return
        if keys:
            raise PlanStoreError(
                f"plan store at {self.root!r} predates compute-dtype keying "
                f"(format version < {PLAN_FORMAT_VERSION}: no {_MARKER}) — "
                "re-run precompute_plans into a fresh root")
        # written whole, then renamed: a process opening the root at once
        # reads the marker whole or not at all
        tmp = f"{mpath}.{os.getpid()}.{uuid.uuid4().hex}"
        with open(tmp, "w") as f:
            json.dump({"format_version": PLAN_FORMAT_VERSION}, f)
        os.replace(tmp, mpath)

    # -- addressing ---------------------------------------------------------
    @staticmethod
    def key_for(weight_hash: str, *, tau, tile: int, block_n: int,
                levels: int, backend: str, use_mxu: bool = False,
                dtype: str = "float32") -> str:
        echo = _config_echo(tau, tile, block_n, levels, backend, use_mxu,
                            dtype)
        blob = json.dumps({"weight": weight_hash, "cfg": echo,
                           "version": PLAN_FORMAT_VERSION}, sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:32]

    def _dir(self, key: str) -> str:
        return os.path.join(self.root, key)

    def keys(self):
        if not os.path.isdir(self.root):
            return []
        return sorted(
            d for d in os.listdir(self.root)
            if not d.startswith(".")  # .tmp_*: a crashed or running put
            and os.path.isfile(os.path.join(self.root, d, "manifest.json")))

    def __len__(self) -> int:
        return len(self.keys())

    def contains(self, weight_hash: str, **cfg) -> bool:
        return os.path.isfile(
            os.path.join(self._dir(self.key_for(weight_hash, **cfg)),
                         "manifest.json"))

    # -- put / get ----------------------------------------------------------
    def put(self, fw: FrozenWeight) -> str:
        """Persist one artifact; returns its key. Atomic (tmp + rename)."""
        if not fw.weight_hash:
            raise ValueError("a FrozenWeight needs a weight_hash to be stored")
        key = self.key_for(fw.weight_hash, **fw.config_key())
        final = self._dir(key)
        # a writer's own tmp dir: ranks that hold one shard (or a weight
        # every model rank keeps whole) put one key at once
        tmp = os.path.join(self.root,
                           f".tmp_{key}_{os.getpid()}_{uuid.uuid4().hex}")
        os.makedirs(tmp)

        def host(x):
            return x.detach().cpu().numpy()

        arrays = {"nbmax": host(fw.nbmax),
                  "kj_k": np.asarray(fw.kj_k, np.int32),
                  "kj_j": np.asarray(fw.kj_j, np.int32)}
        if fw.b_scale is not None:
            arrays["b_scale"] = host(fw.b_scale)
        for l, lv in enumerate(fw.levels):
            arrays[f"level_{l}"] = host(lv)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "format_version": fw.version,
            "weight_hash": fw.weight_hash,
            **fw.config_key(),
            "num_pyramid_levels": len(fw.levels),
            "wshape": list(fw.wshape),
            "padded": list(fw.padded),
            "arrays": sorted(arrays),
        }
        if fw.tuned is not None:
            # provenance and the bucket floor: not part of the key
            manifest["tuned"] = fw.tuned.as_manifest()
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        with open(os.path.join(self.root, _PUT_LOCK), "a") as lock:
            # writers move into place one at a time; readers take no lock
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.isfile(os.path.join(final, "manifest.json")):
                # another writer stored this key first: the key addresses
                # the content, so its artifact is this one (and a reader
                # may be loading it)
                shutil.rmtree(tmp, ignore_errors=True)
                return key
            if os.path.exists(final):
                # no manifest, so no reader loads it, and under the lock no
                # writer is placing it: a leftover, not an artifact
                shutil.rmtree(final)
            os.rename(tmp, final)
        return key

    def get(self, weight_hash: str, *, tau, tile: int, block_n: int,
            levels: int, backend: str, device, use_mxu: bool = False,
            dtype: str = "float32") -> Optional[FrozenWeight]:
        """Load an artifact onto `device`, or None on a miss. Raises
        `PlanStoreError` when the artifact exists but its manifest does not
        match the running code (format version, backend registry)."""
        key = self.key_for(weight_hash, tau=tau, tile=tile, block_n=block_n,
                           levels=levels, backend=backend, use_mxu=use_mxu,
                           dtype=dtype)
        path = self._dir(key)
        mpath = os.path.join(path, "manifest.json")
        if not os.path.isfile(mpath):
            self.misses += 1
            return None
        with open(mpath) as f:
            man = json.load(f)
        if man.get("format_version") != PLAN_FORMAT_VERSION:
            raise PlanStoreError(
                f"plan artifact {key} was written with format version "
                f"{man.get('format_version')!r}; this build reads version "
                f"{PLAN_FORMAT_VERSION} — re-run precompute_plans")
        if man.get("backend") not in kops.BACKENDS:
            raise PlanStoreError(
                f"plan artifact {key} targets backend {man.get('backend')!r} "
                f"which is not registered ({sorted(kops.BACKENDS)}) — "
                "re-run precompute_plans against this build")
        with np.load(os.path.join(path, "arrays.npz")) as data:
            arrays = {name: data[name] for name in data.files}

        def dev(name):
            return torch.as_tensor(arrays[name], device=device)

        n_levels = int(man["num_pyramid_levels"])
        fw = FrozenWeight(
            float(np.float32(man["tau"])),
            tuple(dev(f"level_{l}") for l in range(n_levels)),
            dev("nbmax"),
            arrays["kj_k"].astype(np.int32, copy=False),
            arrays["kj_j"].astype(np.int32, copy=False),
            dev("b_scale") if "b_scale" in arrays else None,
            tile=int(man["tile"]), block_n=int(man["block_n"]),
            num_levels=int(man["levels"]), backend=man["backend"],
            wshape=tuple(man["wshape"]), padded=tuple(man["padded"]),
            use_mxu=bool(man.get("use_mxu", False)),
            weight_hash=man["weight_hash"],
            version=int(man["format_version"]),
            compute_dtype=man.get("dtype", "float32"),
            tuned=TunedParams.from_manifest(man.get("tuned")),
        )
        self.hits += 1
        return fw

    def manifest_pointer(self) -> dict:
        """What a checkpoint records next to the weights so a restored
        server finds its precomputed plans."""
        return {"path": os.path.abspath(self.root),
                "format_version": PLAN_FORMAT_VERSION}
