"""Walk a model's gated GEMM weights and freeze their weight-side plans,
through an in-memory cache and an on-disk `PlanStore` when given.

Twin of `repro.plans.precompute` (`iter_gated_weights`, `tune_for`,
`freeze_tree`, `populate`). The gated GEMMs are the leaves named
wq/wk/wv/wo/w1/w2/w3 directly under a "mix" or "mlp" subtree. The port keeps
layers as a Python list of per-layer dicts (no stacked leading axis), so
`freeze_tree` mirrors that: a list of per-layer dicts of `FrozenWeight`s;
each per-layer (K, N) weight hashes like the reference's slice `flat[l]` of
its stacked leaf, so the two packages address one weight by one
fingerprint. With `SpammConfig.autotune` the port tunes what the
reference tunes: a stack of `group_len`-layer groups (1 for an attention or
SSM stack, the block pattern's 3 for a hybrid one) is tuned once per site —
its position in the group and its path — from group 0's weight, as the
reference tunes a stacked leaf from its first slice, and each layer of a
hybrid stack's tail (the reference's unstacked 2-D weights) on its own.
The two packages then pick the same parameters and file the artifacts
under the same addresses. `populate` is the store writer of
`repro_torch.launch.precompute_plans`.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.plan import WeightPlanCache
from repro_torch.plans.frozen import FrozenWeight
from repro_torch.plans.store import PlanStore, fingerprints

GATED_NAMES = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")
GATED_PARENTS = ("mix", "mlp")


def _is_gated(path, leaf) -> bool:
    return (len(path) >= 2 and path[-2] in GATED_PARENTS
            and path[-1] in GATED_NAMES and getattr(leaf, "ndim", 0) >= 2)


def _children(node):
    if isinstance(node, dict):
        return node.items()
    if isinstance(node, list):
        return enumerate(node)
    return ()


def iter_gated_weights(params, _prefix=()):
    """Yield (path_tuple, leaf) for every gated GEMM weight of a params
    tree; list positions (layer indices) appear in the path as ints."""
    for name, sub in _children(params):
        path = _prefix + (name,)
        if isinstance(sub, (dict, list)):
            yield from iter_gated_weights(sub, path)
        elif _is_gated(path, sub):
            yield path, sub


def frozen_leaves(tree):
    """Yield the `FrozenWeight`s of a `freeze_tree` result in walk order."""
    for _, sub in _children(tree):
        if isinstance(sub, (dict, list)):
            yield from frozen_leaves(sub)
        else:
            yield sub


def tune_for(w, scfg, *, profile=None, use_mxu: bool = False):
    """Autotune one weight's blocking parameters against the roofline cost
    model: argmin of predicted frozen-call time over block_n × levels ×
    bucket floor, with the config's own (block_n, levels, 16) always in the
    search space. `profile` is a `core.cost.CostProfile`; None loads
    `scfg.tune_profile` (or the nominal coefficients)."""
    from repro_torch.core import cost

    if profile is None:
        profile = cost.CostProfile.load_or_default(scfg.tune_profile)
    return cost.tune_weight(
        w, scfg.tau, tile=scfg.tile, dtype=scfg.dtype, backend=scfg.backend,
        profile=profile, defaults=(scfg.block_n, scfg.levels, 16),
        use_mxu=use_mxu)


def _freeze_one(w, scfg, *, cache=None, store: Optional[PlanStore] = None,
                use_mxu: bool = False, tuned=None,
                weight_hash: Optional[str] = None) -> FrozenWeight:
    """One weight → FrozenWeight, through the cache/store tiers when
    given (without a cache: the store, then a build). With `tuned` (a
    `TunedParams`) the artifact is frozen at the tuned block_n and levels,
    which address it in the store, and carries the record. `weight_hash`
    is w's content fingerprint when the caller has it (hashed here
    otherwise)."""
    block_n = tuned.block_n if tuned is not None else scfg.block_n
    levels = tuned.levels if tuned is not None else scfg.levels
    cache = cache if cache is not None else WeightPlanCache()
    return cache.frozen_weight(
        w, tau=scfg.tau, tile=scfg.tile, block_n=block_n, levels=levels,
        backend=scfg.backend, use_mxu=use_mxu, store=store, dtype=scfg.dtype,
        tuned=tuned, weight_hash=weight_hash)


def _tune_site(path, grouped: int, group_len: int) -> tuple:
    """The autotuner's site of a gated weight at `path`: its path names
    with the layer index replaced by the position in its group, or, past
    the `grouped` layers of whole groups, by the layer itself."""
    names = tuple(x for x in path if not isinstance(x, int))
    layer = next((x for x in path if isinstance(x, int)), None)
    if layer is None:
        return names
    if layer < grouped:
        return ("group", layer % group_len) + names
    return ("tail", layer) + names


def freeze_tree(params, scfg, *, cache=None, store: Optional[PlanStore] = None,
                use_mxu: bool = False, group_len: int = 1):
    """Freeze every gated weight of a params tree at SpAMM config `scfg`.

    Returns (tree, count): `tree` mirrors the params structure at the
    gated leaves (lists stay lists), each leaf a `FrozenWeight`; `count`
    is the number of weights frozen. `cache` (a `WeightPlanCache`) is the
    in-memory tier, `store` the persistent one: with a warm store the walk
    only loads (no get-norm pass). The content fingerprints are taken up
    front, on a few threads. With `scfg.autotune` each site
    (`_tune_site`: the path, with the layer index replaced by its position
    in a `group_len`-layer group, or by itself in the tail after the whole
    groups) is tuned once, on its first weight, and every layer of the site
    is frozen at that pick."""
    profile = None
    if scfg.autotune:
        from repro_torch.core import cost

        profile = cost.CostProfile.load_or_default(scfg.tune_profile)
    hashes = iter(fingerprints(w for _, w in iter_gated_weights(params)))
    n_layers = len(params.get("layers", ()))
    grouped = n_layers - n_layers % group_len
    tuned_by_site: dict = {}
    count = 0

    def walk(node, path):
        nonlocal count
        if isinstance(node, list):
            return [walk(x, path + (i,)) for i, x in enumerate(node)]
        out = {}
        for name, sub in node.items():
            p = path + (name,)
            if isinstance(sub, (dict, list)):
                frozen = walk(sub, p)
                if frozen:
                    out[name] = frozen
            elif _is_gated(p, sub):
                tuned = None
                if scfg.autotune:
                    site = _tune_site(p, grouped, group_len)
                    tuned = tuned_by_site.get(site)
                    if tuned is None:
                        tuned = tuned_by_site[site] = tune_for(
                            sub, scfg, profile=profile, use_mxu=use_mxu)
                out[name] = _freeze_one(sub, scfg, cache=cache, store=store,
                                        use_mxu=use_mxu, tuned=tuned,
                                        weight_hash=next(hashes))
                count += 1
        return out

    return walk(params, ()), count


def populate(store: PlanStore, params, scfg, *, cache=None,
             use_mxu: bool = False, group_len: int = 1) -> int:
    """Populate `store` with frozen plans for every gated GEMM weight of
    `params` under SpAMM config `scfg` (`group_len` as in `freeze_tree`).
    Returns the number of weights processed (store hits + fresh builds)."""
    _, count = freeze_tree(params, scfg, cache=cache, store=store,
                           use_mxu=use_mxu, group_len=group_len)
    return count
