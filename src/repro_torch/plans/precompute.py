"""Walk a model's gated GEMM weights and freeze their weight-side plans.

Twin of `repro.plans.precompute` (`iter_gated_weights`, `freeze_tree`),
without the on-disk `PlanStore` and the autotuner (ROADMAP queue A). The
gated GEMMs are the leaves named wq/wk/wv/wo/w1/w2/w3 directly under a "mix"
or "mlp" subtree. The port keeps layers as a Python list of per-layer dicts
(no stacked leading axis), so `freeze_tree` mirrors that: a list of
per-layer dicts of `FrozenWeight`s.
"""
from __future__ import annotations

from repro_torch.plans.frozen import FrozenWeight

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


def freeze_tree(params, scfg, *, use_mxu: bool = False):
    """Freeze every gated weight of a params tree at SpAMM config `scfg`.

    Returns (tree, count): `tree` mirrors the params structure at the
    gated leaves (lists stay lists), each leaf a `FrozenWeight`; `count`
    is the number of weights frozen."""
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
                out[name] = FrozenWeight.build(
                    sub, scfg.tau, tile=scfg.tile, block_n=scfg.block_n,
                    levels=scfg.levels, backend=scfg.backend,
                    use_mxu=use_mxu, compute_dtype=scfg.dtype)
                count += 1
        return out

    return walk(params, ()), count
