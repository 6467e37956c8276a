"""Helpers for the port's parameter and state trees: nested dicts (keys
visited sorted) and lists of tensors — the part of `jax.tree` the
training path needs."""
from __future__ import annotations


def leaves(tree) -> list:
    """The leaves of `tree` in a fixed order: dict keys sorted, lists in
    order."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def flatten_with_paths(tree, prefix: str = "") -> list:
    """[(path, leaf), ...] in `leaves` order; a path joins the dict keys
    and list indices with "/" ("layers/0/mix/wq")."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_with_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten_with_paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def map_(fn, tree, *rest):
    """A tree of the same structure with fn(leaf, *matching leaves of
    `rest`) at each leaf."""
    if isinstance(tree, dict):
        return {k: map_(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def map_specs(fn, specs, *trees):
    """Like `map_` over a tree of placements (`models.model.param_specs`),
    whose tuples are leaves: fn(spec, *matching leaves of `trees`)."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [map_specs(fn, v, *(t[i] for t in trees))
                for i, v in enumerate(specs)]
    return fn(specs, *trees)


def pairs(tree, specs) -> list:
    """[(leaf, spec), ...] in `leaves(tree)` order, `specs` a placement
    tree of the same structure (its tuples are leaves)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in pairs(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in pairs(v, specs[i])]
    return [(tree, specs)]
