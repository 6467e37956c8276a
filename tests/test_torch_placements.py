"""The port's placements against the reference's, with no process group:
`param_specs` against `param_pspecs` leaf for leaf (every arch, FSDP on
and off, MoE tp and ep), `sanitize_spec` against `launch.dryrun`'s on a
table of shapes and meshes (the reference reads only `mesh.shape[axis]`,
so a stub mapping serves), `best_mesh_shape` against the reference's, the
EP expert padding, the production mesh's shape rule, the tile rule of
`place_spec`, and `shard_params` cutting what the ranks' shards put back
together."""
import dataclasses
import itertools
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import ParallelConfig as RParallel
from repro.configs import get_config as rget_config
from repro.distributed import elastic as RE
from repro.launch.dryrun import sanitize_spec as rsanitize
from repro.models import model as RM
from repro_torch.configs import ParallelConfig, get_config
from repro_torch.distributed import elastic as E
from repro_torch.launch import mesh as MS
from repro_torch.models import model as M
from repro_torch.models import transformer as tr


def _as_tuple(spec, ndim):
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


def _ref_tree(arch, fsdp, moe=None):
    rcfg, cfg = rget_config(arch).reduced(), get_config(arch).reduced()
    if moe is not None:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe,
                                                                 impl=moe))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               impl=moe))
    rpcfg = RParallel(fsdp=fsdp)
    shapes = jax.eval_shape(lambda k: RM.init_params(rcfg, rpcfg, k),
                            jax.random.key(0))
    specs = RM.param_pspecs(rcfg, rpcfg, shapes)
    return cfg, ParallelConfig(fsdp=fsdp), shapes, specs


def _ref_as_port(cfg, shapes, specs):
    """The reference's specs in the port's tree: a stacked layer leaf's
    spec without its leading L entry; a hybrid stack's groups and tail
    in stack order."""
    def drop(sp_tree, sh_tree, stacked):
        if isinstance(sp_tree, dict):
            return {k: drop(sp_tree[k], sh_tree[k], stacked)
                    for k in sp_tree}
        t = _as_tuple(sp_tree, len(sh_tree.shape))
        return t[1:] if stacked else t

    out = {k: drop(specs[k], shapes[k], False) for k in specs
           if k not in ("layers", "groups", "tail")}
    if tr.stack_kinds(cfg) == "hybrid":
        n_groups, gkinds, tail = tr.hybrid_pattern(cfg)
        layers = [drop(specs["groups"][f"l{i}"], shapes["groups"][f"l{i}"],
                       True) for _ in range(n_groups)
                  for i in range(len(gkinds))]
        layers += [drop(specs["tail"][f"l{i}"], shapes["tail"][f"l{i}"],
                        False) for i in range(len(tail))]
    else:
        one = drop(specs["layers"], shapes["layers"], True)
        layers = [one] * cfg.num_layers
    out["layers"] = layers
    return out


CASES = ([(a, f, None) for a in ARCH_IDS for f in (True, False)]
         + [(a, f, impl) for a in ("qwen2-moe-a2.7b", "mixtral-8x22b")
            for f in (True, False) for impl in ("tp", "ep")])


@pytest.mark.parametrize("arch,fsdp,moe", CASES,
                         ids=[f"{a}-{'fsdp' if f else 'nofsdp'}"
                              + (f"-{m}" if m else "") for a, f, m in CASES])
def test_param_specs_equal_the_references(arch, fsdp, moe):
    cfg, pcfg, shapes, specs = _ref_tree(arch, fsdp, moe)
    params = M.init_params(cfg, pcfg, device="meta")
    got = M.param_specs(cfg, pcfg, params)
    assert got == _ref_as_port(cfg, shapes, specs)


SANITIZE_TABLE = [
    (("data", "model"), (64, 128)),
    (("model", "data"), (50280, 4608)),
    ((None, "model"), (3, 6)),
    (("model",), (8,)),
    ((("data", "model"), None), (24, 5)),
    ((("data", "model"), None), (18, 5)),
    ((None, "data", "model"), (7, 64, 96)),
    (("model", None, None), (60, 4, 4)),
    (("data",), (5, 3)),
]
MESH_SIZES = [{"data": 1, "model": 1}, {"data": 2, "model": 2},
              {"data": 4, "model": 3}, {"data": 16, "model": 16},
              {"data": 3, "model": 8}]


@pytest.mark.parametrize("sizes", MESH_SIZES,
                         ids=[f"{s['data']}x{s['model']}"
                              for s in MESH_SIZES])
def test_sanitize_spec_equals_the_references(sizes):
    stub = types.SimpleNamespace(shape=sizes)
    for spec, shape in SANITIZE_TABLE:
        from jax.sharding import PartitionSpec as P

        want = _as_tuple(rsanitize(stub, P(*spec), shape), len(shape))
        assert M.sanitize_spec(sizes, spec, shape) == want, (spec, shape)


@pytest.mark.parametrize("mp", [1, 2, 4, 8, 16])
def test_best_mesh_shape_equals_the_references(mp):
    for n in range(1, 33):
        assert E.best_mesh_shape(n, mp) == RE.best_mesh_shape(n, mp), n


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_ep_padding_and_params_from_jax_take_the_padded_tree(m):
    rcfg = rget_config("qwen2-moe-a2.7b").reduced()
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, num_experts=6))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           num_experts=6))
    rp = RM.init_params(rcfg, RParallel(), jax.random.key(1),
                        model_axis_size=m)
    port = M.params_from_jax(jax.tree.map(np.asarray, rp), cfg,
                             device="cpu")
    own = M.init_params(cfg, ParallelConfig(), device="meta",
                        model_axis_size=m)
    e_pad = -(-6 // m) * m
    for li in range(cfg.num_layers):
        moe = port["layers"][li]["moe"]
        assert moe["w1"].shape[0] == moe["w2"].shape[0] == e_pad
        assert moe["router"].shape == (cfg.d_model, 6)
        np.testing.assert_array_equal(
            moe["w2"].numpy(), np.asarray(rp["layers"]["moe"]["w2"][li]))
        assert {k: tuple(v.shape) for k, v in own["layers"][li]["moe"].items()
                if k != "shared"} == {k: tuple(v.shape) for k, v in
                                      moe.items() if k != "shared"}


def test_production_mesh_shape_rule():
    assert MS.production_shape(8) == ((1, 8), ("data", "model"))
    assert MS.production_shape(256) == ((32, 8), ("data", "model"))
    assert MS.production_shape(512, multi_pod=True) == (
        (2, 32, 8), ("pod", "data", "model"))
    for bad, mp in ((4, False), (12, False), (24, True), (8, True)):
        with pytest.raises(ValueError, match="does not fit"):
            MS.production_shape(bad, multi_pod=mp)


@pytest.mark.parametrize("tile", [16, 64])
def test_place_spec_keeps_only_whole_tile_model_cuts(tile):
    sizes = {"data": 2, "model": 2}
    # starcoder2-7b over model = 2: wq 4608 → 2304 per rank (36 tiles of 64)
    assert M.place_spec(sizes, ("data", "model"), (4608, 4608),
                        tile=tile) == ("data", "model")
    # a 96-wide cut of 48 columns per rank is whole tiles of 16, not of 64
    want = ("data", "model") if 48 % tile == 0 else ("data", None)
    assert M.place_spec(sizes, ("data", "model"), (64, 96),
                        tile=tile) == want
    # experts are not a matrix dim: no tile rule
    assert M.place_spec(sizes, ("model", None, None), (6, 64, 32),
                        tile=tile) == ("model", None, None)
    # what sanitize drops stays dropped
    assert M.place_spec(sizes, ("data", "model"), (5, 128),
                        tile=tile) == (None, "model")


class _Coords:
    """A NetCtx stand-in for shard_params: axis sizes and this rank's
    coordinates, no process group."""

    def __init__(self, sizes, coords):
        self.sizes, self.coords = sizes, coords

    def size(self, ax):
        return self.sizes.get(ax, 1)

    def index(self, ax):
        return self.coords.get(ax, 0)


@pytest.mark.parametrize("arch", ["starcoder2-7b", "qwen2-moe-a2.7b"])
def test_shard_params_cuts_the_shards_the_mesh_puts_back(arch, monkeypatch):
    cfg = get_config(arch).reduced()
    pcfg = ParallelConfig()
    params = M.init_params(cfg, pcfg, 3, device="cpu", model_axis_size=2)
    sizes = {"data": 2, "model": 2}
    specs = M.placements(cfg, pcfg, params, sizes, tile=16)
    shards = {}
    for d, m in itertools.product(range(2), range(2)):
        monkeypatch.setattr(M, "_ctx_of",
                            lambda _, c={"data": d, "model": m}:
                            _Coords(sizes, c))
        shards[d, m] = M.shard_params(params, specs, None)
    from repro_torch import tree as T

    for (path, full), (_, spec) in zip(
            T.flatten_with_paths(params),
            _spec_items(specs)):
        # put the leaf back: concatenate along each placed dim in
        # row-major coordinate order
        def leaf(d, m):
            node = shards[d, m]
            for k in path.split("/"):
                node = node[int(k)] if isinstance(node, list) else node[k]
            return node

        axes = {ax: dim for dim, e in enumerate(spec) if e is not None
                for ax in (e if isinstance(e, tuple) else (e,))}
        rows = []
        for d in range(2):
            parts = [leaf(d, m) for m in range(2)]
            if "model" in axes:
                parts = [torch.cat(parts, axes["model"])]
            rows.append(parts[0])
        got = torch.cat(rows, axes["data"]) if "data" in axes else rows[0]
        assert torch.equal(got, full), path


def _spec_items(specs, prefix=""):
    if isinstance(specs, dict):
        return [x for k in sorted(specs)
                for x in _spec_items(specs[k], f"{prefix}{k}/")]
    if isinstance(specs, list):
        return [x for i, v in enumerate(specs)
                for x in _spec_items(v, f"{prefix}{i}/")]
    return [(prefix[:-1], specs)]
