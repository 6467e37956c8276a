"""The port's plan store and offline precompute path against the JAX
reference: content fingerprints, store keys, artifacts file for file,
round trips, refusals, the memory tier above the store, and an engine that
warm-starts reduced starcoder2-7b from a precomputed store on the CPU.

The same numpy inputs go through both packages; the port runs the plain
versions of its kernels (CPU tensors, backend "torch"), the reference its
jnp backend or its Pallas kernels in interpret mode.
"""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_workers as W

from repro.configs import ParallelConfig as RParallel
from repro.configs import SpammConfig as RSpamm
from repro.configs import get_config as rget_config
from repro.core.cost import TunedParams as RTuned
from repro.models import model as RM
from repro.plans import precompute as rpre
from repro.plans import store as rstore
from repro.plans.frozen import FrozenWeight as RFrozenWeight
from repro_torch.configs import ParallelConfig, SpammConfig, get_config
from repro_torch.core import cost as tcost
from repro_torch.core import plan as tplan
from repro_torch.core.cost import TunedParams
from repro_torch.kernels import ops as tops
from repro_torch.models import model as M
from repro_torch.plans import precompute as tpre
from repro_torch.plans import store as tstore
from repro_torch.plans.frozen import PLAN_FORMAT_VERSION, FrozenWeight
from repro_torch.plans.store import PlanStore, PlanStoreError, fingerprint
from repro_torch.serving.engine import Engine, Request

# stored normmaps: the two packages' f32 tile norms sum 1024 squares (tile
# 32) in other orders; measured ≤ 1.3e-6 on the int8 and bf16 views against
# the reference's jnp einsum, as tests/test_torch_lowp.py states for its norms
NORM_RTOL = 2e-6
TAU = 4.0   # gates a partial fraction of the _decay operands at tile 32
ARCH = "starcoder2-7b"
TILE = 16
B, PLEN, MAX_NEW, MAX_LEN = 2, 16, 4, 64
RPCFG = RParallel(compute_dtype="float32", remat="none", attn_q_chunk=8,
                  attn_kv_chunk=8, decode_seq_shard=False)
PCFG = ParallelConfig(compute_dtype="float32", attn_q_chunk=8)


def _decay(m, n, seed, scale=0.4):
    rng = np.random.default_rng(seed)
    d = np.abs(np.arange(m)[:, None] - np.arange(n)[None, :])
    base = (scale / (d ** 0.5 + 1)).astype(np.float32)
    return base * rng.standard_normal((m, n)).astype(np.float32)


BASE = dict(tau=TAU, tile=32, block_n=1, levels=1, backend="torch")


def _mk_fw(w, **kw):
    cfg = {**BASE, **kw}
    wt = torch.as_tensor(w)
    return FrozenWeight.build(wt, cfg.pop("tau"), weight_hash=fingerprint(wt),
                              **cfg)


@pytest.fixture(scope="module")
def models():
    rcfg = rget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    rparams = RM.init_params(rcfg, RPCFG, jax.random.key(0))
    params = M.params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                               device="cpu")
    return cfg, rparams, params


# ---------------------------------------------------------------------------
# addressing
# ---------------------------------------------------------------------------

def test_fingerprint_matches_reference(models):
    """A per-layer weight of the port hashes like the reference's slice of
    its stacked leaf, for every gated weight of the model."""
    cfg, rparams, params = models
    want = {}
    for path, leaf in rpre.iter_gated_weights(rparams):
        flat = np.asarray(leaf).reshape(-1, *leaf.shape[-2:])
        for l in range(flat.shape[0]):
            want[(l, *path[-2:])] = rstore.fingerprint(flat[l])
    ws = list(tpre.iter_gated_weights(params))
    got = {(p[1], *p[-2:]): fingerprint(w) for p, w in ws}
    assert len(got) == 6 * cfg.num_layers and got == want
    assert tstore.fingerprints(w for _, w in ws) == [got[(p[1], *p[-2:])]
                                                     for p, _ in ws]


@pytest.mark.parametrize("field,value", [
    (None, None), ("tau", 0.1), ("tile", 16), ("block_n", 2), ("levels", 0),
    ("backend", "interpret"), ("use_mxu", True), ("dtype", "int8"),
    ("dtype", "bfloat16"), ("dtype", "bf16")])
def test_key_for_matches_reference(field, value):
    """The same echo gives the same key in both packages, field by field;
    each field moves the key (bf16 is an alias of bfloat16)."""
    base = dict(tau=0.05, tile=32, block_n=1, levels=1, backend="jnp",
                use_mxu=False, dtype="float32")
    cfg = dict(base) if field is None else {**base, field: value}
    key = PlanStore.key_for("ab" * 32, **cfg)
    assert key == rstore.PlanStore.key_for("ab" * 32, **cfg)
    assert tstore._config_echo(**cfg) == rstore._config_echo(**cfg)
    if field is not None:
        assert key != PlanStore.key_for("ab" * 32, **base)
    assert key != PlanStore.key_for("cd" * 32, **cfg)


def test_key_needs_a_resolved_backend():
    with pytest.raises(ValueError, match="resolve"):
        PlanStore.key_for("ab", tau=1.0, tile=16, block_n=1, levels=0,
                          backend="auto")
    assert tops.resolve_backend("auto", "cpu") == "torch"
    assert tops.resolve_backend("cuda", "cpu") == "cuda"
    fw = FrozenWeight.build(torch.ones(32, 32), 1.0, tile=16)
    assert fw.backend == "torch" and fw.config_key()["backend"] == "torch"


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_mxu", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_artifact_matches_reference_file_for_file(tmp_path, dtype, use_mxu):
    """A port artifact and a reference artifact of the same weight at the
    same config: the same marker, manifests equal except `backend`, the
    same arrays (pair lists and int8 scales exactly, normmaps within
    NORM_RTOL). The reference freezes on its jnp backend, or through its
    Pallas kernel in interpret mode for the Eq. 3-4 variant."""
    w = _decay(128, 96, 5)
    h = rstore.fingerprint(w)
    kw = dict(tile=32, block_n=2, levels=1, use_mxu=use_mxu,
              compute_dtype=dtype)
    rbackend = "interpret" if use_mxu else "jnp"
    rfw = RFrozenWeight.build(jnp.asarray(w), TAU, backend=rbackend,
                              weight_hash=h, **kw)
    tfw = FrozenWeight.build(torch.as_tensor(w), TAU, weight_hash=h, **kw)
    rkey = rstore.PlanStore(str(tmp_path / "ref")).put(rfw)
    tkey = PlanStore(str(tmp_path / "port")).put(tfw)
    assert tkey != rkey                       # the backend is keyed
    with open(tmp_path / "ref" / "STORE_FORMAT.json") as f:
        rmark = json.load(f)
    with open(tmp_path / "port" / "STORE_FORMAT.json") as f:
        assert json.load(f) == rmark
    with open(tmp_path / "ref" / rkey / "manifest.json") as f:
        rman = json.load(f)
    with open(tmp_path / "port" / tkey / "manifest.json") as f:
        tman = json.load(f)
    assert (rman.pop("backend"), tman.pop("backend")) == (rbackend, "torch")
    assert tman == rman
    with np.load(tmp_path / "ref" / rkey / "arrays.npz") as r, \
            np.load(tmp_path / "port" / tkey / "arrays.npz") as t:
        assert sorted(t.files) == sorted(r.files) == tman["arrays"]
        for name in r.files:
            assert t[name].dtype == r[name].dtype, name
            if name.startswith(("kj_", "b_scale")):
                np.testing.assert_array_equal(t[name], r[name], err_msg=name)
            else:
                np.testing.assert_allclose(t[name], r[name], rtol=NORM_RTOL,
                                           atol=0, err_msg=name)
    assert ("b_scale" in tman["arrays"]) == (dtype == "int8")


def test_store_roundtrip_hit_and_config_invalidation(tmp_path):
    w = _decay(64, 96, 20)
    st = PlanStore(str(tmp_path))
    fw = _mk_fw(w)
    st.put(fw)
    h = fingerprint(torch.as_tensor(w))
    assert h == rstore.fingerprint(w) == fw.weight_hash
    got = st.get(h, device="cpu", **BASE)
    assert got is not None and (st.hits, st.misses) == (1, 0)
    assert got.config_key() == fw.config_key()
    for name in ("wshape", "padded", "weight_hash", "version", "tuned",
                 "use_mxu", "compute_dtype", "num_levels"):
        assert getattr(got, name) == getattr(fw, name), name
    assert got.version == PLAN_FORMAT_VERSION and got.tau == fw.tau
    assert torch.equal(got.nbmax, fw.nbmax)
    np.testing.assert_array_equal(got.kj_k, fw.kj_k)
    np.testing.assert_array_equal(got.kj_j, fw.kj_j)
    assert all(torch.equal(a, b) for a, b in zip(got.levels, fw.levels))
    # the loaded artifact plans identically to the freshly built one
    x = torch.as_tensor(_decay(64, 64, 21))
    p1 = tplan.plan(x, frozen_weight=fw.for_rows(2))
    p2 = tplan.plan(x, frozen_weight=got.for_rows(2))
    assert torch.equal(p1.mask, p2.mask) and 0 < int(p1.valid_tiles)
    assert torch.equal(tplan.execute(p1, x, torch.as_tensor(w)),
                       tplan.execute(p2, x, torch.as_tensor(w)))
    # another weight is a miss (content addressing) ...
    w2 = w.copy()
    w2[0, 0] += 1.0
    assert st.get(fingerprint(torch.as_tensor(w2)), device="cpu",
                  **BASE) is None
    # ... and so is ANY config field changing
    for field, val in [("tau", TAU * 2), ("tile", 16), ("block_n", 2),
                       ("levels", 0), ("backend", "cuda"), ("use_mxu", True),
                       ("dtype", "int8"), ("dtype", "bfloat16")]:
        assert st.get(h, device="cpu", **{**BASE, field: val}) is None, field
    assert st.misses == 9 and st.contains(h, **BASE) and len(st) == 1


def test_store_keeps_tuned_records(tmp_path):
    """A tuned record rides the manifest (not the key) and sets the bucket
    floor; its manifest form is the reference's."""
    tuned = TunedParams(block_n=1, levels=1, bucket=64, predicted_us=3.5,
                        default_predicted_us=4.0, profile_key="torch/cpu")
    assert tuned.as_manifest() == RTuned(*tuned).as_manifest()
    assert TunedParams.from_manifest(None) is None
    w = _decay(64, 64, 22)
    fw = _mk_fw(w)
    fw.tuned = tuned
    st = PlanStore(str(tmp_path))
    assert st.put(fw) == PlanStore.key_for(fw.weight_hash, **BASE)
    got = st.get(fw.weight_hash, device="cpu", **BASE)
    assert got.tuned == tuned and got.bucket_floor == 64
    assert got.for_rows(1).step_i.numel() == 64
    assert _mk_fw(w).bucket_floor == 16
    assert st.manifest_pointer() == {"path": os.path.abspath(str(tmp_path)),
                                     "format_version": PLAN_FORMAT_VERSION}


def test_store_put_races_with_writers_and_a_reader(tmp_path):
    """Three processes put one key at once, round after round, while a
    fourth loads it: every put returns the key, the first writer's
    artifact stays (once a load hits, every later load hits the same
    artifact), and no tmp dir is left. Every other round starts over a
    leftover dir without a manifest (a crashed put of another build) at
    the key's place, which the writers replace."""
    from repro_torch.launch.mesh import spawn_ranks

    w = _decay(64, 96, 23)
    taus = [TAU * (1 + r / 8) for r in range(8)]
    root = str(tmp_path / "store")
    PlanStore(root)
    keys = []
    for r, tau in enumerate(taus):
        fw = _mk_fw(w, tau=tau)
        keys.append(PlanStore.key_for(fw.weight_hash, **fw.config_key()))
        if r % 2:
            os.makedirs(os.path.join(root, keys[-1]))
            with open(os.path.join(root, keys[-1], "arrays.npz"), "w") as f:
                f.write("partial")
    got = spawn_ranks(W.store_race, 4, backend="gloo",
                      args=(root, w, taus, 3), timeout_s=120)
    for rank in range(3):
        assert got[rank] == keys, rank
    for r, loads in enumerate(got[3]):
        first = next((i for i, x in enumerate(loads) if x is not None),
                     len(loads))
        assert all(loads[first:]) and len(loads) - first > 40, (r, loads)
    st = PlanStore(root)
    assert st.keys() == sorted(keys)
    assert not [d for d in os.listdir(root) if d.startswith(".tmp_")]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_store_refuses_version_and_backend_mismatch(tmp_path):
    w = _decay(64, 64, 22)
    st = PlanStore(str(tmp_path))
    key = st.put(_mk_fw(w))
    h = fingerprint(torch.as_tensor(w))
    mpath = tmp_path / key / "manifest.json"
    with open(mpath) as f:
        man = json.load(f)
    man["format_version"] = PLAN_FORMAT_VERSION + 1
    with open(mpath, "w") as f:
        json.dump(man, f)
    with pytest.raises(PlanStoreError, match="format version"):
        st.get(h, device="cpu", **BASE)
    man["format_version"] = PLAN_FORMAT_VERSION
    man["backend"] = "not-a-backend"
    with open(mpath, "w") as f:
        json.dump(man, f)
    with pytest.raises(PlanStoreError, match="not registered"):
        st.get(h, device="cpu", **BASE)
    with pytest.raises(ValueError, match="weight_hash"):
        st.put(FrozenWeight.build(torch.as_tensor(w), TAU, tile=32))


def test_reference_store_opens_but_its_artifacts_are_refused(tmp_path):
    """A root the reference wrote opens in the port (same format marker),
    and its artifact, made for a backend the port lacks, raises; the
    reference likewise rejects the port's backend names."""
    w = _decay(64, 64, 23)
    h = rstore.fingerprint(w)
    rst = rstore.PlanStore(str(tmp_path))
    rst.put(RFrozenWeight.build(jnp.asarray(w), TAU, tile=32, levels=1,
                                backend="jnp", weight_hash=h))
    st = PlanStore(str(tmp_path))
    assert len(st) == 1
    with pytest.raises(PlanStoreError, match="not registered"):
        st.get(h, device="cpu", **{**BASE, "backend": "jnp"})
    assert st.get(h, device="cpu", **BASE) is None     # torch: a clean miss
    st.put(_mk_fw(w))
    with pytest.raises(ValueError):
        rst.get(h, **BASE)


def test_store_refuses_legacy_roots(tmp_path):
    legacy = tmp_path / "legacy"
    art = legacy / "deadbeefdeadbeef"
    art.mkdir(parents=True)
    with open(art / "manifest.json", "w") as f:
        json.dump({"format_version": PLAN_FORMAT_VERSION - 1}, f)
    with pytest.raises(PlanStoreError, match="predates compute-dtype"):
        PlanStore(str(legacy))
    vers = tmp_path / "versioned"
    vers.mkdir()
    with open(vers / "STORE_FORMAT.json", "w") as f:
        json.dump({"format_version": PLAN_FORMAT_VERSION - 1}, f)
    with pytest.raises(PlanStoreError, match="fresh root"):
        PlanStore(str(vers))
    # fresh roots mark themselves and reopen; a .tmp_* leftover of a crashed
    # put is no artifact
    fresh = tmp_path / "fresh"
    PlanStore(str(fresh))
    assert (fresh / "STORE_FORMAT.json").is_file()
    (fresh / ".tmp_junk").mkdir()
    st = PlanStore(str(fresh))
    assert len(st) == 0
    shutil.rmtree(fresh / ".tmp_junk")
    st.put(_mk_fw(_decay(64, 64, 24)))
    assert len(PlanStore(str(fresh))) == 1


# ---------------------------------------------------------------------------
# the memory tier and the precompute walk
# ---------------------------------------------------------------------------

def test_weight_plan_cache_is_memory_tier_above_store(tmp_path):
    b = torch.as_tensor(_decay(64, 64, 25))
    st = PlanStore(str(tmp_path))
    cache = tplan.WeightPlanCache(store=st)
    kw = dict(tau=TAU, tile=32, levels=1)
    fw1 = cache.frozen_weight(b, **kw)
    assert cache.frozen_misses == 1 and st.misses == 1 and len(st) == 1
    assert fw1.backend == "torch" and fw1.weight_hash == fingerprint(b)
    fw2 = cache.frozen_weight(b, **kw)           # memory hit
    assert fw2 is fw1 and cache.frozen_hits == 1 and st.hits == 0
    cache2 = tplan.WeightPlanCache(store=st)     # cold memory, warm store
    fw3 = cache2.frozen_weight(b, **kw)
    assert (st.hits, st.misses) == (1, 1)         # loaded, not rebuilt
    assert torch.equal(fw3.nbmax, fw1.nbmax)
    cache.frozen_weight(b, use_mxu=True, **kw)   # the variant is keyed
    assert cache.frozen_misses == 2 and len(st) == 2
    cache.clear()
    assert (cache.frozen_hits, cache.frozen_misses) == (0, 0)
    assert cache.frozen_weight(b, **kw) is not fw1


# coefficients under which the tuner's picks differ by site on the reduced
# model (bytes and flops dear, steps and gate nearly free)
TUNE_COEFFS = (1e9, 1e9, 1e-12, 1e-6, 1e15)
# relative distance every layer-0 weight norm keeps from the autotune τ
GATE_MARGIN = 1e-3


def _tune_profile(path):
    """One profile file: TUNE_COEFFS under the port's key and the
    reference's."""
    prof = tcost.CostProfile()
    for backend in ("torch", "jnp"):
        prof.put(backend, tcost.CostCoeffs(*TUNE_COEFFS, calibrated=True),
                 kind="cpu")
    return prof.save(str(path))


def _autotune_tau(params, lo=1.9, hi=2.0):
    """A τ in [lo, hi] in the widest gap of layer 0's gated weight norms at
    TILE: the tuner gates the all-ones activation at nb ≥ τ, so no pick
    can flip on an ulp between the packages' norms."""
    ns = np.unique(np.concatenate([
        tops.tile_norms(w, TILE).numpy().ravel()
        for path, w in tpre.iter_gated_weights(params) if path[1] == 0]))
    mid = np.sqrt(ns[:-1] * ns[1:])
    gap = np.where((mid > lo) & (mid < hi), ns[1:] / ns[:-1] - 1.0, 0.0)
    assert gap.max() >= 2 * GATE_MARGIN
    return float(mid[int(np.argmax(gap))])


def test_populate_counts_and_refuses_autotune(models, tmp_path, monkeypatch):
    """populate counts and hits; with autotune (refused before the tuner
    was ported, now run) `freeze_tree` and `populate` tune each gated site
    once, on its layer-0 weight, and freeze every layer at the pick: the
    reference's picks (its stacked leaves tuned from slice 0), frozen at
    the tuned block_n and levels, and the reference's store addresses (up
    to the backend's name); the store keeps the `TunedParams`."""
    cfg, rparams, params = models
    sc = SpammConfig(enable=True, tau=0.05, tile=TILE)
    st = PlanStore(str(tmp_path / "plain"))
    n = tpre.populate(st, params, sc)
    assert n == 6 * cfg.num_layers == len(st) == st.misses and st.hits == 0
    assert tpre.populate(st, params, sc) == n and st.hits == n
    tree, count = tpre.freeze_tree(params, sc)    # no cache, no store
    assert count == n and len(tree["layers"]) == cfg.num_layers
    assert set(tree["layers"][0]["mix"]) == {"wq", "wk", "wv", "wo"}
    assert all(fw.tuned is None for fw in tpre.frozen_leaves(tree))

    prof = _tune_profile(tmp_path / "profile.json")
    tau = _autotune_tau(params)
    sa = SpammConfig(enable=True, tau=tau, tile=TILE, autotune=True,
                     tune_profile=prof)
    tuned_on = []
    orig = tpre.tune_for

    def recording(w, scfg, **kw):
        tuned_on.append(w)
        return orig(w, scfg, **kw)

    monkeypatch.setattr(tpre, "tune_for", recording)
    tree, count = tpre.freeze_tree(params, sa)
    monkeypatch.undo()
    layer0 = {id(w) for path, w in tpre.iter_gated_weights(params)
              if path[1] == 0}
    assert count == n and len(tuned_on) == 6
    assert {id(w) for w in tuned_on} == layer0
    rtree, rcount = rpre.freeze_tree(
        rparams, RSpamm(enable=True, tau=tau, tile=TILE, backend="jnp",
                        autotune=True, tune_profile=prof))
    assert rcount == count
    picks = set()
    for layer in range(cfg.num_layers):
        for part, sites in tree["layers"][layer].items():
            for site, fw in sites.items():
                rfw = rtree["layers"][part][site][layer]
                assert fw.tuned is tree["layers"][0][part][site].tuned
                assert fw.tuned._replace(profile_key="") == \
                    rfw.tuned._replace(profile_key="")
                assert fw.tuned.profile_key == "torch/cpu"
                assert fw.tuned.predicted_us <= \
                    fw.tuned.default_predicted_us
                assert (fw.block_n, fw.num_levels) == (
                    fw.tuned.block_n, fw.tuned.levels) == (
                    rfw.block_n, rfw.num_levels)
                assert fw.bucket_floor == fw.tuned.bucket
                assert fw.weight_hash == rfw.weight_hash
                assert PlanStore.key_for(
                    fw.weight_hash,
                    **{**fw.config_key(), "backend": "jnp"}) == \
                    rstore.PlanStore.key_for(rfw.weight_hash,
                                             **rfw.config_key())
                picks.add(fw.block_n)
    assert len(picks) > 1, picks          # the picks differ by site
    fw0 = tpre.tune_for(params["layers"][0]["mlp"]["w1"], sc)
    assert (fw0.block_n, fw0.levels, fw0.bucket) in {
        (b, lv, bk) for b in tcost.BLOCK_N_CHOICES
        for lv in tcost.LEVELS_CHOICES for bk in tcost.BUCKET_CHOICES}
    assert fw0.profile_key == "torch/<nominal>"

    st2 = PlanStore(str(tmp_path / "tuned"))
    assert tpre.populate(st2, params, sa) == n == len(st2) == st2.misses
    warm = PlanStore(st2.root)
    for path, w in tpre.iter_gated_weights(params):
        fw = tree["layers"][path[1]][path[2]][path[3]]
        got = warm.get(fw.weight_hash, **fw.config_key(), device="cpu")
        assert got is not None and got.tuned == fw.tuned
    assert warm.hits == n and warm.misses == 0


def test_spamm_configs_match_field_for_field():
    """Every field of the reference's SpammConfig, the MoE switch
    `moe_bmm` included, in its order, with the same defaults."""
    ours = {f.name: f.default for f in dataclasses.fields(SpammConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(RSpamm)}
    assert list(ref) == list(ours) and ours["moe_bmm"] is False
    assert all(ours[k] == ref[k] for k in ours if k != "backend")
    assert ours["autotune"] is False and ours["tune_profile"] is None


# ---------------------------------------------------------------------------
# warm-started serving
# ---------------------------------------------------------------------------

def _generate(cfg, params, sc, prompts, **kw):
    eng = Engine(cfg, PCFG, params, max_len=MAX_LEN, spamm_cfg=sc,
                 device="cpu", **kw)
    reqs = [Request(prompt=p, max_new_tokens=MAX_NEW) for p in prompts]
    return eng, np.stack(eng.generate(reqs)), reqs[0].out["spamm"]


def test_engine_warm_starts_from_precomputed_store(models, tmp_path,
                                                    monkeypatch):
    """populate → a fresh engine with the store: store hits only, no
    get-norm on a weight-shaped matrix while it freezes and serves, the
    cold engine's tokens; a second wave reports 0/0 store traffic."""
    cfg, _, params = models
    sc = SpammConfig(enable=True, tau=12.0, tile=TILE)  # gates both phases
    st = PlanStore(str(tmp_path))
    n = tpre.populate(st, params, sc)
    assert n == 6 * cfg.num_layers
    prompts = np.random.default_rng(1).integers(
        1, cfg.vocab, size=(B, PLEN)).astype(np.int32)
    _, cold, cold_sp = _generate(cfg, params, sc, prompts)
    assert "plan_store_hits" not in cold_sp
    assert 0.0 < cold_sp["valid_fraction"] < 1.0
    assert 0.0 < cold_sp["decode_valid_fraction"] < 1.0

    weight_shapes = {tuple(w.shape)
                     for _, w in tpre.iter_gated_weights(params)}
    seen = []
    bk = tops.BACKENDS["torch"]

    def recording(fn):
        def norms(x, *a, **kw):
            seen.append(tuple(x.shape))
            return fn(x, *a, **kw)
        return norms

    monkeypatch.setitem(tops.BACKENDS, "torch", dataclasses.replace(
        bk, norms=recording(bk.norms), norms_quant=recording(bk.norms_quant)))
    eng, warm, sp = _generate(cfg, params, sc, prompts,
                              plan_store=str(tmp_path))
    np.testing.assert_array_equal(warm, cold)
    assert (sp["plan_store_hits"], sp["plan_store_misses"]) == (n, 0)
    assert seen and not weight_shapes & set(seen), (weight_shapes, seen)
    reqs = [Request(prompt=p, max_new_tokens=MAX_NEW) for p in prompts]
    np.testing.assert_array_equal(np.stack(eng.generate(reqs)), cold)
    sp2 = reqs[0].out["spamm"]
    assert (sp2["plan_store_hits"], sp2["plan_store_misses"]) == (0, 0)
    assert eng.spamm_ctx.cache.store is eng.plan_store


def test_precompute_and_serve_clis_on_cpu(tmp_path, capsys):
    """precompute_plans populates a store that serve --plan-store then hits
    for every gated weight, with the tokens of a run without the store."""
    from repro_torch.launch import precompute_plans, serve

    root = str(tmp_path / "plans")
    flags = ["--spamm-tile", "16", "--spamm-levels", "1"]
    precompute_plans.main(["--arch", ARCH, "--reduced", "--plan-store", root,
                           "--tau", "0.05", "--device", "cpu", *flags])
    out = capsys.readouterr().out
    assert "precomputed 12 weight plans" in out and "12 built" in out
    argv = ["--arch", ARCH, "--reduced", "--num-requests", "2",
            "--prompt-len", "16", "--max-new", "3", "--device", "cpu",
            "--spamm-tau", "0.05", *flags]
    serve.main(argv)
    plain = capsys.readouterr().out
    serve.main(argv + ["--plan-store", root])
    warm = capsys.readouterr().out
    assert "plan_store: 12h/0m" in warm and "plan_store" not in plain
    toks = [[ln for ln in o.splitlines() if ln.strip().startswith("req")]
            for o in (plain, warm)]
    assert len(toks[0]) == 2 and toks[0] == toks[1]
    # autotuned (refused before the tuner was ported): precompute with
    # --autotune --tune-profile, then serve --spamm-autotune with the same
    # profile hits every tuned artifact, with the tokens of an autotuned
    # run without the store
    prof = _tune_profile(tmp_path / "profile.json")
    tuned_root = str(tmp_path / "tuned")
    precompute_plans.main(["--arch", ARCH, "--reduced", "--plan-store",
                           tuned_root, "--tau", "1.9", "--device", "cpu",
                           "--autotune", "--tune-profile", prof, *flags])
    out = capsys.readouterr().out
    assert "precomputed 12 weight plans" in out and "autotuned" in out
    argv = ["--arch", ARCH, "--reduced", "--num-requests", "2",
            "--prompt-len", "16", "--max-new", "3", "--device", "cpu",
            "--spamm-tau", "1.9", *flags, "--spamm-autotune",
            "--spamm-tune-profile", prof]
    serve.main(argv)
    plain = capsys.readouterr().out
    serve.main(argv + ["--plan-store", tuned_root])
    warm = capsys.readouterr().out
    assert "plan_store: 12h/0m" in warm
    for o in (plain, warm):
        assert "autotune (block_n, levels, bucket):" in o
    toks = [[ln for ln in o.splitlines() if ln.strip().startswith("req")]
            for o in (plain, warm)]
    assert len(toks[0]) == 2 and toks[0] == toks[1]
