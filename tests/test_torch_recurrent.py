"""The recurrent families against the JAX reference at `.reduced()` size:
mamba2-1.3b (the chunked SSD block, `models/ssm.py`) and recurrentgemma-9b
(the RG-LRU hybrid, `models/rglru.py`), at its reduced 3 layers (one (rec,
rec, attn) group) and at 5 (one group plus a two-layer tail). The same
weights (the reference's, carried across by `params_from_jax`), inputs from
a numpy seed, the reference's SpAMM on its `jnp` backend and the port on
the plain versions of its kernels (CPU tensors).

Tolerance: f32 outputs within OUT_RTOL of their largest magnitude. The
port's SSD sums its einsums in another order, and its RG-LRU scan is a
Hillis–Steele scan where the reference's `lax.associative_scan` combines
in another tree; both stay within 1e-6 here, so the bound is the one the
other families' tests hold. Structural tables (configs, layer kinds,
labels, frozen sites, fingerprints, autotune picks, tokens) must be exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ParallelConfig as RParallel
from repro.configs import SpammConfig as RSpamm
from repro.configs import get_config as rget_config
from repro.launch.mesh import make_ctx, make_host_mesh
from repro.models import model as RM
from repro.models import rglru as rrglru
from repro.models import ssm as rssm
from repro.models import transformer as rtr
from repro.plans import precompute as rpre
from repro.plans.store import fingerprint as rfingerprint
from repro.serving.engine import Engine as REngine
from repro.serving.engine import Request as RRequest
from repro_torch.configs import (PORTED_ARCHS, ParallelConfig, RGLRUConfig,
                                 SpammConfig, SSMConfig, get_config)
from repro_torch.core import plan as tplan
from repro_torch.launch import serve as tserve
from repro_torch.models import model as M
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tr
from repro_torch.plans import precompute as tpre
from repro_torch.plans.store import fingerprint
from repro_torch.serving.engine import Engine, Request

TILE = 16
B, PLEN, MAX_NEW, MAX_LEN = 2, 16, 5, 64
# f32 outputs relative to their largest magnitude (see the module docstring)
OUT_RTOL = 1e-5
# relative distance every gate product keeps from the gate τ, far above the
# ~1e-6 relative gap between the two packages' f32 norms
GATE_MARGIN = 1e-3
RPCFG = RParallel(compute_dtype="float32", remat="none", attn_q_chunk=8,
                  attn_kv_chunk=8, decode_seq_shard=False)
PCFG = ParallelConfig(compute_dtype="float32", attn_q_chunk=8)
# (arch, layers or None for the reduced depth)
MODELS = {"mamba2": ("mamba2-1.3b", None),
          "recurrentgemma": ("recurrentgemma-9b", None),
          "recurrentgemma_tail": ("recurrentgemma-9b", 5)}
HYBRID = ("recurrentgemma", "recurrentgemma_tail")
# the published widths each arch is held to (the configs' own sources)
FULL = {
    "mamba2-1.3b": dict(family="ssm", num_layers=48, d_model=2048,
                        num_heads=0, num_kv_heads=0, d_ff=0, vocab=50280,
                        subquadratic=True),
    "recurrentgemma-9b": dict(family="hybrid", num_layers=38, d_model=4096,
                              num_heads=16, num_kv_heads=1, d_ff=12288,
                              vocab=256000, act="gelu", sliding_window=2048,
                              subquadratic=True),
}
FULL_SUB = {
    "mamba2-1.3b": ("ssm", dict(state=128, head_dim=64, expand=2, chunk=256,
                                conv_dim=4, n_groups=1)),
    "recurrentgemma-9b": ("rglru", dict(lru_width=4096, conv_dim=4,
                                        c_exponent=8.0,
                                        block_pattern=("rec", "rec",
                                                       "attn"))),
}


def _fields(cfg) -> dict:
    """A config's fields, its sub-configs as dicts (the two packages'
    dataclasses are distinct types)."""
    return {f.name: (dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                     else v)
            for f in dataclasses.fields(cfg)
            for v in (getattr(cfg, f.name),)}


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _close(got, want):
    err = _rel_err(got, want)
    assert err <= OUT_RTOL, err


def _t(x):
    return torch.tensor(np.asarray(x))


def _configs(arch, layers):
    cfg, rcfg = get_config(arch).reduced(), rget_config(arch).reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        rcfg = dataclasses.replace(rcfg, num_layers=layers)
    return cfg, rcfg


@functools.lru_cache(maxsize=None)
def _model(name):
    arch, layers = MODELS[name]
    cfg, rcfg = _configs(arch, layers)
    rparams = RM.init_params(rcfg, RPCFG, jax.random.key(0))
    np_tree = jax.tree.map(np.asarray, rparams)
    params = M.params_from_jax(np_tree, cfg, device="cpu")
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(B, PLEN)).astype(np.int32)
    return dict(name=name, cfg=cfg, rcfg=rcfg, rparams=rparams,
                np_tree=np_tree, params=params, prompts=prompts)


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    return _model(request.param)


@pytest.fixture(scope="module", params=HYBRID)
def hybrid(request):
    return _model(request.param)


# ---------------------------------------------------------------------------
# configs and layer layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(FULL))
def test_config_fields_equal_the_references(arch):
    assert arch in PORTED_ARCHS
    for full, rfull in ((get_config(arch), rget_config(arch)),
                        (get_config(arch).reduced(),
                         rget_config(arch).reduced())):
        assert _fields(full) == _fields(rfull)
    full = get_config(arch)
    for k, v in FULL[arch].items():
        assert getattr(full, k) == v, k
    sub, fields = FULL_SUB[arch]
    assert dataclasses.asdict(getattr(full, sub)) == fields
    assert tr.stack_kinds(full) == rtr.stack_kinds(rget_config(arch))


def test_sub_config_defaults_equal_the_references():
    from repro.configs import RGLRUConfig as RRGLRU
    from repro.configs import SSMConfig as RSSM

    assert dataclasses.asdict(SSMConfig()) == dataclasses.asdict(RSSM())
    assert dataclasses.asdict(RGLRUConfig()) == dataclasses.asdict(RRGLRU())


@pytest.mark.parametrize("layers", [3, 5, 38])
def test_hybrid_layer_kinds_follow_the_reference_order(layers):
    """The flat list is the reference's groups in order, then its tail."""
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                              num_layers=layers)
    rcfg = dataclasses.replace(rget_config("recurrentgemma-9b"),
                               num_layers=layers)
    assert tr.hybrid_pattern(cfg) == rtr.hybrid_pattern(rcfg)
    n_groups, gkinds, tail = rtr.hybrid_pattern(rcfg)
    assert tr.layer_kinds(cfg) == gkinds * n_groups + tail
    assert tr.group_len(cfg) == 3
    assert len(tr.layer_kinds(cfg)) == layers
    if layers == 38:
        assert (n_groups, len(tail)) == (12, 2)


def test_params_from_jax_flattens_the_stacks(model):
    """Every reference leaf lands in the port's flat list, bit for bit: a
    hybrid group g's `l{i}` at layer 3g + i, the tail's `l{i}` after the
    groups; the port's own init makes the same tree."""
    cfg, np_tree, params = model["cfg"], model["np_tree"], model["params"]
    kinds = tr.layer_kinds(cfg)
    assert len(params["layers"]) == cfg.num_layers

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    if tr.stack_kinds(cfg) == "hybrid":
        n_groups, gkinds, tail = tr.hybrid_pattern(cfg)
        where = [(np_tree["groups"][f"l{i}"], g) for g in range(n_groups)
                 for i in range(len(gkinds))]
        where += [(np_tree["tail"][f"l{i}"], None) for i in range(len(tail))]
    else:
        where = [(np_tree["layers"], l) for l in range(cfg.num_layers)]
    for layer, (src, idx) in zip(params["layers"], where):
        want = dict(leaves(src))
        got = dict(leaves(layer))
        assert set(got) == set(want)
        for path, w in want.items():
            w = w if idx is None else w[idx]
            np.testing.assert_array_equal(got[path].numpy(), w)
    for layer, kind in zip(params["layers"], kinds):
        assert ("ssm" in layer) == (kind == "ssm")
        if kind == "rec":
            assert "in_gelu" in layer["mix"]
        if kind == "attn":
            assert "wq" in layer["mix"]
    own = M.init_params(cfg, PCFG, 0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), own) == \
        jax.tree.map(lambda t: tuple(t.shape), params)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _ssm_setup():
    cfg, rcfg = _configs("mamba2-1.3b", None)
    rp = rssm.ssm_params(jax.random.key(3), rcfg.ssm, cfg.d_model,
                         jnp.float32)
    return cfg, rcfg, rp, {k: _t(v) for k, v in rp.items()}


@pytest.mark.parametrize("init_state", [False, True])
def test_ssd_chunked_matches_reference(init_state):
    """S = 40 at chunk 32, as `ssm_block` runs it: one chunk from the
    initial state, then the 8-token remainder from the carried state; and
    two carried chunks at S = 64."""
    cfg, *_ = _ssm_setup()
    rng = np.random.default_rng(4)
    h, p, n = 8, cfg.ssm.head_dim, cfg.ssm.state
    for s in (40, 64):
        x = rng.standard_normal((2, s, h, p)).astype(np.float32)
        dt = rng.uniform(1e-3, 0.1, (2, s, h)).astype(np.float32)
        a = -rng.uniform(1.0, 16.0, h).astype(np.float32)
        bm = rng.standard_normal((2, s, n)).astype(np.float32)
        cm = rng.standard_normal((2, s, n)).astype(np.float32)
        s0 = (rng.standard_normal((2, h, p, n)).astype(np.float32)
              if init_state else None)
        m = (s // 32) * 32
        runs = [(slice(0, m), 32)] + ([(slice(m, s), s - m)] if m < s
                                      else [])
        st, rst = (None if s0 is None else _t(s0)), s0
        for sl, q in runs:
            y, st = tssm.ssd_chunked(_t(x[:, sl]), _t(dt[:, sl]), _t(a),
                                     _t(bm[:, sl]), _t(cm[:, sl]), q,
                                     init_state=st)
            ry, rst = rssm.ssd_chunked(
                jnp.asarray(x[:, sl]), jnp.asarray(dt[:, sl]),
                jnp.asarray(a), jnp.asarray(bm[:, sl]),
                jnp.asarray(cm[:, sl]), q,
                init_state=None if rst is None else jnp.asarray(rst))
            _close(y, ry)
            _close(st, rst)
            assert st.dtype == torch.float32


def test_ssm_block_matches_reference():
    """S = 40: the chunked run and the remainder, the output, the carried
    state and the conv cache."""
    cfg, rcfg, rp, tp = _ssm_setup()
    x = np.random.default_rng(5).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    y, c = tssm.ssm_block(tp, _t(x), cfg.ssm, norm_eps=cfg.norm_eps)
    ry, rc = rssm.ssm_block(rp, jnp.asarray(x), rcfg.ssm,
                            norm_eps=rcfg.norm_eps)
    _close(y, ry)
    _close(c["state"], rc["state"])
    _close(c["conv"], rc["conv"])
    assert c["conv"].shape == (2, cfg.ssm.conv_dim - 1,
                               tssm.ssm_dims(cfg.ssm, cfg.d_model).conv_ch)


def test_ssm_decode_step_matches_reference_in_place():
    """One token against a carried cache: the reference's output and
    cache, written into the given cache tensors."""
    cfg, rcfg, rp, tp = _ssm_setup()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    _, rc = rssm.ssm_block(rp, jnp.asarray(x), rcfg.ssm)
    cache = {k: _t(v).clone() for k, v in rc.items()}
    ids = {k: v.data_ptr() for k, v in cache.items()}
    xt = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    for _ in range(2):
        y, new = tssm.ssm_decode_step(tp, _t(xt), cache, cfg.ssm)
        ry, rc = rssm.ssm_decode_step(rp, jnp.asarray(xt), rc, rcfg.ssm)
        _close(y, ry)
        assert new is cache
        assert {k: v.data_ptr() for k, v in cache.items()} == ids
        for k in ("state", "conv"):
            _close(cache[k], rc[k])


def _rglru_setup():
    cfg, rcfg = _configs("recurrentgemma-9b", None)
    rp = rrglru.rglru_params(jax.random.key(7), rcfg.rglru, cfg.d_model,
                             jnp.float32)
    return cfg, rcfg, rp, {k: _t(v) for k, v in rp.items()}


@pytest.mark.parametrize("init_h", [False, True])
@pytest.mark.parametrize("s", [1, 37, 64])
def test_rglru_scan_matches_reference(init_h, s):
    cfg, rcfg, rp, tp = _rglru_setup()
    rng = np.random.default_rng(8)
    w = cfg.rglru.lru_width
    x = rng.standard_normal((2, s, w)).astype(np.float32)
    h0 = rng.standard_normal((2, w)).astype(np.float32) if init_h else None
    y, h = trglru.rglru_scan(tp, _t(x), cfg.rglru,
                             init_h=None if h0 is None else _t(h0))
    ry, rh = rrglru.rglru_scan(rp, jnp.asarray(x), rcfg.rglru,
                               init_h=None if h0 is None else jnp.asarray(h0))
    _close(y, ry)
    _close(h, rh)


def test_rglru_block_matches_reference():
    cfg, rcfg, rp, tp = _rglru_setup()
    x = np.random.default_rng(9).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    y, c = trglru.rglru_block(tp, _t(x), cfg.rglru)
    ry, rc = rrglru.rglru_block(rp, jnp.asarray(x), rcfg.rglru)
    _close(y, ry)
    _close(c["h"], rc["h"])
    _close(c["conv"], rc["conv"])


def test_rglru_decode_step_matches_reference_in_place():
    cfg, rcfg, rp, tp = _rglru_setup()
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    _, rc = rrglru.rglru_block(rp, jnp.asarray(x), rcfg.rglru)
    cache = {k: _t(v).clone() for k, v in rc.items()}
    ids = {k: v.data_ptr() for k, v in cache.items()}
    xt = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    for _ in range(2):
        y, new = trglru.rglru_decode_step(tp, _t(xt), cache, cfg.rglru)
        ry, rc = rrglru.rglru_decode_step(rp, jnp.asarray(xt), rc,
                                          rcfg.rglru)
        _close(y, ry)
        assert new is cache
        assert {k: v.data_ptr() for k, v in cache.items()} == ids
        for k in ("h", "conv"):
            _close(cache[k], rc[k])


def test_softplus_is_the_references_above_twenty():
    x = torch.tensor([-30.0, -1.0, 0.0, 5.0, 19.9, 20.1, 40.0])
    np.testing.assert_array_equal(
        tssm.softplus(x).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x.numpy()))))


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _ref_cache_layers(rcache, cfg):
    """The reference's cache pytree as the port's flat list of dicts."""
    def pick(tree, idx):
        return {k: np.asarray(v) if idx is None else np.asarray(v)[idx]
                for k, v in tree.items()}

    if tr.stack_kinds(cfg) != "hybrid":
        return [pick(rcache["layers"], l) for l in range(cfg.num_layers)]
    n_groups, gkinds, tail = tr.hybrid_pattern(cfg)
    out = [pick(rcache["groups"][f"l{i}"], g) for g in range(n_groups)
           for i in range(len(gkinds))]
    return out + [pick(rcache["tail"][f"l{i}"], None)
                  for i in range(len(tail))]


def _assert_caches_close(cache, rcache, cfg):
    want = _ref_cache_layers(rcache, cfg)
    assert len(cache["layers"]) == len(want)
    for got, ref in zip(cache["layers"], want):
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == torch.float32
            _close(got[k], ref[k])


def test_prefill_logits_and_caches_match_reference(model):
    cfg, rcfg = model["cfg"], model["rcfg"]
    prompts = model["prompts"]
    step = M.make_prefill_step(cfg, PCFG)
    rstep = RM.make_prefill_step(rcfg, RPCFG, make_ctx(make_host_mesh()))
    with torch.inference_mode():
        cache, logits = step(model["params"],
                             {"tokens": torch.as_tensor(prompts)})
    rcache, rlogits = rstep(model["rparams"], {"tokens": jnp.asarray(prompts)})
    _close(logits, rlogits)
    _assert_caches_close(cache, rcache, cfg)


def test_init_cache_matches_reference(model):
    cfg, rcfg = model["cfg"], model["rcfg"]
    cache = M.init_cache(cfg, PCFG, B, MAX_LEN, device="cpu")
    want = _ref_cache_layers(RM.init_cache(rcfg, RPCFG, B, MAX_LEN), cfg)
    for got, ref in zip(cache["layers"], want):
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in got.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in ref.items()}


def test_decode_steps_match_reference(model):
    """Prefill, the engines' padding into the decode cache, then three
    decode steps: logits and every layer's cache after each."""
    cfg, rcfg = model["cfg"], model["rcfg"]
    prompts = model["prompts"]
    eng = Engine(cfg, PCFG, model["params"], max_len=MAX_LEN, device="cpu")
    reng = REngine(rcfg, RPCFG, make_ctx(make_host_mesh()), model["rparams"],
                   max_len=MAX_LEN)
    dstep = M.make_decode_step(cfg, PCFG)
    rdstep = RM.make_decode_step(rcfg, RPCFG, make_ctx(make_host_mesh()))
    with torch.inference_mode():
        pc, logits = M.make_prefill_step(cfg, PCFG)(
            model["params"], {"tokens": torch.as_tensor(prompts)})
        cache = eng._pad_cache(pc, M.init_cache(cfg, PCFG, B, MAX_LEN,
                                                device="cpu"))
    rpc, rlogits = RM.make_prefill_step(rcfg, RPCFG, make_ctx(
        make_host_mesh()))(model["rparams"], {"tokens": jnp.asarray(prompts)})
    rcache = reng._pad_cache(rpc)
    tok = np.asarray(rlogits).argmax(-1).astype(np.int32)[:, None]
    for t in range(3):
        pos = PLEN + t
        with torch.inference_mode():
            logits, _ = dstep(model["params"], torch.as_tensor(tok), cache,
                              pos)
        rlogits, rcache = rdstep(model["rparams"], jnp.asarray(tok), rcache,
                                 jnp.int32(pos))
        _close(logits, rlogits)
        _assert_caches_close(cache, rcache, cfg)
        tok = np.asarray(rlogits).argmax(-1).astype(np.int32)[:, None]


@pytest.mark.parametrize("plen", [1, 2, 3])
def test_decode_continues_a_prompt_shorter_than_the_conv(model, plen):
    """A prompt shorter than conv_dim - 1 leaves a short conv history; the
    engine right-aligns it in the decode cache, zeros before it (the causal
    conv's own padding), so a decode step after a `plen`-token prefill
    gives the logits of a prefill over the `plen + 1` tokens."""
    cfg, params = model["cfg"], model["params"]
    eng = Engine(cfg, PCFG, params, max_len=MAX_LEN, device="cpu")
    pre = M.make_prefill_step(cfg, PCFG)
    seq = torch.as_tensor(model["prompts"][:, :plen + 1])
    with torch.inference_mode():
        short, _ = pre(params, {"tokens": seq[:, :plen]})
        cache = eng._pad_cache(short, M.init_cache(cfg, PCFG, B, MAX_LEN,
                                                   device="cpu"))
        logits, _ = M.make_decode_step(cfg, PCFG)(params, seq[:, plen:],
                                                  cache, plen)
        _, want = pre(params, {"tokens": seq})
    _close(logits, want)


def _engines(model, tau, **kw):
    sc = rsc = None
    if tau is not None:
        sc = SpammConfig(enable=True, tau=tau, tile=TILE)
        rsc = RSpamm(enable=True, tau=tau, tile=TILE, backend="jnp")
    eng = Engine(model["cfg"], PCFG, model["params"], max_len=MAX_LEN,
                 spamm_cfg=sc, device="cpu")
    reng = REngine(model["rcfg"], RPCFG, make_ctx(make_host_mesh()),
                   model["rparams"], max_len=MAX_LEN, spamm_cfg=rsc, **kw)
    return eng, reng


def _serve(model, eng, reng):
    prompts = model["prompts"]
    reqs = [Request(prompt=p, max_new_tokens=MAX_NEW) for p in prompts]
    rreqs = [RRequest(prompt=p, max_new_tokens=MAX_NEW) for p in prompts]
    return ((np.stack(eng.generate(reqs)), reqs[0].out),
            (np.stack(reng.generate(rreqs)), rreqs[0].out))


@pytest.fixture(scope="module")
def dense_served(model):
    """One dense wave of each engine, shared by the dense and τ = 0
    cases."""
    return _serve(model, *_engines(model, None))


@pytest.mark.parametrize("tau", [None, 0.0], ids=["dense", "tau0"])
def test_engine_tokens_match_reference(model, tau, dense_served):
    (toks, out), (rtoks, rout) = (dense_served if tau is None else
                                  _serve(model, *_engines(model, tau)))
    assert toks.shape == (B, MAX_NEW) and out["graphs"]["decode"] is False
    np.testing.assert_array_equal(toks, rtoks)
    if tau is None:
        assert out["spamm"] is None
        return
    np.testing.assert_array_equal(toks, dense_served[0][0])
    sp, rsp = out["spamm"], rout["spamm"]
    for key in ("gated_gemms", "decode_gated_gemms", "valid_fraction",
                "decode_valid_fraction"):
        assert sp[key] == rsp[key], key
    if model["name"] == "mamba2":
        # no gated GEMM: in_proj/out_proj are plain in the reference too
        assert sp["gated_gemms"] == sp["decode_gated_gemms"] == 0
        assert sp["valid_fraction"] is None and sp["per_layer"] == {}


def test_ssm_with_spamm_on_at_any_tau_is_dense():
    """mamba2 has no gated GEMM: a wave at τ > 0 is the dense wave, with
    zero taps and no division by a zero count."""
    model = _model("mamba2")
    (toks, out), (rtoks, rout) = _serve(model, *_engines(model, 1e3))
    dense, _ = _serve(model, *_engines(model, None))
    np.testing.assert_array_equal(toks, dense[0])
    np.testing.assert_array_equal(toks, rtoks)
    sp = out["spamm"]
    assert sp["gated_gemms"] == rout["spamm"]["gated_gemms"] == 0
    assert sp["decode_valid_fraction"] is None
    assert sp["gemm_bytes_moved"] is None and "cost_residual" not in sp


def _gap(p):
    p = np.sort(p[p > 0])
    lo, hi = int(0.35 * p.size), int(0.65 * p.size)
    g = lo + int(np.argmax(p[lo + 1:hi + 1] / p[lo:hi]))
    return float(np.sqrt(p[g] * p[g + 1]))


def _products(model, tau):
    """Every gate product a port wave at `tau` evaluates, with its τ and
    row grid."""
    products = []
    orig = tplan._plan_frozen

    def recording(a, fp, **kw):
        p = orig(a, fp, **kw)
        prod = p.norm_a[fp.step_i, fp.step_k] * fp.nbmax[fp.step_k, fp.step_j]
        products.append((prod[fp.step_real].numpy(), fp.tau, fp.gm))
        return p

    eng, _ = _engines(model, tau)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tplan, "_plan_frozen", recording)
        eng.generate([Request(prompt=p, max_new_tokens=MAX_NEW)
                      for p in model["prompts"]])
    return products


def _gap_tau(model):
    """A τ in a gap of the decode steps' gate products (decode keeps part
    of its tiles), GATE_MARGIN away from every product the run evaluates."""
    tau = _gap(np.concatenate([p for p, _, gm in _products(model, 0.0)
                               if gm == 1]))
    for _ in range(5):
        prods = _products(model, tau)
        margin = min(float(np.min(np.abs(p - tau)) / tau)
                     for p, _, _ in prods)
        if margin >= GATE_MARGIN:
            return tau
        tau = _gap(np.concatenate([p for p, _, gm in prods if gm == 1]))
    raise AssertionError(f"no τ {GATE_MARGIN} away from every product")


@pytest.fixture(scope="module")
def hybrid_gap(hybrid):
    """The hybrid stack's gap τ, and one wave of each engine at it: (τ, the
    port's engine, the two waves), shared by the tests that serve there."""
    tau = _gap_tau(hybrid)
    eng, reng = _engines(hybrid, tau)
    return tau, eng, _serve(hybrid, eng, reng)


def test_hybrid_gap_tau_matches_reference(hybrid_gap):
    """τ > 0 through frozen plans on the hybrid stack: the reference's
    tokens, valid fractions and per-(layer, site) cells."""
    _, _, ((toks, out), (rtoks, rout)) = hybrid_gap
    sp, rsp = out["spamm"], rout["spamm"]
    assert 0.0 < sp["decode_valid_fraction"] < 1.0
    np.testing.assert_array_equal(toks, rtoks)
    for key in ("valid_fraction", "decode_valid_fraction"):
        assert sp[key] == pytest.approx(rsp[key], abs=1e-12), key
    assert sp["gated_gemms"] == rsp["gated_gemms"]
    assert sp["decode_gated_gemms"] == rsp["decode_gated_gemms"]


def test_hybrid_frozen_equals_eager(hybrid, hybrid_gap):
    """Twin of the reference's frozen-parity test on the hybrid arch
    (`tests/test_frozen_plans.py`: τ 0.05, tile 16, weights from key 1,
    two 20-token prompts, 3 new tokens): the port's frozen engine emits the
    tokens of the reference's in-trace (lazy) and frozen engines, and its
    frozen prefill ≡ its eager (unfrozen) gate bit for bit, at that τ and
    at a gap τ."""
    cfg, rcfg = hybrid["cfg"], hybrid["rcfg"]
    rparams = RM.init_params(rcfg, RPCFG, jax.random.key(1))
    params = M.params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                               device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab, size=20).astype(np.int32)
               for _ in range(2)]
    sc = SpammConfig(enable=True, tau=0.05, tile=TILE)
    rsc = RSpamm(enable=True, tau=0.05, tile=TILE, backend="jnp")
    eng = Engine(cfg, PCFG, params, max_len=MAX_LEN, spamm_cfg=sc,
                 device="cpu")
    toks = eng.generate([Request(prompt=p, max_new_tokens=3)
                         for p in prompts])
    for freeze in (False, True):
        reng = REngine(rcfg, RPCFG, make_ctx(make_host_mesh()), rparams,
                       max_len=MAX_LEN, spamm_cfg=rsc, freeze_plans=freeze)
        rtoks = reng.generate([RRequest(prompt=p, max_new_tokens=3)
                               for p in prompts])
        for a, b in zip(toks, rtoks):
            np.testing.assert_array_equal(a, b)
    x = torch.as_tensor(np.stack(prompts))
    with torch.inference_mode():
        _, frozen = eng._prefill(params, {"tokens": x},
                                 eng._frozen_for(x.numel()))
        _, eager = eng._prefill(params, {"tokens": x}, None)
    assert torch.equal(frozen, eager)
    eng, _ = _engines(hybrid, hybrid_gap[0])
    x = torch.as_tensor(hybrid["prompts"])
    with torch.inference_mode():
        _, frozen = eng._prefill(hybrid["params"], {"tokens": x},
                                 eng._frozen_for(x.numel()))
        _, eager = eng._prefill(hybrid["params"], {"tokens": x}, None)
    assert torch.equal(frozen, eager)


def test_per_layer_labels_on_hybrid(hybrid, hybrid_gap):
    """Twin of the reference's per-layer test on the hybrid arch: every tap
    carries its flat layer index (group g's sub-layer i is 3g + i, the
    tail's after the groups), rec layers hold only MLP sites, the cells sum
    to the aggregates and equal the reference's."""
    _, eng, ((_, out), (_, rout)) = hybrid_gap
    pl, rpl = out["spamm"]["per_layer"], rout["spamm"]["per_layer"]
    kinds = tr.layer_kinds(hybrid["cfg"])
    assert sorted(pl) == list(range(len(kinds)))
    for layer, sites in pl.items():
        want = {"w1", "w2", "w3"} | ({"wq", "wk", "wv", "wo"}
                                     if kinds[layer] == "attn" else set())
        assert set(sites) == want, layer
    assert {int(k) for k in rpl} == set(pl)
    for layer, sites in pl.items():
        rsites = rpl[layer]
        assert set(rsites) == set(sites)
        for site, cell in sites.items():
            for key in ("gated_gemms", "decode_gated_gemms"):
                assert cell[key] == rsites[site][key], (layer, site, key)
            for key in ("valid_fraction", "decode_valid_fraction"):
                assert cell[key] == pytest.approx(rsites[site][key],
                                                  abs=1e-12)
    sp = out["spamm"]
    assert sum(c["gated_gemms"] for s in pl.values()
               for c in s.values()) == sp["gated_gemms"]
    assert sum(c["decode_gated_gemms"] for s in pl.values()
               for c in s.values()) == sp["decode_gated_gemms"]
    assert eng.trace_counts == {"prefill": 0, "decode": 1}


# ---------------------------------------------------------------------------
# the frozen walk
# ---------------------------------------------------------------------------

def test_freeze_tree_covers_hybrid_groups(hybrid):
    """Twin of the reference's hybrid freeze test: only the attn layers
    contribute wq..wo, every rec and attn layer its MLP; the count is the
    reference's, each weight's fingerprint equals the reference's per-slice
    one."""
    cfg, params = hybrid["cfg"], hybrid["params"]
    sc = SpammConfig(enable=True, tau=0.1, tile=TILE)
    tree, count = tpre.freeze_tree(params, sc, group_len=tr.group_len(cfg))
    rtree, rcount = rpre.freeze_tree(
        hybrid["rparams"], RSpamm(enable=True, tau=0.1, tile=TILE,
                                  backend="jnp"))
    assert count == rcount
    assert rcount == 4 * (cfg.num_layers // 3) + 3 * cfg.num_layers
    for layer, kind in zip(tree["layers"], tr.layer_kinds(cfg)):
        if kind == "attn":
            assert set(layer) == {"mix", "mlp"}
            assert set(layer["mix"]) == {"wq", "wk", "wv", "wo"}
        else:
            assert set(layer) == {"mlp"}
        assert set(layer["mlp"]) == {"w1", "w2", "w3"}
    want = sorted(fw.weight_hash for fw in _ref_leaves(rtree))
    got = sorted(fw.weight_hash for fw in tpre.frozen_leaves(tree))
    assert got == want
    for path, w in tpre.iter_gated_weights(params):
        assert fingerprint(w) == rfingerprint(np.asarray(w.numpy()))


def _ref_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _ref_leaves(v)
    elif isinstance(tree, list):
        yield from tree
    else:
        yield tree


def test_autotune_picks_equal_the_references_on_hybrid(hybrid):
    """Autotune tunes a grouped site once (group 0's weight) and each tail
    weight on its own, as the reference does: every weight's pick and
    store address equal the reference's."""
    cfg, params = hybrid["cfg"], hybrid["params"]
    sc = SpammConfig(enable=True, tau=0.05, tile=TILE, autotune=True)
    tree, _ = tpre.freeze_tree(params, sc, group_len=tr.group_len(cfg))
    rtree, _ = rpre.freeze_tree(
        hybrid["rparams"], RSpamm(enable=True, tau=0.05, tile=TILE,
                                  backend="jnp", autotune=True))

    def picks(leaves):
        return sorted((fw.weight_hash, fw.block_n, fw.num_levels,
                       fw.tuned.bucket) for fw in leaves)

    assert picks(tpre.frozen_leaves(tree)) == picks(_ref_leaves(rtree))
    # the tail's weights were tuned on their own: a site key per tail layer
    grouped = cfg.num_layers - cfg.num_layers % 3
    sites = {tpre._tune_site(p, grouped, 3)
             for p, _ in tpre.iter_gated_weights(params)}
    n_tail = cfg.num_layers - grouped
    assert len(sites) == 13 + 3 * n_tail


# ---------------------------------------------------------------------------
# what recurrent stacks refuse
# ---------------------------------------------------------------------------

def test_recurrent_stacks_reject_chunking_and_mixed_lengths(model):
    """Twin of the reference's test: `prefill_chunk` raises at
    construction ("attention stack"), a mixed-length batch at generate
    ("cannot chunk"), with the reference's words."""
    cfg, params = model["cfg"], model["params"]
    with pytest.raises(ValueError, match="attention stack") as err:
        Engine(cfg, PCFG, params, max_len=MAX_LEN, prefill_chunk=8,
               device="cpu")
    with pytest.raises(ValueError) as rerr:
        REngine(model["rcfg"], RPCFG, make_ctx(make_host_mesh()),
                model["rparams"], max_len=MAX_LEN, prefill_chunk=8)
    assert str(err.value) == str(rerr.value)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in (8, 12)]
    eng = Engine(cfg, PCFG, params, max_len=MAX_LEN, device="cpu")
    reng = REngine(model["rcfg"], RPCFG, make_ctx(make_host_mesh()),
                   model["rparams"], max_len=MAX_LEN)
    with pytest.raises(ValueError, match="cannot chunk") as err:
        eng.generate([Request(prompt=p, max_new_tokens=2) for p in prompts])
    with pytest.raises(ValueError) as rerr:
        reng.generate([RRequest(prompt=p, max_new_tokens=2)
                       for p in prompts])
    assert str(err.value) == str(rerr.value)
    with pytest.raises(NotImplementedError) as err:
        tr.stack_prefill_chunk(params, None, None, None, cfg, PCFG)
    with pytest.raises(NotImplementedError) as rerr:
        rtr.stack_prefill_chunk(model["rparams"], None, None, None,
                                model["rcfg"], RPCFG, None)
    assert str(err.value) == str(rerr.value)


@pytest.mark.parametrize("arch", list(FULL))
def test_serve_cli_on_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--reduced", "--num-requests", "2",
                 "--prompt-len", "16", "--max-new", "3", "--device", "cpu",
                 "--spamm-tau", "0.0", "--spamm-tile", "16"])
    out = capsys.readouterr().out
    assert "served 2 requests, 6 tokens" in out
    with pytest.raises(ValueError, match="cannot chunk"):
        tserve.main(["--arch", arch, "--reduced", "--num-requests", "4",
                     "--prompt-len", "16", "--max-new", "2", "--device",
                     "cpu", "--mixed-lengths"])
