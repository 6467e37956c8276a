"""The port's chunked-prefill plane against the JAX reference on reduced
starcoder2-7b: the same weights (carried across by `params_from_jax`),
prompts from a numpy seed, the reference on its `jnp` backend and the port
on the plain versions of its kernels (CPU tensors).

At τ > 0 the gate is per row tile, and a chunked step's tiles hold other
lanes (idle slots, clamp-padded chunk tails) than a solo run's, so a
chunked engine is held to the reference's chunked step functions and
engine on identical lanes; against solo runs only at τ = 0 or with SpAMM
off.
"""
import dataclasses

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
from repro.serving.engine import Engine as REngine
from repro.serving.engine import Request as RRequest
from repro_torch.configs import ParallelConfig, SpammConfig, get_config
from repro_torch.core import plan as tplan
from repro_torch.core.cost import bucket_ladder
from repro_torch.models import model as M
from repro_torch.models import transformer as tr
from repro_torch.serving import engine as E
from repro_torch.serving.engine import Engine, Request

ARCH = "starcoder2-7b"
TILE = 16
CHUNK = 16
MAX_LEN = 64
MAX_NEW = 4
# chunk and decode logits against the reference: f32 after two layers, the
# port's one-softmax attention against the reference's blocked online
# softmax, relative to the logits' largest magnitude
LOGIT_TOL = 1e-5
# relative distance every gate product must keep from τ, far above the
# ~1e-6 relative gap between the two packages' f32 norms
GATE_MARGIN = 1e-3
MIX = (5, 16, 23)
QUEUE_MIX = (5, 16, 23, 9, 12, 30)

RPCFG = RParallel(compute_dtype="float32", remat="none", attn_q_chunk=8,
                  attn_kv_chunk=8, decode_seq_shard=False)
PCFG = ParallelConfig(compute_dtype="float32", attn_q_chunk=8)


@pytest.fixture(scope="module")
def setup():
    rcfg = rget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    rparams = RM.init_params(rcfg, RPCFG, jax.random.key(0))
    params = M.params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                               device="cpu")
    return rcfg, cfg, rparams, params


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in lengths]


def _sc(tau):
    return None if tau is None else SpammConfig(enable=True, tau=tau,
                                                tile=TILE)


def _rsc(tau):
    return None if tau is None else RSpamm(enable=True, tau=tau, tile=TILE,
                                           backend="jnp")


def _engine(setup, tau=None, cfg=None, **kw):
    _, base, _, params = setup
    return Engine(cfg or base, PCFG, params, max_len=MAX_LEN,
                  spamm_cfg=_sc(tau), device="cpu", **kw)


def _generate(eng, prompts, max_new=MAX_NEW, **kw):
    reqs = [Request(prompt=p, max_new_tokens=max_new, **kw) for p in prompts]
    return [o.tolist() for o in eng.generate(reqs)], reqs


def _ref_generate(setup, prompts, tau, **kw):
    rcfg, _, rparams, _ = setup
    eng = REngine(rcfg, RPCFG, make_ctx(make_host_mesh()), rparams,
                  max_len=MAX_LEN, spamm_cfg=_rsc(tau), **kw)
    reqs = [RRequest(prompt=p, max_new_tokens=MAX_NEW) for p in prompts]
    return [o.tolist() for o in eng.generate(reqs)], reqs


def _solo(setup, prompts, tau=None, cfg=None):
    return [_generate(_engine(setup, tau, cfg), [p])[0][0] for p in prompts]


def _recording(monkeypatch):
    """Record (row tiles, gate products of real steps) of every frozen
    gate the port evaluates."""
    products = []
    orig = tplan._plan_frozen

    def recording(a, fp, **kw):
        p = orig(a, fp, **kw)
        prod = p.norm_a[fp.step_i, fp.step_k] * fp.nbmax[fp.step_k, fp.step_j]
        products.append((fp.gm, prod[fp.step_real].numpy()))
        return p

    monkeypatch.setattr(tplan, "_plan_frozen", recording)
    return products


def _gap_tau(p, lo, hi):
    """τ in the widest gap of the sorted products between quantiles."""
    p = np.sort(p)
    a, b = int(lo * p.size), int(hi * p.size)
    g = a + int(np.argmax(p[a + 1:b + 1] / p[a:b]))
    return float(np.sqrt(p[g] * p[g + 1]))


@pytest.fixture(scope="module")
def gap_tau(setup):
    """A τ in a gap of every gate product the 2-slot queue run evaluates,
    inside the decode steps' range (whose row tile holds 2 real rows, so
    their products lie below the chunks'): both phases keep part of their
    tiles, and no decision can flip on an ulp."""
    with pytest.MonkeyPatch.context() as mp:
        products = _recording(mp)
        _, cfg, _, _ = setup
        prompts = _prompts(cfg, QUEUE_MIX, 6)
        _generate(_engine(setup, 0.0, prefill_chunk=CHUNK, max_slots=2),
                  prompts)
        dec = np.concatenate([p for gm, p in products if gm == 1])
        tau = _gap_tau(dec, 0.35, 0.65)
        for _ in range(5):
            products.clear()
            _, reqs = _generate(_engine(setup, tau, prefill_chunk=CHUNK,
                                        max_slots=2), prompts)
            allp = np.concatenate([p for _, p in products])
            margin = float(np.min(np.abs(allp - tau)) / tau)
            if margin >= GATE_MARGIN:
                break
            tau = _gap_tau(allp[allp < np.percentile(dec, 80)], 0.3, 0.9)
    assert margin >= GATE_MARGIN, (tau, margin)
    sp = reqs[0].out["spamm"]
    assert 0.0 < sp["valid_fraction"] < 1.0
    assert 0.0 < sp["decode_valid_fraction"] < 1.0
    return tau


# ---------------------------------------------------------------------------
# step functions against the reference's
# ---------------------------------------------------------------------------

def _ref_cache(rcache):
    return {n: np.asarray(rcache["layers"][n]) for n in ("k", "v")}


def _port_cache(cache):
    return {n: np.stack([c[n].numpy() for c in cache["layers"]])
            for n in ("k", "v")}


def _close(got, want, tol=LOGIT_TOL):
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def test_chunk_and_decode_steps_match_reference(setup, gap_tau):
    """A full chunk, a partial chunk with sentinels (a clamp-padded tail
    and an idle lane), then a decode step with one sentinel lane, gated
    through frozen plans at the gap τ: logits and caches within LOGIT_TOL
    of the reference's steps, and every sentinel's cache row unchanged bit
    for bit."""
    rcfg, cfg, rparams, params = setup
    b = 2
    rctx = make_ctx(make_host_mesh())
    reng = REngine(rcfg, RPCFG, rctx, rparams, max_len=MAX_LEN,
                   spamm_cfg=_rsc(gap_tau))
    eng = _engine(setup, gap_tau)
    rchunk = jax.jit(RM.make_prefill_chunk_step(rcfg, RPCFG, rctx,
                                                spamm_cfg=reng.spamm_ctx))
    rdec = jax.jit(RM.make_decode_step(rcfg, RPCFG, rctx,
                                       spamm_cfg=reng.spamm_ctx))
    chunk = M.make_prefill_chunk_step(cfg, PCFG, spamm_cfg=eng.spamm_ctx)
    dec = M.make_decode_step(cfg, PCFG, spamm_cfg=eng.spamm_ctx)
    rcache = RM.init_cache(rcfg, RPCFG, b, MAX_LEN)
    cache = M.init_cache(cfg, PCFG, b, MAX_LEN, device="cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, cfg.vocab, (b, 2 * CHUNK)).astype(np.int32)
    n = 5                                    # row 0's partial second chunk
    full_pos = np.tile(np.arange(CHUNK, dtype=np.int32), (b, 1))
    part_tok = tokens[:, CHUNK:].copy()
    part_tok[0, n:] = part_tok[0, n - 1]
    part_pos = np.full((b, CHUNK), MAX_LEN, np.int32)
    part_pos[0, :n] = CHUNK + np.arange(n)
    steps = [(tokens[:, :CHUNK], full_pos, np.array([CHUNK - 1] * b)),
             (part_tok, part_pos, np.array([n - 1, -1]))]
    with torch.inference_mode():
        for tk, pos, last in steps:
            frozen = eng._frozen_for(b * CHUNK)
            before = _port_cache(cache)
            rcache, rlogits = rchunk(
                rparams, {"tokens": jnp.asarray(tk)}, rcache,
                jnp.asarray(pos), jnp.asarray(last, jnp.int32),
                reng._frozen_for(b * CHUNK))
            cache, logits = chunk(params, {"tokens": torch.as_tensor(tk)},
                                  cache, torch.as_tensor(pos),
                                  torch.as_tensor(last, dtype=torch.int32),
                                  frozen)
            _close(logits.numpy(), np.asarray(rlogits))
            got, want = _port_cache(cache), _ref_cache(rcache)
            for name in ("k", "v"):
                _close(got[name], want[name])
                for row in range(b):
                    dropped = np.setdiff1d(np.arange(MAX_LEN), pos[row])
                    np.testing.assert_array_equal(
                        got[name][:, row, dropped],
                        before[name][:, row, dropped])
        posv = np.array([CHUNK + n, MAX_LEN], np.int32)
        nxt = logits.argmax(-1).to(torch.int32)[:, None]
        before = _port_cache(cache)
        rlogits, rcache = rdec(rparams, jnp.asarray(nxt.numpy()), rcache,
                               jnp.asarray(posv), reng._frozen_for(b))
        logits, cache = dec(params, nxt, cache, torch.as_tensor(posv),
                            eng._frozen_for(b))
    _close(logits.numpy(), np.asarray(rlogits))
    got, want = _port_cache(cache), _ref_cache(rcache)
    for name in ("k", "v"):
        _close(got[name], want[name])
        np.testing.assert_array_equal(got[name][:, 1], before[name][:, 1])
        keep = np.arange(MAX_LEN) != CHUNK + n
        np.testing.assert_array_equal(got[name][:, 0, keep],
                                      before[name][:, 0, keep])


def test_decode_sentinel_never_wraps_on_a_ring_flagged_cache(setup):
    """window >= max_len keeps `layer_decode`'s ring flag on a linear
    cache: a per-row sentinel must drop, not wrap onto slot 0 (where a
    prefilling lane holds its token 0), while a lockstep position on the
    same cache still takes the ring modulo."""
    _, cfg, _, params = setup
    wcfg = dataclasses.replace(cfg, sliding_window=MAX_LEN)
    cache = M.init_cache(wcfg, PCFG, 2, MAX_LEN, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for c in cache["layers"]:
        for name in ("k", "v"):
            c[name].copy_(torch.randn(c[name].shape, generator=gen))
    before = [{n: c[n].clone() for n in ("k", "v")} for c in cache["layers"]]
    x = torch.randn(2, 1, cfg.d_model, generator=gen)
    with torch.inference_mode():
        tr.stack_decode(params, x, cache, torch.tensor([7, MAX_LEN],
                                                       dtype=torch.int32),
                        wcfg, PCFG)
    for c, c0 in zip(cache["layers"], before):
        for name in ("k", "v"):
            assert torch.equal(c[name][1], c0[name][1])
            assert not torch.equal(c[name][0, 7], c0[name][0, 7])
            keep = torch.arange(MAX_LEN) != 7
            assert torch.equal(c[name][0, keep], c0[name][0, keep])


# ---------------------------------------------------------------------------
# engine against the reference engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau", [None, 0.0], ids=["dense", "tau0"])
def test_mixed_lengths_match_reference_and_solo(setup, tau):
    """Mixed lengths (5, 16, 23) with SpAMM off and at τ = 0: the same
    tokens as the reference's engine and as the port's solo waves, every
    prompt token used."""
    _, cfg, _, _ = setup
    prompts = _prompts(cfg, MIX, 0)
    eng = _engine(setup, tau)
    got, reqs = _generate(eng, prompts)
    want, _ = _ref_generate(setup, prompts, tau)
    assert got == want
    assert got == _solo(setup, prompts, tau)
    assert [r.out["tokens"].tolist() for r in reqs] == got
    assert eng.chunk_steps > 0 and eng.admissions == len(prompts)
    lat = reqs[0].out["latency"]
    assert lat["ttft_s"] > 0 and lat["decode_steps"] > 0
    if tau is not None:
        sp = reqs[0].out["spamm"]
        assert sp["valid_fraction"] == sp["decode_valid_fraction"] == 1.0


def test_queue_gated_matches_reference_chunked_engine(setup, gap_tau):
    """6 requests through max_slots=2 at a gated τ: the same tokens and
    valid fractions as the reference's chunked engine on the same inputs."""
    _, cfg, _, _ = setup
    prompts = _prompts(cfg, QUEUE_MIX, 6)
    eng = _engine(setup, gap_tau, prefill_chunk=CHUNK, max_slots=2)
    got, reqs = _generate(eng, prompts)
    want, rreqs = _ref_generate(setup, prompts, gap_tau,
                                prefill_chunk=CHUNK, max_slots=2)
    assert got == want
    assert eng.admissions == len(prompts)
    sp, rsp = reqs[0].out["spamm"], rreqs[0].out["spamm"]
    for key in ("valid_fraction", "decode_valid_fraction"):
        assert sp[key] == pytest.approx(rsp[key], abs=1e-12)
    assert sp["gated_gemms"] == rsp["gated_gemms"]
    assert sp["decode_gated_gemms"] == rsp["decode_gated_gemms"]


# ---------------------------------------------------------------------------
# port-only properties of the plane
# ---------------------------------------------------------------------------

def test_queue_at_tau0_matches_solo_waves(setup):
    """max_slots=2 over 6 mixed prompts at τ = 0: every request's tokens
    are its solo wave's (the gate keeps every tile whatever the lanes)."""
    _, cfg, _, _ = setup
    prompts = _prompts(cfg, QUEUE_MIX, 6)
    got, _ = _generate(_engine(setup, 0.0, prefill_chunk=CHUNK,
                               max_slots=2), prompts)
    assert got == _solo(setup, prompts, 0.0)


@pytest.mark.parametrize("plen", [16, 32])
def test_tile_aligned_chunked_matches_oneshot_wave(setup, gap_tau, plen):
    """Equal tile-aligned prompts, gated: chunk cuts on tile boundaries
    keep every row tile's rows, so the chunked plane gives the one-shot
    wave's tokens."""
    _, cfg, _, _ = setup
    prompts = _prompts(cfg, (plen,) * 4, 4)
    wave, _ = _generate(_engine(setup, gap_tau), prompts)
    chunked, _ = _generate(_engine(setup, gap_tau, prefill_chunk=CHUNK),
                           prompts)
    assert chunked == wave


def test_one_slot_tile_aligned_matches_solo_when_gated(setup, gap_tau):
    """One slot and tile-aligned prompts: every row tile of a chunk or a
    decode step holds only its own request's rows (no other lane, no
    clamp-padded tail), exactly as in the request's solo wave, so the
    gated tokens equal the solo waves' even at τ > 0. (With several slots,
    or a prompt that ends inside a tile, other rows share the tiles and
    the gate may keep other tiles: both packages' chunked engines then
    agree with each other, not with solo runs.)"""
    _, cfg, _, _ = setup
    prompts = _prompts(cfg, (16, 32, 48), 6)
    got, _ = _generate(_engine(setup, gap_tau, prefill_chunk=CHUNK,
                               max_slots=1), prompts)
    assert got == _solo(setup, prompts, gap_tau)


def test_eos_frees_slot_midwave(setup):
    """A slot whose request emits EOS frees early, its output ending at the
    EOS token, and a queued request takes the slot; the others run to
    their budget with their tokens unchanged."""
    _, cfg, _, _ = setup
    prompts = _prompts(cfg, (8, 14, 11), 7)
    free, _ = _generate(_engine(setup, 0.0, prefill_chunk=CHUNK,
                                max_slots=2), prompts, max_new=6)
    eos = free[0][1]
    eng = _engine(setup, 0.0, prefill_chunk=CHUNK, max_slots=2)
    reqs = [Request(prompt=prompts[0], max_new_tokens=6, eos_id=eos)] + [
        Request(prompt=p, max_new_tokens=6) for p in prompts[1:]]
    outs = [o.tolist() for o in eng.generate(reqs)]
    assert outs[0] == free[0][:2]
    assert outs[1:] == free[1:]
    assert eng.admissions == 3


def test_non_pow2_max_slots_floors(setup):
    """max_slots=3 runs 2 slots, never 4, and `_floor_pow2` floors."""
    assert [E._floor_pow2(n) for n in range(1, 9)] == [1, 2, 2, 4, 4, 4, 4,
                                                       8]
    _, cfg, _, _ = setup
    prompts = _prompts(cfg, (5, 16, 23, 9), 10)
    eng = _engine(setup, 0.0, prefill_chunk=CHUNK, max_slots=3)
    got, _ = _generate(eng, prompts)
    assert set(key[1] for key, _ in eng._steps) == {2}
    assert {tuple(t.shape) for t in eng._chunk_step(2, CHUNK)
            .inputs.values()} == {(2, CHUNK), (2,)}
    assert got == _solo(setup, prompts, 0.0)


def test_chunking_disabled_rejects_mixed_lengths(setup):
    _, cfg, _, _ = setup
    eng = _engine(setup, prefill_chunk=0)
    with pytest.raises(ValueError, match="prefill_chunk=0"):
        eng.generate([Request(prompt=p) for p in _prompts(cfg, (4, 5), 2)])


def test_chunk_off_the_tile_raises(setup):
    with pytest.raises(ValueError, match="multiple of the SpAMM tile"):
        _engine(setup, 0.0, prefill_chunk=TILE + 8)
    _engine(setup, None, prefill_chunk=TILE + 8)    # no gate, no rule
    with pytest.raises(ValueError, match="max_slots"):
        _engine(setup, max_slots=-1)


def test_windowed_window_ge_max_len_keeps_token0(setup):
    """sliding_window >= max_len: lane 0 (5 tokens) decodes while lane 1
    (23 tokens) is still chunking, carrying the sentinel position. Its
    writes must drop, so lane 1 keeps its token-0 K/V and both lanes give
    their solo tokens."""
    _, cfg, _, _ = setup
    wcfg = dataclasses.replace(cfg, sliding_window=MAX_LEN)
    prompts = _prompts(cfg, (5, 23), 9)
    eng = _engine(setup, 0.0, wcfg, prefill_chunk=8 * 2)
    got, _ = _generate(eng, prompts)
    assert got == _solo(setup, prompts, 0.0, wcfg)


def test_trace_counts_bounded_by_bucket_ladder(setup):
    """A sweep of six (batch, prompt length) shapes through one chunked
    engine uses at most len(bucket_ladder(6, 1)) step keys per kind."""
    _, cfg, _, _ = setup
    rng = np.random.default_rng(8)
    shapes = [(1, 5), (2, 16), (3, 23), (4, 9), (5, 12), (6, 30)]
    eng = _engine(setup, 0.05, prefill_chunk=CHUNK)
    for b, plen in shapes:
        prompts = [rng.integers(1, cfg.vocab, plen).astype(np.int32)
                   for _ in range(b)]
        outs, _ = _generate(eng, prompts, max_new=2)
        assert all(len(o) == 2 for o in outs)
    ladder = bucket_ladder(max(b for b, _ in shapes), 1)
    assert 1 <= eng.trace_counts["prefill"] <= len(ladder)
    assert 1 <= eng.trace_counts["decode"] <= len(ladder)


# ---------------------------------------------------------------------------
# static-buffer discipline: what the engine captures reads its buffers
# ---------------------------------------------------------------------------

def _clone_cache(cache):
    return {"layers": [{n: c[n].clone() for n in ("k", "v")}
                       for c in cache["layers"]]}


def _assert_caches_equal(a, b):
    for ca, cb in zip(a["layers"], b["layers"]):
        for n in ("k", "v"):
            assert torch.equal(ca[n], cb[n])


@pytest.mark.parametrize("kind", ["wave_decode", "slot_decode", "chunk"])
def test_captured_callable_reads_its_static_buffers(setup, gap_tau, kind):
    """The exact callable the engine captures, called twice with its
    static buffers updated in place between the calls: the second call
    equals a fresh call of the step function at the new inputs, logits and
    cache bit for bit — no position, token or index is baked in."""
    _, cfg, _, params = setup
    eng = _engine(setup, gap_tau, prefill_chunk=CHUNK)
    b = 2
    rng = np.random.default_rng(11)
    tok = lambda *shape: rng.integers(1, cfg.vocab, shape).astype(np.int32)
    if kind == "wave_decode":
        step, key = eng._wave_decode_step(b), ("wave", b)
        calls = [dict(tokens=tok(b, 1), pos=np.int32(9)),
                 dict(tokens=tok(b, 1), pos=np.int32(10))]
    elif kind == "slot_decode":
        step, key = eng._slot_decode_step(b), ("slots", b)
        calls = [dict(tokens=tok(b, 1), positions=np.array([9, MAX_LEN])),
                 dict(tokens=tok(b, 1), positions=np.array([10, 3]))]
    else:
        step, key = eng._chunk_step(b, CHUNK), ("slots", b)
        p0 = np.tile(np.arange(CHUNK, dtype=np.int32), (b, 1))
        p1 = np.full((b, CHUNK), MAX_LEN, np.int32)
        p1[0, :7] = CHUNK + np.arange(7)
        calls = [dict(tokens=tok(b, CHUNK), positions=p0,
                      last_idx=np.array([CHUNK - 1, 4])),
                 dict(tokens=tok(b, CHUNK), positions=p1,
                      last_idx=np.array([6, -1]))]
    cache = eng._caches[key]
    gen = torch.Generator().manual_seed(1)
    for c in cache["layers"]:
        for n in ("k", "v"):
            c[n].copy_(torch.randn(c[n].shape, generator=gen))
    body, inputs = step.body, step.inputs
    with torch.inference_mode():
        for name, v in calls[0].items():
            inputs[name].copy_(torch.as_tensor(np.asarray(v)).reshape(
                inputs[name].shape))
        body()
        fresh_cache = _clone_cache(cache)
        for name, v in calls[1].items():
            inputs[name].copy_(torch.as_tensor(np.asarray(v)).reshape(
                inputs[name].shape))
        got = body()["logits"].clone()
        new = {k: torch.as_tensor(np.asarray(v)) for k, v in calls[1].items()}
        if kind == "chunk":
            _, want = eng._chunk(params, {"tokens": new["tokens"]},
                                 fresh_cache, new["positions"],
                                 new["last_idx"], eng._frozen_for(b * CHUNK))
        else:
            pos = new["pos"] if kind == "wave_decode" else new["positions"]
            want, _ = eng._decode(params, new["tokens"], fresh_cache, pos,
                                  eng._frozen_for(b))
    assert torch.equal(got, want)
    _assert_caches_equal(cache, fresh_cache)
    assert eng.trace_counts == {"prefill": int(kind == "chunk"),
                                "decode": int(kind != "chunk")}


def test_serve_cli_mixed_lengths_on_cpu(capsys):
    """The serve CLI's chunked recipe: --mixed-lengths at τ = 0 prints
    each request's solo tokens, and reports its chunks."""
    from repro_torch.launch import serve

    argv = ["--arch", ARCH, "--reduced", "--device", "cpu",
            "--num-requests", "4", "--prompt-len", "24", "--max-new", "3",
            "--mixed-lengths", "--prefill-chunk", "16", "--spamm-tile", "16",
            "--spamm-tau", "0.0"]
    serve.main(argv)
    out = capsys.readouterr().out
    assert "chunked: slots=4 chunk=16" in out
    lines = [ln.split(":", 1)[1].strip() for ln in out.splitlines()
             if ln.strip().startswith("req")]
    cfg = get_config(ARCH).reduced()
    pcfg = ParallelConfig(compute_dtype="float32", attn_q_chunk=64)
    params = M.init_params(cfg, pcfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    plens = rng.integers(12, 25, size=4)
    assert len(set(plens.tolist())) > 1
    for n, line in zip(plens, lines):
        p = rng.integers(1, cfg.vocab, size=int(n)).astype(np.int32)
        solo = Engine(cfg, pcfg, params, max_len=256,
                      spamm_cfg=SpammConfig(enable=True, tau=0.0, tile=16),
                      device="cpu").generate(
            [Request(prompt=p, max_new_tokens=3)])[0]
        assert line == str(solo[:12].tolist())


def test_recorded_taps_replay_as_blocks():
    """What a captured step taps is recorded apart from the wave's taps;
    a replay's block of taps drains as the same single taps, in order,
    with the phase current at the replay."""
    from repro_torch.core.module import SpammContext, Tap

    ctx = SpammContext(SpammConfig(enable=True, tau=0.0, tile=TILE))
    ctx.begin_stats()
    ctx.tap(torch.tensor(0.5))
    with ctx.record() as got:
        ctx.tap(torch.tensor(0.25), torch.tensor(3.0))
        ctx.tap(torch.tensor(0.75))
    assert [float(v) for _, v, _ in got] == [0.25, 0.75]
    ctx.set_phase("decode")
    ctx.tap_block(torch.tensor([0.25, 0.75]), torch.tensor([3.0]),
                  (True, False))
    assert ctx.end_stats() == [Tap("prefill", 0.5, None),
                               Tap("decode", 0.25, 3.0),
                               Tap("decode", 0.75, None)]
