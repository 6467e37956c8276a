"""The port's pod-sharded engine (`Engine(mesh_devices=N, devices=[cpu]*N)`)
and its re-sharding control plane on reduced starcoder2-7b, against the
port's unsharded engine and the JAX reference's unsharded engine (the
reference's own sharded tests need fake XLA devices and fail under this
jax; its single-device engine is the oracle). The same weights reach both
packages (`params_from_jax`); the embedding gets the reference test's
hot/cold id→norm profile, so the prompts' tokens move the work estimate
and the controller re-cuts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ParallelConfig as RParallel
from repro.configs import SpammConfig as RSpamm
from repro.configs import get_config as rget_config
from repro.core import schedule as RS
from repro.launch.mesh import make_ctx, make_host_mesh
from repro.models import model as RM
from repro.serving.engine import Engine as REngine
from repro.serving.engine import Request as RRequest
from repro_torch.configs import ParallelConfig, SpammConfig, get_config
from repro_torch.core.schedule import ReshardConfig
from repro_torch.models import model as M
from repro_torch.serving import graphs as G
from repro_torch.serving.engine import Engine, Request

ARCH = "starcoder2-7b"
TILE, PLEN, MAX_NEW, MAX_LEN = 4, 16, 6, 48
RPCFG = RParallel(compute_dtype="float32", remat="none", attn_q_chunk=8,
                  attn_kv_chunk=8, decode_seq_shard=False)
PCFG = ParallelConfig(compute_dtype="float32", attn_q_chunk=8)
# (batch, share of hot prompts): G = 4 groups (uniform cut over 4 shards),
# then 6 (ragged: the cut can move)
WAVES = ((16, 0.0), (16, 0.5), (24, 0.25), (24, 0.75))


@pytest.fixture(scope="module")
def setup():
    rcfg = rget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    rparams = RM.init_params(rcfg, RPCFG, jax.random.key(0))
    emb = np.asarray(rparams["embed"]["embedding"])
    scale = np.where(np.arange(cfg.vocab) < cfg.vocab // 2, 0.05, 5.0)
    rparams["embed"]["embedding"] = jnp.asarray(
        (emb * scale[:, None]).astype(np.float32))
    params = M.params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                               device="cpu")
    return rcfg, cfg, rparams, params


def _prompts(cfg, b, mix, seed):
    rng = np.random.default_rng(seed)
    hot = int(b * mix)
    return [rng.integers(cfg.vocab // 2, cfg.vocab, PLEN).astype(np.int32)
            if i < hot else
            rng.integers(1, cfg.vocab // 2, PLEN).astype(np.int32)
            for i in range(b)]


def _engine(setup, tau, **kw):
    _, cfg, _, params = setup
    return Engine(cfg, PCFG, params, max_len=MAX_LEN, device="cpu",
                  spamm_cfg=SpammConfig(enable=True, tau=tau, tile=TILE),
                  **kw)


def _serve(eng, prompts, max_new=MAX_NEW):
    reqs = [Request(prompt=p.copy(), max_new_tokens=max_new)
            for p in prompts]
    return [o.tolist() for o in eng.generate(reqs)], reqs[0].out


@pytest.fixture(scope="module")
def tau():
    """The reference sharded test's τ: between the cold rows' (≈ 0.2) and
    the hot rows' (≈ 20) probe products."""
    return 2.0


@pytest.fixture(scope="module")
def oracle(setup, tau):
    """Each wave's tokens from the reference's unsharded engine."""
    rcfg, cfg, rparams, _ = setup
    eng = REngine(rcfg, RPCFG, make_ctx(make_host_mesh()), rparams,
                  max_len=MAX_LEN, spamm_cfg=RSpamm(enable=True, tau=tau,
                                                    tile=TILE, backend="jnp"))
    out = []
    for i, (b, mix) in enumerate(WAVES):
        reqs = [RRequest(prompt=p, max_new_tokens=MAX_NEW)
                for p in _prompts(cfg, b, mix, i)]
        out.append([o.tolist() for o in eng.generate(reqs)])
    return out


@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_tokens_equal_unsharded_and_reference(setup, tau, oracle,
                                                      ndev):
    """Every wave's tokens equal the port's unsharded engine's and the
    reference's bit for bit, with the controller re-cutting between and
    within waves (drift threshold 1.0, a pinned probe grid); the captured
    steps stay one per shard and shape."""
    _, cfg, _, _ = setup
    eng = _engine(setup, tau, mesh_devices=ndev, devices=["cpu"] * ndev,
                  reshard_cfg=ReshardConfig(num_devices=ndev, every=2,
                                            drift_threshold=1.0,
                                            probe_window=8))
    ref = _engine(setup, tau)
    for i, (b, mix) in enumerate(WAVES):
        prompts = _prompts(cfg, b, mix, i)
        toks, out = _serve(eng, prompts)
        assert toks == _serve(ref, prompts)[0] == oracle[i], i
        lay = eng.shard_layout
        assert sum(lay["real"]) == b and len(lay["real"]) == ndev
        sp = out["spamm"]
        assert sp["reshard_probes"] == 3       # engine steps 0, 2, 4 of 6
        assert sp["partition_imbalance"] is not None
    assert eng._resharder.resharded >= 1, eng._resharder.history
    # one decode step per shard and per static shard width (two widths)
    assert eng.trace_counts == {"prefill": 0, "decode": 2 * ndev}
    assert eng.gm_histogram


def test_default_devices_and_rejections(setup, tau):
    """No silent fallback: the default device list is the cards, which a
    CPU run lacks; unfrozen plans, MoE archs, misaligned batches and
    prompts, too few request groups and mixed lengths are refused in the
    reference's words."""
    _, cfg, _, params = setup
    with pytest.raises(ValueError, match="CUDA devices visible"):
        _engine(setup, tau, mesh_devices=2)
    with pytest.raises(ValueError, match="frozen plans"):
        Engine(cfg, PCFG, params, max_len=MAX_LEN, device="cpu",
               mesh_devices=2, devices=["cpu"] * 2)
    moe = get_config("mixtral-8x22b").reduced()
    moe_params = M.init_params(moe, PCFG, 0, device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        Engine(moe, PCFG, moe_params, max_len=MAX_LEN, device="cpu",
               spamm_cfg=SpammConfig(enable=True, tau=tau, tile=TILE),
               mesh_devices=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="cuts 3 strips"):
        _engine(setup, tau, mesh_devices=2, devices=["cpu"] * 2,
                reshard_cfg=ReshardConfig(num_devices=3, every=1))
    with pytest.raises(ValueError, match="3 devices"):
        _engine(setup, tau, mesh_devices=2, devices=["cpu"] * 3)
    eng = _engine(setup, tau, mesh_devices=4, devices=["cpu"] * 4)
    ones = np.ones(PLEN, np.int32)
    for reqs, match in (
            ([ones] * 6, "batch % tile"),
            ([np.ones(PLEN - 2, np.int32)] * 16, "prompt length"),
            ([ones] * 8, "cannot fill"),
            ([ones] * 15 + [np.ones(PLEN - 4, np.int32)], "equal-length")):
        with pytest.raises(ValueError, match=match):
            _serve(eng, reqs, max_new=2)


def test_sharded_chunked_prefill_equals_unsharded(setup, tau, oracle):
    """`prefill_chunk` swaps each shard's one-shot prefill for a chunk loop
    at one static shape (a partial last chunk included) on a full-length
    linear cache: the tokens are the unsharded engine's."""
    _, cfg, _, _ = setup
    for chunk in (2 * TILE, 3 * TILE):
        eng = _engine(setup, tau, mesh_devices=2, devices=["cpu"] * 2,
                      prefill_chunk=chunk,
                      reshard_cfg=ReshardConfig(every=1,
                                                drift_threshold=1.0,
                                                probe_window=8))
        for i in (2, 3):
            toks, _ = _serve(eng, _prompts(cfg, *WAVES[i], i))
            assert toks == oracle[i], (chunk, i)
        assert eng.chunk_steps == 2 * -(-PLEN // chunk)
        assert eng.trace_counts["prefill"] == 2    # one chunk step a shard


# ---------------------------------------------------------------------------
# re-sharding on the unsharded engine: pure control plane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("every", [1, 2, 3])
def test_reshard_cadence_and_bit_identity(setup, every):
    """The reference test's scenario (τ 2.0 between the cold and hot
    rows' products, 2 strips): tokens equal with re-sharding on and off;
    probes, events and the live imbalance equal the reference engine's."""
    rcfg, cfg, rparams, _ = setup
    rsc = RS.ReshardConfig(num_devices=2, every=every, drift_threshold=1.0)
    reng = REngine(rcfg, RPCFG, make_ctx(make_host_mesh()), rparams,
                   max_len=96, reshard_cfg=rsc,
                   spamm_cfg=RSpamm(enable=True, tau=2.0, tile=16,
                                    backend="jnp"))
    _, _, _, params = setup
    eng = Engine(cfg, PCFG, params, max_len=96, device="cpu",
                 spamm_cfg=SpammConfig(enable=True, tau=2.0, tile=16),
                 reshard_cfg=ReshardConfig(num_devices=2, every=every,
                                           drift_threshold=1.0))
    off = Engine(cfg, PCFG, params, max_len=96, device="cpu",
                 spamm_cfg=SpammConfig(enable=True, tau=2.0, tile=16))
    rng = np.random.default_rng(0)
    waves = [[rng.integers(1, cfg.vocab // 2, 32).astype(np.int32)
              for _ in range(2)],
             [rng.integers(cfg.vocab // 2, cfg.vocab, 32).astype(np.int32),
              rng.integers(1, cfg.vocab // 2, 32).astype(np.int32)]]
    for w, prompts in enumerate(waves):
        reqs = [Request(prompt=p.copy(), max_new_tokens=5) for p in prompts]
        rreqs = [RRequest(prompt=p.copy(), max_new_tokens=5)
                 for p in prompts]
        toks = [o.tolist() for o in eng.generate(reqs)]
        assert toks == _serve(off, prompts, 5)[0]
        assert toks == [o.tolist() for o in reng.generate(rreqs)]
        sp, rsp = reqs[0].out["spamm"], rreqs[0].out["spamm"]
        # engine steps per wave: 1 prefill + 4 decode, counted across waves
        assert sp["reshard_probes"] == rsp["reshard_probes"] == len(
            [s for s in range(5 * w, 5 * w + 5) if s % every == 0])
        assert sp["resharded"] == rsp["resharded"]
        assert sp["partition_imbalance"] == pytest.approx(
            rsp["partition_imbalance"], rel=1e-6)
    assert eng._resharder.resharded == reng._resharder.resharded >= 1
    np.testing.assert_array_equal(eng.partition_offsets,
                                  reng.partition_offsets)
    assert "resharded" not in _serve(off, waves[0], 2)[1]["spamm"]


# ---------------------------------------------------------------------------
# captured shard steps: one capture each, under its own device
# ---------------------------------------------------------------------------

class _Replay:
    """A CPU stand-in for a captured graph: a replay reruns the captured
    body and rewrites the capture's static outputs in place."""

    def __init__(self, step):
        self.step = step

    def replay(self):
        st = self.step
        with G._recording(st.spamm_ctx) as taps:
            out = st.body()
        for k, v in out.items():
            st.outputs[k].copy_(v)
        if st._taps is not None:
            new = G._stack_taps(taps)
            st._taps[0].copy_(new[0])
            if st._taps[1] is not None:
                st._taps[1].copy_(new[1])


def test_recut_copies_into_captured_steps_without_recapture(setup, tau,
                                                            oracle,
                                                            monkeypatch):
    """With the steps captured (a CPU stand-in for the graph), re-cuts
    between and within waves copy the new tables into the captured
    buffers: the capture count stays one per shard and shape, the tokens
    stay the oracle's, and every capture and replay ran inside
    `torch.cuda.device(<its shard's device>)`."""
    _, cfg, _, _ = setup
    entered, captured = [], []

    class _Device:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(self.device)

        def __exit__(self, *exc):
            entered.pop()

    def capture(self):
        captured.append((self, entered[-1] if entered else None))
        with G._recording(self.spamm_ctx) as taps:
            self.outputs = self.body()
            self._taps = G._stack_taps(taps)
        self._launches = [0] * len(G.read_counters())
        self._graph = _Replay(self)
        self.capture_s = 0.0

    monkeypatch.setattr(Engine, "_capture",
                        property(lambda self: self.cuda_graphs))
    monkeypatch.setattr(G.StepGraph, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool",))
    monkeypatch.setattr(torch.cuda, "device", _Device)
    moves = []
    refresh = Engine._refresh_shard

    def counting(self):
        src = refresh(self)
        if src is not None:
            moves.append(tuple(int(x) for x in self._shard["offs_g"]))
        return src

    monkeypatch.setattr(Engine, "_refresh_shard", counting)
    eng = _engine(setup, tau, mesh_devices=4, devices=["cpu"] * 4,
                  reshard_cfg=ReshardConfig(every=1, drift_threshold=1.0,
                                            probe_window=8))
    counts = []
    for i, (b, mix) in enumerate(WAVES):
        toks, _ = _serve(eng, _prompts(cfg, b, mix, i))
        assert toks == oracle[i], i
        counts.append(sum(s.capture_s is not None
                          for s in eng._steps.values()))
    assert eng._resharder.resharded >= 2, eng._resharder.history
    assert len(moves) >= 1, "no re-cut moved a request group"
    assert counts == [4, 4, 8, 8], counts
    assert len(captured) == 8
    for step, dev in captured:
        assert dev is step.device and dev in eng._devices
    keys = [k for (k, cap) in eng._steps if cap]
    assert sorted({k[1] for k in keys}) == [0, 1, 2, 3]
    assert all(isinstance(s._graph, _Replay)
               for (k, cap), s in eng._steps.items() if cap)
    assert not entered
