"""Rank bodies of the port's multi-rank CPU tests (gloo on CPU ranks).

Spawned ranks import this module, not the test files: it imports neither
JAX nor the reference package, so a rank starts quickly. Each function
takes the rank and plain arguments (numpy operands) and returns numpy
arrays and Python numbers."""
import torch

from repro_torch.core import distributed as D
from repro_torch.core import schedule as S
from repro_torch.launch.mesh import make_mesh


def rowpart_jobs(rank, jobs, ranks):
    """spamm_rowpart over a 1-D "data" mesh of `ranks` ranks, one call per
    job (a, b, tau, tile, schedule, offsets, compute_dtype); returns
    [(C, fraction)]."""
    torch.set_num_threads(1)
    mesh = make_mesh((ranks,), ("data",), backend="gloo", device_type="cpu")
    out = []
    for a, b, tau, tile, schedule, offsets, dtype in jobs:
        c, frac = D.spamm_rowpart(torch.from_numpy(a), torch.from_numpy(b),
                                  tau, mesh, axis="data", tile=tile,
                                  backend="torch", schedule=schedule,
                                  offsets=offsets, compute_dtype=dtype)
        out.append((c.numpy(), float(frac)))
    return out


def mesh_2d_jobs(rank, jobs):
    """On a 2×2 ("data", "model") mesh: spamm_2d per job (a, b, tau, tile,
    schedule, offsets), spamm_rowpart over its "data" axis for the first
    job (cyclic), and the re-shard device count resolved from the mesh."""
    torch.set_num_threads(1)
    mesh = make_mesh((2, 2), ("data", "model"), backend="gloo",
                     device_type="cpu")
    out = []
    for a, b, tau, tile, schedule, offsets in jobs:
        c, frac = D.spamm_2d(torch.from_numpy(a), torch.from_numpy(b), tau,
                             mesh, tile=tile, backend="torch",
                             schedule=schedule, offsets=offsets)
        out.append((c.numpy(), float(frac)))
    a, b, tau, tile = jobs[0][:4]
    c, frac = D.spamm_rowpart(torch.from_numpy(a), torch.from_numpy(b), tau,
                              mesh, axis="data", tile=tile, backend="torch",
                              schedule="cyclic")
    resolved = [S.resolve_reshard_devices(S.ReshardConfig(), mesh,
                                          axes).num_devices
                for axes in (("data",), ("data", "model"))]
    return out, (c.numpy(), float(frac)), resolved


# ---------------------------------------------------------------------------
# model parallelism (tests/test_torch_tp.py): one spawn runs every job
# ---------------------------------------------------------------------------

def tp_jobs(rank, jobs):
    """Each job (kind, kwargs) on this rank, in order; returns the list of
    per-job results (numpy)."""
    torch.set_num_threads(1)
    return [_TP_JOBS[kind](rank, **kw) for kind, kw in jobs]


def _ctx(shape, cfg, pcfg, tile, params):
    """The NetCtx of a `shape` mesh with the placements of `params`."""
    from repro_torch.launch import mesh as MS
    from repro_torch.models import model as M

    mesh = make_mesh(shape, ("data", "model"), backend="gloo",
                     device_type="cpu")
    ctx = MS.make_ctx(mesh, tile=tile)
    return ctx.replace(specs=M.placements(cfg, pcfg, params, ctx, tile=tile))


def _rows(t, ctx):
    w = t.shape[0] // ctx.ndata
    return t[ctx.data_index * w:(ctx.data_index + 1) * w]


def _specialize(tree, gm):
    if isinstance(tree, dict):
        return {k: _specialize(v, gm) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_specialize(v, gm) for v in tree]
    return tree.for_rows(gm)


def _fw_tables(tree):
    """{(layer, part, name): (nbmax, kj_k, kj_j)} of a freeze_tree."""
    out = {}
    for li, layer in enumerate(tree["layers"]):
        for part, sub in layer.items():
            for name, fw in sub.items():
                out[li, part, name] = (fw.nbmax.numpy(), fw.kj_k, fw.kj_j)
    return out


def _serve_model(rank, *, cfg, pcfg, params, tokens, labels, dec_tokens,
                 max_len, shape, tile, spamm=None, freeze=False,
                 decode=True):
    """Loss and hidden states, prefill logits, then decode steps at the
    given tokens, of this rank's rows over a `shape` mesh. With `freeze`,
    decode gates through the frozen plans of this rank's compute weights
    (their tables returned too). The gated GEMMs' taps come back with the
    prefill (global over "model")."""
    from repro_torch.core.module import SpammContext
    from repro_torch.models import model as M
    from repro_torch.plans.precompute import freeze_tree

    ctx = _ctx(shape, cfg, pcfg, tile, params)
    local = M.shard_params(params, ctx.specs, ctx)
    batch = {"tokens": _rows(torch.from_numpy(tokens), ctx),
             "labels": _rows(torch.from_numpy(labels), ctx)}
    sc = SpammContext(spamm) if spamm is not None else None
    out = {"data_index": ctx.data_index, "mrank": ctx.mrank}
    with torch.no_grad():
        loss, met = M.loss_fn(cfg, pcfg, local, batch, spamm_cfg=sc, ctx=ctx)
        out["loss"] = float(loss)
        out["h"] = M.forward_hidden(cfg, pcfg, local, batch, ctx=ctx)[0].numpy()
        if sc is not None:
            sc.begin_stats()
        cache, logits = M.make_prefill_step(cfg, pcfg, spamm_cfg=sc,
                                            ctx=ctx)(local, batch)
        if sc is not None:
            out["prefill_taps"] = [t.value for t in sc.end_stats()]
        out["prefill"] = logits.numpy()
        if not decode:
            return out
        cache = M.place_cache(cache, cfg, pcfg, max_len, ctx=ctx)
        frozen = None
        if freeze:
            fw, _ = freeze_tree(M.compute_params(local, cfg, ctx), spamm)
            out["frozen_tables"] = _fw_tables(fw)
            b_loc = batch["tokens"].shape[0]
            frozen = _specialize(fw, -(-b_loc // spamm.tile))
        step = M.make_decode_step(cfg, pcfg, spamm_cfg=sc, ctx=ctx)
        s0 = tokens.shape[1]
        dec, taps = [], []
        for i in range(dec_tokens.shape[1]):
            if sc is not None:
                sc.begin_stats()
            inp = _rows(torch.from_numpy(dec_tokens[:, i:i + 1]), ctx)
            lg, cache = step(local, inp, cache, s0 + i, frozen)
            dec.append(lg.numpy())
            if sc is not None:
                taps.append([t.value for t in sc.end_stats()])
        out["decode"] = dec
        out["decode_taps"] = taps
    return out


def _train(rank, *, cfg, pcfg, params, batches, tcfg, shape, tile,
           compression=False, elastic_batch=None):
    """`len(batches)` train steps over a `shape` mesh from whole `params`;
    returns the losses and (gathered, rank 0) parameters and moments. With
    `elastic_batch`, the state then moves onto the best mesh of ranks 0-2
    (`distributed.elastic`): each survivor's re-gathered params and moments
    are compared bit for bit with the state, and one step runs there."""
    from repro_torch import tree as T
    from repro_torch.distributed import elastic as E
    from repro_torch.distributed.compression import Int8EF
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamW

    ctx = _ctx(shape, cfg, pcfg, tile, params)
    opt = AdamW(tcfg, compression=Int8EF() if compression else None)
    local = M.shard_params(params, ctx.specs, ctx)
    state = opt.init(local)
    step = M.make_train_step(cfg, pcfg, opt, ctx=ctx)
    losses = []
    for i, (tok, lab) in enumerate(batches):
        b = {"tokens": _rows(torch.from_numpy(tok), ctx),
             "labels": _rows(torch.from_numpy(lab), ctx)}
        local, state, met = step(local, state, b, i)
        losses.append(float(met["loss"]))
    full = {"params": M.gather_params(local, ctx.specs, ctx),
            "opt_state": {k: M.gather_params(v, ctx.specs, ctx)
                          for k, v in state.items()}}
    out = {"losses": losses}
    if rank == 0:
        out["params"] = T.map_(lambda t: t.numpy(), full["params"])
        for k in ("mu", "ef"):
            if k in full["opt_state"]:
                out[k] = T.map_(lambda t: t.numpy(), full["opt_state"][k])
    if elastic_batch is None:
        return out
    new_mesh = E.build_elastic_mesh(range(3), model_parallel=shape[1],
                                    device_type="cpu")
    out["elastic_shape"] = tuple(new_mesh.shape)
    moved = E.reshard_state(full, cfg, pcfg, new_mesh, tile=tile)
    if moved is None:
        return out
    from repro_torch.launch import mesh as MS

    ctx3 = MS.make_ctx(new_mesh, tile=tile, specs=moved["specs"])
    back = {"params": M.gather_params(moved["params"], ctx3.specs, ctx3)}
    back.update({k: M.gather_params(moved["opt_state"][k], ctx3.specs, ctx3)
                 for k in ("mu", "nu")})
    want = {"params": full["params"], "mu": full["opt_state"]["mu"],
            "nu": full["opt_state"]["nu"]}
    out["elastic_bitwise"] = all(
        torch.equal(a, b) for k in want
        for a, b in zip(T.leaves(back[k]), T.leaves(want[k])))
    step3 = M.make_train_step(cfg, pcfg, opt, ctx=ctx3)
    tok, lab = elastic_batch
    b = {"tokens": _rows(torch.from_numpy(tok), ctx3),
         "labels": _rows(torch.from_numpy(lab), ctx3)}
    _, _, met = step3(moved["params"], moved["opt_state"], b, len(batches))
    out["elastic_loss"] = float(met["loss"])
    return out


def _moe(rank, *, cfg, pcfg, params, x, shape, tile, spamm=None):
    """Layer 0's moe_block of a MoE model (`params` whole) on this rank's
    rows of x over a `shape` mesh → {"y" rows, "aux"}."""
    from repro_torch.core.module import SpammContext
    from repro_torch.models import model as M
    from repro_torch.models import moe as MoE

    ctx = _ctx(shape, cfg, pcfg, tile, params)
    local = M.shard_params(params, ctx.specs, ctx)
    sc = SpammContext(spamm) if spamm is not None else None
    with torch.no_grad():
        y, aux = MoE.moe_block(local["layers"][0]["moe"],
                               _rows(torch.from_numpy(x), ctx), cfg.moe,
                               cfg.act, spamm_cfg=sc, ctx=ctx,
                               spec=ctx.specs["layers"][0]["moe"])
    return {"y": y.numpy(), "aux": float(aux), "data_index": ctx.data_index}


def _loop(rank, *, cfg, pcfg, tcfg, shape, tile, ckpt_dir, batch, seq,
          spamm=None, reshard=None):
    """The train loop over a `shape` mesh (`train(ctx=)`, SpAMM and the
    re-sharding probe as given): tcfg's steps with checkpoints, then a
    resume from the latest to two more steps. Returns both runs' losses,
    the restart count and the first run's gating stats."""
    import dataclasses

    from repro_torch.launch import mesh as MS
    from repro_torch.train.loop import train

    mesh = make_mesh(shape, ("data", "model"), backend="gloo",
                     device_type="cpu")
    ctx = MS.make_ctx(mesh, tile=tile)
    run = train(cfg, pcfg, dataclasses.replace(tcfg, ckpt_dir=ckpt_dir),
                global_batch=batch, seq_len=seq, log_every=0, device="cpu",
                ctx=ctx, spamm_cfg=spamm, reshard_cfg=reshard)
    more = dataclasses.replace(tcfg, ckpt_dir=ckpt_dir,
                               total_steps=tcfg.total_steps + 2)
    resumed = train(cfg, pcfg, more, global_batch=batch, seq_len=seq,
                    log_every=0, device="cpu", ctx=ctx, resume=True)
    return {"losses": run.losses, "resumed": resumed.losses,
            "restarts": resumed.restarts, "spamm_stats": run.spamm_stats}


def _init(rank, *, cfg, pcfg, shape, tile):
    """Whether `init_params(ctx=)` (each piece cut as it is made) equals
    `shard_params` of the whole init bit for bit, and what a rank that
    does not keep a `gather_params` gets: {"same", "dropped", "whole"}."""
    from repro_torch import tree as T
    from repro_torch.launch import mesh as MS
    from repro_torch.models import model as M

    mesh = make_mesh(shape, ("data", "model"), backend="gloo",
                     device_type="cpu")
    ctx = M.with_placements(MS.make_ctx(mesh, tile=tile), cfg, pcfg)
    mine = M.init_params(cfg, pcfg, 3, device="cpu", ctx=ctx)
    whole = M.init_params(cfg, pcfg, 3, device="cpu",
                          model_axis_size=ctx.nmodel)
    cut = M.shard_params(whole, ctx.specs, ctx)
    same = all(torch.equal(a, b) for a, b in zip(T.leaves(mine),
                                                 T.leaves(cut)))
    keep = rank == 0
    back = M.gather_params(mine, ctx.specs, ctx, keep=keep, device="cpu")
    return {"same": same,
            "dropped": all(t is None for t in T.leaves(back)) != keep,
            "whole": keep and all(torch.equal(a, b) for a, b in zip(
                T.leaves(back), T.leaves(whole)))}


_TP_JOBS = {"serve": _serve_model, "train": _train, "moe": _moe,
            "loop": _loop, "init": _init}


def compat_job(rank, n):
    """`_all_gather` and `_reduce_scatter` (through `repro_torch.compat`)
    with every warning recorded, beside the same collectives called by
    their older torch names; returns (warning categories and messages,
    gathered, scattered, gathered by the old name, scattered by it)."""
    import warnings

    import torch.distributed as dist

    torch.set_num_threads(1)
    group = dist.group.WORLD
    x = torch.arange(3 * n, dtype=torch.float32).reshape(3, n) + 100 * rank
    y = torch.arange(2 * 4 * n, dtype=torch.float32).reshape(8, n) * (rank + 1)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        gathered = D._all_gather(x, group)
        scattered = D._reduce_scatter(y, group)
    old_g = x.new_empty((2 * 3, n))
    old_s = y.new_empty((4, n))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dist.all_gather_into_tensor(old_g, x, group=group)
        dist.reduce_scatter_tensor(old_s, y, op=dist.ReduceOp.SUM,
                                   group=group)
    return ([(w.category.__name__, str(w.message)) for w in seen],
            gathered.numpy(), scattered.numpy(), old_g.numpy(),
            old_s.numpy())


# ---------------------------------------------------------------------------
# the plan store under several writers (tests/test_torch_store.py)
# ---------------------------------------------------------------------------

def store_race(rank, root, w, taus, writers, loads_after_hit=40,
               deadline_s=60.0):
    """Round by round, one key each (`w`'s artifact at a τ of `taus`):
    the ranks below `writers` put it into the store at `root` at once,
    the other ranks load it meanwhile, until `loads_after_hit` loads have
    followed the first hit. Returns per round the writer's key, or the
    reader's loads in order: None for a miss, else whether the artifact
    equals this rank's own build."""
    import time

    import torch.distributed as dist

    from repro_torch.plans.frozen import FrozenWeight
    from repro_torch.plans.store import PlanStore, fingerprint

    torch.set_num_threads(1)
    wt = torch.from_numpy(w)
    h = fingerprint(wt)
    cfg = dict(tile=32, block_n=1, levels=1, backend="torch")
    st = PlanStore(root)
    out = []
    for tau in taus:
        fw = FrozenWeight.build(wt, tau, weight_hash=h, **cfg)
        dist.barrier()
        if rank < writers:
            out.append(st.put(fw))
            continue
        seen, hits, t0 = [], 0, time.perf_counter()
        while hits <= loads_after_hit and time.perf_counter() - t0 < deadline_s:
            got = st.get(h, tau=tau, device="cpu", **cfg)
            if got is None:
                seen.append(None)
                continue
            hits += 1
            seen.append(torch.equal(got.nbmax, fw.nbmax)
                        and all(torch.equal(a, b)
                                for a, b in zip(got.levels, fw.levels)))
        out.append(seen)
    dist.barrier()
    return out


# ---------------------------------------------------------------------------
# the serving engine over a model axis (tests/test_torch_engine_mesh.py)
# ---------------------------------------------------------------------------

def engine_mesh_jobs(rank, jobs):
    """Each job (kind, kwargs) on this rank of a 4-rank world, in order;
    returns the list of per-job results (numpy and Python values)."""
    torch.set_num_threads(1)
    return [_ENGINE_JOBS[kind](rank, **kw) for kind, kw in jobs]


def _model_ctx(model, cfg, pcfg, tile, batch_axes=()):
    """The ctx of a (4 / model, model) mesh with the model's placements.
    Without batch axes the "data" rows are replicas: each serves the same
    requests over its own `model` ranks."""
    from repro_torch.launch import mesh as MS
    from repro_torch.models import model as M

    mesh = make_mesh((4 // model, model), ("data", "model"), backend="gloo",
                     device_type="cpu")
    ctx = MS.make_ctx(mesh, tile=tile, batch_axes=batch_axes)
    return M.with_placements(ctx, cfg, pcfg)


def _engine(rank, *, cfg, pcfg, params, model, tile, spamm, prompts,
            max_new, max_len, kw):
    """One wave of `prompts` through `Engine(ctx=)` on this rank's shards.
    Returns the tokens, the first request's `out` (stats and graphs), and
    on the wave plane the prefill logits of the engine's own step and
    frozen plans and the last decode step's logits."""
    import numpy as np

    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    ctx = _model_ctx(model, cfg, pcfg, tile)
    local = M.shard_params(params, ctx.specs, ctx)
    eng = Engine(cfg, pcfg, local, max_len=max_len, spamm_cfg=spamm,
                 device="cpu", ctx=ctx, **kw)
    reqs = [Request(prompt=p, max_new_tokens=max_new) for p in prompts]
    out = {"mrank": ctx.mrank,
           "tokens": [o.tolist() for o in eng.generate(reqs)],
           "spamm": reqs[0].out["spamm"], "graphs": reqs[0].out["graphs"],
           "shared_out": all(r.out["spamm"] is reqs[0].out["spamm"]
                             for r in reqs)}
    if not kw:
        toks = np.stack(prompts)
        b, s = toks.shape
        with torch.inference_mode():
            _, lg = eng._prefill(local, {"tokens": torch.as_tensor(toks)},
                                 eng._frozen_for(b * s))
        out["prefill"] = lg.numpy()
        step = eng._steps[(("wave", b), False)]
        out["decode"] = step.outputs["logits"].numpy()
    return out


def _engine_store(rank, *, cfg, pcfg, params, model, tile, spamm, prompts,
                  max_new, max_len, store):
    """Two engines on one plan store: the first populates it (every rank
    its own shards' plans; replicas and whole-weight layers put the same
    keys at once), the second warm-starts. Returns each wave's store hits
    and misses and both waves' tokens."""
    import torch.distributed as dist

    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    ctx = _model_ctx(model, cfg, pcfg, tile)
    local = M.shard_params(params, ctx.specs, ctx)
    out = []
    for _ in range(2):
        eng = Engine(cfg, pcfg, local, max_len=max_len, spamm_cfg=spamm,
                     device="cpu", ctx=ctx, plan_store=store)
        reqs = [Request(prompt=p, max_new_tokens=max_new) for p in prompts]
        toks = [o.tolist() for o in eng.generate(reqs)]
        sp = reqs[0].out["spamm"]
        out.append((sp["plan_store_hits"], sp["plan_store_misses"], toks))
        dist.barrier()
    return out


def _engine_refusals(rank, *, cfg, pcfg, params, tile, spamm):
    """The messages of what `Engine(ctx=)` refuses: a batch axis of two
    ranks, a ctx with mesh_devices, a whole tree."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine

    def refused(ctx, p, **kw):
        try:
            Engine(cfg, pcfg, p, spamm_cfg=spamm, device="cpu", ctx=ctx,
                   **kw)
        except ValueError as e:
            return str(e)
        return None

    data = _model_ctx(2, cfg, pcfg, tile, batch_axes=("data",))
    model = _model_ctx(4, cfg, pcfg, tile)
    local = M.shard_params(params, model.specs, model)
    return {"batch": refused(data, M.shard_params(params, data.specs, data)),
            "mesh_devices": refused(model, local, mesh_devices=2),
            "whole": refused(model, params)}


def serve_cli(rank, argv, port):
    """`launch.serve.main(argv)` as torchrun runs it: this process leaves
    the spawned group and joins the CLI's own world from the environment.
    Returns what it printed."""
    import contextlib
    import io
    import os

    from repro_torch.launch import mesh as MS
    from repro_torch.launch import serve

    torch.set_num_threads(1)
    world = torch.distributed.get_world_size()
    MS.destroy_group()
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    return buf.getvalue()


_ENGINE_JOBS = {"engine": _engine, "store": _engine_store,
                "refusals": _engine_refusals}


def engine_tp_on_card(rank, cases, backend):
    """`Engine(ctx=)` on a (1, 2) mesh of `backend` ranks on the card(s),
    graphed and eager, from this rank's shards of `init_params(seed)`, for
    each case {name: job}; a job holds cfg, pcfg, seed, spamm, prompts,
    max_new and the engine's keywords. Returns {name: {cuda_graphs:
    {"tokens", "graphs", "captures"} or {"error": traceback}}}; a case's
    failure is returned, so the others still run."""
    import traceback

    from repro_torch.launch import mesh as MS
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    mesh = make_mesh((1, 2), ("data", "model"), backend=backend,
                     device_type="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for name, job in cases.items():
        cfg, pcfg, spamm = job["cfg"], job["pcfg"], job["spamm"]
        ctx = M.with_placements(MS.make_ctx(mesh, tile=spamm.tile), cfg,
                                pcfg)
        params = M.init_params(cfg, pcfg, job["seed"], device=dev, ctx=ctx)
        out[name] = {}
        for graphs in (True, False):
            try:
                eng = Engine(cfg, pcfg, params, max_len=64, spamm_cfg=spamm,
                             device=dev, ctx=ctx, cuda_graphs=graphs,
                             **job["kw"])
                reqs = [Request(prompt=p, max_new_tokens=job["max_new"])
                        for p in job["prompts"]]
                toks = [o.tolist() for o in eng.generate(reqs)]
                torch.cuda.synchronize()
                out[name][graphs] = {
                    "tokens": toks, "graphs": reqs[0].out["graphs"],
                    "captures": eng.graph_stats()["captures"]}
            except Exception:
                out[name][graphs] = {"error": traceback.format_exc()}
    return out