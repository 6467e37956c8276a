"""Process groups and device meshes of the port (twin of
`repro.launch.mesh`).

The reference builds a `jax.sharding.Mesh` over the devices one process
sees. Here every rank is a process: `init_group` joins the default
`torch.distributed` process group (address, port, rank and world size from
its arguments or from the environment `torchrun` sets: MASTER_ADDR,
MASTER_PORT, RANK, WORLD_SIZE), `make_mesh` lays a `DeviceMesh` over it
(`init_device_mesh`, one process group per mesh axis), and
`destroy_group` leaves it. The backend is an explicit argument: "nccl" for
ranks on their own cards, "gloo" for CPU ranks or for several ranks on one
card (NCCL refuses two ranks on one GPU); nothing switches between them.

`mesh_from_devices` lays a (data, model) mesh over a given list of ranks
(in torch a mesh is over ranks, not devices: the elastic restart builds one
over the survivors, `distributed.elastic`), `make_ctx` makes a model's
`transformer.NetCtx` of a mesh, and `make_production_mesh` is the H100
counterpart of the reference's 16×16 pod slice: "model" spans the GPUs of
one NVLink node (8), "data" the nodes, and with `multi_pod` a leading
"pod" axis of 2.

`join_mesh` is what the train and serve CLIs run under `torchrun`: join the
world with a stated backend, lay the (data, model) mesh and make its ctx.

`fake_world` is the counterpart of the reference's 512 fake XLA host
devices: this process joins a "fake" process group as rank 0 of a world
of any size, whose collectives return at once without
moving data, and gets the production mesh (or a given one) over it. The
dry runs (`launch.dryrun`, `launch.dryrun_spamm`) run rank 0's real share
of a step in it.
"""
from __future__ import annotations

import contextlib
import datetime
import gc
import math
import multiprocessing
import os
import queue as _queue
import socket
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

BACKENDS = ("nccl", "gloo")
NODE_GPUS = 8           # GPUs of one NVLink node: the production model axis


def free_port() -> int:
    """A free TCP port on localhost, for a rendezvous of local ranks."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_group(backend: str, *, rank: Optional[int] = None,
               world_size: Optional[int] = None, addr: Optional[str] = None,
               port: Optional[int] = None, device=None,
               timeout_s: float = 600.0) -> None:
    """Join the default process group over `tcp://addr:port`. Unset
    arguments come from MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE.
    `device`, a CUDA device, becomes this rank's current device first (the
    communicator binds to it); a collective waits at most `timeout_s`."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    env = os.environ
    rank = int(env["RANK"]) if rank is None else int(rank)
    world_size = (int(env["WORLD_SIZE"]) if world_size is None
                  else int(world_size))
    addr = env.get("MASTER_ADDR", "localhost") if addr is None else addr
    port = int(env["MASTER_PORT"]) if port is None else int(port)
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}:{port}", rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s))


def destroy_group() -> None:
    """Leave the default process group (and every mesh group with it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank, world_size, backend, port, devices, fn, args, results):
    try:
        init_group(backend, rank=rank, world_size=world_size,
                   addr="localhost", port=port,
                   device=None if devices is None else devices[rank])
        value = fn(rank, *args)
    except BaseException:
        # reported without leaving the group: leaving an nccl group can
        # block behind a step that failed on the card
        results.put((rank, None, traceback.format_exc()))
        raise
    try:
        results.put((rank, value, None))
    finally:
        gc.collect()    # CUDA graphs left by `fn` go before the group
        destroy_group()


def spawn_ranks(fn: Callable, world_size: int, *, backend: str,
                devices: Optional[Sequence] = None, args: tuple = (),
                timeout_s: float = 900.0) -> list:
    """Run `fn(rank, *args)` on `world_size` local ranks (spawned
    processes joined into one `backend` group on a free localhost port;
    rank r's current device is `devices[r]` when given) and return their
    results in rank order. `fn` and its results must pickle (a
    module-level function; numpy arrays or CPU tensors). The first rank
    that fails ends the others, and its traceback raises here."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, backend, port,
                               None if devices is None else list(devices),
                               fn, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, failure = {}, None
    try:
        while len(out) < world_size and failure is None:
            try:
                rank, value, err = results.get(timeout=timeout_s)
            except _queue.Empty:
                failure = f"no result from a rank within {timeout_s} s"
                break
            if err is not None:
                failure = f"rank {rank} failed:\n{err}"
            out[rank] = value
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.kill()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(world_size)]


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              backend: str, device_type: str = "cuda") -> DeviceMesh:
    """A `DeviceMesh` of `axis_shapes` named `axis_names` over the ranks of
    the default group, which must already run `backend` (`init_group`)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_group(backend, ...) "
                           "before make_mesh")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not {backend!r}")
    return init_device_mesh(device_type, tuple(int(s) for s in axis_shapes),
                            mesh_dim_names=tuple(axis_names))


def make_host_mesh(*, backend: str, device_type: str = "cuda") -> DeviceMesh:
    """The 1×1 mesh with the production axis names ("data", "model")."""
    return make_mesh((1, 1), ("data", "model"), backend=backend,
                     device_type=device_type)


def mesh_from_devices(ranks, shape: Sequence[int],
                      axis_names=("data", "model"), *,
                      device_type: str = "cuda") -> DeviceMesh:
    """A `DeviceMesh` over the given ranks of the default group, laid
    row-major into `shape`. Every rank of the default group must call it
    (each axis's process groups are made collectively); a rank outside
    `ranks` gets a mesh it is not on (`get_coordinate()` is None)."""
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {tuple(shape)} for axes {axis_names}")
    mesh = torch.tensor([int(r) for r in ranks],
                        dtype=torch.int64).reshape(tuple(shape))
    return DeviceMesh(device_type, mesh, mesh_dim_names=tuple(axis_names))


def production_shape(world_size: int, *, multi_pod: bool = False) -> tuple:
    """(axis shape, axis names) of the production mesh over `world_size`
    ranks: "model" the NODE_GPUS GPUs of one NVLink node, "data" the
    nodes (of each pod: `multi_pod` adds a leading "pod" axis of 2).
    Raises ValueError when the world does not fill whole nodes (and, multi-
    pod, two equal pods)."""
    node_gpus = NODE_GPUS
    per_pod = world_size // 2 if multi_pod else world_size
    if (world_size < node_gpus or world_size % node_gpus
            or (multi_pod and (world_size % 2 or per_pod % node_gpus))):
        raise ValueError(
            f"the production mesh needs whole {node_gpus}-GPU nodes"
            f"{' in two equal pods' if multi_pod else ''}: world size "
            f"{world_size} does not fit")
    if multi_pod:
        return (2, per_pod // node_gpus, node_gpus), ("pod", "data", "model")
    return (world_size // node_gpus, node_gpus), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, backend: str = "nccl",
                         device_type: str = "cuda") -> DeviceMesh:
    """The production mesh over the default group's ranks
    (`production_shape`; one rank per GPU, so NCCL)."""
    shape, names = production_shape(dist.get_world_size(),
                                    multi_pod=multi_pod)
    return make_mesh(shape, names, backend=backend, device_type=device_type)


@contextlib.contextmanager
def fake_world(world_size: int, *, multi_pod: bool = False, shape=None,
               axis_names=None, device_type: str = "cuda"):
    """`with fake_world(256) as mesh:` — this process as rank 0 of a
    "fake" process group of `world_size` ranks (no other process exists:
    collectives return at once and move nothing), and a `DeviceMesh` over
    it: `shape`/`axis_names` when given, else the production mesh
    (`production_shape`). The group is destroyed on exit."""
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    if shape is None:
        shape, axis_names = production_shape(world_size, multi_pod=multi_pod)
    if math.prod(shape) != world_size:
        raise ValueError(f"mesh {tuple(shape)} does not hold "
                         f"{world_size} ranks")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield make_mesh(shape, axis_names, backend="fake",
                        device_type=device_type)
    finally:
        dist.destroy_process_group()


def make_ctx(mesh, *, tile: int = 64, batch_axes=None, specs=None):
    """The `transformer.NetCtx` of a mesh: batch axes "pod" and "data"
    (those the mesh has), model axis "model" (`models.model.
    with_placements` adds a model's placements)."""
    from repro_torch.models.transformer import NetCtx

    if batch_axes is None:
        batch_axes = tuple(a for a in mesh.mesh_dim_names
                           if a in ("pod", "data"))
    return NetCtx(mesh, batch_axes=batch_axes, model_axis="model",
                  specs=specs, tile=tile)


def join_mesh(device: str, backend: str, *, mesh: Optional[str] = None,
              production: bool = False, tile: int = 64):
    """Join the torchrun world (`init_group`) and lay its mesh: `mesh`
    "DATA,MODEL", or the production mesh. Rank r runs on the CPU
    (`device` "cpu"), on cuda:LOCAL_RANK (nccl) or on cuda:LOCAL_RANK
    modulo the visible cards (gloo: ranks may share a card). Returns
    (the mesh's NetCtx at `tile`, this rank's device)."""
    if device == "cpu":
        dev = torch.device("cpu")
    elif backend == "nccl":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    else:
        dev = torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", "0"))
            % max(torch.cuda.device_count(), 1))
    init_group(backend, device=dev)
    dtype = "cpu" if dev.type == "cpu" else "cuda"
    if production:
        dm = make_production_mesh(backend=backend, device_type=dtype)
    else:
        shape = tuple(int(x) for x in mesh.split(","))
        dm = make_mesh(shape, ("data", "model"), backend=backend,
                       device_type=dtype)
    return make_ctx(dm, tile=tile), dev
