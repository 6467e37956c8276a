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

The reference's `make_production_mesh` (a 16×16 TPU pod slice) has no
counterpart yet (ROADMAP queue A).
"""
from __future__ import annotations

import datetime
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
        try:
            results.put((rank, fn(rank, *args), None))
        finally:
            destroy_group()
    except BaseException:
        results.put((rank, None, traceback.format_exc()))
        raise


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
