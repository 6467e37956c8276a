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
