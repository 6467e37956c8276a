"""torch version-compat shims (twin of `repro.compat`; no deps on the rest
of the port).

The reference backfills the jax names that moved between versions
(`shard_map`, Pallas' `CompilerParams`). Neither has a torch counterpart:
torch has no `shard_map` (every rank is a process that runs its own shard,
`launch.mesh`), and the port's kernels are CUDA C++, not Pallas. What moved
in torch are the names of the two tensor collectives the port calls:

  * `all_gather_single` — `torch.distributed.all_gather_single` (newer
    torch, which deprecates the old name with a FutureWarning) or
    `all_gather_into_tensor` (older torch);
  * `reduce_scatter_single` — `torch.distributed.reduce_scatter_single` or
    `reduce_scatter_tensor`.

Both pairs take the same arguments (output, input, [op,] group=,
async_op=) and dispatch the same c10d op, so the choice, made once at
import, changes no result.
"""
from __future__ import annotations

import torch.distributed as _dist

all_gather_single = (_dist.all_gather_single
                     if hasattr(_dist, "all_gather_single")
                     else _dist.all_gather_into_tensor)

reduce_scatter_single = (_dist.reduce_scatter_single
                         if hasattr(_dist, "reduce_scatter_single")
                         else _dist.reduce_scatter_tensor)
