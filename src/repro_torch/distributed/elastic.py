"""Elastic scaling and failure handling (twin of
`repro.distributed.elastic`).

When a rank drops, the job goes on with the survivors: (1) build the
largest usable (data, model) mesh from the ranks still alive, (2) re-place
the parameters and both AdamW moments onto it, (3) resume the data stream
at the checkpointed step (`train.loop`). Detecting the failure and
respawning are the cluster scheduler's part. In torch a mesh is over
ranks, so the survivors' mesh is a `DeviceMesh` over their ranks of the
process group the job already has; every rank of that group takes part in
building it, and a rank outside it holds nothing.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch.distributed as dist

from repro_torch.launch.mesh import mesh_from_devices
from repro_torch.models import model as M


def best_mesh_shape(n_devices: int, model_parallel: int) -> tuple:
    """Largest (data, model) grid with the model axis at most
    `model_parallel` that divides the surviving count."""
    model = min(model_parallel, n_devices)
    while n_devices % model:
        model -= 1
    data = n_devices // model
    return (data, model)


def build_elastic_mesh(ranks: Optional[Sequence[int]] = None,
                       model_parallel: int = 8, *,
                       device_type: str = "cuda"):
    """The (data, model) `DeviceMesh` of `best_mesh_shape` over the first
    data·model of `ranks` (default: every rank of the default group)."""
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    data, model = best_mesh_shape(len(ranks), model_parallel)
    return mesh_from_devices(ranks[:data * model], (data, model),
                             device_type=device_type)


def reshard_state(state: dict, cfg, pcfg, new_mesh, *, tile: int = 64,
                  device=None) -> Optional[dict]:
    """A {"params", "opt_state"} state re-placed onto `new_mesh` (a
    DeviceMesh or NetCtx) after a failure or a scale-up: from whole
    tensors (host or device: a checkpoint, or shards gathered from the old
    mesh with `models.model.gather_params`), each leaf of the parameters
    and of both moments cut by the model's placements on the new mesh
    (`models.model.placements`: the reference's specs through
    `sanitize_spec`). Returns this rank's shards on `device` (the leaves'
    own when None), or None on a rank outside the mesh."""
    mesh = new_mesh.mesh if isinstance(new_mesh, M.NetCtx) else new_mesh
    if mesh.get_coordinate() is None:
        return None
    ctx = new_mesh if isinstance(new_mesh, M.NetCtx) else M.NetCtx(mesh)
    params = state["params"]
    specs = M.placements(cfg, pcfg, params, ctx, tile=tile)

    def put(tree):
        return M.shard_params(tree, specs, ctx, device=device)

    out = dict(state)
    out["params"] = put(params)
    if "opt_state" in state:
        os_ = state["opt_state"]
        out["opt_state"] = dict(os_, mu=put(os_["mu"]), nu=put(os_["nu"]))
        if "ef" in os_:
            out["opt_state"]["ef"] = put(os_["ef"])
    out["specs"] = specs
    return out
