"""The port's torch version shims (`repro_torch.compat`): the collectives
`core.distributed` calls go by the name this torch offers, so the newer
torch raises no FutureWarning for them, and the results equal those of
the older names (exact), on 2 gloo CPU ranks."""
import numpy as np
import torch.distributed as dist

from repro_torch.launch.mesh import spawn_ranks

import torch_dist_workers as W


def test_compat_picks_the_name_this_torch_has():
    from repro_torch import compat

    want = (dist.all_gather_single if hasattr(dist, "all_gather_single")
            else dist.all_gather_into_tensor)
    assert compat.all_gather_single is want
    want = (dist.reduce_scatter_single
            if hasattr(dist, "reduce_scatter_single")
            else dist.reduce_scatter_tensor)
    assert compat.reduce_scatter_single is want


def test_collectives_warn_nothing_and_keep_their_values():
    n = 5
    out = spawn_ranks(W.compat_job, 2, backend="gloo", args=(n,))
    for rank, (seen, gathered, scattered, old_g, old_s) in enumerate(out):
        assert not [m for c, m in seen if c == "FutureWarning"], seen
        np.testing.assert_array_equal(gathered, old_g)
        np.testing.assert_array_equal(scattered, old_s)
        x = np.arange(3 * n, dtype=np.float32).reshape(3, n)
        np.testing.assert_array_equal(gathered,
                                      np.concatenate([x, x + 100]))
        y = np.arange(8 * n, dtype=np.float32).reshape(8, n)
        np.testing.assert_array_equal(scattered,
                                      (y * 1 + y * 2)[rank * 4:(rank + 1) * 4])
