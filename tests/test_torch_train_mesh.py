"""The train CLI over a mesh: `python -m torch.distributed.run` starts 4
CPU ranks of `repro_torch.launch.train --mesh 2,2 --backend gloo` on a
reduced model; the run ends, rank 0 reports the global losses, and they
equal the one-device CLI's (the loss is the global mean)."""
import os
import re
import subprocess
import sys

import pytest

from repro_torch.launch.mesh import free_port

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
ARGS = ["--arch", "starcoder2-7b", "--reduced", "--steps", "2", "--batch",
        "4", "--seq", "16", "--device", "cpu", "--ckpt-every", "0"]


def _losses(out: str):
    m = re.search(r"first_loss=([0-9.]+) last_loss=([0-9.]+)", out)
    assert m, out
    return float(m.group(1)), float(m.group(2))


def _run(cmd, tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=240)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    return res.stdout


@pytest.mark.parametrize("mesh", ["2,2"])
def test_train_cli_over_a_gloo_mesh_matches_one_device(tmp_path, mesh):
    one = _run([sys.executable, "-m", "repro_torch.launch.train", *ARGS,
                "--ckpt-dir", str(tmp_path / "one")], tmp_path)
    got = _run([sys.executable, "-m", "torch.distributed.run",
                "--nproc-per-node", "4", "--master-addr", "localhost",
                "--master-port", str(free_port()), "-m",
                "repro_torch.launch.train", *ARGS, "--mesh", mesh,
                "--backend", "gloo", "--ckpt-dir", str(tmp_path / "mesh")],
               tmp_path)
    assert got.count("done:") == 1
    assert _losses(got) == pytest.approx(_losses(one), rel=1e-3)
