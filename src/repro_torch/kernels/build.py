"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` file is compiled by its own `nvcc` process into a shared
library with a plain C interface (`-gencode arch=compute_90a,code=sm_90a`,
Hopper), and loaded with `ctypes`. All compiles start together, so the build
takes as long as the slowest file. Libraries are named by a hash of their
source, the headers of `csrc/` (`*.cuh`, which the sources include) and the
flags, and cached under `kernels/_build/` (listed in .gitignore): a changed
source or header rebuilds, an unchanged one loads. Nothing is built at
import time — the first kernel call (or `build_all()`) triggers the build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("getnorm.cu", "spamm_mm.cu", "spamm_wgmma.cu",
           "spamm_decode.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin, then PATH, then the
    toolkit's default install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are compiled from kernels/csrc at first use")


def library_path(source: str) -> Path:
    """The library of `source`, named by a hash of the source, every header
    of csrc/ and the flags."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def nvcc_command(source: Path, out: Path) -> list:
    """The compile of `source` (a csrc/ file or a variant of one elsewhere)
    into the shared library `out`; csrc/ is on the include path."""
    return [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(source)]


def build_all() -> dict:
    """Compile every source whose library is missing, one nvcc per source,
    all started together. Returns {source: {"seconds", "cached", "ptxas"}}
    (ptxas: the compiler's register / shared-memory report). Raises with
    the compiler's output when any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report, procs = {}, {}
    for source in SOURCES:
        out = library_path(source)
        if out.is_file():
            report[source] = {"seconds": 0.0, "cached": True, "ptxas": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = nvcc_command(CSRC / source, tmp)
        procs[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, out, time.perf_counter())
    failed = []
    for source, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {source} (exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, out)  # atomic: a half-written library is never loaded
        report[source] = {"seconds": seconds, "cached": False, "ptxas": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(source: str) -> ctypes.CDLL:
    """Load the library of `source`, building every missing library first.
    The kernel modules call this once and keep the handle."""
    path = library_path(source)
    if not path.is_file():
        build_all()
    return ctypes.CDLL(str(path))
