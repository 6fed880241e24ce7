"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc for sm_90a into a shared library with a
plain C interface under build/ngp_tpu_torch/, named by the content hash of
the source and the shared csrc/*.cuh headers, at first use (or all at once,
one nvcc process per source, through `build_all`), and loaded with ctypes.
Nothing here runs at import.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ngp_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "ngp_tpu_torch"
SOURCES = ("fused_mlp_fwd", "fused_mlp_bwd", "adam_ema", "hash_encode_fwd", "hash_encode_bwd", "train_batch",
           "render_march", "render_cover_march")

BUILD_LOGS: dict = {}  # name -> nvcc / ptxas output of the build this process made
_LIBS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels are built with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """The library's path, named by the hash of its source and of the shared
    csrc/*.cuh headers (a header change rebuilds every library)."""
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def _command(name: str, out: Path):
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out), str(CSRC / f"{name}.cu"),
    ]


def build_all(names=SOURCES) -> dict:
    """Compile every named source not built yet, one nvcc each, all started
    together; returns {name: library path}. Raises on the first failure."""
    t0 = time.perf_counter()
    todo = {n: library_path(n) for n in names}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, so in todo.items():
        if not so.exists():
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), tmp, so)
    errors = []
    for name, (proc, tmp, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n{err}")
            continue
        BUILD_LOGS[name] = err
        os.replace(tmp, so)
    profiling.count("kernels.builds", len(procs))
    profiling.add("kernels.build_s", time.perf_counter() - t0)
    if errors:
        raise RuntimeError("\n".join(errors))
    return todo


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (built first if needed)."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build_all((name,))[name]))
    return _LIBS[name]


# the kernels whose wrappers count their launches (profiling counter "launches.<name>")
LAUNCH_COUNTERS = ("fused_mlp_fwd", "fused_mlp_bwd", "adam_ema", "hash_encode_fwd", "hash_encode_bwd_stochastic",
                   "hash_encode_bwd_exact", "train_march", "train_emit", "render_march", "render_cover_march")


def launch_counts() -> dict:
    """Launches of each kernel so far in this process."""
    return {name: profiling.get(f"launches.{name}") for name in LAUNCH_COUNTERS}


def set_launch_counts(counts: dict):
    for name in LAUNCH_COUNTERS:
        profiling.count(f"launches.{name}", counts[name] - profiling.get(f"launches.{name}"))


def add_launch_counts(delta: dict):
    """Count the launches a replayed CUDA graph makes: the wrappers ran once,
    at the capture, which launched nothing."""
    for name in LAUNCH_COUNTERS:
        profiling.count(f"launches.{name}", delta[name])
