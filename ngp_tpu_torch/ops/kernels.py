"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc for sm_90a into a shared library with a
plain C interface under build/ngp_tpu_torch/, named by the source's content
hash, at first use (or all at once, one nvcc process per source, through
`build_all`), and loaded with ctypes. Nothing here runs at import.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "ngp_tpu_torch"
SOURCES = ("fused_mlp_fwd", "fused_mlp_bwd", "adam_ema")

BUILD_LOGS: dict = {}  # name -> nvcc / ptxas output of the build this process made
_LIBS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels are built with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    return BUILD_DIR / f"lib{name}_{hashlib.sha1(src).hexdigest()[:12]}.so"


def _command(name: str, out: Path):
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out), str(CSRC / f"{name}.cu"),
    ]


def build_all(names=SOURCES) -> dict:
    """Compile every named source not built yet, one nvcc each, all started
    together; returns {name: library path}. Raises on the first failure."""
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
    if errors:
        raise RuntimeError("\n".join(errors))
    return todo


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (built first if needed)."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build_all((name,))[name]))
    return _LIBS[name]
