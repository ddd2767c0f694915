"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled on first use by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, under
``build/kernels/`` at the root of the checkout, named by a hash of its
source and flags (so an edited source is rebuilt and a stale library is
never loaded).  All missing libraries are compiled together, one ``nvcc``
process per source.  The libraries are loaded with ``ctypes``; each C entry
point returns ``cudaGetLastError()`` and :func:`check` raises on a non-zero
code, with the CUDA error string.  A missing ``nvcc`` or a failed build raises with the compiler's
output: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (cuda_home / "bin" / "nvcc").exists():
        return str(cuda_home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def library_path(src: Path) -> Path:
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{key.hexdigest()[:16]}.so"


def build_all() -> dict[str, float]:
    """Compile every source whose library is missing, all at once.

    Returns the wall seconds of each compile (empty when all were built).
    Each library is written under a temporary name and renamed into place,
    so processes building at the same time never load a half-written file."""
    todo = [s for s in sources() if not library_path(s).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
        jobs.append((src, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    seconds, failures = {}, []
    for src, tmp, t0, proc in jobs:
        out, _ = proc.communicate()
        seconds[src.stem] = time.perf_counter() - t0
        if proc.returncode == 0:
            os.replace(tmp, library_path(src))
        else:
            os.unlink(tmp)
            failures.append(f"nvcc failed on {src.name} ({proc.returncode}):\n{out}")
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.

    Each library exports ``<name>_error(int) -> const char*``, the CUDA
    error string that :func:`check` reports."""
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    build_all()
    lib = ctypes.CDLL(str(library_path(src)))
    err = getattr(lib, f"{name}_error")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def check(name: str, rc: int) -> None:
    """Raise when the C entry point of ``name`` reports a CUDA error."""
    if rc != 0:
        msg = getattr(load(name), f"{name}_error")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")
