"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled on first use by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, under
``build/kernels/`` at the root of the checkout, named by a hash of its
source, of every ``*.cuh`` header beside it (a quoted ``#include`` finds a
header there) and of the flags, so an edited source or header is rebuilt
and a stale library is never loaded.  A source may also be built once more
with a measurement macro (``-DCOUNT_PROBES``, ``-DFLASH_PROBES``) into
``build/probes/``: those variants never ship in the library the port
loads.  All missing libraries are compiled together, one ``nvcc``
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
PROBE_DIR = BUILD_DIR.parent / "probes"
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


def library_path(src: Path, macro: str | None = None) -> Path:
    """The library of ``src`` (built with ``-D<macro>`` into
    ``PROBE_DIR`` when ``macro`` is given), keyed on the bytes of the
    source, of each header beside it and of the flags."""
    key = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        key.update(header.name.encode() + b"\0" + header.read_bytes())
    key.update(" ".join((*NVCC_FLAGS, *_defines(macro))).encode())
    stem = src.stem if macro is None else f"{src.stem}-{macro.lower()}"
    return (BUILD_DIR if macro is None else PROBE_DIR) / f"{stem}-{key.hexdigest()[:16]}.so"


def _defines(macro: str | None) -> tuple[str, ...]:
    return () if macro is None else (f"-D{macro}",)


def build_all(probes: dict[str, str] | None = None) -> dict[str, float]:
    """Compile every source whose library is missing, all at once, and
    each ``probes`` source (stem -> macro) once more with its macro.

    Returns the wall seconds of each compile (empty when all were built).
    Each library is written under a temporary name and renamed into place,
    so processes building at the same time never load a half-written file."""
    targets = [(s, None) for s in sources()]
    targets += [(CSRC / f"{stem}.cu", macro) for stem, macro in (probes or {}).items()]
    todo = [(s, m) for s, m in targets if not library_path(s, m).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    jobs = []
    for src, macro in todo:
        dest = library_path(src, macro)
        dest.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=dest.parent)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *_defines(macro), "-o", tmp, str(src)]
        jobs.append((dest, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    seconds, failures = {}, []
    for dest, tmp, t0, proc in jobs:
        out, _ = proc.communicate()
        name = dest.stem.rsplit("-", 1)[0]
        seconds[name] = time.perf_counter() - t0
        if proc.returncode == 0:
            os.replace(tmp, dest)
        else:
            os.unlink(tmp)
            failures.append(f"nvcc failed on {name} ({proc.returncode}):\n{out}")
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


@functools.cache
def load_probe(name: str, macro: str) -> ctypes.CDLL:
    """The measurement build of ``csrc/<name>.cu`` with ``-D<macro>``,
    built first if needed (never the library the port loads)."""
    build_all({name: macro})
    return ctypes.CDLL(str(library_path(CSRC / f"{name}.cu", macro)))


def check(name: str, rc: int) -> None:
    """Raise when the C entry point of ``name`` reports a CUDA error."""
    if rc != 0:
        msg = getattr(load(name), f"{name}_error")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")
