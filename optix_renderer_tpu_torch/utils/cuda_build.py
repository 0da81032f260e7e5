"""Build the package's CUDA sources into shared libraries at first use.

Each library is compiled by ``nvcc`` from ``csrc/`` into
``optix_renderer_tpu_torch/_build/``, keyed by a hash of its sources and
flags, and written with an atomic rename so concurrent processes see all or
nothing.  The result is a plain C interface loaded with ``ctypes``: no
PyTorch headers are compiled, which keeps a cold build to seconds.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

# Hopper only (sm_90a); --fmad=false keeps each float operation's rounding
# equal to the plain PyTorch versions the kernels are checked against.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
)
_QUOTED_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def find_nvcc() -> str:
    """``nvcc`` from CUDA_HOME, then PyTorch's CUDA_HOME, then PATH."""
    homes = [os.environ.get("CUDA_HOME")]
    from torch.utils import cpp_extension

    homes.append(cpp_extension.CUDA_HOME)
    for home in homes:
        if home:
            cand = os.path.join(home, "bin", "nvcc")
            if os.path.isfile(cand):
                return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, torch's CUDA_HOME/bin and PATH); "
            "the CUDA kernels are built from source at first use and need the CUDA toolkit"
        )
    return found


def _hash_source(h, path: str, label: str, seen: set) -> None:
    """Add the file at ``path`` to ``h``, then each header it includes with
    quotes (found beside it, where nvcc looks first), each file once."""
    if path in seen:
        return
    seen.add(path)
    with open(path, "rb") as f:
        text = f.read()
    h.update(label.encode() + b"\0" + text)
    for inc in _QUOTED_INCLUDE.findall(text):
        header = os.path.join(os.path.dirname(path), inc.decode())
        _hash_source(h, header, inc.decode(), seen)


def library_path(name: str, sources: list[str], flags: tuple = NVCC_FLAGS) -> str:
    """Where the library built from ``sources`` lives (content-addressed:
    the flags, the sources and the headers they include)."""
    h = hashlib.sha256()
    h.update(" ".join(flags).encode())
    seen = set()
    for src in sources:
        _hash_source(h, os.path.join(CSRC_DIR, src), src, seen)
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_library(name: str, sources: list[str], flags: tuple = NVCC_FLAGS) -> tuple[str, float]:
    """Compile ``sources`` (file names under csrc/, or absolute paths) with
    ``flags`` unless already built.

    Returns (path of the .so, seconds spent compiling; 0.0 when cached).
    The compiler's resource report (``-Xptxas -v``) is kept beside the
    library as ``<lib>.log``.
    """
    path = library_path(name, sources, flags)
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [find_nvcc(), *flags, "-o", tmp, *(os.path.join(CSRC_DIR, s) for s in sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    with open(f"{tmp}.log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(f"{tmp}.log", f"{path}.log")
    os.replace(tmp, path)
    return path, seconds


def load_library(name: str, sources: list[str]) -> ctypes.CDLL:
    path, _ = build_library(name, sources)
    return ctypes.CDLL(path)
