"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each library is one ``.cu`` file with a plain C interface, compiled for
``sm_90a`` into ``kernels/_build/`` (listed in ``.gitignore``) at first use.
The file name carries a hash of the source, its local headers and the
flags, so an edited source is rebuilt and a stale library is never loaded.
nvcc's output (the ``-Xptxas -v`` register and shared-memory report) lands
beside the library as ``.log``. Each source has its own lock, so several
sources build at once from several threads (``chip_smoke.py`` starts them
together). Nothing here runs at import time: the CPU tests import every
module without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()                 # guards _LOCKS
_LOCKS: Dict[str, threading.Lock] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built on a machine with "
        "the CUDA toolkit (PATH, CUDA_HOME or /usr/local/cuda)"
    )


def _local_includes(src: Path) -> list:
    """The headers ``src`` includes by a quoted path, relative to it."""
    return [src.parent / ln.split('"')[1] for ln in src.read_text().splitlines()
            if ln.startswith('#include "')]


def library_path(source: str) -> Path:
    """Where the library of ``source`` (relative to ``kernels/``) lands: the
    name hashes the source, the headers it includes by a quoted path and the
    flags, so that an edit to any of them builds anew."""
    src = KERNELS_DIR / source
    text = src.read_bytes() + b"".join(h.read_bytes() for h in _local_includes(src))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


def _build(source: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(KERNELS_DIR / source)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}")
    os.replace(tmp, out)              # atomic: a reader never sees half a file
    out.with_suffix(".log").write_text(res.stdout)


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    with _LOCK:
        lock = _LOCKS.setdefault(source, threading.Lock())
    with lock:
        lib = _LOADED.get(source)
        if lib is None:
            out = library_path(source)
            if not out.exists():
                _build(source, out)
            lib = ctypes.CDLL(str(out))
            _LOADED[source] = lib
        return lib
