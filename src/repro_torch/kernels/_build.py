"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel is one ``.cu`` file with a plain C entry point.  ``nvcc``
compiles it into a shared library under ``build/repro_torch/`` at the root
of the checkout; the library's name carries a hash of the source, of the
``.cuh`` headers beside it and of the flags, so an edited source or header
builds anew and an unchanged one loads at once.
Nothing is built when a module is imported.  Different sources build in
parallel when several threads load them at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_locks: dict[Path, threading.Lock] = {}
_locks_guard = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(found, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(source: Path, flags: tuple[str, ...] = ()) -> Path:
    """Where ``source`` built with ``flags`` (beside ``NVCC_FLAGS``) lives."""
    headers = b"".join(h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    digest = hashlib.sha256(
        source.read_bytes() + headers + " ".join(NVCC_FLAGS + flags).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def load_library(source: Path, flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile ``source`` with ``flags`` (once per content and flags), load it."""
    target = library_path(source, flags)
    with _locks_guard:
        lock = _locks.setdefault(target, threading.Lock())
    with lock:
        if not target.exists():
            nvcc = nvcc_path()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # Build beside the target and rename, so another process never
            # loads a half-written library.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [nvcc, *NVCC_FLAGS, *flags, "-o", tmp, str(source)],
                    capture_output=True, text=True,
                )
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {source.name}:\n{proc.stderr}")
                os.replace(tmp, target)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        return ctypes.CDLL(str(target))
