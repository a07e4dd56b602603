"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel is one ``.cu`` file with a plain C entry point.  ``nvcc``
compiles it into a shared library under ``build/repro_torch/`` at the root
of the checkout; the library's name carries a hash of the source and the
flags, so an edited source builds anew and an unchanged one loads at once.
Nothing is built when a module is imported.
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

# -fmad=false: no contraction beyond what a source spells out (the
# Mandelbrot kernel's rounding must equal the reference's bit for bit).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(found, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def load_library(source: Path) -> ctypes.CDLL:
    """Compile ``source`` (once per content and flags) and load it."""
    with _lock:
        digest = hashlib.sha256(
            source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        target = BUILD_DIR / f"lib{source.stem}-{digest}.so"
        if not target.exists():
            nvcc = nvcc_path()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # Build beside the target and rename, so another process never
            # loads a half-written library.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [nvcc, *NVCC_FLAGS, "-o", tmp, str(source)],
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
