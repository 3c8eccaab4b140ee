"""Build one CUDA source of ``csrc/`` into a shared library at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a plain-C shared
library under ``build/`` at the root of the checkout, once per version of
the source, the headers of ``csrc/`` and the flags (the file name carries
their hash), and loaded with ``ctypes``.  The library is written under a
temporary name and renamed, so concurrent builds agree; a failed build
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc(src: Path) -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{src.name}")


def build_library(name: str) -> tuple[ctypes.CDLL, str]:
    """Compile ``csrc/<name>.cu`` unless this version is built, and load it.

    Returns the library and the compiler's report (registers, shared
    memory, spills) when this call compiled, else an empty string."""
    src_path = CSRC / f"{name}.cu"
    src = src_path.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"lib{name}_{tag}.so"
    log = ""
    if not so.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(src_path), *NVCC_FLAGS, "-o", tmp,
                                   str(src_path)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {src_path}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)         # atomic: concurrent builds agree
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        log = proc.stdout + proc.stderr
    return ctypes.CDLL(str(so)), log
