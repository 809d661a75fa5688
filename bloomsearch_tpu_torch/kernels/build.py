"""Build a CUDA kernel source into a shared library with a plain C interface.

Each kernel module (``probe.py``, ``scan.py``) compiles its own source under
``csrc/`` with ``nvcc`` for ``sm_90a`` at first use, into ``_build/``, and
binds the library with ``ctypes``. Separate sources build in separate nvcc
processes, so callers may build several at once from threads.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")


def nvcc_command(source: str, output: str) -> list[str]:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", output, source,
    ]


def build_library(source: str, library: str, force: bool = False) -> str:
    """Compile ``source`` into ``library`` unless the library is newer.

    Builds to a per-process temporary name and renames into place, so
    concurrent builders never load a half-written library. Returns the
    compiler's stderr (its ``-Xptxas -v`` register and shared-memory
    report); raises RuntimeError when nvcc fails.
    """
    if (
        not force
        and os.path.exists(library)
        and os.path.getmtime(library) >= os.path.getmtime(source)
    ):
        return ""
    os.makedirs(os.path.dirname(library), exist_ok=True)
    tmp = f"{library}.build.{os.getpid()}.{threading.get_ident()}"
    try:
        result = subprocess.run(
            nvcc_command(source, tmp), capture_output=True, text=True, timeout=600
        )
        if result.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source}:\n{result.stderr}")
        os.replace(tmp, library)
        return result.stderr
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
