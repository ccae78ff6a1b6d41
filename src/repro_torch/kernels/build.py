"""Build and bind the hand-written CUDA kernels of ``repro_torch``.

Each kernel source under ``csrc/`` exposes a plain C entry point that
launches on a given stream and returns ``cudaGetLastError()``.  It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root, at first use, keyed on a hash of
the source, the shared headers of ``csrc/`` and the flags, and loaded with
``ctypes``.  Nothing is built when
a module is imported.

Every kernel counts its launches (``CudaKernel.launches``), so a run can show
that its main path went through the kernel: ``launch_counts`` and
``reset_launch_counts`` read and clear the counts of all of them.

``nvcc`` runs with ``-Xptxas -v``; what ptxas says of each entry function
(registers, spills) is kept beside the library and read by ``ptxas_report``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_REGISTRY: Dict[str, "CudaKernel"] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build_library(source: Path) -> Path:
    """Compile ``source`` into a shared library, unless built already."""
    headers = b"".join(h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    digest = hashlib.sha256(
        source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"{source.stem}-{digest[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name}:\n{proc.stderr}")
        _report_path(lib).write_text(proc.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def _report_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def ptxas_report(name: str) -> str:
    """What ptxas said of each entry function of a built kernel's source."""
    lib = _REGISTRY[name].library
    if lib is None:
        raise RuntimeError(f"{name} is not built")
    return _report_path(lib).read_text()


class CudaKernel:
    """One C entry point of a ``csrc/`` source, built at first use."""

    def __init__(self, name: str, source: str, argtypes: Sequence):
        self.name = name
        self.source = CSRC / source
        self.argtypes = list(argtypes)
        self.launches = 0
        self.library = None
        self._fn = None
        _REGISTRY[name] = self

    def build(self):
        if self._fn is None:
            self.library = build_library(self.source)
            lib = ctypes.CDLL(str(self.library))
            fn = getattr(lib, self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Launch; raise if CUDA refused the launch."""
        err = self.build()(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error {err}")
        self.launches += 1


def build_all() -> None:
    """Build every registered kernel, one ``nvcc`` per source, all at once."""
    with ThreadPoolExecutor(max_workers=max(len(_REGISTRY), 1)) as pool:
        for future in [pool.submit(k.build) for k in _REGISTRY.values()]:
            future.result()


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in _REGISTRY.items()}


def reset_launch_counts() -> None:
    for k in _REGISTRY.values():
        k.launches = 0
