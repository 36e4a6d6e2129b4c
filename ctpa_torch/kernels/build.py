"""The one build step for the hand-written CUDA kernels.

Every ``*.cu`` under ``ctpa_torch/csrc/`` is compiled by a single ``nvcc``
call for ``sm_90a`` into one shared library with a plain C interface, which
is loaded with ``ctypes``.  No source includes PyTorch's headers: a build
through ``torch.utils.cpp_extension`` spends minutes in the compiler, this
one seconds.  The build runs once per process, at the first kernel launch,
into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), and raises on any compiler or loader error.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of each extern "C" launcher: c_void_p for pointers and the stream
# (ctypes would otherwise pass a Python int as a 32-bit int and cut it)
SIGNATURES = {
    "patchify_project_launch": (_P,) * 5 + (_I,) * 7 + (_F, _P),
    "flash_attention_fwd_launch": (_P,) * 6 + (_I,) * 7 + (_F, _I, _P),
}


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    ptxas_log: str      # nvcc's -Xptxas -v report: registers, shared memory, spills
    seconds: float      # wall time of the nvcc call


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise FileNotFoundError("nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin")


@functools.cache
def library() -> KernelLibrary:
    """Compile and load the kernels (once per process)."""
    sources = sorted(str(p) for p in CSRC_DIR.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a per-process file name: concurrent processes never load a half-written
    # library; it is unlinked once loaded (the mapping stays valid)
    so_path = BUILD_DIR / f"libctpa_kernels.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(so_path), *sources]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    try:
        lib = ctypes.CDLL(str(so_path))
    finally:
        so_path.unlink(missing_ok=True)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return KernelLibrary(lib, proc.stdout + proc.stderr, seconds)


def check_launch(rc: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code (the launch was refused)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")
