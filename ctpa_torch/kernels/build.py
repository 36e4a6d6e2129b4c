"""The one build step for the hand-written CUDA kernels.

Every ``*.cu`` under ``ctpa_torch/csrc/`` (which may include the ``*.cuh``
headers beside it) is compiled for ``sm_90a`` by its own ``nvcc`` process,
all started together, and the objects are linked into one shared library
with a plain C interface, which is loaded with ``ctypes``.  No source includes PyTorch's headers: a build through
``torch.utils.cpp_extension`` spends minutes in the compiler, this one
seconds.  The build runs once per process, at the first kernel launch, into
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
and raises on any compiler or loader error.
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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of each extern "C" launcher: c_void_p for pointers and the stream
# (ctypes would otherwise pass a Python int as a 32-bit int and cut it)
SIGNATURES = {
    "patchify_project_launch": (_P,) * 5 + (_I,) * 7 + (_F, _P),
    "resample3_patchify_project_launch": (_P,) * 9 + (_I,) * 9 + (_F,) * 6 + (_P,),
    "flash_attention_fwd_launch": (_P,) * 8 + (_I,) * 8 + (_F, _I, _P),
    "flash_attention_fwd_lse_launch": (_P,) * 9 + (_I,) * 8 + (_F, _I, _P),
    "flash_attention_bwd_delta_launch": (_P,) * 3 + (_I,) * 5 + (_P,),
    "flash_attention_bwd_dq_launch": (_P,) * 10 + (_I,) * 8 + (_F, _I, _P),
    "flash_attention_bwd_dkv_launch": (_P,) * 11 + (_I,) * 8 + (_F, _I, _P),
    "flash_attention_bwd_dbias_launch": (_P,) * 10 + (_I,) * 8 + (_F, _I, _P),
    "flash_attention_fwd_d128_launch": (_P,) * 8 + (_I,) * 8 + (_F, _I, _P),
    "flash_attention_fwd_lse_d128_launch": (_P,) * 9 + (_I,) * 8 + (_F, _I, _P),
    "flash_attention_bwd_dq_d128_launch": (_P,) * 10 + (_I,) * 8 + (_F, _I, _P),
    "flash_attention_bwd_dkv_d128_launch": (_P,) * 11 + (_I,) * 8 + (_F, _I, _P),
    "decode_attention_launch": (_P,) * 7 + (_I,) * 6 + (_F, _I, _I, _P),
    "int4_matmul_stream_launch": (_P,) * 7 + (_I,) * 7 + (_P,),
    "int4_act_quant_launch": (_P,) * 3 + (_I,) * 2 + (_P,),
    "int4_matmul_stream_residency": (_I,) * 3,
    "int4_matmul_prefill_launch": (_P,) * 5 + (_I,) * 7 + (_P,),
    "int4_matmul_prefill_clusters": (_I,) * 3,
    "int4_ffn_stream_launch": (_P,) * 11 + (_I,) * 11 + (_P,),
    "int4_ffn_stream_clusters": (_I,) * 6,
    "int4_ffn_prefill_launch": (_P,) * 11 + (_I,) * 7 + (_P,),
    "int8_matmul_stream_launch": (_P,) * 5 + (_I,) * 6 + (_P,),
    "int8_matmul_stream_clusters": (_I,) * 3,
    "int8_matmul_prefill_launch": (_P,) * 5 + (_I,) * 6 + (_P,),
    "int8_matmul_prefill_clusters": (_I,) * 2,
    "int8_ffn_stream_launch": (_P,) * 11 + (_I,) * 8 + (_P,),
    "int8_ffn_stream_clusters": (_I,) * 4,
    "int8_ffn_prefill_launch": (_P,) * 11 + (_I,) * 4 + (_P,),
}


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    ptxas_log: str      # nvcc's -Xptxas -v report: registers, shared memory, spills
    seconds: float      # wall time of the build, compiles and link


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise FileNotFoundError("nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin")


def _run(cmds: list[list[str]]) -> str:
    """Run the commands side by side; their joined output, or raise if any fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


@functools.cache
def library() -> KernelLibrary:
    """Compile and load the kernels (once per process)."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # per-process file names: concurrent processes never load a half-written
    # library; the files are unlinked once loaded (the mapping stays valid)
    tag = os.getpid()
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    so_path = BUILD_DIR / f"libctpa_kernels.{tag}.so"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources, objects)])
        log += _run([[nvcc, *ARCH, "-shared", "-o", str(so_path), *map(str, objects)]])
        seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so_path))
    finally:
        for path in (*objects, so_path):
            path.unlink(missing_ok=True)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return KernelLibrary(lib, log, seconds)


def check_launch(rc: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code (the launch was refused)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")
