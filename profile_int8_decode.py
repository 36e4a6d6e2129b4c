#!/usr/bin/env python3
"""Break the int8 decode kernels (K4, the projection, and K6, the SwiGLU FFN,
at up to 32 rows) down on one CUDA card.

    python3 profile_int8_decode.py        # from the root of a checkout

K4 at Meditron-7B's decode shapes (qkv_proj 4096 -> 12288 at 4 and 32
rows, o_proj 4096 -> 4096 and lm_head 4096 -> 32000 at 4 rows), w8 and
w8a8: the bare launcher of `int8_matmul_stream_kernel`, beside its byte
bound.  K6 at Meditron-7B's FFN (hidden 4096, inter 11008, 135.3 MB of int8
weights) and 1, 4 and 32 rows: the bare launcher of its two decode kernels
(gate/up, then down), each traced with ``torch.profiler`` beside its byte
bound at 3.35 TB/s (gate and up 90.2 MB, down 45.1 MB).  Both with the
splits ops/quant.py would choose from each build's own cluster occupancy,
on weights cycled past the L2 cache (x8 and sx precomputed for the int8
forms), timed with CUDA events behind a spin kernel
(``chip_smoke.device_ms``).  Variants of the sources are compiled side by
side (each its own nvcc and library; each changes one thing, so the
difference is what that thing costs or gains), each timed on the kernel it
changes:

  stages 6         K6's rings six stages deep (four);
  rows 64          K6: 64 contraction rows a ring stage (32);
  gate/up 1 an SM  K6's gate/up register cap for one block an SM (two: at
                   most 128 registers a thread);
  no finishing     K6's blocks keep their split's sums but no block adds
                   them (the result is wrong: it measures the clusters'
                   sums of the splits through distributed shared memory and
                   what follows them);
  K4 3 an SM       K4's register cap for three blocks an SM (two);
  K4 no finishing  the same as K6's for K4;
  K4 counter sums  K4's splits added through device memory instead: each
                   block writes its sums to a work buffer and the last block
                   of a strip (a counter it resets) adds them in split order,
                   launched without clusters (K5's way), the same splits.

Prints the card's name and power limit first, and each build's registers.
Exits 1 without a CUDA card.
"""

from __future__ import annotations

import ctypes
import itertools
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HIDDEN, INTER = 4096, 11008
ROWS = (1, 4, 32)
K4_SHAPES = (("qkv_proj", 4, 4096, 12288), ("qkv_proj", 32, 4096, 12288),
             ("o_proj", 4, 4096, 4096), ("lm_head", 4, 4096, 32000))
_K4_FINISH = """  const cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cluster.sync();
"""
_K4_COUNTER = """  const int splits = gridDim.y;
  __syncthreads();
  Acc* work = reinterpret_cast<Acc*>(k4_work);
  for (int e = tid; e < a.m * kSBN; e += kSThreads) {
    const int tok = e / kSBN, c = e - tok * kSBN;
    if (n0 + c < a.n)
      work[(static_cast<long long>(blockIdx.y) * a.m + tok) * a.n + n0 + c] = part[e];
  }
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(k4_counters + blockIdx.x, 1u) == static_cast<unsigned>(splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = tid; e < a.m * kSBN; e += kSThreads) {
    const int tok = e / kSBN, col = n0 + e - tok * kSBN;
    if (col >= a.n) continue;
    Acc sum = 0;
    for (int z = 0; z < splits; ++z)
      sum += __ldcg(work + (static_cast<long long>(z) * a.m + tok) * a.n + col);
    const float sc = a.scale[col];
    const float y = A8 ? __fmul_rn(__fmul_rn(static_cast<float>(sum), a.sx[tok]), sc)
                       : __fmul_rn(static_cast<float>(sum), sc);
    a.out[static_cast<long long>(tok) * a.n + col] = __float2bfloat16_rn(y);
  }
  if (tid == 0) k4_counters[blockIdx.x] = 0u;
  return;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = 0;
"""
# name: (the kernel it concerns, edits (file, old, new))
VARIANTS = {
    "base": (("K4", "K6"), ()),
    "stages 6": (("K6",), (("int8_ffn.cu", "constexpr int kSStages = 4;",
                            "constexpr int kSStages = 6;"),)),
    "rows 64": (("K6",), (("int8_ffn.cu", "constexpr int kSKC = 32;",
                           "constexpr int kSKC = 64;"),)),
    "gate/up 1 an SM": (("K6",), (("int8_ffn.cu", "__launch_bounds__(kGuThreads, 2)",
                                   "__launch_bounds__(kGuThreads, 1)"),)),
    "no finishing": (("K6",), (("int8_ffn.cu",
                                "for (int tok = rank; tok < a.m; tok += splits) {",
                                "for (int tok = a.m; tok < a.m; tok += splits) {"),
                               ("int8_ffn.cu",
                                "for (int tok = rank + splits * (tid / kDnBN); tok < a.m;",
                                "for (int tok = a.m; tok < a.m;"))),
    "K4 3 an SM": (("K4",), (("int8_matmul.cu",
                              "__launch_bounds__(kSThreads, 2) int8_matmul_stream_kernel",
                              "__launch_bounds__(kSThreads, 3) int8_matmul_stream_kernel"),)),
    "K4 no finishing": (("K4",), (("int8_matmul.cu",
                                   "for (int tok = rank + splits * (tid / kSBN); tok < a.m;",
                                   "for (int tok = a.m; tok < a.m;"),)),
    "K4 counter sums": (("K4",), (
        ("int8_matmul.cu", _K4_FINISH, _K4_COUNTER),
        ("int8_matmul.cu", "extern __shared__ __align__(16) unsigned char smem_stream8[];",
         "extern __shared__ __align__(16) unsigned char smem_stream8[];\n"
         "__device__ float k4_work[8 * 32 * 32000];\n__device__ unsigned int k4_counters[1024];"),
        ("int8_matmul.cu", """  return wstream::launch_clusters(int8_matmul_stream_kernel<NT, A8>,
                                  dim3((a.n + kSBN - 1) / kSBN, splits), kSThreads,
                                  SStage<NT, A8>::kBytes, st, a);""",
         """  auto kernel = int8_matmul_stream_kernel<NT, A8>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SStage<NT, A8>::kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.n + kSBN - 1) / kSBN, splits), kSThreads, SStage<NT, A8>::kBytes, st>>>(a);
  return cudaGetLastError();"""))),
}
_I = ctypes.c_int


def build_variants(tmp: Path) -> dict:
    """Each variant of int8_ffn.cu and int8_matmul.cu (and the headers they
    include) as one library, built side by side: {name: CDLL}."""
    from ctpa_torch.kernels import build

    procs = {}
    for i, (name, (_, edits)) in enumerate(VARIANTS.items()):
        src = tmp / f"v{i}"
        shutil.copytree(build.CSRC_DIR, src)
        for file, old, new in edits:
            text = (src / file).read_text()
            if old not in text:
                raise AssertionError(f"variant {name!r}: {old!r} is not in {file}")
            (src / file).write_text(text.replace(old, new))
        so = tmp / f"v{i}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(src), "-o", str(so),
               str(src / "int8_ffn.cu"), str(src / "int8_matmul.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        lines = log.splitlines()
        regs = []
        for j, ln in enumerate(lines):
            if "entry function" in ln and "stream_kernelILi4E" in ln:
                kind = ("K6 gate/up" if "gateup" in ln else "K6 down" if "ffn_down" in ln
                        else "K4")
                form = "w8" if "ILi4ELb0" in ln else "w8a8"
                regs += [f"{kind} {form} m<=32: " + ", ".join(
                    x.strip().split(": ")[-1] for x in lines[j + 1:j + 3]
                    if "registers" in x or "spill" in x)]
        print(f"  {name}: {'; '.join(regs)}")
        lib = ctypes.CDLL(str(so))
        for fn in ("int8_ffn_stream_launch", "int8_ffn_stream_clusters",
                   "int8_matmul_stream_launch", "int8_matmul_stream_clusters"):
            getattr(lib, fn).argtypes = list(build.SIGNATURES[fn])
            getattr(lib, fn).restype = _I
        libs[name] = lib
    return libs


def traced(fn, calls: int) -> dict:
    """Device ms a call of each K6 decode kernel, by a profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kinds = {"gateup": 0.0, "down": 0.0}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        for kind in kinds:
            if f"ffn_{kind}_stream" in ev.key:
                kinds[kind] += us / 1e3 / calls
    return kinds


def profile_k4(libs: dict, results: dict) -> None:
    import torch

    import chip_smoke as cs
    from ctpa_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    for label, m, d_in, d_out in K4_SHAPES:
        weights = [tuple(c) for c in cs._int8_copies(gen, "cuda", ((d_in, d_out),))]
        x = torch.randn(m, d_in, generator=gen, device="cuda").to(torch.bfloat16)
        x8, sx = quant._quantize_act_kernel(x)
        out = torch.empty(m, d_out, dtype=torch.bfloat16, device="cuda")
        bound = (d_in * d_out + d_out * 4) / cs.PEAK_BYTES * 1e3
        for a8 in (False, True):
            ref = quant.int8_matmul_plain(x, *weights[0], act_quant=a8)
            for name, lib in libs.items():
                if "K4" not in VARIANTS[name][0]:
                    continue
                clusters = tuple(lib.int8_matmul_stream_clusters(m, int(a8), s)
                                 for s in range(1, 9))
                _, splits, per = quant.int8_matmul_plan(m, d_in, d_out, clusters)
                it = itertools.cycle(weights)

                def call():
                    w8, s = next(it)
                    rc = lib.int8_matmul_stream_launch(
                        x8.data_ptr() if a8 else x.data_ptr(), sx.data_ptr() if a8 else None,
                        w8.data_ptr(), s.data_ptr(), out.data_ptr(), m, d_in, d_out, per,
                        splits, int(a8), stream)
                    if rc:
                        raise RuntimeError(f"{name}: launch failed with {rc}")

                device = cs.device_ms(call, 2 * len(weights))
                it = itertools.cycle(weights[:1])
                call()
                err = (out.float() - ref.float()).abs().max().item()
                results["K4", label, m, a8, name] = device
                print(f"  K4 {label} m {m} {'w8a8' if a8 else 'w8'} {name}: device {device:.4f} "
                      f"ms ({bound / device:.2f} of its {bound:.4f} ms byte bound; clusters of "
                      f"1-8 at once {clusters}, {splits} splits of {per} stages); max |err| to "
                      f"plain {err:.3e}", flush=True)
        del weights
        torch.cuda.empty_cache()


def profile_k6(libs: dict, results: dict) -> None:
    import torch

    import chip_smoke as cs
    from ctpa_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(0)
    bound = {"gateup": 2 * HIDDEN * INTER / cs.PEAK_BYTES * 1e3,
             "down": INTER * HIDDEN / cs.PEAK_BYTES * 1e3}
    print(f"K6 byte bounds: gate/up {bound['gateup']:.4f} ms, down {bound['down']:.4f} ms, the "
          f"FFN {bound['gateup'] + bound['down']:.4f} ms")
    ffn = cs._int8_copies(gen, "cuda", ((HIDDEN, INTER), (HIDDEN, INTER), (INTER, HIDDEN)))
    stream = torch.cuda.current_stream().cuda_stream
    n_j = -(-INTER // quant.INT8_BLOCK_J)
    for m in ROWS:
        x = torch.randn(m, HIDDEN, generator=gen, device="cuda").to(torch.bfloat16)
        x8, sx = quant._quantize_act_kernel(x)
        out = torch.empty(m, HIDDEN, dtype=torch.bfloat16, device="cuda")
        for a8 in (False, True):
            ref = quant.int8_ffn_plain(x, *ffn[0], act_quant=a8)
            h = torch.empty(m, n_j * quant.INT8_BLOCK_J, device="cuda",
                            dtype=torch.int8 if a8 else torch.bfloat16)
            sh = torch.empty(m, n_j, device="cuda")
            for name, lib in libs.items():
                if "K6" not in VARIANTS[name][0]:
                    continue
                clusters = tuple(tuple(lib.int8_ffn_stream_clusters(m, int(a8), down, s)
                                       for s in range(1, 9)) for down in (0, 1))
                keep = quant.FFN_STREAM_KC       # the plan counts this build's stages
                quant.FFN_STREAM_KC = 64 if name == "rows 64" else keep
                try:
                    _, gu, gu_per, dn, dn_per = quant.int8_ffn_plan(m, HIDDEN, INTER, clusters)
                finally:
                    quant.FFN_STREAM_KC = keep
                it = itertools.cycle(ffn)

                def call():
                    ws = next(it)
                    rc = lib.int8_ffn_stream_launch(
                        x8.data_ptr() if a8 else x.data_ptr(), sx.data_ptr() if a8 else None,
                        *(t.data_ptr() for t in ws), out.data_ptr(), h.data_ptr(),
                        sh.data_ptr(), m, HIDDEN, INTER, gu_per, gu, dn_per, dn, int(a8),
                        stream)
                    if rc:
                        raise RuntimeError(f"{name}: launch failed with {rc}")

                device = cs.device_ms(call, 2 * len(ffn))
                kinds = traced(call, 2 * len(ffn))
                it = itertools.cycle(ffn[:1])
                call()
                err = (out.float() - ref.float()).abs().max().item()
                results["K6", "ffn", m, a8, name] = device
                parts = ", ".join(f"{k} {v:.4f} ms ({bound[k] / v if v else 0:.2f} of its "
                                  "bound)" for k, v in kinds.items())
                print(f"  K6 m {m} {'w8a8' if a8 else 'w8'} {name}: device {device:.4f} ms "
                      f"({(bound['gateup'] + bound['down']) / device:.2f} of the bound; "
                      f"clusters of 1-8 at once {clusters}, splits {gu} x {gu_per} "
                      f"stages, {dn} x {dn_per} j-blocks); {parts}; max |err| to plain "
                      f"{err:.3e}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_int8_decode: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    with tempfile.TemporaryDirectory() as tmp:
        print("builds (registers, spills of the m <= 32 forms):")
        libs = build_variants(Path(tmp))
        results = {}
        profile_k4(libs, results)
        profile_k6(libs, results)
        print("relative to base (same call):")
        for (kernel, label, m, a8, name), ms in results.items():
            if name != "base":
                base = results[kernel, label, m, a8, "base"]
                print(f"  {kernel} {label} m {m} {'a8' if a8 else 'w8'} {name}: "
                      f"{ms / base:.3f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
