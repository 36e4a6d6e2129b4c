#!/usr/bin/env python3
"""Break the int4 decode kernels (K5, the projection, and K7, the SwiGLU FFN,
at up to 32 rows) down on one CUDA card.

    python3 profile_int4_decode.py        # from the root of a checkout

K5 at Meditron-7B's decode shapes (qkv_proj 4096 -> 12288 at 4 and 32 rows,
o_proj 4096 -> 4096 and lm_head 4096 -> 32000 at 4 rows; group 128), w4
and w4a8: the bare launcher of `int4_matmul_stream_kernel`, timed with CUDA
events over launches that cycle the weights past the L2 cache (x8 and sx
precomputed for w4a8), with the splits ops/quant.py would choose from each
build's own occupancy.  K7 at Meditron-7B's FFN (hidden 4096, inter 11008,
71.9 MB of packed weights and scales) at 1, 4 and 32 rows: the bare
launcher of its two decode kernels (gate/up, then down), with the splits
from each build's own cluster occupancy, timed behind a spin kernel
(``chip_smoke.device_ms``) and traced with ``torch.profiler`` for each
kernel's device time beside its byte bound (gate/up 47.9 MB, down 23.9 MB at
3.35 TB/s).  Variants of the sources are compiled side by side (each its
own nvcc and library; each changes one thing, so the difference is what
that thing costs or gains), and each is timed on the kernels it changes:

  stages 3 / 6     K5's cp.async ring three or six groups deep (four);
  w4 on 4 warps    K5's w4 without splitting each group's k-steps over 8
                   warps;
  no dequant       w4's A registers taken from the raw nibbles, without the
                   fp32 products and bf16 rounding (stream_common.cuh, K5 and
                   K7; the result is wrong: it measures what the
                   dequantization costs);
  no x staging     K5's x rows not copied into the ring (wrong result: what
                   staging x costs);
  K7 stages 3      both K7 rings three stages deep (four);
  K7 down 1 an SM  the down kernel's register cap for one block an SM (two:
                   at most 128 registers a thread);
  K7 no finishing  the blocks keep their split's sums but no block adds
                   them (wrong result: the clusters' sums of the splits and
                   what follows them).

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

# name: (the kernels it concerns, edits (file, old, new))
VARIANTS = {
    "base": (("K5", "K7"), ()),
    "stages 3": (("K5",), (("int4_matmul.cu", "constexpr int kStages = 4;",
                            "constexpr int kStages = 3;"),)),
    "stages 6": (("K5",), (("int4_matmul.cu", "constexpr int kStages = 4;",
                            "constexpr int kStages = 6;"),)),
    "w4 on 4 warps": (("K5",), (("int4_matmul.cu", "constexpr int kW4Halves = 2;",
                                 "constexpr int kW4Halves = 1;"),)),
    "no dequant": (("K5", "K7"), (("stream_common.cuh",
                                   "  const uint32_t sel = 0x7650u | static_cast<uint32_t>(byte);",
                                   "  return (lo >> (8 * byte)) ^ hi ^ __float_as_uint(s);\n"
                                   "  const uint32_t sel = 0x7650u | static_cast<uint32_t>(byte);"),)),
    "no x staging": (("K5",), (("int4_matmul.cu",
                                "for (int e = tid; e < NT * 8 * kChunks; e += kThreads) {",
                                "for (int e = tid; e < 0; e += kThreads) {"),)),
    "K7 stages 3": (("K7",), (("int4_ffn.cu", "constexpr int kSStages = 4;",
                               "constexpr int kSStages = 3;"),)),
    "K7 down 1 an SM": (("K7",), (("int4_ffn.cu", "__launch_bounds__(kDnThreads, 2)",
                                   "__launch_bounds__(kDnThreads, 1)"),)),
    "K7 no finishing": (("K7",), (("int4_ffn.cu",
                                   "for (int tok0 = rank; tok0 < a.m; tok0 += 2 * splits) {",
                                   "for (int tok0 = a.m; tok0 < a.m; tok0 += 2 * splits) {"),
                                  ("int4_ffn.cu",
                                   "for (int tok = rank + splits * (tid / kDnBN); tok < a.m;",
                                   "for (int tok = a.m; tok < a.m;"))),
}
SHAPES = (("qkv_proj", 4, 4096, 12288), ("qkv_proj", 32, 4096, 12288),
          ("o_proj", 4, 4096, 4096), ("lm_head", 4, 4096, 32000))
HIDDEN, INTER, FFN_ROWS = 4096, 11008, (1, 4, 32)
_I = ctypes.c_int


def build_variants(tmp: Path) -> dict:
    """Each variant of int4_matmul.cu and int4_ffn.cu (and the headers they
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
               str(src / "int4_matmul.cu"), str(src / "int4_ffn.cu")]
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
            if "entry function" not in ln:
                continue
            if "int4_matmul_stream_kernelILi128ELi1E" in ln:
                form = "K5 w4" if "Lb0" in ln.split("stream_kernel")[1][:20] else "K5 w4a8"
            elif "ffn_" in ln and "stream_kernelILi128ELi" in ln:
                tail = ln.split("stream_kernelILi128ELi")[1]
                form = (f"K7 {'gate/up' if 'gateup' in ln else 'down'} "
                        f"{'w4a8' if tail[2:5] == 'Lb1' else 'w4'} NT {tail[0]}")
            else:
                continue
            regs += [f"{form}: " + ", ".join(
                x.strip().split(": ")[-1] for x in lines[j + 1:j + 3]
                if "registers" in x or "spill" in x)]
        print(f"  {name}: {'; '.join(regs)}")
        lib = ctypes.CDLL(str(so))
        for fn in ("int4_matmul_stream_launch", "int4_matmul_stream_residency",
                   "int4_ffn_stream_launch", "int4_ffn_stream_clusters"):
            getattr(lib, fn).argtypes = list(build.SIGNATURES[fn])
            getattr(lib, fn).restype = _I
        libs[name] = lib
    return libs


def traced(fn, calls: int) -> dict:
    """Device ms a call of each K7 decode kernel, by a profiler trace."""
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
            if f"int4_ffn_{kind}_stream" in ev.key:
                kinds[kind] += us / 1e3 / calls
    return kinds


def profile_k5(libs: dict, results: dict) -> None:
    import torch

    import chip_smoke as cs
    from ctpa_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    counters = torch.zeros(1024, dtype=torch.int32, device="cuda")
    for label, m, d_in, d_out in SHAPES:
        weights = cs._quant_copies(gen, "cuda", d_in, d_out)
        x = torch.randn(m, d_in, generator=gen, device="cuda").to(torch.bfloat16)
        x8, sx = quant.quantize_act_int8(x)
        sx = sx.reshape(-1).contiguous()
        out = torch.empty(m, d_out, dtype=torch.bfloat16, device="cuda")
        nbytes = m * d_in * 2 + d_in // 2 * d_out + d_in // 128 * d_out * 4 + m * d_out * 2
        for a8 in (False, True):
            ref = quant.int4_matmul_plain(x, *weights[0], act_quant=a8)
            for name, lib in libs.items():
                if "K5" not in VARIANTS[name][0]:
                    continue
                blocks = lib.int4_matmul_stream_residency(m, 128, int(a8))
                _, splits, per = quant.int4_matmul_plan(m, d_in, d_out, 128, (sms * blocks,))
                work = torch.empty(splits, m, d_out, device="cuda")
                it = itertools.cycle(weights)

                def call():
                    w4, s = next(it)
                    rc = lib.int4_matmul_stream_launch(
                        x8.data_ptr() if a8 else x.data_ptr(), sx.data_ptr() if a8 else None,
                        w4.data_ptr(), s.data_ptr(), out.data_ptr(), work.data_ptr(),
                        counters.data_ptr(), m, d_in, d_out, 128, per, splits, int(a8), stream)
                    if rc:
                        raise RuntimeError(f"{name}: launch failed with {rc}")

                ms = cs.cuda_ms(call, iters=4 * len(weights), warmup=len(weights))
                it = itertools.cycle(weights[:1])
                call()
                err = (out.float() - ref.float()).abs().max().item()
                results["K5", label, m, a8, name] = ms
                print(f"  K5 {label} m {m} {'w4a8' if a8 else 'w4'} {name}: {ms:.4f} ms "
                      f"({nbytes / ms / 1e9:.2f} TB/s; {blocks} blocks an SM, {splits} "
                      f"splits of {per} groups; max |err| to plain {err:.3e})", flush=True)
        del weights
        torch.cuda.empty_cache()


def profile_k7(libs: dict, results: dict) -> None:
    import torch

    import chip_smoke as cs
    from ctpa_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    ffn = cs._ffn_copies(gen, "cuda", HIDDEN, INTER)
    n_gh, n_gi = HIDDEN // 128, INTER // 128
    bound = {"gateup": (HIDDEN * INTER + 2 * n_gh * INTER * 4) / cs.PEAK_BYTES * 1e3,
             "down": (INTER // 2 * HIDDEN + n_gi * HIDDEN * 4) / cs.PEAK_BYTES * 1e3}
    print(f"K7 byte bounds: gate/up {bound['gateup']:.4f} ms, down {bound['down']:.4f} ms, the "
          f"FFN {bound['gateup'] + bound['down']:.4f} ms")
    bj = quant.ffn_block_j(INTER, 128)
    n_j = -(-INTER // bj)
    for m in FFN_ROWS:
        x = torch.randn(m, HIDDEN, generator=gen, device="cuda").to(torch.bfloat16)
        x8, sx = quant.quantize_act_int8(x)
        sx = sx.reshape(-1).contiguous()
        out = torch.empty(m, HIDDEN, dtype=torch.bfloat16, device="cuda")
        sh = torch.empty(m, n_j, device="cuda")
        for a8 in (False, True):
            ref = quant.int4_ffn_plain(x, *ffn[0], act_quant=a8)
            h = torch.empty(m, n_j * bj, device="cuda",
                            dtype=torch.int8 if a8 else torch.bfloat16)
            for name, lib in libs.items():
                if "K7" not in VARIANTS[name][0]:
                    continue
                clusters = tuple(tuple(lib.int4_ffn_stream_clusters(m, 128, 128, int(a8), down, s)
                                       for s in range(1, 9)) for down in (0, 1))
                _, gu, gu_per, dn, dn_per = quant.int4_ffn_plan(m, HIDDEN, INTER, 128, clusters)
                it = itertools.cycle(ffn)

                def call():
                    ws = next(it)
                    rc = lib.int4_ffn_stream_launch(
                        x8.data_ptr() if a8 else x.data_ptr(), sx.data_ptr() if a8 else None,
                        *(t.data_ptr() for t in ws), out.data_ptr(), h.data_ptr(),
                        sh.data_ptr(), m, HIDDEN, INTER, 128, 128, bj, gu_per, gu, dn_per, dn,
                        int(a8), stream)
                    if rc:
                        raise RuntimeError(f"{name}: launch failed with {rc}")

                device = cs.device_ms(call, 2 * len(ffn))
                kinds = traced(call, 2 * len(ffn))
                it = itertools.cycle(ffn[:1])
                call()
                err = (out.float() - ref.float()).abs().max().item()
                results["K7", "ffn", m, a8, name] = device
                parts = ", ".join(f"{k} {v:.4f} ms ({bound[k] / v if v else 0:.2f} of its "
                                  "bound)" for k, v in kinds.items())
                print(f"  K7 m {m} {'w4a8' if a8 else 'w4'} {name}: device {device:.4f} ms "
                      f"({(bound['gateup'] + bound['down']) / device:.2f} of the bound; "
                      f"clusters of 1-8 at once {clusters}, splits {gu} x {gu_per} groups, "
                      f"{dn} x {dn_per} j-blocks); {parts}; max |err| to plain {err:.3e}",
                      flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_int4_decode: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    with tempfile.TemporaryDirectory() as tmp:
        print("builds (registers, spills of K5's m <= 8 and K7's group-128 forms):")
        libs = build_variants(Path(tmp))
        results = {}
        profile_k5(libs, results)
        profile_k7(libs, results)
        print("relative to base (same call):")
        for (kernel, label, m, a8, name), ms in results.items():
            if name != "base":
                base = results[kernel, label, m, a8, "base"]
                print(f"  {kernel} {label} m {m} {'a8' if a8 else 'w4'} {name}: "
                      f"{ms / base:.3f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
