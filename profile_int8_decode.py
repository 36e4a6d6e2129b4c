#!/usr/bin/env python3
"""Break K6's decode kernels (the int8 SwiGLU FFN at up to 32 rows) down on
one CUDA card.

    python3 profile_int8_decode.py        # from the root of a checkout

At Meditron-7B's FFN (hidden 4096, inter 11008, 135.3 MB of int8 weights)
and 1, 4 and 32 rows, w8 and w8a8: the bare launcher of K6's two decode
kernels (gate/up, then down), with the splits ops/quant.py would choose
from each build's own cluster occupancy, on weights cycled past the L2 cache (x8
and sx precomputed for w8a8), timed with CUDA events behind a spin kernel
(``chip_smoke.device_ms``) and traced with ``torch.profiler`` for each
kernel's device time beside its byte bound at 3.35 TB/s (gate and up 90.2
MB, down 45.1 MB).  Variants of int8_ffn.cu are compiled side by side (each
its own nvcc and library; each changes one thing, so the difference is
what that thing costs or gains):

  stages 6        both rings six stages deep (four);
  rows 64         64 contraction rows a ring stage (32);
  gate/up 1 an SM the gate/up kernel's register cap for one block an SM
                  (two: at most 128 registers a thread);
  no finishing    the blocks keep their split's sums but no block adds
                  them (the result is wrong: it measures the clusters'
                  sums of the splits through distributed shared memory and
                  what follows them).

Prints the card's name and power limit first, and each build's registers.
Exits 1 without a CUDA card.
"""

from __future__ import annotations

import ctypes
import itertools
import subprocess
import sys
import tempfile
from pathlib import Path

HIDDEN, INTER = 4096, 11008
ROWS = (1, 4, 32)
VARIANTS = {
    "base": None,
    "stages 6": (("constexpr int kSStages = 4;", "constexpr int kSStages = 6;"),),
    "rows 64": (("constexpr int kSKC = 32;", "constexpr int kSKC = 64;"),),
    "gate/up 1 an SM": (("__launch_bounds__(kGuThreads, 2)",
                         "__launch_bounds__(kGuThreads, 1)"),),
    "no finishing": (("for (int tok = rank; tok < a.m; tok += splits) {",
                      "for (int tok = a.m; tok < a.m; tok += splits) {"),
                     ("for (int tok = rank + splits * (tid / kDnBN); tok < a.m;",
                      "for (int tok = a.m; tok < a.m;")),
}
_I = ctypes.c_int


def build_variants(src: str, tmp: Path) -> dict:
    """Each variant of int8_ffn.cu as (launcher, cluster occupancy query),
    built side by side."""
    from ctpa_torch.kernels import build

    procs = {}
    for i, (name, edit) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edit or ():
            if old not in text:
                raise AssertionError(f"variant {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu, so = tmp / f"v{i}.cu", tmp / f"v{i}.so"
        cu.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(build.CSRC_DIR), "-o",
               str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        lines = log.splitlines()
        regs = []
        for j, ln in enumerate(lines):
            if "entry function" in ln and "stream_kernelILi4E" in ln:
                kind = "gate/up" if "gateup" in ln else "down"
                form = "w8" if "ILi4ELb0" in ln else "w8a8"
                regs += [f"{kind} {form} m<=32: " + ", ".join(
                    x.strip().split(": ")[-1] for x in lines[j + 1:j + 3]
                    if "registers" in x or "spill" in x)]
        print(f"  {name}: {'; '.join(regs)}")
        lib = ctypes.CDLL(str(so))
        launch = lib.int8_ffn_stream_launch
        launch.argtypes = list(build.SIGNATURES["int8_ffn_stream_launch"])
        launch.restype = _I
        clusters = lib.int8_ffn_stream_clusters
        clusters.argtypes = [_I, _I, _I, _I]
        clusters.restype = _I
        fns[name] = (launch, clusters)
    return fns


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
            if f"{kind}_stream" in ev.key:
                kinds[kind] += us / 1e3 / calls
    return kinds


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_int8_decode: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ctpa_torch.kernels import build
    from ctpa_torch.ops import quant

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    src = (build.CSRC_DIR / "int8_ffn.cu").read_text()
    bound = {"gateup": 2 * HIDDEN * INTER / cs.PEAK_BYTES * 1e3,
             "down": INTER * HIDDEN / cs.PEAK_BYTES * 1e3}
    print(f"byte bounds: gate/up {bound['gateup']:.4f} ms, down {bound['down']:.4f} ms, "
          f"the FFN {bound['gateup'] + bound['down']:.4f} ms")
    with tempfile.TemporaryDirectory() as tmp:
        print("builds (registers, spills of the m <= 32 forms):")
        fns = build_variants(src, Path(tmp))
        gen = torch.Generator(device="cuda").manual_seed(0)
        ffn = cs._int8_copies(gen, "cuda", ((HIDDEN, INTER), (HIDDEN, INTER), (INTER, HIDDEN)))
        stream = torch.cuda.current_stream().cuda_stream
        n_j = -(-INTER // quant.INT8_BLOCK_J)
        results = {}
        for m in ROWS:
            x = torch.randn(m, HIDDEN, generator=gen, device="cuda").to(torch.bfloat16)
            x8, sx = quant._quantize_act_kernel(x)
            out = torch.empty(m, HIDDEN, dtype=torch.bfloat16, device="cuda")
            for a8 in (False, True):
                ref = quant.int8_ffn_plain(x, *ffn[0], act_quant=a8)
                h = torch.empty(m, n_j * quant.INT8_BLOCK_J, device="cuda",
                                dtype=torch.int8 if a8 else torch.bfloat16)
                sh = torch.empty(m, n_j, device="cuda")
                for name, (launch, query) in fns.items():
                    clusters = tuple(tuple(query(m, int(a8), down, s) for s in range(1, 9))
                                     for down in (0, 1))
                    keep = quant.FFN_STREAM_KC       # the plan counts this build's stages
                    quant.FFN_STREAM_KC = 64 if name == "rows 64" else keep
                    try:
                        _, gu, gu_per, dn, dn_per = quant.int8_ffn_plan(m, HIDDEN, INTER,
                                                                        clusters)
                    finally:
                        quant.FFN_STREAM_KC = keep
                    it = itertools.cycle(ffn)

                    def call():
                        ws = next(it)
                        rc = launch(x8.data_ptr() if a8 else x.data_ptr(),
                                    sx.data_ptr() if a8 else None,
                                    *(t.data_ptr() for t in ws), out.data_ptr(), h.data_ptr(),
                                    sh.data_ptr(), m, HIDDEN, INTER, gu_per, gu, dn_per, dn,
                                    int(a8), stream)
                        if rc:
                            raise RuntimeError(f"{name}: launch failed with {rc}")

                    device = cs.device_ms(call, 2 * len(ffn))
                    kinds = traced(call, 2 * len(ffn))
                    it = itertools.cycle(ffn[:1])
                    call()
                    err = (out.float() - ref.float()).abs().max().item()
                    results[m, a8, name] = device
                    parts = ", ".join(f"{k} {v:.4f} ms ({bound[k] / v if v else 0:.2f} of its "
                                      "bound)" for k, v in kinds.items())
                    print(f"  m {m} {'w8a8' if a8 else 'w8'} {name}: device {device:.4f} ms "
                          f"({(bound['gateup'] + bound['down']) / device:.2f} of the bound; "
                          f"clusters of 1-8 at once {clusters}, splits {gu} x {gu_per} "
                          f"stages, {dn} x {dn_per} j-blocks); {parts}; max |err| to plain "
                          f"{err:.3e}",
                          flush=True)
        print("relative to base (same call):")
        for (m, a8, name), ms in results.items():
            if name != "base":
                print(f"  m {m} {'w8a8' if a8 else 'w8'} {name}: "
                      f"{ms / results[m, a8, 'base']:.3f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
