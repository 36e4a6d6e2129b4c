#!/usr/bin/env python3
"""Break K5's decode kernel (the int4 projection at up to 32 rows) down on
one CUDA card.

    python3 profile_int4_decode.py        # from the root of a checkout

At Meditron-7B's decode shapes (qkv_proj 4096 -> 12288 at 4 and 32 rows,
o_proj 4096 -> 4096 and lm_head 4096 -> 32000 at 4 rows; group 128), w4
and w4a8: the bare launcher of `int4_matmul_stream_kernel`, timed with CUDA
events over launches that cycle the weights past the L2 cache (x8 and sx
precomputed for w4a8), with the splits ops/quant.py would choose from each
build's own occupancy, beside variants of its source compiled here (each
its own nvcc and library; each changes one thing, so the difference is what
that thing costs or gains):

  stages 3 / 6     the cp.async ring three or six groups deep (four);
  w4 on 4 warps    w4 without splitting each group's k-steps over 8 warps;
  no dequant       w4's A registers taken from the raw nibbles, without the
                   fp32 products and bf16 rounding (the result is wrong: it
                   measures what the dequantization costs);
  no x staging     x's rows not copied into the ring (wrong result: what
                   staging x costs).

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

VARIANTS = {
    "base": None,
    "stages 3": ("constexpr int kStages = 4;", "constexpr int kStages = 3;"),
    "stages 6": ("constexpr int kStages = 4;", "constexpr int kStages = 6;"),
    "w4 on 4 warps": ("constexpr int kW4Halves = 2;", "constexpr int kW4Halves = 1;"),
    "no dequant": ("  const uint32_t sel = 0x7650u | static_cast<uint32_t>(byte);",
                   "  return (lo >> (8 * byte)) ^ hi ^ __float_as_uint(s);\n"
                   "  const uint32_t sel = 0x7650u | static_cast<uint32_t>(byte);"),
    "no x staging": ("for (int e = tid; e < NT * 8 * kChunks; e += kThreads) {",
                     "for (int e = tid; e < 0; e += kThreads) {"),
}
SHAPES = (("qkv_proj", 4, 4096, 12288), ("qkv_proj", 32, 4096, 12288),
          ("o_proj", 4, 4096, 4096), ("lm_head", 4, 4096, 32000))
_P, _I = ctypes.c_void_p, ctypes.c_int


def build_variants(src: str, tmp: Path) -> dict:
    """Each variant of int4_matmul.cu as (launcher, residency query), built
    side by side."""
    from ctpa_torch.kernels import build

    procs = {}
    for i, (name, edit) in enumerate(VARIANTS.items()):
        text = src
        if edit is not None:
            if edit[0] not in src:
                raise AssertionError(f"variant {name!r}: {edit[0]!r} is not in the source")
            text = src.replace(edit[0], edit[1])
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
            if "entry function" in ln and "stream_kernelILi128ELi1E" in ln:
                form = "w4" if "Lb0" in ln.split("stream_kernel")[1][:20] else "w4a8"
                regs += [f"{form} m<=8: " + ", ".join(
                    x.strip().split(": ")[-1] for x in lines[j + 1:j + 3]
                    if "registers" in x or "spill" in x)]
        print(f"  {name}: {'; '.join(regs)}")
        lib = ctypes.CDLL(str(so))
        launch = lib.int4_matmul_stream_launch
        launch.argtypes = list(build.SIGNATURES["int4_matmul_stream_launch"])
        launch.restype = _I
        resid = lib.int4_matmul_stream_residency
        resid.argtypes = [_I, _I, _I]
        resid.restype = _I
        fns[name] = (launch, resid)
    return fns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_int4_decode: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ctpa_torch.kernels import build
    from ctpa_torch.ops import quant

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    src = (build.CSRC_DIR / "int4_matmul.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        print("builds (registers, spills of the m <= 8 forms):")
        fns = build_variants(src, Path(tmp))
        gen = torch.Generator(device="cuda").manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        counters = torch.zeros(1024, dtype=torch.int32, device="cuda")
        results = {}
        for label, m, d_in, d_out in SHAPES:
            weights = cs._quant_copies(gen, "cuda", d_in, d_out)
            x = torch.randn(m, d_in, generator=gen, device="cuda").to(torch.bfloat16)
            x8, sx = quant.quantize_act_int8(x)
            sx = sx.reshape(-1).contiguous()
            out = torch.empty(m, d_out, dtype=torch.bfloat16, device="cuda")
            nbytes = m * d_in * 2 + d_in // 2 * d_out + d_in // 128 * d_out * 4 + m * d_out * 2
            for a8 in (False, True):
                ref = quant.int4_matmul_plain(x, *weights[0], act_quant=a8)
                for name, (launch, resid) in fns.items():
                    blocks = resid(m, 128, int(a8))
                    _, splits, per = quant.int4_matmul_plan(m, d_in, d_out, 128, sms, blocks)
                    work = torch.empty(splits, m, d_out, device="cuda")
                    it = itertools.cycle(weights)

                    def call():
                        w4, s = next(it)
                        rc = launch(x8.data_ptr() if a8 else x.data_ptr(),
                                    sx.data_ptr() if a8 else None, w4.data_ptr(), s.data_ptr(),
                                    out.data_ptr(), work.data_ptr(), counters.data_ptr(), m,
                                    d_in, d_out, 128, per, splits, int(a8), stream)
                        if rc:
                            raise RuntimeError(f"{name}: launch failed with {rc}")

                    ms = cs.cuda_ms(call, iters=4 * len(weights), warmup=len(weights))
                    it = itertools.cycle(weights[:1])
                    call()
                    err = (out.float() - ref.float()).abs().max().item()
                    results[label, m, a8, name] = ms
                    print(f"  {label} m {m} {'w4a8' if a8 else 'w4'} {name}: {ms:.4f} ms "
                          f"({nbytes / ms / 1e9:.2f} TB/s; {blocks} blocks an SM, {splits} "
                          f"splits of {per} groups; max |err| to plain {err:.3e})", flush=True)
            del weights
            torch.cuda.empty_cache()
        print("relative to base (same call):")
        for (label, m, a8, name), ms in results.items():
            if name != "base":
                base = results[label, m, a8, "base"]
                print(f"  {label} m {m} {'w4a8' if a8 else 'w4'} {name}: {ms / base:.3f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
