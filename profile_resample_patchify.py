#!/usr/bin/env python3
"""Break the fused resample-patchify kernel (K9) down on one CUDA card.

    python3 profile_resample_patchify.py        # from the root of a checkout

At the shipped raw (160, 512, 512), x2 (240, 480, 512) bf16, dim 512: the
kernel's bare launcher timed with CUDA events on precomputed operands, x2
cycled past the L2 cache, beside variants of its source compiled here (each
its own nvcc and library; each changes one thing, so the difference is what
that thing costs):

  ieee division    the window divides by the scale, as ctpa writes it;
  no window        the kernel as built with the window off (a launch flag);
  no task loop     the x2 rows are copied to shared memory but no column is
                   formed: the row copies, their barrier and the projection;
  no staging       the projection and its epilogue alone;

then the wrapper's parts (the taps with the call's host sync, the folded
projection), K1's wrapper at the same shape, and torch.profiler's device
time per launch of K9 and K1.  Prints the card's name and power limit
first.  Exits 1 without a CUDA card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

VARIANTS = {
    "ieee division": ("* inv_scale;", "/ scale;"),
    "no task loop": ("e < tile.slabs * w * nr; e += kThreads) {\n      const int rr",
                     "e < 0; e += kThreads) {\n      const int rr"),
    "no staging": ("float* sq_s) {\n    // the chunk's x2 rows",
                   "float* sq_s) {\n    return;\n    // the chunk's x2 rows"),
}


def build_variants(src: str, tmp: Path) -> dict:
    """Each variant of the source as a loaded launcher, built side by side."""
    from ctpa_torch.kernels import build

    procs = {}
    for i, (name, (old, new)) in enumerate(VARIANTS.items()):
        if old not in src:
            raise AssertionError(f"variant {name!r}: {old!r} is not in the source")
        cu, so = tmp / f"v{i}.cu", tmp / f"v{i}.so"
        cu.write_text(src.replace(old, new))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(build.CSRC_DIR), "-o",
               str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"  {name}: {'; '.join(regs)}")
        fn = getattr(ctypes.CDLL(str(so)), "resample3_patchify_project_launch")
        fn.argtypes = list(build.SIGNATURES["resample3_patchify_project_launch"])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_resample_patchify: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ctpa_torch.core.config import CTViTConfig
    from ctpa_torch.kernels import build
    from ctpa_torch.ops import resample_patchify as rp
    from ctpa_torch.ops.patchify import patchify_project

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    print("building the kernels and the variants (registers and spills):")
    fns = {"as built": build.library().lib.resample3_patchify_project_launch}
    with tempfile.TemporaryDirectory() as tmp:
        fns.update(build_variants((build.CSRC_DIR / "resample_patchify.cu").read_text(),
                                  Path(tmp)))

    dev, bf16 = "cuda", torch.bfloat16
    cfg = CTViTConfig()
    pt, p, dim, pd = cfg.temporal_patch_size, cfg.patch_size, cfg.dim, cfg.patch_dim
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    with torch.inference_mode():
        ops = cs.k9_operands(gen, dev, cs.RAW_SHAPE, None, cs.RAW_SPACING)
        g = (1 + 0.1 * torch.randn(pd, generator=gen, device=dev)).to(bf16)
        K = (0.02 * torch.randn(pd, dim, generator=gen, device=dev)).to(bf16)
        taps_i, taps_w, _ = rp.stage3_taps(ops.wwp)
        kg, v2 = rp._fold_terms(g, K, bf16)
        masks = [m.to(torch.uint8).contiguous() for m in ops[2:5]]
        D, H, ws = ops.x2.shape
        W = ops.wwp.shape[0]
        out = torch.empty(D // pt, H // p, W // p, dim, dtype=bf16, device=dev)
        x2s = [ops.x2, ops.x2.clone()]                 # 118 MB each, past the 50 MB L2
        stream = torch.cuda.current_stream().cuda_stream
        kw = dict(window=ops.window, pad_value=ops.pad_value)

        def launch(fn, x2, window=True):
            lo, hi, shift, scale = ops.window
            rc = fn(x2.data_ptr(), taps_i.data_ptr(), taps_w.data_ptr(),
                    *(m.data_ptr() for m in masks), kg.data_ptr(), v2.data_ptr(),
                    out.data_ptr(), D, H, ws, W, pt, p, p, dim, int(window), lo, hi, shift,
                    scale, ops.pad_value, 1e-5, stream)
            build.check_launch(rc, "resample3_patchify_project")

        def cycled_ms(f, inputs=x2s):
            calls = iter(range(10 ** 6))
            return cs.cuda_ms(lambda: f(inputs[next(calls) % 2]))

        ref = rp.resample3_patchify_project_plain(*ops[:5], g, K, pt, p, p, **kw).float()
        print("bare launcher, shipped shape (ms a launch):")
        for name, fn in fns.items():
            launch(fn, ops.x2)
            err = (out.float() - ref).abs().max().item()
            print(f"  {name:16s} {cycled_ms(lambda x2: launch(fn, x2)):.4f}  "
                  f"(max |out - plain| {err:.3e})")
        no_window = cycled_ms(lambda x2: launch(fns["as built"], x2, False))
        print(f"  {'no window':16s} {no_window:.4f}")
        vols = [(torch.rand(D, H, W, generator=gen, device=dev) * 2 - 1).to(bf16)
                for _ in range(2)]
        parts = {
            "resample3_patchify_project": cycled_ms(
                lambda x2: rp.resample3_patchify_project(x2, *ops[1:5], g, K, pt, p, p, **kw)),
            "stage3_taps and the host sync": cs.cuda_ms(
                lambda: bool(rp.stage3_taps(ops.wwp)[2])),
            "folded projection": cs.cuda_ms(lambda: rp._fold_terms(g, K, bf16)),
            "patchify_project (K1)": cycled_ms(lambda v: patchify_project(v, g, K, pt, p, p),
                                               vols),
        }
        print("wrappers (ms a call):")
        for name, ms in parts.items():
            print(f"  {name:30s} {ms:.4f}")

        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(10):
                rp.resample3_patchify_project(x2s[i % 2], *ops[1:5], g, K, pt, p, p, **kw)
                patchify_project(vols[i % 2], g, K, pt, p, p)
            torch.cuda.synchronize()
        print("device time per launch (torch.profiler):")
        for ev in prof.key_averages():
            if "patchify_project_kernel" in ev.key:
                dt = getattr(ev, "device_time", None) or ev.cuda_time
                print(f"  {ev.key[:60]}: {dt / 1e3:.4f} ms over {ev.count} launches")
    return 0


if __name__ == "__main__":
    sys.exit(main())
