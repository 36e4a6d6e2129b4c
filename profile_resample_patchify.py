#!/usr/bin/env python3
"""Time the patch-embed kernels, K9 (fused resample-patchify) and K1
(patchify), on one CUDA card, against a parent tree's build in the same
process.

    python3 profile_resample_patchify.py [--parent DIR]    # from the root of a checkout

At the shipped raw (160, 512, 512), x2 (240, 480, 512) bf16, and the
shipped volume (240, 480, 480) bf16, dim 512: each kernel's bare launcher on
precomputed operands, its input cycled between two copies past the 50 MB L2
cache, timed with CUDA events behind a spin kernel (chip_smoke.device_ms),
each timing after an idle second.  With --parent DIR (a checkout of the
parent commit, e.g. unpacked by ``git archive``), the parent's patchify.cu
and resample_patchify.cu with their headers are built by their own nvcc
processes into a library of their own and timed beside this tree's in the
order parent, this, this, parent.  Then variants of this tree's source,
each its own build, which leave parts of the kernel out (the outputs are
then wrong; only the time counts):

  no staging      the staging threads form no patch row (the copies and
                  the products run);
  no products     the consumers issue no wgmma;
  no row copies   no source row is copied (the staging reads stale units);
  products alone, rows alone, staging alone   two of the three left out;
  timeline        clock64 marks of the first cluster's blocks at each
                  k-block (staging thread 0, the window's copier, the
                  consumers), printed for a few k-blocks;

and the dense bf16 torch.matmul of the (13,824, 4,000) patch matrix by K as
a yardstick (no single PyTorch call computes the fused function; the port
never calls it).  Prints the card's name and power limit first and the
ptxas report of each build's kernels.  Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

LAUNCHERS = ("patchify_project_launch", "resample3_patchify_project_launch")
SOURCES = ("patchify.cu", "resample_patchify.cu")
SOURCES_BY_KERNEL = (("patchify.cu", "K1"), ("resample_patchify.cu", "K9"))
# (file, old, new) edits on a copy of this tree's csrc/
NO_FORMING = [("patch_wgmma.cuh", "      if (task)\n        stage.form(", "      if (false)\n        stage.form(")]
NO_PRODUCTS = [("patch_wgmma.cuh", "for (int kk = 0; kk < kKB / 16; ++kk) {",
                "for (int kk = 0; kk < 0; ++kk) {")]
NO_ROWS = [("patch_wgmma.cuh", "const int n_rows = g.bulk ? g.rows : 0;", "const int n_rows = 0;"),
           ("patch_wgmma.cuh", "for (int r = r_a; r <= r_b; ++r)\n          hopper::mbar_wait(&ufull",
            "for (int r = r_a; r < r_a; ++r)\n          hopper::mbar_wait(&ufull")]
VARIANTS = {
    "no staging": NO_FORMING,
    "no products": NO_PRODUCTS,
    "no row copies": NO_ROWS,
    "products alone": NO_FORMING + NO_ROWS,
    "rows alone": NO_FORMING + NO_PRODUCTS,
    "staging alone": NO_PRODUCTS + NO_ROWS,
}
# clock64 marks of blocks 0 and 1 (a cluster) per k-block, read by
# patch_timeline_K1/K9(): staging thread 0 after the empty wait (0), after
# the row waits (1), after its warp's arrival (2); the window's copier after
# its empty wait (3); consumer thread 128 after the full wait (4) and
# wgmma_wait<1> (5); consumer thread 256 after the full wait (6)
TIMELINE = [
    ("patch_wgmma.cuh", "extern __shared__ __align__(16) unsigned char patch_smem[];",
     "extern __shared__ __align__(16) unsigned char patch_smem[];\n"
     "__device__ long long patch_tl[2][80][8];\n"
     "#define MARK(k, e) if (blockIdx.x < 2 && k < 80) patch_tl[blockIdx.x][k][e] = clock64()"),
    ("patch_wgmma.cuh", "      hopper::mbar_wait(&empty[s], at.phase ^ 1);\n      if (g.bulk) {",
     "      hopper::mbar_wait(&empty[s], at.phase ^ 1);\n      if (st == 0) MARK(kb, 0);\n"
     "      if (g.bulk) {"),
    ("patch_wgmma.cuh", "hopper::mbar_wait(&ufull[r & (g.units - 1)], (r >> g.unit_shift) & 1);\n",
     "hopper::mbar_wait(&ufull[r & (g.units - 1)], (r >> g.unit_shift) & 1);\n"
     "        if (st == 0) MARK(kb, 1);\n"),
    ("patch_wgmma.cuh", "      if (lane == 0) hopper::mbar_arrive(&full[s]);\n",
     "      if (lane == 0) hopper::mbar_arrive(&full[s]);\n      if (st == 0) MARK(kb, 2);\n"),
    ("patch_wgmma.cuh", "        if (lane == 0) {\n          unsigned char* stg = ring + at.s * kStageBytes;\n",
     "        if (lane == 0) {\n          MARK(kb, 3);\n          unsigned char* stg = ring + at.s * kStageBytes;\n"),
    ("patch_wgmma.cuh", "      hopper::mbar_wait(&full[s], at.phase);\n",
     "      hopper::mbar_wait(&full[s], at.phase);\n"
     "      if (tid == kConsumer0) MARK(kb, 4);\n      if (tid == kConsumer0 + 128) MARK(kb, 6);\n"),
    ("patch_wgmma.cuh", "      hopper::wgmma_wait<1>();   // the previous stage's products are done\n",
     "      hopper::wgmma_wait<1>();   // the previous stage's products are done\n"
     "      if (tid == kConsumer0) MARK(kb, 5);\n"),
] + [(src, "  return static_cast<int>(err);\n}",
       "  return static_cast<int>(err);\n}\n"
       f"extern \"C\" int patch_timeline_{kernel}(long long* out) {{\n"
       "  return static_cast<int>(cudaMemcpyFromSymbol(out, patch_wgmma::patch_tl, "
       "sizeof(patch_wgmma::patch_tl)));\n}") for src, kernel in SOURCES_BY_KERNEL]
VARIANTS["timeline"] = TIMELINE


def start_build(csrc: Path, out: Path) -> list:
    """nvcc for each of K1's and K9's sources in csrc, started together."""
    from ctpa_torch.kernels import build

    out.mkdir(parents=True, exist_ok=True)
    return [(subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-c", "-I", str(csrc), "-o",
                               str(out / f"{Path(src).stem}.o"), str(csrc / src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
            for src in SOURCES]


def finish_build(label: str, procs: list) -> ctypes.CDLL:
    """Link the objects into a library, load it and print its ptxas report."""
    from ctpa_torch.kernels import build

    log = ""
    for proc, _ in procs:
        log += proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{label}: nvcc failed:\n{log}")
    out = procs[0][1]
    so = out / "lib.so"
    subprocess.run([build._nvcc(), *build.ARCH, "-shared", "-o", str(so),
                    *(str(out / f"{Path(src).stem}.o") for src in SOURCES)], check=True)
    lib = ctypes.CDLL(str(so))
    for name in LAUNCHERS:
        fn = getattr(lib, name)
        fn.argtypes = list(build.SIGNATURES[name])
        fn.restype = ctypes.c_int
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            regs = [ln.split(":", 1)[-1].strip() for ln in lines[i + 1:i + 4]
                    if "registers" in ln or "spill" in ln]
            print(f"  {label}: {line.split('entry function')[-1].strip()[:60]} "
                  f"{'; '.join(regs)}")
    return lib


def variant_csrc(tmp: Path, name: str) -> Path:
    from ctpa_torch.kernels import build

    csrc = tmp / name.replace(" ", "_")
    shutil.copytree(build.CSRC_DIR, csrc)
    for file, old, new in VARIANTS[name]:
        text = (csrc / file).read_text()
        if text.count(old) != 1:
            raise AssertionError(f"variant {name!r}: {old!r} is not once in {file}")
        (csrc / file).write_text(text.replace(old, new))
    return csrc


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, help="a checkout of the parent commit")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_resample_patchify: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ctpa_torch.core.config import CTViTConfig
    from ctpa_torch.kernels import build
    from ctpa_torch.ops import resample_patchify as rp
    from ctpa_torch.ops.patchify import _fold_terms, patchify_project_plain

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
    print("builds (registers and spills):")
    procs = {name: start_build(variant_csrc(tmp, name), tmp / f"{name}.out") for name in VARIANTS}
    if args.parent:
        procs["parent"] = start_build(args.parent / "ctpa_torch" / "csrc", tmp / "parent.out")
    libs = {"this": build.library().lib}
    libs.update({label: finish_build(label, p) for label, p in procs.items()})

    dev, bf16 = "cuda", torch.bfloat16
    cfg = CTViTConfig()
    pt, p, dim, pd = cfg.temporal_patch_size, cfg.patch_size, cfg.dim, cfg.patch_dim
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    stream = torch.cuda.current_stream().cuda_stream
    with torch.inference_mode():
        ops = cs.k9_operands(gen, dev, cs.RAW_SHAPE, None, cs.RAW_SPACING)
        g = (1 + 0.1 * torch.randn(pd, generator=gen, device=dev)).to(bf16)
        K = (0.02 * torch.randn(pd, dim, generator=gen, device=dev)).to(bf16)
        taps_i, taps_w = ops.taps
        kg, v2_9 = rp._fold_terms(g, K, bf16)
        masks = [m.to(torch.uint8).contiguous() for m in ops[2:5]]
        D, H, ws = ops.x2.shape
        W = ops.wwp.shape[0]
        out = torch.empty(D // pt, H // p, W // p, dim, dtype=bf16, device=dev)
        x2s = [ops.x2, ops.x2.clone()]                 # 118 MB each, past the 50 MB L2
        vols = [(torch.rand(D, H, W, generator=gen, device=dev) * 2 - 1).to(bf16)
                for _ in range(2)]
        gf, kv, v2_1 = _fold_terms(g, K, bf16)
        lo, hi, shift, scale = ops.window

        def k9(lib, x2):
            rc = lib.resample3_patchify_project_launch(
                x2.data_ptr(), taps_i.data_ptr(), taps_w.data_ptr(),
                *(m.data_ptr() for m in masks), kg.data_ptr(), v2_9.data_ptr(), out.data_ptr(),
                D, H, ws, W, pt, p, p, dim, 1, lo, hi, shift, scale, ops.pad_value, 1e-5, stream)
            build.check_launch(rc, "resample3_patchify_project")

        def k1(lib, vol):
            rc = lib.patchify_project_launch(vol.data_ptr(), gf.data_ptr(), kv.data_ptr(),
                                             v2_1.data_ptr(), out.data_ptr(), D, H, W, pt, p, p,
                                             dim, 1e-5, stream)
            build.check_launch(rc, "patchify_project")

        def timed(fn, inputs):
            calls = iter(range(10 ** 6))
            return cs.idle_ms(lambda: fn(inputs[next(calls) % 2]))

        refs = {"K9": rp.resample3_patchify_project_plain(*ops[:5], g, K, pt, p, p,
                                                          window=ops.window,
                                                          pad_value=ops.pad_value).float(),
                "K1": patchify_project_plain(vols[0], g, K, pt, p, p).float()}
        kernels = {"K9": (k9, x2s), "K1": (k1, vols)}
        order = ["parent", "this", "this", "parent"] if args.parent else ["this"]
        print("bare launchers at the shipped shape (ms a launch, device time after an idle "
              "second; max |out - plain| on the first input):")
        for kname, (fn, inputs) in kernels.items():
            for label in order:
                fn(libs[label], inputs[0])
                err = (out.float() - refs[kname]).abs().max().item()
                ms = timed(lambda x: fn(libs[label], x), inputs)
                print(f"  {kname} {label:7s} {ms:.4f}  (max err {err:.3e})", flush=True)
            for label in VARIANTS:
                if label.startswith("timeline"):
                    continue
                print(f"  {kname} {label:12s} {timed(lambda x: fn(libs[label], x), inputs):.4f}")
        for label in ("timeline",):
            for kname, (fn, inputs) in kernels.items():
                fn(libs[label], inputs[0])
                torch.cuda.synchronize()
                buf = (ctypes.c_longlong * (2 * 80 * 8))()
                getattr(libs[label], f"patch_timeline_{kname}")(buf)
                tl = [[list(buf[(b * 80 + k) * 8:(b * 80 + k + 1) * 8]) for k in range(63)]
                      for b in range(2)]
                for b in range(2):
                    t0 = tl[b][0][0]
                    print(f"  {label}, {kname}, block {b}: cycles since the first empty wait")
                    for k in (0, 1, 2, 3, 10, 11, 12, 30, 31, 62):
                        print(f"    kb {k:2d}: " + " ".join(f"{x - t0:8d}" for x in tl[b][k][:7]))
        x = torch.randn(D // pt * (H // p) * (W // p), pd, generator=gen, device=dev).to(bf16)
        mm = cs.idle_ms(lambda: torch.matmul(x, K))
        print(f"yardstick (never called by the port): dense bf16 torch.matmul of the "
              f"{tuple(x.shape)} patch matrix by K {mm:.4f} ms")
        taps_ms = cs.cuda_ms(lambda: bool(rp.stage3_taps(ops.wwp)[2]))
        fold_ms = cs.cuda_ms(lambda: rp._fold_terms(g, K, bf16))
        print(f"wrapper parts (ms a call): taps read from the matrix with their host sync "
              f"{taps_ms:.4f} (the main path takes preprocess's); folded projection {fold_ms:.4f}")
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
