#!/usr/bin/env python3
"""Time the decode-attention kernel (K8) on one CUDA card, against a parent
tree's build in the same process.

    python3 profile_decode_attention.py [--parent DIR]    # from the root of a checkout

At Meditron-7B's decode shape (h 32, head dim 128, a 608-slot cache: 4
prompts of 512/448/384/320 tokens padded to 512, then 96 decode slots, the
main path's last-step validity, prompts repeated at batch 32): b 4 with a
bf16 and an int8 cache, b 32 with an int8 and a bf16 cache, and a GQA rep-4
bf16 case at b 4 (kvh 8).  Each kernel's bare launcher on precomputed
operands, the layer cycled over all 32 so each launch reads planes that are
not in the 50 MB L2 cache, timed with CUDA events behind a spin kernel
(chip_smoke.device_ms), each timing after an idle second.  With --parent DIR
(a checkout of the parent commit, e.g. unpacked by ``git archive``), the
parent's decode_attention.cu is built by its own nvcc process into a library
of its own and timed beside this tree's in the order parent, this, this,
parent.  Then two variants of this tree's source, each its own build, which
leave parts of the kernel out (the outputs are then wrong; only the time
counts):

  loads only   the consumers wait for each tile and release it, with no dot
               and no softmax (the bulk copies, the masks and the merge run);
  no merge     rank 0 writes its own block's state; no cluster barrier and
               no distributed-shared-memory read;

and this tree's kernel at each split of the cluster (1, 2, 4, 8 blocks a
head; the wrapper's choice is marked).  Prints each time beside the byte
bound and the fraction of it reached, scaled_dot_product_attention on the
float caches as a yardstick (the port never calls it), the ptxas register
and spill report of each build, and the card's name and power limit.  Exits
1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

SOURCE = "decode_attention.cu"
LAYERS, H, HD, M = 32, 32, 128, 608
# (label, b, kvh, int8 cache)
SHAPES = (("b 4 bf16", 4, 32, False), ("b 4 int8", 4, 32, True), ("b 32 int8", 32, 32, True),
          ("b 32 bf16", 32, 32, False), ("b 4 bf16 GQA rep 4", 4, 8, False))
# (file, old, new) edits on a copy of this tree's csrc/
VARIANTS = {
    "loads only": [(SOURCE, "for (int jb = gi; jb < T; jb += kBatch * NG) {",
                    "for (int jb = gi; jb < 0; jb += kBatch * NG) {")],
    "no merge": [(SOURCE, "        if (k < a.ranks) {\n          mk[k] =",
                  "        if (k < 1) {\n          mk[k] ="),
                 (SOURCE, "if (k == a.ranks) break;", "if (k == 1) break;"),
                 (SOURCE, "  if (a.ranks > 1) {\n    hopper::cluster_sync();",
                  "  if (false) {\n    hopper::cluster_sync();"),
                 (SOURCE, "  if (a.ranks > 1) hopper::cluster_sync();", "  if (false) hopper::cluster_sync();")],
}


def start_build(csrc: Path, out: Path) -> tuple:
    """nvcc for the decode-attention source in csrc, into a library of its own."""
    from ctpa_torch.kernels import build

    out.mkdir(parents=True, exist_ok=True)
    so = out / "lib.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(csrc), "-o", str(so),
           str(csrc / SOURCE)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


def ptxas_summary(log: str) -> str:
    """Entry functions, their register range and every instantiation that spills."""
    regs, spills, name = [], [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "Used" in line and "registers" in line and name:
            regs.append(int(re.search(r"Used (\d+) registers", line).group(1)))
        elif "spill" in line and name and not re.search(r"\b0 bytes spill stores, 0 bytes spill loads", line):
            spills.append(f"{name}: {line.strip()}")
    out = f"{len(regs)} entry functions, {min(regs)}-{max(regs)} registers"
    return out + (", spills:\n    " + "\n    ".join(spills) if spills else ", no spill")


def finish_build(label: str, proc_so: tuple, parent: bool) -> tuple:
    from ctpa_torch.kernels import build

    proc, so = proc_so
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"{label}: nvcc failed:\n{log}")
    lib = ctypes.CDLL(str(so))
    fn = lib.decode_attention_launch
    argtypes = list(build.SIGNATURES["decode_attention_launch"])
    fn.argtypes = argtypes[:-2] + argtypes[-1:] if parent else argtypes   # no split argument
    fn.restype = ctypes.c_int
    print(f"  {label}: {ptxas_summary(log)}", flush=True)
    return fn, parent


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
    import torch.nn.functional as F

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, help="a checkout of the parent commit")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_decode_attention: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ctpa_torch.kernels import build
    from ctpa_torch.ops import decode_attention as da

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
    print("builds (ptxas):")
    procs = {name: start_build(variant_csrc(tmp, name), tmp / name.replace(" ", "_"))
             for name in VARIANTS}
    procs["this"] = start_build(build.CSRC_DIR, tmp / "this")
    if args.parent:
        procs["parent"] = start_build(args.parent / "ctpa_torch" / "csrc", tmp / "parent")
    libs = {label: finish_build(label, p, label == "parent") for label, p in procs.items()}

    dev, bf16 = "cuda", torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 5)
    scale = HD ** -0.5
    order = ["parent", "this", "this", "parent"] if args.parent else ["this"]
    for label, b, kvh, quant in SHAPES:
        slot = torch.arange(M, device=dev)
        lens = torch.tensor(cs.PROMPT_LENS, device=dev).repeat(b // 4)
        valid = (slot[None] < lens[:, None]) | (slot[None] >= max(cs.PROMPT_LENS))
        shape = (LAYERS, b, kvh, M, HD)
        q = torch.randn(b, H, HD, generator=gen, device=dev).to(bf16)
        if quant:
            ck, cv = (torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
                      for _ in range(2))
            ks, vs = (0.001 + 0.02 * torch.rand(shape[:4], generator=gen, device=dev)
                      for _ in range(2))
        else:
            ck, cv = (torch.randn(shape, generator=gen, device=dev, dtype=bf16) for _ in range(2))
            ks = vs = None
        out = torch.empty_like(q)
        n_valid = int(valid.sum().item())
        elt = 1 if quant else 2
        nbytes = (2 * n_valid * kvh * HD * elt + (2 * n_valid * kvh * 4 if quant else 0)
                  + 2 * b * H * HD * 2 + b * M)
        b_ms, b_by = cs.bound_ms(nbytes, 4.0 * n_valid * H * HD)
        chosen = da.split_count(b * kvh, M, HD, sms)
        dtype = da._TYPES[(q.dtype, ck.dtype)]

        def launch(fn_parent, layer, splits=chosen):
            fn, parent = fn_parent
            tail = (dtype, stream) if parent else (dtype, splits, stream)
            rc = fn(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), valid.data_ptr(),
                    ks.data_ptr() if quant else None, vs.data_ptr() if quant else None,
                    out.data_ptr(), b, H, kvh, M, HD, layer, scale, *tail)
            build.check_launch(rc, "decode_attention")

        def timed(fn_parent, splits=chosen):
            layers = itertools.cycle(range(LAYERS))
            return cs.idle_ms(lambda: launch(fn_parent, next(layers), splits))

        ref = da.decode_attention_plain(q, ck, cv, valid, 5, ks, vs, scale).float()
        print(f"{label} (b {b}, h {H}, kvh {kvh}, m {M}, hd {HD}; {n_valid} of {b * M} slots "
              f"valid): bound {b_ms * 1e3:.2f} us ({b_by}, {nbytes / 1e6:.1f} MB); split "
              f"{chosen} (ms a launch, device time after an idle second)", flush=True)
        for name in order:
            launch(libs[name], 5)
            err = (out.float() - ref).abs().max().item()
            ms = timed(libs[name])
            print(f"  {name:8s} {ms:.4f}  {b_ms / ms:.2f} of the bound  (max err {err:.3e})",
                  flush=True)
        for name in VARIANTS:
            ms = timed(libs[name])
            print(f"  {name:8s} {ms:.4f}  {b_ms / ms:.2f} of the bound")
        for splits in da.SPLITS:
            ms = timed(libs["this"], splits)
            print(f"  split {splits}{' (chosen)' if splits == chosen else ''}: {ms:.4f}  "
                  f"{b_ms / ms:.2f} of the bound")
        if not quant:
            layers = itertools.cycle(range(LAYERS))
            mask = valid[:, None, None, :]

            def sdpa_call(i):
                return F.scaled_dot_product_attention(q[:, :, None], ck[i], cv[i], attn_mask=mask,
                                                      scale=scale, enable_gqa=kvh != H)

            sdpa = cs.idle_ms(lambda: sdpa_call(next(layers)))
            print(f"  yardstick (never called by the port): scaled_dot_product_attention "
                  f"{sdpa:.4f}")
        del ck, cv, ks, vs
        torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
