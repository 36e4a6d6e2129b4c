#!/usr/bin/env python3
"""Break the quantized prefill kernels (above 32 rows; ``csrc/
prefill_wgmma.cuh``) down on one CUDA card: K4's and K5's projection kernel
and K6's and K7's two FFN kernels (gate/up, then down).

    python3 profile_quant_prefill.py [--parent DIR]   # from the root of a checkout

For each FFN form (K6 w8 and w8a8, K7 w4 and w4a8) at Meditron-7B's FFN
(hidden 4096, inter 11008) and 2,048 rows: the gate/up and down kernels'
device times from a ``torch.profiler`` trace of ten calls, each beside its
own bound at 989 TFLOP/s bf16 or 1,979 TOPS int8 and 3.35 TB/s; the whole
call's device time (CUDA events behind a spin kernel, as
``chip_smoke.device_ms``); and, as a yardstick the port never calls, the
same three products as dense bf16 ``torch.matmul`` on the dequantized
weights.  For each projection form (K4 w8 and w8a8, K5 w4 and w4a8) at
Meditron-7B's fused qkv_proj (4096 -> 12288) and o_proj (4096 -> 4096) and
2,048 rows: the projection kernel's device time from a trace beside its
bound, the call's device time, dense bf16 ``torch.matmul`` beside it.
Then each prefill kernel's registers and spills from the build's ptxas
report, and the projection kernel's token tile: this tree's (128 tokens a
block, 64 for w4a8) against a build of the sources with half of it (64,
and 32 for w4a8), each the bare launcher at qkv_proj and 2,048 rows, in
turns.

With ``--parent DIR`` (an unpacked checkout of another commit, e.g. the
parent's by ``git archive``), the same measurements of both trees in one
run, in the order parent, this tree, this tree, parent, each tree in a
process of its own that builds its own kernels: every form's FFN call and
projection call (qkv_proj and o_proj) at 33, 128 and 2,048 rows, each
timed after the card idled for a second (the work just before a timing
moves it by up to a few percent: ``after_load``, run before it), and a
quantized prefill of the LLM trunk (32 layers at Meditron-7B's width,
random weights from a seed, 4 x 512 tokens, the fused FFN), the median of
three; whether each FFN form's output at 2,048 rows has the same bits
in both trees; and whether K6's and K7's prefill kernels compile to the
same machine code in both (``cuobjdump -sass`` of each tree's
``int8_ffn.cu`` and ``int4_ffn.cu``, names and addresses stripped).  And
both trees' K6 and K7 prefill kernels in one process (``same_process``):
each tree's two FFN sources alone, and each tree's whole library, built
alike and called through their bare launchers on the same buffers,
parent, this tree, this tree, parent; then this tree's on copies of the
same buffers at other device addresses.

Prints the card's name and power limit first.  Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HIDDEN, INTER, ROWS = 4096, 11008, 2048
PEAK_BF16, PEAK_INT8, HBM = 989e12, 1979e12, 3.35e12
FORMS = (("K6 w8", 8, False), ("K6 w8a8", 8, True), ("K7 w4", 4, False), ("K7 w4a8", 4, True))
PROJ_FORMS = (("K4 w8", 8, False), ("K4 w8a8", 8, True), ("K5 w4", 4, False),
              ("K5 w4a8", 4, True))
PROJ_SHAPES = (("qkv_proj", 4096, 12288), ("o_proj", 4096, 4096))
# the projection kernel's token tile halved: (file, old, new) edits of a
# copy of csrc/
HALF_TILE = (("prefill_wgmma.cuh", "constexpr int kProjBN = 128;", "constexpr int kProjBN = 64;"),
             ("prefill_wgmma.cuh", "constexpr int kProjBNA8 = 64;",
              "constexpr int kProjBNA8 = 32;"))

# The measurement both trees run: one process per tree, rounds on request
# (a line on stdin), one JSON line of results a round.  It uses only what
# both trees have: ops.quant's wrappers and the LLM's modules.
WORKER = r'''
import hashlib, json, statistics, sys, time
import torch
from ctpa_torch.core.config import LLMConfig
from ctpa_torch.models.layers import set_compute_dtype
from ctpa_torch.models.llm import LlamaForCausalLM
from ctpa_torch.ops import quant

torch.backends.cuda.matmul.allow_tf32 = False
FORMS, PROJ_FORMS, PROJ_SHAPES = json.loads(sys.argv[1])
dev = "cuda"

def device_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    time.sleep(1.0)   # the card leaves the previous call's power state first
    torch.cuda._sleep(50_000_000)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters

def weights(bits, gen):
    q = quant.quantize_int4 if bits == 4 else quant.quantize_int8
    ws = []
    for a, b in ((4096, 11008), (4096, 11008), (11008, 4096)):
        ws += list(q(0.02 * torch.randn(a, b, generator=gen, device=dev)))
    return ws

def llm(bits, a8, base=None):
    cfg = LLMConfig(weight_quant=f"int{bits}", quant_ffn_kernel=True, quant_act=a8)
    if base is not None:
        model = LlamaForCausalLM(cfg, device="meta", dtype=torch.bfloat16)
        model.load_state_dict(base.state_dict(), assign=True)
        return set_compute_dtype(model, torch.bfloat16).eval()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(bits)
    with torch.no_grad():
        for name, t in model.named_parameters():
            t.copy_(0.02 * torch.randn(t.shape, generator=gen, device=dev))
        for name, t in model.named_buffers():
            if name.endswith("kernel_q"):
                rows = t.shape[0] * (2 if bits == 4 else 1)
                w = 0.02 * torch.randn(rows, t.shape[1], generator=gen, device=dev)
                q, s = quant.quantize_int4(w) if bits == 4 else quant.quantize_int8(w)
                t.copy_(q)
                model.get_submodule(name.rsplit(".", 1)[0]).get_buffer(
                    "scale_g" if bits == 4 else "scale").copy_(s)
    return set_compute_dtype(model, torch.bfloat16).eval()

gen = torch.Generator(device=dev).manual_seed(0)
ffn = {bits: weights(bits, gen) for bits in (4, 8)}
proj = {}
for bits in (4, 8):
    q = quant.quantize_int4 if bits == 4 else quant.quantize_int8
    for label, d_in, d_out in PROJ_SHAPES:
        proj[bits, label] = q(0.02 * torch.randn(d_in, d_out, generator=gen, device=dev))
xs = {m: torch.randn(m, 4096, generator=gen, device=dev).to(torch.bfloat16) for m in (33, 128, 2048)}
models = {}
for bits in (4, 8):
    models[bits, False] = llm(bits, False)
    models[bits, True] = llm(bits, True, models[bits, False])
ids = torch.randint(0, 32000, (4, 512), generator=gen, device=dev)
mask = torch.ones(4, 512, dtype=torch.bool, device=dev)
print(json.dumps({"ready": torch.cuda.get_device_name(0)}), flush=True)
for _ in sys.stdin:
    out = {}
    with torch.inference_mode():
        for label, bits, a8 in FORMS:
            f = quant.int4_ffn if bits == 4 else quant.int8_ffn
            row = {f"ffn m {m}": device_ms(lambda: f(x, *ffn[bits], act_quant=a8), 10 if m > 128 else 50)
                   for m, x in xs.items()}
            got = f(xs[2048], *ffn[bits], act_quant=a8).view(torch.int16).cpu().numpy().tobytes()
            row["digest"] = hashlib.sha256(got).hexdigest()
            model = models[bits, a8]
            model.model(ids, mask)
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                model.model(ids, mask)
                e.record()
                torch.cuda.synchronize()
                times.append(s.elapsed_time(e))
            row["prefill 4 x 512"] = statistics.median(times)
            out[label] = row
        for label, bits, a8 in PROJ_FORMS:
            f = quant.int4_matmul if bits == 4 else quant.int8_matmul
            out[label] = {f"{shape} m {m}": device_ms(lambda: f(x, *proj[bits, shape], act_quant=a8),
                                                      10 if m > 128 else 50)
                          for shape, _, _ in PROJ_SHAPES for m, x in xs.items()}
    print(json.dumps(out), flush=True)
'''


def bound_ms(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM * 1e3, ops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def breakdown() -> None:
    """This tree's kernels at 2,048 rows, traced kernel by kernel, beside their
    bounds and the dense bf16 yardstick."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ctpa_torch.kernels import build
    from ctpa_torch.ops import quant

    lib = build.library()
    print(f"build {lib.seconds:.1f} s")
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(ROWS, HIDDEN, generator=gen, device=dev).to(torch.bfloat16)
    m, d, i = ROWS, HIDDEN, INTER
    for label, bits, a8 in FORMS:
        q = quant.quantize_int4 if bits == 4 else quant.quantize_int8
        ws = []
        for a, b in ((d, i), (d, i), (i, d)):
            ws += list(q(0.02 * torch.randn(a, b, generator=gen, device=dev)))
        fn = quant.int4_ffn if bits == 4 else quant.int8_ffn
        call = lambda: fn(x, *ws, act_quant=a8)  # noqa: E731
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        kern = {"gate/up": 0.0, "down": 0.0}
        for ev in prof.key_averages():
            for part, key in (("gate/up", "gateup_kernel"), ("down", "down_kernel")):
                if key in ev.key and "prefill_wgmma" in ev.key:
                    kern[part] += ev.device_time_total / 1e3 / 10
        wbytes = 2 * d * i * (0.5 if bits == 4 else 1) + (2 * (d // 128) * i * 4 if bits == 4
                                                            else 2 * i * 4)
        hbytes = m * i * (1 if a8 else 2)
        peak = PEAK_INT8 if a8 else PEAK_BF16
        gu_b = bound_ms(m * d * (1 if a8 else 2) + wbytes + hbytes, 4.0 * m * d * i, peak)
        dn_b = bound_ms(hbytes + i * d * (0.5 if bits == 4 else 1) + m * d * 2, 2.0 * m * i * d,
                        peak)
        whole = cuda_event_ms(call, 10)
        deq = [quant.dequantize_int4(w, s) if bits == 4 else quant.dequantize_int8(w, s)
               for w, s in zip(ws[0::2], ws[1::2])]
        h = torch.randn(m, i, generator=gen, device=dev).to(torch.bfloat16)
        dense = cuda_event_ms(lambda: (x @ deq[0], x @ deq[1], h @ deq[2]), 10)
        print(f"{label} m {m}: call {whole:.4f} ms (device); gate/up {kern['gate/up']:.4f} ms, "
              f"bound {gu_b[0]:.4f} ({gu_b[1]}), {gu_b[0] / max(kern['gate/up'], 1e-9):.2f} of "
              f"it; down {kern['down']:.4f} ms, bound {dn_b[0]:.4f} ({dn_b[1]}), "
              f"{dn_b[0] / max(kern['down'], 1e-9):.2f} of it; dense bf16 torch.matmul of the "
              f"three products {dense:.4f} ms", flush=True)
        del ws, deq
    for label, bits, a8 in PROJ_FORMS:
        q = quant.quantize_int4 if bits == 4 else quant.quantize_int8
        fn = quant.int4_matmul if bits == 4 else quant.int8_matmul
        peak = PEAK_INT8 if a8 else PEAK_BF16
        for shape, d_in, d_out in PROJ_SHAPES:
            w, s = q(0.02 * torch.randn(d_in, d_out, generator=gen, device=dev))
            call = lambda: fn(x, w, s, act_quant=a8)  # noqa: E731
            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            kern = sum(ev.device_time_total for ev in prof.key_averages()
                       if "proj_kernel" in ev.key) / 1e3 / 10
            wbytes = d_in * d_out * (0.5 if bits == 4 else 1) + (
                (d_in // 128) * d_out * 4 if bits == 4 else d_out * 4)
            b = bound_ms(m * d_in * 2 + wbytes + m * d_out * 2, 2.0 * m * d_in * d_out, peak)
            deq = (quant.dequantize_int4 if bits == 4 else quant.dequantize_int8)(w, s)
            print(f"{label} {shape} m {m}: call {cuda_event_ms(call, 10):.4f} ms (device); "
                  f"kernel {kern:.4f} ms, bound {b[0]:.4f} ({b[1]}), {b[0] / max(kern, 1e-9):.2f} "
                  f"of it; dense bf16 torch.matmul {cuda_event_ms(lambda: x @ deq, 10):.4f} ms",
                  flush=True)
            del w, s, deq
    # registers and spills of the prefill kernels
    log = lib.ptxas_log.splitlines()
    for n, line in enumerate(log):
        found = re.search(r"Compiling entry function '(\S*prefill_wgmma\S*(proj|gateup|down)"
                          r"_kernel\S*)'", line)
        if not found:
            continue
        form = re.search(r"FormILb(\d)ELb(\d)ELi(\d+)ELi(\d+)E", found.group(1))
        what = (f"{found.group(2)} int{4 if form.group(1) == '1' else 8}"
                f"{' a8' if form.group(2) == '1' else ''} G {form.group(3)} "
                f"{form.group(4)} tokens")
        info = " ".join(x.split("ptxas info    :")[-1].strip() for x in log[n + 1:n + 4]
                        if "bytes stack frame" in x or "Used" in x)
        print(f"  ptxas {what}: {info}")


def half_tile_library(tmp: Path):
    """int8_matmul.cu and int4_matmul.cu built with HALF_TILE's edits, as a
    library of their own."""
    from ctpa_torch.kernels import build

    src = tmp / "half"
    shutil.copytree(build.CSRC_DIR, src)
    for file, old, new in HALF_TILE:
        text = (src / file).read_text()
        if text.count(old) != 1:
            raise AssertionError(f"{old!r} is not once in {file}")
        (src / file).write_text(text.replace(old, new))
    so = tmp / "half.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(src), "-o", str(so),
                    str(src / "int8_matmul.cu"), str(src / "int4_matmul.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn in ("int8_matmul_prefill_launch", "int4_matmul_prefill_launch"):
        getattr(lib, fn).argtypes = list(build.SIGNATURES[fn])
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def token_tiles() -> None:
    """The projection kernel's bare launcher at qkv_proj and 2,048 rows: this
    tree's token tile against HALF_TILE's, in the order this tree, half,
    half, this tree."""
    import torch

    from ctpa_torch.kernels import build
    from ctpa_torch.ops import quant

    with tempfile.TemporaryDirectory() as tmp:
        libs = {"this tree": build.library().lib, "half tile": half_tile_library(Path(tmp))}
        gen = torch.Generator(device="cuda").manual_seed(3)
        stream = torch.cuda.current_stream().cuda_stream
        _, d_in, d_out = PROJ_SHAPES[0]
        x = torch.randn(ROWS, d_in, generator=gen, device="cuda").to(torch.bfloat16)
        x8, sx = quant._quantize_act_kernel(x)
        out = torch.empty(ROWS, d_out, dtype=torch.bfloat16, device="cuda")
        chunks = d_in // quant.PREFILL_KC
        for label, bits, a8 in PROJ_FORMS:
            q = quant.quantize_int4 if bits == 4 else quant.quantize_int8
            w, s = q(0.02 * torch.randn(d_in, d_out, generator=gen, device="cuda"))
            ref = (quant.int4_matmul_plain if bits == 4 else quant.int8_matmul_plain)(
                x, w, s, act_quant=a8)
            times = []
            for tag in ("this tree", "half tile", "half tile", "this tree"):
                lib = libs[tag]
                args = (x8.data_ptr() if a8 else x.data_ptr(), sx.data_ptr() if a8 else None,
                        w.data_ptr(), s.data_ptr(), out.data_ptr(), ROWS, d_in, d_out)
                if bits == 4:
                    call = lambda: lib.int4_matmul_prefill_launch(  # noqa: E731
                        *args, quant.GROUP, chunks, 1, int(a8), stream)
                else:
                    call = lambda: lib.int8_matmul_prefill_launch(  # noqa: E731
                        *args, chunks, 1, int(a8), stream)
                if call():
                    raise RuntimeError(f"{label} {tag}: the launch failed")
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                times.append(f"{tag} {cuda_event_ms(call, 20):.4f} (max |err| {err:.2e})")
            print(f"{label} qkv_proj m {ROWS} token tile: " + ", ".join(times) + " ms",
                  flush=True)


def cuda_event_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def ffn_sass(root: Path, src: str, tmp: Path) -> dict:
    """{(kernel, int4, a8, G): its SASS instructions} of the FFN prefill
    kernels in ``root``'s ``csrc/<src>.cu``, addresses stripped."""
    from ctpa_torch.kernels import build

    cubin = tmp / f"{abs(hash(str(root)))}_{src}.cubin"
    subprocess.run([build._nvcc(), *build.ARCH, "-std=c++17", "-O3", "-cubin", "-o", str(cubin),
                    str(root / "ctpa_torch" / "csrc" / f"{src}.cu")], check=True,
                   capture_output=True)
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(cubin)], capture_output=True, text=True,
                          check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        found = re.match(r"\s*Function : (\S+)", line)
        if found:
            k = re.search(r"(gateup_kernel|down_kernel).*?4FormILb(\d)ELb(\d)ELi(\d+)E",
                          found.group(1))
            cur = k.groups() if k else None
            if cur:
                funcs[cur] = []
        elif cur and "/*" in line:
            ins = re.sub(r"/\*[0-9a-f]{4}\*/", "", line.split(";")[0]).strip()
            if ins:
                funcs[cur].append(ins)
    return funcs


def same_ffn_code(parent: Path) -> None:
    """K6's and K7's prefill kernels in the parent's tree and this one:
    the same SASS or not, kernel by kernel."""
    here = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        for src in ("int8_ffn", "int4_ffn"):
            old, new = ffn_sass(parent.resolve(), src, Path(tmp)), ffn_sass(here, src, Path(tmp))
            for key in sorted(old):
                kind, int4, a8, g = key
                what = f"{src} {kind} {'a8' if a8 == '1' else 'w'} G {g}"
                if key not in new:
                    print(f"{what}: not in this tree")
                    continue
                print(f"{what}: {len(old[key])} / {len(new[key])} instructions, "
                      f"{'the same SASS' if old[key] == new[key] else 'DIFFERENT SASS'}")


def tree_libraries(trees: dict, tmp: Path) -> dict:
    """{tag: library} for each tag's (tree, sources): those sources of the
    tree's ``ctpa_torch/csrc/`` (None: every ``*.cu`` there, the library
    ``kernels/build.py`` builds), each built alike (one nvcc per source,
    all started together, then one link a library) and loaded side by
    side in this process, with the FFN prefill launchers bound."""
    from ctpa_torch.kernels import build

    objs, slug = {}, {tag: re.sub(r"\W", "_", tag) for tag in trees}
    for tag, (root, names) in trees.items():
        csrc = root / "ctpa_torch" / "csrc"
        srcs = sorted(csrc.glob("*.cu")) if names is None else [csrc / f"{n}.cu" for n in names]
        for src in srcs:
            objs[tag, src] = tmp / f"{slug[tag]}_{src.stem}.o"
    build._run([[build._nvcc(), *build.NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for (_, src), obj in objs.items()])
    libs = {}
    for tag in trees:
        so = tmp / f"{slug[tag]}.so"
        build._run([[build._nvcc(), *build.ARCH, "-shared", "-o", str(so),
                     *(str(obj) for (t, _), obj in objs.items() if t == tag)]])
        lib = ctypes.CDLL(str(so))
        for fn in ("int8_ffn_prefill_launch", "int4_ffn_prefill_launch"):
            getattr(lib, fn).argtypes = list(build.SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[tag] = lib
    return libs


def ffn_buffers(bits: int, a8: bool, m: int, gen) -> dict:
    """Fresh inputs, weights and outputs of one FFN prefill call at
    Meditron-7B's FFN on m rows: the buffers ``ops/quant.py`` hands the
    bare launcher, x already quantized for a8."""
    import torch

    from ctpa_torch.ops import quant

    q = quant.quantize_int4 if bits == 4 else quant.quantize_int8
    ws = []
    for a, b in ((HIDDEN, INTER), (HIDDEN, INTER), (INTER, HIDDEN)):
        ws += list(q(0.02 * torch.randn(a, b, generator=gen, device="cuda")))
    x = torch.randn(m, HIDDEN, generator=gen, device="cuda").to(torch.bfloat16)
    sx = None
    if a8:
        x, sx = quant.quantize_act_int8(x)
        sx = sx.reshape(-1).contiguous()
    bj = quant.ffn_block_j(INTER, 128) if bits == 4 else quant.INT8_BLOCK_J
    n_j = -(-INTER // bj)
    return dict(x=x, sx=sx, ws=ws, bj=bj,
                out=torch.empty(m, HIDDEN, dtype=torch.bfloat16, device="cuda"),
                h=torch.empty(m, n_j * bj, dtype=torch.int8 if a8 else torch.bfloat16,
                              device="cuda"),
                sh=torch.empty(m, n_j, device="cuda") if a8 else None)


def ffn_launch(lib, bits: int, a8: bool, bufs: dict):
    """The bare prefill launcher of K6 or K7 on ``bufs``, as a callable."""
    import torch

    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    m = bufs["x"].shape[0]
    args = (ptr(bufs["x"]), ptr(bufs["sx"]), *(t.data_ptr() for t in bufs["ws"]),
            bufs["out"].data_ptr(), bufs["h"].data_ptr(), ptr(bufs["sh"]), m, HIDDEN, INTER)
    stream = torch.cuda.current_stream().cuda_stream
    if bits == 4:
        return lambda: lib.int4_ffn_prefill_launch(*args, 128, 128, bufs["bj"], int(a8), stream)
    return lambda: lib.int8_ffn_prefill_launch(*args, int(a8), stream)


def same_process(parent: Path, placements: int = 4) -> None:
    """K6's and K7's prefill kernels of both trees in one process, called
    through their bare launchers on the same buffers at 33, 128 and 2,048
    rows, in the order parent, this tree, this tree, parent, with the
    output bits of each compared: from libraries of each tree's
    ``int8_ffn.cu`` and ``int4_ffn.cu`` alone, and from each tree's whole
    library (every kernel, as the port loads it).  Then this tree's
    FFN-only library at 2,048 rows on ``placements`` fresh copies of the
    same buffers, each allocated after a spacer of its own size (other
    device addresses), timed in the order 0 .. n-1, n-1 .. 0.  The
    launchers' calls are the kernels and their host code (tensor maps,
    launch attributes) with nothing of the process around them."""
    import torch

    here, ffn = Path(__file__).resolve().parent, ("int8_ffn", "int4_ffn")
    pairs = (("parent", "this tree", "FFN-only libraries"),
             ("parent's", "this tree's", "whole libraries"))
    with tempfile.TemporaryDirectory() as tmp:
        libs = tree_libraries({"parent": (parent.resolve(), ffn), "this tree": (here, ffn),
                               "parent's": (parent.resolve(), None),
                               "this tree's": (here, None)}, Path(tmp))
        gen = torch.Generator(device="cuda").manual_seed(5)
        for label, bits, a8 in FORMS:
            for m in (33, 128, ROWS):
                bufs = ffn_buffers(bits, a8, m, gen)
                for old, new, what in pairs:
                    times, bits_seen = [], set()
                    for tag in (old, new, new, old):
                        call = ffn_launch(libs[tag], bits, a8, bufs)
                        if call():
                            raise RuntimeError(f"{label} {tag}: the launch failed")
                        torch.cuda.synchronize()
                        bits_seen.add(bufs["out"].view(torch.int16).cpu().numpy().tobytes())
                        times.append(f"{tag} {cuda_event_ms(call, 10 if m > 128 else 50):.4f}")
                    print(f"{label} ffn m {m}, one process, the same buffers, {what}: "
                          + ", ".join(times) + " ms; output bits "
                          + ("the same" if len(bits_seen) == 1 else "DIFFER"), flush=True)
                del bufs
            copies, spacers = [], []
            for i in range(placements):
                spacers.append(torch.empty((i + 1) * 37 << 20, dtype=torch.uint8, device="cuda"))
                copies.append(ffn_buffers(bits, a8, ROWS, torch.Generator(
                    device="cuda").manual_seed(5)))
            times = {i: [] for i in range(placements)}
            order = list(range(placements))
            for i in order + order[::-1]:
                call = ffn_launch(libs["this tree"], bits, a8, copies[i])
                times[i].append(cuda_event_ms(call, 10))
            flat = [t for ts in times.values() for t in ts]
            print(f"{label} ffn m {ROWS}, this tree, {placements} placements of the same "
                  f"buffers: " + ", ".join(f"{i}: {ts[0]:.4f} / {ts[1]:.4f}"
                                           for i, ts in times.items())
                  + f" ms; spread {(max(flat) - min(flat)) / min(flat):.2%}", flush=True)
            del copies, spacers
            torch.cuda.empty_cache()


def after_load(seconds: float = 0.5) -> None:
    """Whether the work just before a timing moves it: each FFN form's call
    (this tree's wrapper, 33 and 2,048 rows) timed after the card idled
    for a second, and right after ``seconds`` of dense bf16 matmuls (8,192
    square, the card at its power limit), in the order idle, load, load,
    idle."""
    import time

    import torch

    from ctpa_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(7)
    a = torch.randn(8192, 8192, generator=gen, device="cuda").to(torch.bfloat16)
    one = cuda_event_ms(lambda: a @ a, 5)
    for label, bits, a8 in FORMS:
        fn = quant.int4_ffn if bits == 4 else quant.int8_ffn
        for m in (33, ROWS):
            bufs = ffn_buffers(bits, False, m, gen)
            x = torch.randn(m, HIDDEN, generator=gen, device="cuda").to(torch.bfloat16)
            call = lambda: fn(x, *bufs["ws"], act_quant=a8)  # noqa: E731
            times = []
            for before in ("idle", "load", "load", "idle"):
                torch.cuda.synchronize()
                if before == "idle":
                    time.sleep(1.0)
                else:
                    for _ in range(round(seconds * 1e3 / one)):
                        a @ a
                times.append(f"after {before} {cuda_event_ms(call, 10 if m > 128 else 50):.4f}")
            print(f"{label} ffn m {m}: " + ", ".join(times) + " ms", flush=True)
            del bufs


def compare(parent: Path) -> None:
    """Both trees' FFN and projection calls and quantized prefills, parent,
    this tree, this tree, parent."""
    forms = json.dumps((FORMS, PROJ_FORMS, PROJ_SHAPES))
    here = Path(__file__).resolve().parent
    procs = {}
    for tag, root in (("parent", parent.resolve()), ("this tree", here)):
        procs[tag] = subprocess.Popen([sys.executable, "-c", WORKER, forms], cwd=root,
                                      env={**__import__("os").environ, "PYTHONPATH": str(root)},
                                      stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        for tag, proc in procs.items():
            ready = proc.stdout.readline()
            if not ready:
                raise RuntimeError(f"the {tag} worker ended before it was ready")
        results = []
        for tag in ("parent", "this tree", "this tree", "parent"):
            procs[tag].stdin.write("run\n")
            procs[tag].stdin.flush()
            line = procs[tag].stdout.readline()
            if not line:
                raise RuntimeError(f"the {tag} worker ended")
            results.append((tag, json.loads(line)))
        for label, _, _ in FORMS + PROJ_FORMS:
            for key in results[0][1][label]:
                if key == "digest":   # the FFN's bits at 2,048 rows, the same in both trees?
                    same = len({r[label][key] for _, r in results}) == 1
                    print(f"{label} ffn m 2048 output bits: "
                          f"{'the same in both trees' if same else 'DIFFER between the trees'}")
                    continue
                print(f"{label} {key}: " + ", ".join(f"{tag} {r[label][key]:.4f}"
                                                   for tag, r in results) + " ms")
    finally:
        for proc in procs.values():
            proc.stdin.close()
            proc.wait(timeout=120)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="an unpacked checkout to compare with")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_quant_prefill.py needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    breakdown()
    token_tiles()
    if args.parent is not None:
        same_ffn_code(args.parent)
        same_process(args.parent)
        after_load()
        compare(args.parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
