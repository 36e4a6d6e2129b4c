#!/usr/bin/env python3
"""Break K6's and K7's prefill kernels (the fused quantized SwiGLU FFN above
32 rows: gate/up, then down; ``csrc/ffn_wgmma.cuh``) down on one CUDA card.

    python3 profile_ffn_prefill.py [--parent DIR]     # from the root of a checkout

For each form (K6 w8 and w8a8, K7 w4 and w4a8) at Meditron-7B's FFN (hidden
4096, inter 11008) and 2,048 rows: the gate/up and down kernels' device
times from a ``torch.profiler`` trace of ten calls, each beside its own
bound at 989 TFLOP/s bf16 or 1,979 TOPS int8 and 3.35 TB/s; the whole
call's device time (CUDA events behind a spin kernel, as
``chip_smoke.device_ms``); and, as a yardstick the port never calls, the
same three products as dense bf16 ``torch.matmul`` on the dequantized
weights.  Then each prefill kernel's registers and spills from the build's
ptxas report.

With ``--parent DIR`` (an unpacked checkout of another commit, e.g. the
parent's by ``git archive``), the same measurements of both trees in one
run, in the order parent, this tree, this tree, parent, each tree in a
process of its own that builds its own kernels: every form's FFN call at
33, 128 and 2,048 rows, and a quantized prefill of the LLM trunk (32
layers at Meditron-7B's width, random weights from a seed, 4 x 512 tokens,
the fused FFN), the median of three.

Prints the card's name and power limit first.  Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

HIDDEN, INTER, ROWS = 4096, 11008, 2048
PEAK_BF16, PEAK_INT8, HBM = 989e12, 1979e12, 3.35e12
FORMS = (("K6 w8", 8, False), ("K6 w8a8", 8, True), ("K7 w4", 4, False), ("K7 w4a8", 4, True))

# The measurement both trees run: one process per tree, rounds on request
# (a line on stdin), one JSON line of results a round.  It uses only what
# both trees have: ops.quant's wrappers and the LLM's modules.
WORKER = r'''
import json, statistics, sys
import torch
from ctpa_torch.core.config import LLMConfig
from ctpa_torch.models.layers import set_compute_dtype
from ctpa_torch.models.llm import LlamaForCausalLM
from ctpa_torch.ops import quant

torch.backends.cuda.matmul.allow_tf32 = False
FORMS = json.loads(sys.argv[1])
dev = "cuda"

def device_ms(fn, iters):
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
                if key in ev.key and "ffn_wgmma" in ev.key:
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
    # registers and spills of the prefill kernels
    log = lib.ptxas_log.splitlines()
    for n, line in enumerate(log):
        found = re.search(r"Compiling entry function '(\S*ffn_wgmma\S*(gateup|down)_kernel\S*)'",
                          line)
        if not found:
            continue
        form = re.search(r"FormILb(\d)ELb(\d)ELi(\d+)E", found.group(1))
        what = (f"{found.group(2)} int{4 if form.group(1) == '1' else 8}"
                f"{' a8' if form.group(2) == '1' else ''} G {form.group(3)}")
        info = " ".join(x.split("ptxas info    :")[-1].strip() for x in log[n + 1:n + 4]
                        if "bytes stack frame" in x or "Used" in x)
        print(f"  ptxas {what}: {info}")


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


def compare(parent: Path) -> None:
    """Both trees' FFN calls and quantized prefills, parent, this tree, this
    tree, parent."""
    forms = json.dumps(FORMS)
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
        for label, _, _ in FORMS:
            for key in results[0][1][label]:
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
        print("profile_ffn_prefill.py needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    breakdown()
    if args.parent is not None:
        compare(args.parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
