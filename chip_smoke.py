#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's zero-shot serving path once on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its seconds:
  1. card    — the device's name and nvidia-smi's name and power limit;
  2. build   — nvcc builds every kernel under ctpa_torch/csrc/, with each
               kernel's registers, shared memory and spills from -Xptxas -v;
  3. kernels — each kernel against its plain PyTorch version at the shapes
               the serving path gives it, then timed with CUDA events beside
               its plain version, a one-call PyTorch yardstick where one
               exists, and the card's bound for the same work;
  4. serving — CTCLIP at the shipped geometry in bf16 with seeded random
               weights: the 36 prompt latents are encoded once, then 4
               inference-path requests and one train-path raw volume are
               served; each request prints its latency, its 18
               probabilities, its kernel launches and the peak memory;
  5. plain   — the same requests through the model's plain paths (no hand
               kernel), with the differences bounded.

The line before the last is nvidia-smi's "name, power.limit"; the one before
that a JSON object with one entry per kernel.  The last line is
{"ok": true, "device": {...}}.  A failed check raises, so the exit code is
not 0.  Nothing of JAX or of the ctpa package is imported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time

# NVIDIA H100 SXM data-sheet peaks (dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SEED = 0
N_REQUESTS = 4
RAW_SHAPE = (160, 512, 512)          # train-path raw volume, as bench.py
RAW_SPACING = (2.0, 0.75, 0.75)
INFER_SHAPE = (512, 512, 250)        # (h, w, d) pre-normalised inference volume

# Tolerances, each with its reason:
# kernel vs plain version in bf16: both sum the same rounded products in
# fp32, in another order, and round the result to bf16 (one ulp = 2^-8).
BF16_ATOL, BF16_RTOL = 2e-2, 2e-2
# in fp32 (K2 only; K1 computes in bf16) the only difference is the order
# of the 576 terms of each sum
FP32_ATOL, FP32_RTOL = 1e-4, 1e-4
# serving, kernel path vs plain path: bf16 rounds at other places (the
# LN-folded patch embed vs the explicit one), so tokens differ by bf16 noise
# before the VQ; the VQ argmax over 8192 random codes turns some of that
# noise into different codes.  Bounded: probabilities, the latent of the
# un-quantized tokens, and (loosely) the quantized latent.
PROB_ATOL = 2e-2
PREVQ_LATENT_MIN_COS = 0.999
VQ_LATENT_MIN_COS = 0.8


@contextlib.contextmanager
def phase(name: str):
    print(f"== phase {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call over `iters` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def compare(name: str, got, ref, atol: float, rtol: float) -> float:
    """Max abs error; raises when |got - ref| > atol + rtol * |ref| anywhere."""
    import torch

    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    excess = (err - (atol + rtol * ref.abs())).max().item()
    max_abs = err.max().item()
    rel = max_abs / max(ref.abs().max().item(), 1e-30)
    print(f"  {name}: max_abs_err {max_abs:.3e}  rel {rel:.3e}  (atol {atol}, rtol {rtol})")
    if not torch.isfinite(got).all() or excess > 0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {max_abs}, tolerance exceeded by {excess})")
    return max_abs


def check_kernels(dev) -> dict:
    """Phase 3: K1 and K2 against their plain versions and timed."""
    import torch
    import torch.nn.functional as F

    from ctpa_torch.core.config import CTViTConfig
    from ctpa_torch.ops.attention_ops import l2norm
    from ctpa_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from ctpa_torch.ops.patchify import patchify_project, patchify_project_plain

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    bf16 = torch.bfloat16
    cfg = CTViTConfig()
    pt, p, dim, pd = cfg.temporal_patch_size, cfg.patch_size, cfg.dim, cfg.patch_dim
    T, H, W = cfg.temporal_size, cfg.image_size, cfg.image_size
    rows = {}

    # K1 at the serving shape: one (240, 480, 480) bf16 volume per launch
    vol = (torch.rand(T, H, W, generator=gen, device=dev) * 2 - 1)
    g = 1 + 0.1 * torch.randn(pd, generator=gen, device=dev)
    K = 0.02 * torch.randn(pd, dim, generator=gen, device=dev)
    v_, g_, K_ = vol.to(bf16), g.to(bf16), K.to(bf16)
    k1_err = compare("patchify_project bf16",
                     patchify_project(v_, g_, K_, pt, p, p, out_dtype=bf16),
                     patchify_project_plain(v_, g_, K_, pt, p, p, out_dtype=bf16),
                     BF16_ATOL, BF16_RTOL)
    ms = cuda_ms(lambda: patchify_project(v_, g_, K_, pt, p, p, out_dtype=bf16))
    plain_ms = cuda_ms(lambda: patchify_project_plain(v_, g_, K_, pt, p, p, out_dtype=bf16))
    t, h, w = T // pt, H // p, W // p
    nbytes = T * H * W * 2 + pd * 4 + pd * dim * 2 + dim * 4 + t * h * w * dim * 2
    b_ms, b_by = bound_ms(nbytes, 2.0 * t * h * w * pd * dim)
    rows["patchify_project"] = dict(
        name="patchify_project", route="cuda", source="ctpa_torch/csrc/patchify.cu",
        replaces="ctpa/ops/pallas/patchify.py:180", max_abs_err=k1_err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print(f"  patchify_project: {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {b_ms * 1e3:.1f} us "
          f"({b_by})  library none")

    # K2 at the spatial fold's shape: (24, 8, 576, 32), CPB bias (8, 576, 576)
    b, heads, n, d = cfg.temporal_tokens, cfg.heads, cfg.spatial_tokens, cfg.dim_head
    scale = 8.0
    q = l2norm(torch.randn(b, heads, n, d, generator=gen, device=dev))
    k = l2norm(torch.randn(b, heads, n, d, generator=gen, device=dev))
    v = torch.randn(b, heads, n, d, generator=gen, device=dev)
    bias = 0.5 * torch.randn(heads, n, n, generator=gen, device=dev)
    cases = [("bias (h,n,m), bound", bias, True), ("bias (1,n,m), bound", bias[:1], True),
             ("bias (b,h,n,m), bound", bias.expand(b, heads, n, n), True),
             ("bias (h,n,m), online softmax", bias, False), ("no bias, online softmax", None, False)]
    for dtype, atol, rtol in ((bf16, BF16_ATOL, BF16_RTOL), (torch.float32, FP32_ATOL, FP32_RTOL)):
        for label, bb, with_bound in cases:
            q_, k_, v_ = q.to(dtype), k.to(dtype), v.to(dtype)
            bb = bb.to(dtype).contiguous() if bb is not None else None
            lb = (scale + bb.max().float()) if with_bound and bb is not None else None
            err = compare(f"flash_attention {dtype} {label}",
                          flash_attention(q_, k_, v_, bias=bb, scale=scale, logit_bound=lb),
                          flash_attention_plain(q_, k_, v_, bb, scale, lb), atol, rtol)
            if dtype == bf16 and label == cases[0][0]:
                k2_err = err
    q_, k_, v_, bb = q.to(bf16), k.to(bf16), v.to(bf16), bias.to(bf16)
    lb = scale + bb.max().float()
    ms = cuda_ms(lambda: flash_attention(q_, k_, v_, bias=bb, scale=scale, logit_bound=lb))
    plain_ms = cuda_ms(lambda: flash_attention_plain(q_, k_, v_, bb, scale, lb))
    # yardstick only, never called by the port
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=bb, scale=scale))
    nbytes = 4 * b * heads * n * d * 2 + heads * n * n * 2 + 4
    b_ms, b_by = bound_ms(nbytes, 4.0 * b * heads * n * n * d)
    rows["flash_attention"] = dict(
        name="flash_attention_fwd", route="cuda", source="ctpa_torch/csrc/flash_attention.cu",
        replaces="ctpa/ops/pallas/flash_attention.py:918", max_abs_err=k2_err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    print(f"  flash_attention: {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {b_ms * 1e3:.1f} us "
          f"({b_by})  library (scaled_dot_product_attention) {lib_ms:.4f} ms")
    return rows


def build_serving(vit_cfg, bert_cfg, clip_cfg, dev, dtype):
    """CTCLIP with seeded random weights, its VQ state and the classifier
    (which encodes the 36 prompts once)."""
    import torch

    from ctpa_torch.core.init import random_init_
    from ctpa_torch.data.tokenizer import SimpleWordTokenizer
    from ctpa_torch.eval.zeroshot import ZeroShotClassifier
    from ctpa_torch.models.ctclip import CTCLIP
    from ctpa_torch.ops.vq import vq_init

    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = CTCLIP(clip_cfg, vit_cfg, bert_cfg, device=dev, dtype=dtype).eval()
    random_init_(model, gen)
    vq = vq_init(gen, vit_cfg.codebook_size, vit_cfg.dim, device=dev)
    tok = SimpleWordTokenizer(bert_cfg.vocab_size, bert_cfg.max_position_embeddings)

    def tokenize(texts):
        out = tok(texts)
        return (torch.as_tensor(out["input_ids"], device=dev).long(),
                torch.as_tensor(out["attention_mask"], device=dev))

    clf = ZeroShotClassifier(model.encode_text, tokenize, model.temperature.float().exp())
    return model, vq, clf


def make_requests(vit_cfg, dev, n_requests: int, infer_shape, raw_shape):
    """(label, video) pairs: inference-path volumes and one train-path raw
    volume, preprocessed on the device; data drawn from a seeded generator."""
    import torch

    from ctpa_torch.core.config import PreprocessConfig
    from ctpa_torch.ops.preprocess import preprocess_volume, preprocess_volume_inference

    grid = (vit_cfg.temporal_size, vit_cfg.image_size, vit_cfg.image_size)
    infer_cfg = dataclasses.replace(PreprocessConfig.inference(), target_shape=grid)
    train_cfg = dataclasses.replace(PreprocessConfig.train(), target_shape=grid)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    reqs = []
    for i in range(n_requests):
        vol = torch.rand(infer_shape, generator=gen, device=dev) * 2 - 1
        reqs.append((f"inference {i}",
                     lambda vol=vol: preprocess_volume_inference(vol, infer_cfg)))
    raw = torch.randint(-24, 3000, raw_shape, generator=gen, device=dev).to(torch.float32)
    reqs.append(("train-path raw", lambda: preprocess_volume(
        raw, 1.0, -1024.0, RAW_SPACING, train_cfg)))
    return reqs


def serve(model, vq, clf, requests, dev, dtype, expect_launches=None):
    """Serve each request (preprocess -> encode -> score); returns per-request
    (latent, probabilities, model input)."""
    import torch

    from ctpa_torch.ops.flash_attention import flash_attention
    from ctpa_torch.ops.patchify import patchify_project

    results = []
    for label, preprocess in requests:
        k1, k2 = patchify_project.launches, flash_attention.launches
        if dev != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        video = preprocess()[None].to(dtype)               # (1, 1, D, H, W)
        latent, _ = model.encode_image(video, vq)
        probs = clf.score(latent)[0]
        if dev != "cpu":
            torch.cuda.synchronize()
        latency = time.perf_counter() - t0
        launches = (patchify_project.launches - k1, flash_attention.launches - k2)
        peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
        if not (torch.isfinite(latent).all() and torch.isfinite(probs).all()):
            raise AssertionError(f"{label}: non-finite output")
        if probs.shape != (len(clf.pathologies),) or latent.shape != (1, model.cfg.dim_latent):
            raise AssertionError(f"{label}: shapes {tuple(probs.shape)} {tuple(latent.shape)}")
        if expect_launches is not None and launches != expect_launches:
            raise AssertionError(f"{label}: launches (patchify, flash) {launches}, "
                                 f"expected {expect_launches}")
        print(f"  request {label}: latency {latency * 1e3:.1f} ms  launches patchify "
              f"{launches[0]} flash {launches[1]}  peak memory {peak / 2**30:.2f} GiB")
        print("    probabilities " + " ".join(f"{x:.4f}" for x in probs.tolist()))
        results.append((latent.float(), probs.float(), video))
    return results


def compare_serving(model, plain, kernel_res, plain_res):
    """Bound the kernel path's outputs against the plain path's; the latent of
    the un-quantized tokens is computed here, outside the timed requests."""
    import torch

    for i, ((lat_k, p_k, video), (lat_p, p_p, _)) in enumerate(zip(kernel_res, plain_res)):
        pre_k = model.encode_image(video, None)[0].float()
        pre_p = plain.encode_image(video, None)[0].float()
        dp = (p_k - p_p).abs().max().item()
        cos_vq = torch.nn.functional.cosine_similarity(lat_k, lat_p).item()
        cos_pre = torch.nn.functional.cosine_similarity(pre_k, pre_p).item()
        print(f"  request {i}: max |prob diff| {dp:.3e} (<= {PROB_ATOL})  latent cos "
              f"{cos_vq:.6f} (>= {VQ_LATENT_MIN_COS})  un-quantized latent cos {cos_pre:.6f} "
              f"(>= {PREVQ_LATENT_MIN_COS})")
        if dp > PROB_ATOL or cos_vq < VQ_LATENT_MIN_COS or cos_pre < PREVQ_LATENT_MIN_COS:
            raise AssertionError(f"request {i}: kernel path and plain path disagree")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    from ctpa_torch.core.config import BertConfig, CTCLIPConfig, CTViTConfig
    from ctpa_torch.kernels import build
    from ctpa_torch.ops.flash_attention import flash_attention
    from ctpa_torch.ops.patchify import patchify_project

    dev = "cuda"
    # fp32 references in full fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with phase("card"):
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
        print(f"  device {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
              f"cuda {torch.version.cuda}")

    with phase("build"):
        lib = build.library()
        print(f"  nvcc: {lib.seconds:.2f} s")
        for line in lib.ptxas_log.splitlines():
            if any(s in line for s in ("entry function", "registers", "spill")):
                print("  " + line.strip())

    with torch.inference_mode():
        with phase("kernels"):
            rows = check_kernels(dev)

        vit_cfg = dataclasses.replace(CTViTConfig(), pallas_patchify=True, flash_axial=True)
        bert_cfg, clip_cfg, dtype = BertConfig(), CTCLIPConfig(), torch.bfloat16
        with phase("serving"):
            model, vq, clf = build_serving(vit_cfg, bert_cfg, clip_cfg, dev, dtype)
            requests = make_requests(vit_cfg, dev, N_REQUESTS, INFER_SHAPE, RAW_SHAPE)
            torch.cuda.synchronize()
            patchify_project.launches = 0
            flash_attention.launches = 0
            kernel_res = serve(model, vq, clf, requests, dev, dtype,
                               expect_launches=(1, vit_cfg.spatial_depth))
            rows["patchify_project"]["launches"] = patchify_project.launches
            rows["flash_attention"]["launches"] = flash_attention.launches
            print(f"  main path: patchify_project launched {patchify_project.launches} times, "
                  f"flash_attention {flash_attention.launches} times for "
                  f"{len(requests)} volumes")
            for key in ("patchify_project", "flash_attention"):
                if rows[key]["launches"] == 0:
                    raise AssertionError(f"{key} never launched on the main path")

        with phase("plain"):
            plain_cfg = dataclasses.replace(vit_cfg, pallas_patchify=False, flash_axial=False)
            from ctpa_torch.models.ctclip import CTCLIP

            plain = CTCLIP(clip_cfg, plain_cfg, bert_cfg, device=dev, dtype=dtype).eval()
            plain.load_state_dict(model.state_dict())
            plain_res = serve(plain, vq, clf, requests, dev, dtype, expect_launches=(0, 0))
            compare_serving(model, plain, kernel_res, plain_res)

    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{key: rows[k][key] for key in order} for k in ("patchify_project", "flash_attention")]
    for row in kernels:
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms"):
            if not math.isfinite(row[key]):
                raise AssertionError(f"{row['name']}: {key} is not finite")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
