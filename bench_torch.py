#!/usr/bin/env python3
"""Benchmark: the PyTorch/CUDA port's preprocess+encode volumes/sec on one
CUDA card, the twin of ``bench.py``'s headline program.

    python3 bench_torch.py [--front-end patchify|resample_patchify]

Per volume: a raw CT volume (160, 512, 512) float32 already on the card
(slope 1, intercept -1024, spacing (2.0, 0.75, 0.75)) -> HU rescale,
trilinear resample, window and crop/pad to (240, 480, 480)
(``PreprocessConfig.train()``) -> CTViT at the shipped geometry in bf16
(patch embed, 4 spatial layers through the flash kernel, 4 temporal layers)
-> VQ-8192 -> temporal mean-pool + flatten -> 294,912 -> 512 latent ->
l2norm.  The CLIP pair adds a 512-token report through the CXR-BERT
geometry text tower and the similarity.

Front ends (``--front-end``):
  patchify           bench.py's configuration: the whole resample in torch
                     (the width contraction, window and mask included), the
                     volume cast to bf16, then the fused patchify kernel (K1);
  resample_patchify  the depth and height contractions in torch, then the
                     fused resample-patchify kernel (K9), which resamples the
                     width, windows and masks inside the patch embed.

Parameters are seeded random values, as ``bench.py``'s ``materialize``
makes them: every parameter normal(0, 0.02), the latent projection
normal(0, 0.002).  A sample is one volume, timed on the host clock between
two ``torch.cuda.synchronize()``; the raw is perturbed before each sample,
outside the timed region.  ``compile_first_s`` is the first call's wall
time, the kernels' nvcc build included.  Prints ONE JSON line on stdout,
with ``bench.py``'s keys in ``bench.py``'s order and then ``front_end`` and
``device``; diagnostics go to stderr.  Without a CUDA card it exits 1.

``vs_baseline`` is the rate times ``bench.py``'s pinned CPU reference
(``CPU_REF_S_PER_VOLUME`` = 11.6 s a volume); ``vs_baseline_live_cpu_leg``
divides it by this run's own CPU reference, ``bench_cpu_reference``: the
same workload as ``bench.py``'s (a torch trilinear resample and the
factorized encoder at the reference's token geometry, plain torch on the
CPU), its attention written out as softmax(q k^T / sqrt(d)) v.  A failure
of that leg raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import sys
import time

import torch

from ctpa_torch.core.config import BertConfig, CTViTConfig, PreprocessConfig
from ctpa_torch.models.bert import BertEncoder
from ctpa_torch.models.ctvit import CTViT
from ctpa_torch.models.layers import compute_dtype
from ctpa_torch.ops.attention_ops import l2norm
from ctpa_torch.ops.preprocess import preprocess_stage12, preprocess_volume
from ctpa_torch.ops.vq import vq_init

RAW_SHAPE = (160, 512, 512)
SPACING = (2.0, 0.75, 0.75)
SLOPE, INTERCEPT = 1.0, -1024.0
FRONT_ENDS = ("patchify", "resample_patchify")
TEXT_LEN = 512
DIM_LATENT = 512
SAMPLES = 15
SEED = 0
# bench.py's pinned CPU-reference seconds a volume, the denominator of
# vs_baseline (bench.py explains its origin)
CPU_REF_S_PER_VOLUME = 11.6


def log(*a):
    print(*a, file=sys.stderr, flush=True)


@torch.no_grad()
def materialize_(module: torch.nn.Module, gen: torch.Generator, std: float = 0.02):
    """Every parameter normal(0, std) from ``gen``, in registration order."""
    for p in module.parameters():
        p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * std)
    return module


def build(dev) -> dict:
    """The bench's models and weights in bf16: CTViT with the patchify and
    flash kernels, its VQ state, the latent projection, the text tower and
    its projection, one tokenized report."""
    vit_cfg = dataclasses.replace(CTViTConfig(), pallas_patchify=True, flash_axial=True)
    bert_cfg, dtype = BertConfig(), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    vit = materialize_(CTViT(vit_cfg, device=dev, dtype=dtype).eval(), gen)
    vq = vq_init(gen, vit_cfg.codebook_size, vit_cfg.dim, device=dev)
    hw = (vit_cfg.image_size // vit_cfg.patch_size) ** 2
    w_latent = (torch.randn(hw * vit_cfg.dim, DIM_LATENT, generator=gen, device=dev)
                * 0.002).to(dtype)
    bert = materialize_(BertEncoder(bert_cfg, device=dev, dtype=dtype).eval(), gen)
    w_text = (torch.randn(bert_cfg.hidden_size, DIM_LATENT, generator=gen, device=dev)
              * 0.02).to(dtype)
    ids = torch.randint(1, bert_cfg.vocab_size, (1, TEXT_LEN), generator=gen, device=dev)
    return dict(vit=vit, vq=vq, w_latent=w_latent, bert=bert, w_text=w_text, ids=ids,
                tmask=torch.ones_like(ids))


def pipeline(vit: CTViT, w_latent, vq_state, raw, front_end: str = "patchify",
             spacing=SPACING, cfg: PreprocessConfig = PreprocessConfig.train()):
    """One raw volume -> its (dim_latent,) l2-normalised image latent
    (``bench.py``'s ``pipeline_fn``); ``vq_state`` None skips the VQ."""
    dtype = compute_dtype(vit.patch_embed, vit.patch_embed.proj_kernel)
    if front_end == "patchify":
        video = preprocess_volume(raw, SLOPE, INTERCEPT, spacing, cfg)
        tokens, _ = vit(video[None].to(dtype), vq_state)
    elif front_end == "resample_patchify":
        ops = preprocess_stage12(raw, SLOPE, INTERCEPT, spacing, cfg, dtype=dtype)
        tokens, _ = vit.forward_stage3(ops, vq_state)
    else:
        raise ValueError(f"front_end must be one of {FRONT_ENDS}, not {front_end!r}")
    pooled = tokens.mean(dim=1).reshape(tokens.shape[0], -1)
    return l2norm(pooled @ w_latent.to(pooled.dtype))[0]


def pipeline_clip(vit, w_latent, vq_state, raw, bert, w_text, ids, tmask,
                  front_end: str = "patchify"):
    """The CLIP pair (``bench.py``'s ``pipeline_clip_fn``): the image latent,
    a report through the text tower (CLS pooling) and their similarity."""
    img = pipeline(vit, w_latent, vq_state, raw, front_end)
    _, cls = bert(ids, tmask)
    txt = l2norm(cls @ w_text.to(cls.dtype))[0]
    return img @ txt.to(img.dtype), img


def time_samples(fn, raw, n: int) -> list[float]:
    """Seconds per call over ``n`` calls, each on a freshly perturbed raw."""
    out = []
    for i in range(n):
        r = raw + 1e-3 * (i + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(r)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def spread(label: str, samples: list[float]) -> float:
    ms = sorted(s * 1e3 for s in samples)
    med = statistics.median(ms)
    log(f"{label}: median {med:.3f} ms over {len(ms)} samples (min {ms[0]:.3f}, "
        f"max {ms[-1]:.3f})")
    return med / 1e3


def bench_cpu_reference(iters: int = 2) -> float:
    """Volumes/s of ``bench.py``'s reference workload on the CPU: torch
    trilinear resample (the offline + online prep cost) + factorized
    transformer encode at the reference's token geometry, one warm-up
    volume, then the mean of ``iters``."""
    import torch.nn.functional as F

    torch.manual_seed(0)
    dim, heads, depth_s, depth_t = 512, 8, 4, 4
    t_tok, hw = 24, 576

    raw = torch.randint(-24, 3000, RAW_SHAPE, dtype=torch.int16).float()

    patch_proj = torch.nn.Linear(4000, dim)
    qkv = [torch.nn.Linear(dim, dim * 3) for _ in range(depth_s + depth_t)]
    proj = [torch.nn.Linear(dim, dim) for _ in range(depth_s + depth_t)]
    ff1 = [torch.nn.Linear(dim, dim * 4) for _ in range(depth_s + depth_t)]
    ff2 = [torch.nn.Linear(dim * 4, dim) for _ in range(depth_s + depth_t)]
    final = torch.nn.Linear(24 * 24 * dim, dim)

    def mha(x, i):
        b, n, d = x.shape
        q, k, v = qkv[i](x).chunk(3, dim=-1)
        q = q.view(b, n, heads, -1).transpose(1, 2)
        k = k.view(b, n, heads, -1).transpose(1, 2)
        v = v.view(b, n, heads, -1).transpose(1, 2)
        o = torch.softmax(q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5, dim=-1) @ v
        o = o.transpose(1, 2).reshape(b, n, d)
        x = x + proj[i](o)
        return x + ff2[i](F.gelu(ff1[i](x)))

    def one_volume():
        with torch.no_grad():
            # resample to target spacing then crop/pad (reference order)
            scale = [SPACING[i] / t for i, t in enumerate((1.5, 0.75, 0.75))]
            new = [int(RAW_SHAPE[i] * scale[i]) for i in range(3)]
            x = F.interpolate(raw[None, None], size=new, mode="trilinear",
                              align_corners=False)[0, 0]
            x = x.clamp(-1000, 1000) / 1000
            # center crop/pad to (240, 480, 480)
            tgt = (240, 480, 480)
            pads, slices = [], []
            for a in range(3):
                s = x.shape[a]
                if s > tgt[a]:
                    st = (s - tgt[a]) // 2
                    slices.append(slice(st, st + tgt[a]))
                    pads.append((0, 0))
                else:
                    slices.append(slice(None))
                    before = (tgt[a] - s) // 2
                    pads.append((before, tgt[a] - s - before))
            x = x[slices[0], slices[1], slices[2]]
            flat_pads = [p for pair in reversed(pads) for p in pair]
            x = F.pad(x, flat_pads, value=-1.0)
            # patch embed (24, 24, 24, 4000) -> tokens
            x = x.view(24, 10, 24, 20, 24, 20).permute(0, 2, 4, 1, 3, 5).reshape(
                24, 24, 24, 4000)
            tok = patch_proj(x)                         # (t, h, w, d)
            # spatial: (t, hw, d); temporal: (hw, t, d)
            s = tok.view(t_tok, hw, dim)
            for i in range(depth_s):
                s = mha(s, i)
            tmp = s.view(t_tok, hw, dim).permute(1, 0, 2)
            for i in range(depth_t):
                tmp = mha(tmp, depth_s + i)
            pooled = tmp.permute(1, 0, 2).mean(dim=0).reshape(1, -1)
            return final(pooled)

    one_volume()                       # warm up threads/allocs
    t0 = time.perf_counter()
    for _ in range(iters):
        one_volume()
    dt = (time.perf_counter() - t0) / iters
    log(f"cpu reference steady-state: {dt * 1000:.0f} ms/volume")
    return 1.0 / dt


def result_line(per_volume: float, per_pair: float, compile_first_s: float, front_end: str,
                device: str, cpu_vps: float) -> dict:
    """The JSON line: ``bench.py``'s keys in its order, then the port's."""
    if not (math.isfinite(cpu_vps) and cpu_vps > 0):
        raise ValueError(f"the CPU reference leg gave {cpu_vps} volumes/s")
    vps = 1.0 / per_volume
    return {
        "metric": "preproc_encode_volumes_per_sec_per_chip",
        "value": vps,
        "unit": "volumes/sec",
        "vs_baseline": vps * CPU_REF_S_PER_VOLUME,
        "vs_baseline_live_cpu_leg": vps / cpu_vps,
        "clip_pairs_per_sec_incl_text": 1.0 / per_pair,
        "compile_first_s": compile_first_s,
        "front_end": front_end,
        "device": device,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--front-end", choices=FRONT_ENDS, default="patchify")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("bench_torch: no CUDA device; this benchmark runs on the card only")
        return 1
    dev = "cuda"
    kind = torch.cuda.get_device_name(0)
    log(f"device {kind}; front end {args.front_end}")
    with torch.inference_mode():
        m = build(dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        raw = torch.randint(-24, 3000, RAW_SHAPE, generator=gen, device=dev).to(torch.float32)
        torch.cuda.synchronize()

        def one(r):
            return pipeline(m["vit"], m["w_latent"], m["vq"], r, args.front_end)

        def pair(r):
            return pipeline_clip(m["vit"], m["w_latent"], m["vq"], r, m["bert"], m["w_text"],
                                 m["ids"], m["tmask"], args.front_end)

        t0 = time.perf_counter()
        latent = one(raw)
        torch.cuda.synchronize()
        compile_first_s = time.perf_counter() - t0
        log(f"first call (kernel build included): {compile_first_s:.2f} s")
        if latent.shape != (DIM_LATENT,) or not torch.isfinite(latent).all():
            raise AssertionError(f"latent {tuple(latent.shape)} is not finite or misshaped")
        for _ in range(2):
            one(raw)
        per_volume = spread("volume", time_samples(one, raw, SAMPLES))
        for _ in range(2):
            pair(raw)
        per_pair = spread("clip pair", time_samples(pair, raw, SAMPLES))
    print(json.dumps(result_line(per_volume, per_pair, compile_first_s, args.front_end, kind,
                                 bench_cpu_reference())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
