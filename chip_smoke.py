#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's zero-shot serving, raw-volume encode
(bench_torch.py's program), contrastive training, report generation, report
training, int4 and int8 report serving, streaming report serving,
zero-shot evaluation from files, the report workload from files, CT-CLIP
training from files, the fused full-sequence encoder and the generative
(VQGAN) path once on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its seconds:
  1. card          — the device's name and nvidia-smi's name and power limit;
  2. build         — nvcc builds every kernel under ctpa_torch/csrc/, with
                     each kernel's registers, shared memory and spills from
                     -Xptxas -v;
  3. kernels       — K1 and the K2 forward against their plain PyTorch
                     versions at the shapes the serving path gives them
                     (K2 also at head dims 16 and 64),
                     called twice on one input (the bits must repeat), K1
                     once more from a library with a planted fault (a patch
                     row's chunks one place off in the swizzle), which the
                     gate must refuse, then timed with CUDA events (K1 after
                     an idle second) beside the plain version, a one-call
                     PyTorch yardstick where one exists, and the card's bound
                     for the same work (K1 with its fraction of it and its
                     ptxas registers and spills);
  4. serving       — CTCLIP at the shipped geometry in bf16 with seeded
                     random weights: the 36 prompt latents are encoded once,
                     then 4 inference-path requests and one train-path raw
                     volume are served; each request prints its latency, its
                     18 probabilities, its kernel launches and peak memory;
  5. plain         — the same requests through the model's plain paths (no
                     hand kernel), with the differences bounded;
  6. raw-kernels   — the fused resample-patchify kernel (K9) against its
                     plain version at the shipped raw (x2 (240, 480, 512))
                     and at a bucketed raw (width 640, 600 real columns),
                     each called twice (the bits must repeat), once from a
                     library with a planted fault (each patch's last
                     k-block left out of its statistics), which the gate
                     must refuse, then timed after an idle second (x2
                     cycled past the L2 cache) beside its plain version and
                     the shipped front end for the same work (torch stage
                     3, window, mask, bf16 cast, K1), with its fraction of
                     the bound and its ptxas registers and spills;
  7. raw-serving   — bench_torch.pipeline, the headline raw-volume program
                     (preprocess, CTViT, VQ, temporal mean, latent,
                     l2norm), on the serving model: a shipped raw through
                     each front end, K1 and K9, with its time a volume,
                     launches (one K9 and no K1 a volume on the K9 path)
                     and peak memory; then the plain phase's gates against
                     the unfused plain path for both front ends and between
                     them; two planted K9 faults (taps shifted by one
                     source column, window left out) must fail them;
  8. train-kernels — K2 with its logsumexp and the four K3 backward passes
                     against their plain versions at the training shapes
                     (batch 2), bf16 and fp32, three bias forms and a ragged
                     n; timed as in phase 3, beside the forward and backward
                     of scaled_dot_product_attention as a yardstick;
  9. training      — CTCLIP at the shipped geometry with fp32 parameters,
                     bf16 compute and block remat takes 4 AdamW steps
                     through CTClipTrainer on 2 preprocessed synthetic
                     volumes and 512-token reports; each step prints its
                     wall time, loss, grad norm, temperature, peak memory
                     and kernel launches;
 10. train-plain   — the first step again from the same state with
                     flash_axial off (no hand kernel), the loss and the
                     spatial fold's gradients bounded against the kernel
                     path's;
 11. report-kernels — the decode-attention kernel (K8) against its plain
                     version at the decode shape of Meditron-7B (a 608-slot
                     cache): batch 4 with a bf16 cache, with holes, with an
                     int8 cache and GQA rep 4; batch 32 at the quant
                     headline's validity with int8 and bf16 caches; each
                     form called twice (the bits must repeat); K8 built
                     again with a planted fault (KERNEL_FAULTS: the
                     cluster's merge one rank short), which the gate must
                     refuse; the four batch 4 / 32, bf16 / int8 caches
                     timed after an idle second (call and device time)
                     beside the plain version, scaled_dot_product_attention
                     (float caches) and the bound;
 12. report        — CTReportGenerator at Meditron-7B width (LLMConfig()),
                     the shipped CTViT with pallas_patchify, bf16 weights
                     built on the card from a seed, flash_decode: 4
                     inference-path volumes and 4 prompts right-padded to
                     512 tokens, 96 new tokens decoded greedily; prints the
                     prefill and decode-step times, tokens/s, peak memory
                     and the launches (4 K1, 32 x 95 K8), then decodes 16
                     tokens with the int8 KV cache;
 13. report-plain  — the same weights with flash_decode off, and the same
                     weights in fp32 with flash_decode off, teacher-forced
                     on the kernel path's tokens (which it must give back):
                     the kernel path's fused logits must be as close to the
                     fp32 reference as the plain path's, and agree with the
                     plain path's on the top-1 token; the kernel path with a
                     planted fault (the prompt's holes ignored, or the wrong
                     layer's planes read) must fail these gates;
 14. report-train-kernels — K2's masked forms (causal, q_offset, kv_mask with
                     inner holes, rows with no valid key) and K3's masked
                     passes against their plain versions: at report
                     training's shape (b 2, h 32, n = m = 512, head dim 128,
                     bf16, causal, real lengths 512/384) and with the three
                     bias forms at head dims 32, 64 and 128; timed beside
                     scaled_dot_product_attention with the same mask (call
                     and device time), with bounds counted over the tiles
                     the kernels visit and the real keys; K2-lse and K3 at
                     head dim 128 called twice for bits;
 15. report-train  — a LoRA fine-tune (rank 16, alpha 32 on q, k, v, o) of
                     the report phase's model as the report CLI runs it with
                     --flash-prefill: Meditron-7B width, batch 2 x 512 tokens
                     (real lengths 512/384), one inference-path volume per
                     sample; the frozen bf16 base is shared, the trainable
                     tensors and their AdamW moments are fp32.  3 partitioned
                     steps, then ReportTrainer.train_epoch over 2 batches;
                     prints step times, peak memory, loss, grad norm and the
                     launches per step (32 of each kernel); then traces two
                     more steps with torch.profiler and prints the second's
                     device time by kind of kernel and by kernel;
 16. report-train-plain — the first step from the same state with
                     flash_prefill off (the dense masked attention): loss and
                     per-tensor gradient cosines gated; then the kernel path
                     with a planted fault (q_offset = 1, or causal off) must
                     fail the same gates; and the kernel and dense paths from
                     two more seeded states and batches must pass them.
 17. quant-kernels — the int4 projection (K5) and the fused int4 FFN (K7),
                     weight-only and w4a8, against their plain versions at
                     Meditron-7B's shapes: decode at batch 4 and 32, 33 and
                     128 rows (the prefill kernels' first row counts),
                     prefill of 4 x 512 tokens, a ragged case, and the
                     batch-32 prefill of 16,384 rows untimed; timed as in
                     phase 3 (weights cycled past the L2 cache), K5
                     weight-only beside torch._weight_int4pack_mm and K5's
                     prefill forms beside dense bf16 torch.matmul; the
                     decode and prefill kernels of K5 and K7 called twice
                     for bits, the decode kernels timed beside the prefill
                     kernels at 4-33 rows (a threshold table), and K5 and K7
                     built again with planted faults (KERNEL_FAULTS,
                     compiled in the background since the build phase: K7's
                     w4a8 decode gate/up kernel's row maximum over half a
                     j-block; its w4 prefill gate/up kernel's last k-step of
                     each half group dropped; K5's prefill kernel scaling a
                     token by its pair's other token's row scale), which the
                     gates must refuse;
 18. quant-report  — the report-train phase's checkpoint and the report
                     phase's bf16 base through ctpa_torch.cli.export_serving
                     (--quant int4 --ffn-kernel --kv-quant int8
                     --flash-decode, then with --act-quant) and
                     load_serving_bundle; generate at batch 4 x 512 tokens,
                     96 greedy tokens, weight-only and w4a8, then w4a8 at
                     batch 32: prefill and decode-step times, tokens/s, peak
                     memory, and exactly 65 K5 launches and 64 of K7 (two a
                     layer: the decode kernels at up to 32 rows, else the
                     prefill kernels; K5 one launch a call at any row count;
                     no reduction kernel) per prefill and per decode step
                     (w4a8: 97 activation quantizations at batch 4), 32 K8
                     per decode step;
 19. quant-plain   — each tier's kernel path, the same bundle with
                     quant_impl="xla" and an fp32 reference of the same
                     dequantized weights, teacher-forced on the kernel path's
                     tokens, against gates of report-plain's shape; the kernel
                     path fed tampered inputs (nibble halves swapped, scale_g
                     rolled by one group) over the first QUANT_FAULT_STEPS
                     steps must fail them, read over those steps.
 20. quant8-kernels — the int8 projection (K4) and the fused int8 FFN (K6),
                     weight-only and w8a8, against their plain versions at
                     Meditron-7B's shapes (K4 also at the unfused FFN's
                     gateup and down shapes): decode at batch 4 and 32, 33
                     and 128 rows, prefill of 4 x 512 tokens, ragged cases,
                     the batch-32 prefill untimed; timed as in phase 17, K4
                     beside torch._int_mm (w8a8), torch._weight_int8pack_mm
                     (w8; one call at prefill) and at prefill dense bf16
                     torch.matmul; K4's and K6's decode kernels called twice
                     for bits at batch 4 and 32 and their prefill kernels at
                     2,048 rows (K4 w8a8 equal to its plain version bit for
                     bit at every row count), K4's decode kernel timed
                     beside its prefill kernel at 4-33 rows, and K4 and K6
                     built again with planted faults (KERNEL_FAULTS; K4's
                     split dropped at decode and its prefill kernel's column
                     scales swapped in pairs; K6's at decode and in its w8a8
                     prefill kernel, each a row maximum over half a j-block),
                     which their gates must refuse;
 21. quant8-report — the same base and checkpoint through export_serving
                     (--quant int8 --ffn-kernel --kv-quant int8
                     --flash-decode, then with --act-quant) and
                     load_serving_bundle, after the int4 models are freed;
                     generate as in phase 18 (w8 and w8a8 at batch 4, w8a8
                     at batch 32), exactly 65 K4 launches and 64 of K6 (two
                     a layer: the decode kernels at up to 32 rows, else the
                     prefill kernels; K4 one launch a call; no reduction
                     kernel) per prefill and per decode step (w8a8: 97
                     activation quantizations at batch 4), 32 K8 per decode
                     step;
 22. quant8-plain  — phase 19's gates for the int8 tiers; the planted faults
                     roll the per-column scales by one or shift the
                     contraction by one row.

 23. stream        — bench_stream.py's config 5 through
                     StreamingReportPipeline.run: a burst of 6 raw (160, 512,
                     512) int16 volumes (the port's preprocess_volume and
                     extract_vision, K1 once a volume), one shared 16-token
                     prompt, 64 greedy tokens, 4 lanes, 8 steps a chunk; the
                     plain ring tier and the speculative tier (K = 8, one
                     verify over 4 x 9 rows a chunk) on the report phase's
                     bf16 model (flash_decode) and on quant-report's int4
                     w4a8 bundle (K4-K7's 36-row verify forms), then one
                     plain wave of 4 volumes with the int4 KV cache and one
                     with the int8 cache's integer dots (no flash_decode);
                     prints volumes/s, tokens/s, the median chunk, tokens
                     per verify, the device reads (exactly one a chunk) and
                     each chunk's launches (exactly its steps', beside each
                     admission's lm_head);
 24. stream-plain  — the plain tiers' recorded fused logits against fp32
                     references on their tokens, beside generate at batch 4
                     teacher-forced on them (report-plain's bounds for the
                     bf16 model, quant-plain's for the bundle and the
                     quantized caches); the speculative tiers' tokens equal
                     to the plain tiers' up to the first near tie, and
                     teacher-forced within the same bounds; then a ring
                     rotated one slot too far and a rollback skipped, each
                     served on one wave, must fail the gates.
 25. zeroshot-files — zero-shot evaluation from files at the shipped
                     geometry, in a temporary directory: a reference-layout
                     CT-CLIP_v2.pt written from a seed (1.2 GB fp32), 4 raw
                     NIfTI volumes through ctpa_torch.cli.preprocess
                     (--window inference, sharded npz, metadata CSVs), a
                     reports and an 18-pathology labels CSV; build_ctclip on
                     the .pt in bf16 with K1 and K2, run_zeroshot (1 K1 and
                     4 K2 a volume; load time, time a volume, mean_auc, peak
                     memory) held against the kernel-free path within
                     PROB_ATOL; then the model saved through
                     CheckpointManager and ctpa_torch.cli.zeroshot_infer.main
                     (fp32 CTViTConfig(), no kernels) held against
                     run_zeroshot on the restored state, every artifact
                     present.
 26. report-files  — the report workload from files (run before stream, while
                     quant8-report's w8a8 bundle is on disk), in a temporary
                     directory of seeded npz volumes and JSONL manifests:
                     ctpa_torch.cli.generate_report.main at Meditron-7B
                     width from that bundle (3 items, 4 lanes, 32 greedy
                     tokens; K4, K6 and K8 counted), its tokens
                     teacher-forced through the bundle's kernel path, its
                     plain path (quant_impl "xla", flash_decode off) and an
                     fp32 model of the dequantized weights under
                     quant-plain's gates, given back by the kernel path
                     (RF_GIVE_BACK_MIN; a prompt shifted by a token is
                     not), the vision feature each request carried its
                     item's (RF_VISION_RTOL; its neighbour's is not), and
                     one item through --speculative (16 tokens);
                     evaluate.main nlg on its results with BERTScore from
                     a BF16 safetensors snapshot of a seeded
                     BertConfig() encoder (and --compute-baseline);
                     train_report's loader, eval_fn and a ReportTrainer
                     epoch of 2 partitioned --flash-prefill steps at 2 x 512
                     tokens on the report phase's base (the four d128 flash
                     kernels, 32 launches each a step), the first loss
                     within report-train-plain's gate of the dense path's;
                     the three CLIs again at --tiny on the card (train_report
                     in report and vqa mode, generate_report from its
                     base.pt and latest step, evaluate); MedicalVQAModel at
                     BertConfig() width (logits, loss, one optimizer step,
                     a greedy generate).
 27. clip-files    — CT-CLIP training from files, in a temporary directory:
                     4 raw (160, 512, 512) int16 npz volumes with their
                     metadata CSV, 2 pre-normalised validation volumes with
                     labels, one reports CSV; ctpa_torch.cli.train_clip.main
                     at full width (fp32 model, bf16 video, as ctpa's CLI;
                     no remat), batch 2, 3 steps, the zero-shot eval at step
                     2, --profile-dir: each step's time and launches
                     (exactly 4 of K2-lse and of each K3 pass), the eval's
                     seconds, mean AUROC, peak memory and flash launches,
                     the checkpoint, the trace's size; then one step of
                     make_clip_train_step with use_mlm and use_visual_ssl and
                     CLOOB's projections (bf16, remat; 3 encodes, exactly 24
                     K2-lse and 12 of each K3 pass), timed beside a plain
                     CLIP step, and the same first step with flash_axial off
                     under the CLIP gates (and SSL_LOSS_ATOL on the MLM and
                     SimCLR losses);
 28. fused-encoder — K2-lse and K3's delta, dQ and dK/dV at one volume's
                     13,824 tokens (1, 8, 13,824, 32), bf16, no bias, the
                     cosine bound, against their plain versions (one head
                     at a time) under a limit scaled by the reference's RMS
                     that must reject a planted kernel skipping the last
                     32 keys or queries, twice for bits, timed beside
                     scaled_dot_product_attention and the bound; then a CLIP
                     step with fused_attention at depth 4 (batch 2, bf16,
                     remat; exactly 8 K2-lse and 4 of each pass), twice, and
                     the first step again on the plain cosine attention at
                     the same depth under the CLIP gates.
 29. parallel      — on one rank of an NCCL group: train_clip.main at full
                     width with --coordinator on one rank (2 steps) against
                     the same run alone, within 1e-5 relative; K2-lse and K3
                     rank by rank through parallel/context.py:rank_attention
                     on 4 emulated ranks, at the fused encoder's form (3,456
                     of 13,824 query rows each; outputs concatenated, dK/dV
                     partials summed, against the unsharded call) and at the
                     LLM's causal form (32 heads, d 128, 512 tokens, q_offset
                     0/128/256/384, against the plain versions); planted
                     faults (every rank at q_offset 0, a dK/dV partial left
                     unsummed) must fail the gates; the fused encoder under
                     cp_mesh and context_parallel_attention on the one-rank
                     mesh against the unsharded paths; ContinuousBatcher
                     (mesh=...) at Meditron-7B width, 4 lanes x 16 greedy
                     tokens, equal to the unmeshed batcher's.
 30. vqgan         — the VQGAN step (train/vqgan_trainer.py) at
                     CTViTConfig() with the decoder, Discriminator() and
                     PerceptualNet(), batch 2 (240, 480, 480) volumes, from
                     one set of seeded weights: the spatial fold on K2-lse
                     and K3 with d(bias), exactly 4 launches of each a step,
                     against the plain attention, both quantizing to the
                     plain path's codes, with R1 and without, in bf16 (each
                     loss term within 0.05, each group's gradient cosine
                     >= 0.99) and in fp32 (1e-4, 0.9999); planted flash
                     faults (causal on; the last 32 keys masked, in fp32)
                     must fail the gates; reconstruct under no_grad on K1
                     and K2, its encoder tokens gated against the plain
                     path's (the same fault refused), the voxels and
                     decode_from_codebook_indices printed beside them;
                     then train_vqgan.main from npz files as ctpa's CLI runs
                     (fp32, no kernel): 2 steps, --resume to 3, against an
                     uninterrupted run; step times, peak memory, the
                     checkpoint's size.

The line before the last is nvidia-smi's "name, power.limit"; the one before
that a JSON object with one entry per kernel.  The last line is
{"ok": true, "device": {...}}.  A failed check raises, so the exit code is
not 0.  Nothing of JAX or of the ctpa package is imported.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import dataclasses
import functools
import io
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import warnings

# NVIDIA H100 SXM data-sheet peaks (dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
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
# the logsumexp is fp32 in both dtypes and sums the same fp32 terms in
# another order
LSE_ATOL, LSE_RTOL = 1e-4, 1e-4
# NVIDIA H100 SXM data-sheet fp32 rate outside the tensor cores (K9's
# two-tap stage 3 runs there, beside the projection)
PEAK_FP32_FLOPS = 67e12

# the raw-volume encode path (bench_torch.py): K9 at the shipped raw and at a
# bucketed raw whose array is end-padded past its true extents (width 640,
# 600 real columns); raw-serving times this many volumes per front end
BUCKET_RAW_SHAPE = (160, 512, 640)
BUCKET_TRUE_SHAPE = (150, 500, 600)
BUCKET_SPACING = (2.0, 0.8, 0.7)
RAW_SAMPLES = 7

# training: batch 2 (the reference fine-tune's), 512-token reports, 4 steps
TRAIN_BATCH = 2
TEXT_LEN = 512
TRAIN_STEPS = 4
TRAIN_SPACINGS = ((2.0, 0.75, 0.75), (1.5, 0.7, 0.7))
RAGGED_N = 500
# kernel path vs plain path, first step from one state: the spatial fold's
# gradients point the same way (bf16 rounds at other places on the two
# paths); the loss passes through the VQ, whose codes flip on bf16 noise,
# so it is bounded loosely
TRAIN_GRAD_MIN_COS = 0.99
TRAIN_LOSS_ATOL = 0.05

# report generation: batch 4, prompts right-padded to 512 with these real
# lengths, 96 new tokens (a 608-slot cache, the reference's serving shape)
PROMPT_LENS = (512, 448, 384, 320)
NEW_TOKENS = 96
INT8_NEW_TOKENS = 16
# kernel path vs plain path, teacher-forced on the same tokens.  The fused
# logits are bf16 (lm_head's output): its ulp near the top logits (~4-7) is
# 0.03, the top-2 gap of 32,000 random logits ~0.3.  Both bf16 paths of
# this 32-layer model lie ~7.5% of the max logit per step from the fp32
# model, and ~6.4% from each other: a bound between the two bf16 paths
# alone would sit inside their rounding noise.
# So the kernel path is held against an fp32 teacher-forced
# reference, as closely as the bf16 plain path is: its worst per-step
# max |diff| / max |logit| and its mean |diff| within REPORT_FP32_RATIO of
# the plain path's, its top-1 agreement with fp32 at most
# REPORT_FP32_TOP1_SLACK below the plain path's; and top-1 agreement with
# the plain path on >= REPORT_TOP1_MIN of the (lane, step) pairs (a
# disagreement is a near-tie).  A kernel error beyond bf16 noise moves the
# kernel path away from the fp32 reference while the plain path stays;
# report-plain plants two such errors and checks that the gates reject them.
REPORT_TOP1_MIN = 0.8
REPORT_FP32_RATIO = 1.25
REPORT_FP32_TOP1_SLACK = 0.03

# report training: the report CLI's run with --flash-prefill (batch 2, every
# sample padded to --max-length 512), real lengths 512 and 384
TRAIN_LENS = (512, 384)
REPORT_TRAIN_STEPS = 3           # partitioned steps, then one epoch of:
REPORT_EPOCH_BATCHES = 2
# the masked kernels' checks at smaller shapes: (b, h, n, m), n and m ragged
# against the 64-row tiles
MASKED_SHAPE = (2, 8, 320, 352)
# report-train-plain, kernel path vs dense path, first step from one state,
# both bf16: the loss, and the cosine of each LoRA and head gradient.  Read
# on the H100 (PERF.md): the sound path, from the first state and from
# REPORT_TRAIN_SOUND_SEEDS further states and batches, |diff| 8.7e-4 to
# 2.7e-3 and min cosine 0.9892 to 0.9896; the planted faults |diff| 1.3e-2
# and 1.4e-2, min cosine 0.17 and -0.07.  Each limit lies between the two.
REPORT_TRAIN_LOSS_ATOL = 5e-3
REPORT_TRAIN_GRAD_MIN_COS = 0.9
REPORT_TRAIN_SOUND_SEEDS = (20, 21)
# the epoch's checkpoint: the trained tensors (LoRA and cross-attention)
# that quant-report exports
REPORT_CKPT_DIR = "build/chip_smoke/report_checkpoints"
REPORT_TRAIN_KERNELS = ("flash_attention_fwd_lse_d128", "flash_attention_bwd_delta",
                        "flash_attention_bwd_dq_d128", "flash_attention_bwd_dkv_d128")


# int4 serving, the README's tiers (docs/ROUND3_NOTES.md:316-321): the
# latency tier (weight-only, fused FFN, int8 KV cache) and the headline tier
# (w4a8) at batch 4 x 512 tokens, and w4a8 at batch 32; 96 greedy tokens
# (a 608-slot cache)
QUANT_NEW_TOKENS = 96
QUANT_B32 = 32
QUANT_DIR = "build/chip_smoke/quant"
# quant-plain: the int4 kernel path and the xla path (ctpa's plain
# composition) of one bundle, teacher-forced on the kernel path's tokens,
# each against an fp32-activation reference of the same dequantized weights:
# the kernel path's distance within QUANT_FP32_RATIO of the xla path's, its
# top-1 agreement with the reference at most QUANT_FP32_TOP1_SLACK below the
# xla path's, and top-1 agreement with the xla path >= QUANT_TOP1_MIN.  The
# two paths differ by more than bf16 rounding: in weight-only the kernel
# rounds the dequantized weights to bf16 and the xla path keeps them fp32,
# and in w4a8 the kernel requantizes h per 256-column j-block and the xla
# path per full row; int4 noise through 32 random layers makes the logits
# chaotic, so two sound paths agree on top-1 far less often than in
# report-plain.  Read on the H100 (PERF.md): the sound kernel paths at
# distance ratios 0.796-1.057, top-1 0.026 below the xla path's (w4) and
# 0.073 above it (w4a8), top-1 with the xla path 0.8255 (w4) and 0.5911
# (w4a8); the planted faults of the int4 and int8 tiers, over the first
# QUANT_FAULT_STEPS steps, at ratios 3.699-15.624 and top-1 0.0000.  Each
# limit lies between the two.
QUANT_FP32_RATIO = 1.25
QUANT_FP32_TOP1_SLACK = 0.15
QUANT_TOP1_MIN = 0.3
# the planted faults of quant-plain and quant8-plain run the first
# QUANT_FAULT_STEPS of the QUANT_NEW_TOKENS steps and are gated over them
QUANT_FAULT_STEPS = 24
# quant-kernels: the w4a8 forms against their plain versions p within
# QUANT_A8_ATOL * max|p| + QUANT_A8_RTOL |p|.  Both sum the same exact
# int32 group dots times the same fp32 scales, in another order, and round
# to bf16, so they differ by at most one bf16 ulp of |p| (<= 2^-7 |p|) and,
# in the FFN, by the rare element of h whose fp32 value sits on a level
# boundary of its int8 grid and lands on the other level (one level of sh
# times one down weight, a few 1e-4 of max|p| at Meditron-7B width): the
# atol covers that flip.  ctpa's xla branch, which requantizes h per full
# row instead of per 256-column j-block, must fail this bound at the decode
# and prefill shapes, so the bound sees the j-block rule.  Read on the H100
# (PERF.md): K5 w4a8 within one ulp everywhere, K7 w4a8 needing atol up to
# 2.7e-4 max|p| (16,384 rows), the per-row xla FFN 3.4e-2 to 3.9e-2.
QUANT_A8_RTOL = 2.0 ** -7
QUANT_A8_ATOL = 1e-3
# quant-report: every projection of the bundle, dequantized, against W +
# (alpha / rank) (A B) from the bf16 base and the trained checkpoint.  The
# error's norm over the norm that int4 rounding alone gives (each element
# off by a uniform share of its group's step, step^2 / 12) at most
# QUANT_MERGE_ERR_MAX; and where a LoRA delta D was merged, the bundle's
# departure from the base, projected on D, (deq - W) . D / D . D, within
# QUANT_MERGE_COEF of 1 (0 for an unmerged delta, 2 for a doubly merged
# one).  Read on the H100 (PERF.md): 161 projections at 0.9960-0.9966 of
# int4 rounding, 64 deltas at 0.9985-1.0012; the delta left out, merged
# twice and transposed at 1.05-1.08 and -0.0002, 2.0004 and 0.6644.
QUANT_MERGE_ERR_MAX = 1.02
QUANT_MERGE_COEF = 0.05

# streaming report serving, bench_stream.py's config 5 at its defaults
# (bench_stream.py:40-42, 103-113, 190-201; README.md:80-85): a burst of 6
# raw int16 volumes (slope 1, intercept -1024, spacing (2.0, 0.75, 0.75)),
# one shared 16-token prompt, 64 new tokens, 4 lanes, 8 decode steps a
# chunk; the speculative tier drafts 8 tokens (a chunk of ceil(8 / 9) = 1
# verify over 4 x 9 rows).  The caches hold prompt + budget + the larger of
# a chunk's overshoot and a verify's rows.
STREAM_VOLUMES = 6
STREAM_LANES = 4
STREAM_PROMPT_LEN = 16
STREAM_NEW_TOKENS = 64
STREAM_STEPS = 8
STREAM_K = 8
STREAM_RAW = dict(slope=1.0, intercept=-1024.0, spacing=(2.0, 0.75, 0.75))
# the planted faults serve one wave of this many tokens
STREAM_FAULT_TOKENS = 16
# config 5's plain tier samples (bench_stream.py:299-303): temperature 0.7,
# EOS id 2.  One wave of 4 is served so on the bf16 model.
STREAM_TEMPERATURE = 0.7
STREAM_EOS = 2
# random weights accept no draft, so the speculative tier is also served on
# a twin whose lm_head keeps rows 0 and 1 of the model's, times 16 (a power
# of two: exact in bf16 and fp32), and zeros elsewhere: its greedy tokens
# lie in {0, 1, 2} (2 the first of the tied zero logits), the history
# repeats its bigrams and the drafts are accepted in part.  Its near ties
# are judged on logits 0-2 alone, since argmax never picks a token past 2.
# A sampled speculative wave on it ends requests at EOS id 1.
STREAM_HEAD_ROWS = 2
STREAM_HEAD_SCALE = 16.0
STREAM_HEAD_EOS = 1
# stream gates.  The plain tier's fused logits, recorded as it serves, are
# held against an fp32 reference on the same tokens exactly as
# report_gate holds the kernel path, with generate at batch = lanes,
# teacher-forced on the same tokens, in the plain path's place: the bf16
# model's runs at report-plain's bounds, the int4 bundle and the quantized
# KV caches at quant-plain's.  The speculative tier (no logits recorded:
# its verifies emit a varying number of positions) is held by its tokens:
# (1) equal to the plain tier's up to the first position where the fp32
# reference's top-2 gap is below twice the plain tier's worst |logit -
# fp32 logit| at that position (a near tie: two paths each that far from
# fp32 can order those tokens either way); (2) teacher-forced, its tokens
# are generate's argmax on at least the gate's top-1 share, and fp32's
# argmax at most the gate's slack less often than generate's own argmax is.

# zero-shot evaluation from files (phase zeroshot-files): a reference-layout
# CT-CLIP_v2.pt at the shipped widths (std 0.02 weights, gains near 1, so
# 12 BERT layers and the 294,912 -> 512 projection stay finite), 4 raw
# NIfTI volumes (x, y, z) int16 at (0.75, 0.75, 2.0) mm, stored values with
# intercept -1024, through the preprocess CLI's inference window; the
# zero-shot run scores one volume a batch, so K2 runs spatial_depth times a
# volume
ZS_VOLUMES = 4
ZS_NIFTI_SHAPE = (512, 512, 160)
ZS_SPACING = (0.75, 0.75, 2.0)
ZS_WEIGHT_STD = 0.02
# main() against run_zeroshot on the same saved state and config, in one
# process: the same fp32 program on the same inputs
ZS_CLI_ATOL = 1e-5

# CT-CLIP training from files (phase clip-files): train_clip.main at full
# width on CF_VOLUMES raw (160, 512, 512) int16 npz volumes with their
# metadata and CF_VALID pre-normalised validation volumes with labels, batch
# 2, CF_STEPS steps, the zero-shot eval every CF_EVAL_EVERY steps, under
# --profile-dir; as ctpa's CLI, an fp32 model under the bf16 policy with no
# remat, so each step launches K2-lse and each K3 pass spatial_depth times
# (the fp32 forms).  Then one step of make_clip_train_step with the MLM and
# SimCLR objectives and CLOOB's projections (bf16, remat: 3 encodes a step)
# on the kernel path and the plain path, under the CLIP gates above.
CF_VOLUMES = 4
CF_VALID = 2
# the SSL step's two objectives, gated beside the total loss (they enter it
# with weight 0.05 each, below TRAIN_LOSS_ATOL's reach): the SimCLR loss
# over the two encoded views is a bf16 value near 1 (an ulp of 2^-8 below 1,
# 2^-7 above), the MLM loss fp32 from the text tower alone.  Both read a gap
# of 0 on the H100 (PERF.md); the limit admits a few bf16 ulps.
SSL_LOSS_ATOL = 2e-2
CF_STEPS = 3
CF_EVAL_EVERY = 2
# the fused full-sequence encoder (phase fused-encoder): K2-lse and the
# three K3 passes it runs at one volume's t*h*w tokens, with no bias and the
# cosine bound, against their plain versions (taken one head at a time: the
# (1, 8, n, n) fp32 scores are 6.1 GB); then a CLIP step with
# fused_attention at FUSED_DEPTH blocks (batch 2, bf16, remat) on the kernel
# path and on the plain cosine attention, under the CLIP gates
FUSED_SHAPE = (1, 8, 13824, 32)
FUSED_DEPTH = 4
# the fused form's bf16 limit: at n 13,824 the output and dV are ~1/sqrt(n)
# in size (a std near 0.023), so BF16_ATOL would be as large as a typical
# value.  The absolute limit is FUSED_ATOL_RMS times the reference's RMS
# instead, rtol BF16_RTOL.  A kernel that skips the last FUSED_FAULT_ROWS
# keys (forward, dQ) or queries (dK/dV) -- the smallest tile any of these
# kernels walks -- is planted from the plain versions and must fail it.
# Read on the H100 (PERF.md): the kernels need an atol of at most 0.0093
# RMS (the output; dV 0.0078, dQ and dK 0.0001), the planted faults at least
# 1.2458 (the output).  The limit lies 5x above the one and 25x below the
# other; at this form it is about 1e-3 for the output and dV.
FUSED_ATOL_RMS = 0.05
FUSED_FAULT_ROWS = 32
FUSED_KERNELS = ("flash_attention_fwd_lse", "flash_attention_bwd_delta",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv")

# the generative path (phase vqgan): the VQGAN step (train/vqgan_trainer.py)
# at CTViTConfig() with the decoder, Discriminator() and PerceptualNet(),
# VQGAN_BATCH volumes of (1, 240, 480, 480), from one set of seeded weights
# (train_vqgan.init_state; the discriminator and perceptual net drawn again
# at He's scale, vqgan_nets) on the kernel path (flash_axial: K2-lse and K3
# with d(bias) on the spatial fold) and on the plain path, with R1 (step
# count 0) and without (count 1), in fp32 and in bf16 compute.  Both paths
# quantize to the plain path's codes (pinned_codes): the two paths' tokens
# differ by rounding noise before the VQ argmax over 8192 random codes, and
# in bf16 that noise sends 1.34% of the tokens to other codes (read on the
# H100, PERF.md), whose patches the decoder, the discriminator and their
# gradients then follow.  With the codes pinned the decoder sees the same
# quantized tokens on both paths, and the kernels' part is what differs:
# the encoder's gradients (through the straight-through VQ and the
# commitment loss) and the commitment loss.  In bf16 each loss term lies
# within TRAIN_LOSS_ATOL and each parameter group's gradient cosine
# (VQGAN_GROUPS) is at least TRAIN_GRAD_MIN_COS, the CLIP step's gates; in
# fp32 within VQGAN_FP32_LOSS_ATOL and VQGAN_FP32_MIN_COS, set from the
# readings.  The kernel path with a planted flash fault must fail the gate:
# in fp32 both of VQGAN_FAULTS, the smaller one a kernel that skips the
# last FUSED_FAULT_ROWS keys of each slab (the bias masks them); in bf16
# the first.  Read on the H100 (PERF.md): fp32 loss gaps at most 7.2e-7,
# cosines at least 0.9999993; the masked keys' least cosine 0.968 (the
# CPB), causal on's 0.518; bf16 loss gaps at most 1.0e-2 (disc_loss),
# cosines at least 0.9971, causal on's 0.487.
# Then train_vqgan.main from canonical-grid npz files as ctpa's CLI runs
# (fp32, plain attention, no kernel): VQGAN_CLI_STEPS steps, --resume to one
# more, against an uninterrupted run within VQGAN_CLI_RTOL relative plus
# VQGAN_CLI_ATOL.  The three runs take deterministic algorithms
# (deterministic_algorithms): with the card's unordered float sums
# (index_add_'s atomics in the VQ sums, cuDNN's weight gradients) fp32 noise
# went through two Adam steps, read on the H100 at 5.0e-5 absolute on
# gen_gan (-0.064 at the CLI's 0.02 weights) in earlier runs and 2.7e-4 in
# a later one, past the limit; the two runs see the same batches in the
# same order (the loader's shuffle of two volumes is [0, 1] each epoch).  Then reconstruct under
# no_grad with pallas_patchify and flash_axial (K1, K2) in bf16: the
# encoder's tokens before the VQ against the plain path's within
# VQGAN_TOKENS_RMS relative RMS, and each spatial block's attention output
# within VQGAN_ATTN_RMS; the planted key-skipping fault must exceed one of
# them.  Read on the H100 (PERF.md): the tokens 8.6e-3, the attention
# outputs at most 1.19e-2; with the fault 1.26e-2 and 0.191 (the residual
# stream carries the tokens, so the fault shows in the attention outputs).
# The voxels of reconstruct and of decode_from_codebook_indices on its
# codes are printed beside the plain path's, not gated (a flipped code
# changes its whole patch).
VQGAN_BATCH = 2
VQGAN_CLI_STEPS = 2
VQGAN_CLI_RTOL, VQGAN_CLI_ATOL = 1e-3, 1e-4
VQGAN_FP32_LOSS_ATOL = 1e-4
VQGAN_FP32_MIN_COS = 0.9999
VQGAN_FAULTS = ("causal on", f"last {FUSED_FAULT_ROWS} keys masked")
VQGAN_TOKENS_RMS = 0.02
VQGAN_ATTN_RMS = 0.05
VQGAN_GROUPS = ("enc_spatial_transformer", "spatial_rel_pos_bias", "enc_temporal_transformer",
                "decoder", "discriminator")
VQGAN_METRICS = ("gen_loss", "disc_loss", "recon", "perceptual", "gen_gan", "commit", "r1")

# parallelism (phase parallel), on one card: one rank of an NCCL group.
# (a) train_clip.main at full width on clip-files' volumes with --coordinator
# on one rank, PAR_STEPS steps, against the same run without it: losses and
# parameters within PAR_RTOL relative (bit equality printed).  (b) Context
# parallelism rank by rank on the factored per-rank body
# (parallel/context.py:rank_attention), CP_RANKS emulated ranks: the fused
# encoder's form (FUSED_SHAPE, bf16, no bias, the cosine bound), each rank's
# n/p query rows over all n keys, the concatenated K2-lse outputs and the
# summed K3 dK/dV partials against the unsharded kernel call under
# fused_tolerance's limits; the LLM form (CP_LLM_SHAPE: Meditron-7B's 32
# heads at head dim 128, causal), each rank at q_offset = r n/p against the
# plain versions under the kernel gate (BF16_ATOL / BF16_RTOL), and the
# ranks together against the unsharded kernel call.  Planted faults that
# the gates must refuse: every rank at q_offset 0, and a dK/dV partial left
# unsummed.  Then on the one-rank NCCL mesh (the phase's main path): the
# fused encoder (CP_FUSED_DEPTH blocks, one volume, forward and backward)
# under cp_mesh against cp_mesh=None, and context_parallel_attention at the
# LLM form against flash_attention.  (c) ContinuousBatcher(mesh=...) on
# the one-rank group with a Meditron-7B-width bf16 model (flash_decode off:
# ctpa refuses the decode kernel under a mesh), TP_LANES lanes,
# TP_NEW_TOKENS greedy tokens: the tokens equal the unmeshed batcher's.
PAR_STEPS = 2
PAR_RTOL = 1e-5
CP_RANKS = 4
CP_LLM_SHAPE = (2, 32, 512, 128)
CP_FUSED_DEPTH = 1
TP_LANES = 4
TP_PROMPT = 64
TP_NEW_TOKENS = 16

# the report workload from files (phase report-files): generate_report.main
# at Meditron-7B width from quant8-report's w8a8 bundle (K4, K6 and K8;
# kept on disk until this phase), greedy, RF_ITEMS inference-path volumes
# through RF_LANES lanes, RF_NEW_TOKENS new tokens, then one item of
# RF_SPEC_TOKENS through the --speculative tier; evaluate.main nlg on its
# results with a BF16 snapshot of a seeded CXR-BERT-geometry encoder;
# train_report's loader, eval_fn and a ReportTrainer epoch of
# RF_TRAIN_ITEMS / 2 partitioned --flash-prefill steps at 512 tokens on the
# report phase's model (the four d128 flash kernels); the three CLIs once
# more at --tiny; MedicalVQAModel at BertConfig() width.  The CLI's
# predictions are held, teacher-forced, by quant-plain's gates and by the
# give-back and vision checks below; the training loss by
# report-train-plain's.  Its word ids come from CRC-32
# (stable_word_tokenizer), so every run decodes and trains on the same ids.
RF_ITEMS = 3
RF_LANES = 4
RF_NEW_TOKENS = 32
RF_SPEC_K = 4
RF_SPEC_TOKENS = 16
RF_TRAIN_ITEMS = 4
RF_BUNDLE = os.path.join(QUANT_DIR, "bundle_w8a8")
# the CLI's tokens, teacher-forced through the bundle's kernel path, come back
# on at least RF_GIVE_BACK_MIN of the (item, step) pairs, and those of a
# planted CLI fault (the prompt's first token dropped) on less; the vision
# feature each request carried lies within RF_VISION_RTOL of max |feature|
# of the twin's for its item, and its neighbour's does not.  The faults are
# read over their first RF_FAULT_STEPS steps.  Read on the H100 (PERF.md):
# the CLI's tokens 0.9271 (1.0000 over the first 8 steps; 0.82-0.92 under
# salted word ids), the shifted prompt's 0.0000, each item given its
# neighbour's lane 0.8750, which the give-back cannot tell from the sound
# run (the seeded model's tokens hang on the prompt, hardly on the vision),
# hence the vision check: 0 from the twin's own, 0.1947 from its
# neighbour's.
RF_GIVE_BACK_MIN = 0.6
RF_VISION_RTOL = 1e-2
RF_FAULT_STEPS = 8
RF_BERT_STD = 0.02
RF_WORDS = ("the lung is clear no nodule pleural effusion small opacity right left lobe "
            "pulmonary embolism present in segmental arteries filling defect").split()


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


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time per call of the CUDA kernels ``fn`` launches, without
    the host's dispatch between calls (which ``cuda_ms`` includes when it
    exceeds them): the calls are queued behind a spin kernel of about 50 ms,
    so the card runs them back to back, and CUDA events time them.  (A
    profiler trace of such short windows lost kernel events at times, and
    read 0 or too little.)"""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def idle_ms(fn, iters: int = 20) -> float:
    """``device_ms(fn, iters)`` after the card has idled a second: a timing
    taken right after dense tensor-core work reads slow (the card at its
    power limit)."""
    import torch

    torch.cuda.synchronize()
    time.sleep(1.0)
    return device_ms(fn, iters)


def ptxas_report(kernel: str) -> str:
    """nvcc's -Xptxas -v lines for the entry function whose name holds
    ``kernel``: registers, shared memory, spills."""
    from ctpa_torch.kernels import build

    lines = build.library().ptxas_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            rest = [ln.split(":", 1)[-1].strip() for ln in lines[i + 1:i + 4]
                    if "Compiling entry" not in ln and ("registers" in ln or "spill" in ln
                                                        or "stack frame" in ln)]
            return "; ".join(rest)
    raise AssertionError(f"ptxas reported no entry function {kernel}")


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
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


def repeatable(name: str, fn) -> None:
    """Two calls of ``fn`` must give the same bits (a tensor or a tuple of
    tensors); raises otherwise."""
    import torch

    first, second = fn(), fn()
    if not isinstance(first, tuple):
        first, second = (first,), (second,)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    diff = max((a.float() - b.float()).abs().max().item() for a, b in zip(first, second))
    print(f"  {name}: two calls on one input {'bitwise equal' if same else f'differ by {diff}'}")
    if not same:
        raise AssertionError(f"{name}: two calls on one input differ (max |diff| {diff})")


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
    k1_ref = patchify_project_plain(v_, g_, K_, pt, p, p, out_dtype=bf16)
    k1_err = compare("patchify_project bf16",
                     patchify_project(v_, g_, K_, pt, p, p, out_dtype=bf16), k1_ref,
                     BF16_ATOL, BF16_RTOL)
    repeatable("patchify_project bf16",
               lambda: patchify_project(v_, g_, K_, pt, p, p, out_dtype=bf16))
    fault_refused("K1", "a patch row's 16-byte chunks one place off in the swizzle",
                  lambda: patchify_project(v_, g_, K_, pt, p, p, out_dtype=bf16),
                  lambda got: compare("patchify_project, planted fault", got, k1_ref,
                                      BF16_ATOL, BF16_RTOL))
    ms = idle_ms(lambda: patchify_project(v_, g_, K_, pt, p, p, out_dtype=bf16))
    plain_ms = idle_ms(lambda: patchify_project_plain(v_, g_, K_, pt, p, p, out_dtype=bf16))
    t, h, w = T // pt, H // p, W // p
    nbytes = T * H * W * 2 + pd * 4 + pd * dim * 2 + dim * 4 + t * h * w * dim * 2
    b_ms, b_by = bound_ms(nbytes, 2.0 * t * h * w * pd * dim)
    rows["patchify_project"] = dict(
        name="patchify_project", route="cuda", source="ctpa_torch/csrc/patchify.cu",
        replaces="ctpa/ops/pallas/patchify.py:180", max_abs_err=k1_err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print(f"  patchify_project: {ms:.4f} ms (device, after an idle second)  plain "
          f"{plain_ms:.4f} ms  bound {b_ms * 1e3:.1f} us ({b_by}, {b_ms / ms:.3f} of it)  "
          f"library none")
    print(f"    ptxas: {ptxas_report('patchify_project_kernel')}")

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
    # the other head dims the kernel takes, every case, at 4 of the 24 slabs
    for d_ in (16, 64):
        qd = l2norm(torch.randn(4, heads, n, d_, generator=gen, device=dev))
        kd = l2norm(torch.randn(4, heads, n, d_, generator=gen, device=dev))
        vd = torch.randn(4, heads, n, d_, generator=gen, device=dev)
        for dtype, atol, rtol in ((bf16, BF16_ATOL, BF16_RTOL),
                                  (torch.float32, FP32_ATOL, FP32_RTOL)):
            for label, bb, with_bound in cases:
                q_, k_, v_ = qd.to(dtype), kd.to(dtype), vd.to(dtype)
                if bb is not None:
                    bb = (bb[:4] if bb.ndim == 4 else bb).to(dtype).contiguous()
                lb = (scale + bb.max().float()) if with_bound and bb is not None else None
                compare(f"flash_attention {dtype} d {d_} {label}",
                        flash_attention(q_, k_, v_, bias=bb, scale=scale, logit_bound=lb),
                        flash_attention_plain(q_, k_, v_, bb, scale, lb), atol, rtol)
    q_, k_, v_, bb = q.to(bf16), k.to(bf16), v.to(bf16), bias.to(bf16)
    lb = scale + bb.max().float()
    repeatable("flash_attention bf16 bias (h,n,m), bound",
               lambda: flash_attention(q_, k_, v_, bias=bb, scale=scale, logit_bound=lb))
    ms = cuda_ms(lambda: flash_attention(q_, k_, v_, bias=bb, scale=scale, logit_bound=lb))
    plain_ms = cuda_ms(lambda: flash_attention_plain(q_, k_, v_, bb, scale, lb))
    # yardstick only, never called by the port
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=bb, scale=scale))
    nbytes = 4 * b * heads * n * d * 2 + heads * n * n * 2 + 4
    b_ms, b_by = bound_ms(nbytes, 4.0 * b * heads * n * n * d)
    rows["flash_attention_fwd"] = dict(
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

    from ctpa_torch.ops.flash_attention import LAUNCHES
    from ctpa_torch.ops.patchify import patchify_project

    results = []
    for label, preprocess in requests:
        k1, k2 = patchify_project.launches, LAUNCHES["flash_attention_fwd"]
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
        launches = (patchify_project.launches - k1, LAUNCHES["flash_attention_fwd"] - k2)
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


def k9_operands(gen, dev, raw_shape, true_shape, spacing):
    """A seeded raw (true extents filled, the rest of the bucket zero) through
    stages 1-2 of the train-path preprocess, x2 in bf16."""
    import torch

    from ctpa_torch.core.config import PreprocessConfig
    from ctpa_torch.ops.preprocess import preprocess_stage12

    raw = torch.zeros(raw_shape, device=dev)
    real = true_shape or raw_shape
    raw[tuple(slice(0, n) for n in real)] = torch.randint(-24, 3000, real, generator=gen,
                                                          device=dev).to(torch.float32)
    return preprocess_stage12(raw, 1.0, -1024.0, spacing, PreprocessConfig.train(),
                              src_shape=true_shape, dtype=torch.bfloat16)


def check_raw_kernels(dev) -> dict:
    """Phase 6: K9 against its plain version at the shipped raw and
    at a bucketed raw, then timed (x2 cycled past the L2 cache) beside its
    plain version and the shipped front end for the same work (the torch
    stage 3 in fp32, window, mask, bf16 cast and K1)."""
    import torch

    from ctpa_torch.core.config import CTViTConfig
    from ctpa_torch.ops import resample_patchify as rp
    from ctpa_torch.ops.patchify import patchify_project
    from ctpa_torch.ops.preprocess import resample_stage3

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    bf16 = torch.bfloat16
    cfg = CTViTConfig()
    pt, p, dim, pd = cfg.temporal_patch_size, cfg.patch_size, cfg.dim, cfg.patch_dim
    g = (1 + 0.1 * torch.randn(pd, generator=gen, device=dev)).to(bf16)
    K = (0.02 * torch.randn(pd, dim, generator=gen, device=dev)).to(bf16)
    for label, raw_shape, true_shape, spacing in (
            ("shipped", RAW_SHAPE, None, RAW_SPACING),
            ("bucketed", BUCKET_RAW_SHAPE, BUCKET_TRUE_SHAPE, BUCKET_SPACING)):
        ops = k9_operands(gen, dev, raw_shape, true_shape, spacing)
        args = (*ops[:5], g, K, pt, p, p)
        kw = dict(window=ops.window, pad_value=ops.pad_value)
        got = rp.resample3_patchify_project(*args, taps=ops.taps, **kw)
        ref = rp.resample3_patchify_project_plain(*args, **kw)
        err = compare(f"resample3_patchify_project bf16, {label} raw {raw_shape}"
                      f"{'' if true_shape is None else f' (true {true_shape})'}, x2 "
                      f"{tuple(ops.x2.shape)}", got, ref, BF16_ATOL, BF16_RTOL)
        repeatable(f"resample3_patchify_project bf16, {label} raw",
                   lambda: rp.resample3_patchify_project(*args, taps=ops.taps, **kw))
        if label == "shipped":
            shipped, k9_err = ops, err
            fault_refused("K9", "each patch's last k-block left out of its statistics",
                          lambda: rp.resample3_patchify_project(*args, taps=ops.taps, **kw),
                          lambda out: compare("resample3_patchify_project, planted fault", out,
                                              ref, BF16_ATOL, BF16_RTOL))
            # ctpa's rounding: a constant patch gets rsig * (sum(g*K) - sum(bf16(g*K)))
            pad = ~ops.vd.reshape(-1, pt).any(1)
            if pad.any() and not pad.all():
                print(f"    fully padded temporal rows {pad.nonzero().flatten().tolist()}: "
                      f"max |token| kernel {got[pad].float().abs().max().item():.4f}, plain "
                      f"{ref[pad].float().abs().max().item():.4f}; elsewhere plain "
                      f"{ref[~pad].float().abs().max().item():.4f}")
    ops = shipped
    kw = dict(window=ops.window, pad_value=ops.pad_value)
    x2s = itertools.cycle([ops.x2, ops.x2.clone()])     # 118 MB each, past the 50 MB L2

    def front_end(x2):
        video = resample_stage3(x2, *ops[1:]).to(bf16)
        return patchify_project(video, g, K, pt, p, p, out_dtype=bf16)

    ms = idle_ms(lambda: rp.resample3_patchify_project(next(x2s), *ops[1:5], g, K, pt, p, p,
                                                       taps=ops.taps, **kw))
    plain_ms = idle_ms(lambda: rp.resample3_patchify_project_plain(next(x2s), *ops[1:5], g, K, pt,
                                                                   p, p, **kw))
    front_ms = idle_ms(lambda: front_end(next(x2s)))
    taps_ms = cuda_ms(lambda: bool(rp.stage3_taps(ops.wwp)[2]))
    D, H, ws = ops.x2.shape
    W = ops.wwp.shape[0]
    t, h, w = D // pt, H // p, W // p
    nbytes = (D * H * ws * 2 + W * ws * 4 + D + H + W + pd * 2 + pd * dim * 2
              + t * h * w * dim * 2)
    flops = 2.0 * t * h * w * pd * dim
    b_ms, b_by = bound_ms(nbytes, flops)
    print(f"  resample3_patchify_project: {ms:.4f} ms (device, after an idle second)  plain "
          f"{plain_ms:.4f} ms  shipped front end (torch stage 3, window, mask, cast, K1) "
          f"{front_ms:.4f} ms  library none; taps read from the matrix with their host sync "
          f"{taps_ms:.4f} ms (the main path takes preprocess's)")
    print(f"    ptxas: {ptxas_report('resample3_patchify_project_kernel')}")
    taps_flops = 4.0 * D * H * W
    print(f"    bound {b_ms * 1e3:.1f} us ({b_by}, {b_ms / ms:.3f} of it): {nbytes / 1e6:.1f} MB "
          f"({nbytes / PEAK_BYTES * 1e6:.1f} us), projection {flops / 1e9:.1f} GFLOP bf16 "
          f"({flops / PEAK_BF16_FLOPS * 1e6:.1f} us); two-tap stage 3 {taps_flops / 1e9:.3f} "
          f"GFLOP fp32 ({taps_flops / PEAK_FP32_FLOPS * 1e6:.1f} us, beside it); a dense stage 3 "
          f"would add {2.0 * D * H * W * ws / 1e9:.1f} GFLOP")
    return {"resample3_patchify_project": dict(
        name="resample3_patchify_project", route="cuda",
        source="ctpa_torch/csrc/resample_patchify.cu",
        replaces="ctpa/ops/pallas/resample_patchify.py:114", max_abs_err=k9_err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)}


def encode_launches() -> tuple[int, int, int]:
    """(K9, K1, K2 forward) launch counts."""
    from ctpa_torch.ops.flash_attention import LAUNCHES
    from ctpa_torch.ops.patchify import patchify_project
    from ctpa_torch.ops.resample_patchify import resample3_patchify_project

    return (resample3_patchify_project.launches, patchify_project.launches,
            LAUNCHES["flash_attention_fwd"])


@contextlib.contextmanager
def planted_k9_fault(kind: str):
    """The K9 front end with a deliberate fault in what it hands the kernel:
    "taps shifted" (every stage-3 tap reads the next source column) or
    "window left out" (the HU window is not applied)."""
    from ctpa_torch.models import ctvit

    kernel = ctvit.resample3_patchify_project

    def shifted(x2, *args, taps, **kw):
        i, w = taps
        return kernel(x2, *args, taps=((i + 1).clamp(max=x2.shape[2] - 1), w), **kw)

    def no_window(*args, **kw):
        return kernel(*args, **dict(kw, window=None))

    ctvit.resample3_patchify_project = shifted if kind == "taps shifted" else no_window
    try:
        yield
    finally:
        ctvit.resample3_patchify_project = kernel


def raw_serving(model, plain, vq, clf, dev, rows: dict) -> None:
    """Phase 7: bench_torch.pipeline on the serving model's vision
    tower and latent projection, a shipped raw through each front end
    (RAW_SAMPLES timed volumes, launches counted); then the gates of the
    plain phase against the unfused plain path, for the K9 path, the K1 path
    and K9 against K1; two planted K9 faults must fail them."""
    import torch

    from bench_torch import RAW_SHAPE as BENCH_RAW, SPACING, pipeline
    from ctpa_torch.ops.flash_attention import LAUNCHES
    from ctpa_torch.ops.patchify import patchify_project
    from ctpa_torch.ops.resample_patchify import resample3_patchify_project

    def tower(m):
        return m.visual_transformer, m.to_visual_latent.weight.t()

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    raw = torch.randint(-24, 3000, BENCH_RAW, generator=gen, device=dev).to(torch.float32)
    expect = {"resample_patchify": (1, 0, model.visual_transformer.cfg.spatial_depth),
              "patchify": (0, 1, model.visual_transformer.cfg.spatial_depth)}
    for front_end in ("resample_patchify", "patchify"):
        pipeline(*tower(model), vq, raw, front_end, SPACING)          # warm-up
        samples = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resample3_patchify_project.launches = patchify_project.launches = 0
        for key in LAUNCHES:
            LAUNCHES[key] = 0
        for i in range(RAW_SAMPLES):
            r = raw + 1e-3 * (i + 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            latent = pipeline(*tower(model), vq, r, front_end, SPACING)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        launches = encode_launches()
        peak = torch.cuda.max_memory_allocated()
        if front_end == "resample_patchify":
            rows["resample3_patchify_project"]["launches"] = launches[0]
        ms = sorted(samples)
        print(f"  {front_end}: {statistics.median(ms):.3f} ms a volume (median of {len(ms)}; "
              f"{ms[0]:.3f}-{ms[-1]:.3f})  launches K9 {launches[0]} K1 {launches[1]} flash "
              f"{launches[2]}  peak memory {peak / 2**30:.2f} GiB")
        if launches != tuple(n * RAW_SAMPLES for n in expect[front_end]):
            raise AssertionError(f"{front_end}: launches (K9, K1, flash) {launches}, expected "
                                 f"{expect[front_end]} a volume")
        if latent.shape != (model.cfg.dim_latent,) or not torch.isfinite(latent).all():
            raise AssertionError(f"{front_end}: latent {tuple(latent.shape)} not finite")

    def readings(m, front_end):
        lat = pipeline(*tower(m), vq, raw, front_end, SPACING).float()
        pre = pipeline(*tower(m), None, raw, front_end, SPACING).float()
        return lat, pre, clf.score(lat[None])[0].float()

    def gate(label, got, ref) -> bool:
        dp = (got[2] - ref[2]).abs().max().item()
        cos_vq = torch.nn.functional.cosine_similarity(got[0], ref[0], dim=0).item()
        cos_pre = torch.nn.functional.cosine_similarity(got[1], ref[1], dim=0).item()
        print(f"  {label}: max |prob diff| {dp:.3e} (<= {PROB_ATOL})  latent cos {cos_vq:.6f} "
              f"(>= {VQ_LATENT_MIN_COS})  un-quantized latent cos {cos_pre:.6f} "
              f"(>= {PREVQ_LATENT_MIN_COS})")
        return dp <= PROB_ATOL and cos_vq >= VQ_LATENT_MIN_COS and cos_pre >= PREVQ_LATENT_MIN_COS

    unfused = readings(plain, "patchify")
    k9, k1 = readings(model, "resample_patchify"), readings(model, "patchify")
    print("    probabilities (K9 path) " + " ".join(f"{x:.4f}" for x in k9[2].tolist()))
    passed = [gate("K9 path vs unfused plain path", k9, unfused),
              gate("K1 path vs unfused plain path", k1, unfused),
              gate("K9 path vs K1 path", k9, k1)]
    if not all(passed):
        raise AssertionError("raw-serving: a front end disagrees with the unfused plain path")
    for kind in ("taps shifted", "window left out"):
        with planted_k9_fault(kind):
            if gate(f"planted fault ({kind}) vs unfused plain path",
                    readings(model, "resample_patchify"), unfused):
                raise AssertionError(f"raw-serving: the planted K9 fault ({kind}) passes the gates")


TRAIN_KERNELS = ("flash_attention_fwd_lse", "flash_attention_bwd_delta", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "flash_attention_bwd_dbias")
ATTN_FAMILY = ("fmha", "flash", "attention", "attn", "cudnn", "sdp")
# each training flash kernel's source and the TPU kernel it replaces
FLASH_SOURCES = {
    "flash_attention_fwd_lse": ("ctpa_torch/csrc/flash_attention.cu",
                                "ctpa/ops/pallas/flash_attention.py:270"),
    "flash_attention_bwd_delta": ("ctpa_torch/csrc/flash_attention_bwd.cu",
                                  "ctpa/ops/pallas/flash_attention.py:597"),
    "flash_attention_bwd_dq": ("ctpa_torch/csrc/flash_attention_bwd.cu",
                               "ctpa/ops/pallas/flash_attention.py:505"),
    "flash_attention_bwd_dkv": ("ctpa_torch/csrc/flash_attention_bwd.cu",
                                "ctpa/ops/pallas/flash_attention.py:451"),
    "flash_attention_bwd_dbias": ("ctpa_torch/csrc/flash_attention_bwd.cu",
                                  "ctpa/ops/pallas/flash_attention.py:550")}


def sdpa_backend(fn) -> str:
    """The CUDA kernels one call of ``fn`` launches whose names look like
    attention, from a profiler trace; "not seen" when the trace has none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({ev.name for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA
                    and any(w in ev.name.lower() for w in ATTN_FAMILY)})
    return "; ".join(n[:90] for n in names) or "not seen"


def sdpa_backward(forward, leaves, do):
    """The backward alone of one library attention call, as a function:
    ``torch.autograd.grad`` of its retained graph (``forward()``'s output)
    into ``leaves``.  K3's yardstick, never called by the port."""
    import torch

    o = forward()
    return lambda: torch.autograd.grad(o, leaves, grad_outputs=do, retain_graph=True)


def check_train_kernels(dev) -> dict:
    """Phase 8: K2 with its logsumexp and the four K3 passes against their
    plain versions at the training shapes, then timed (bf16, CPB-shaped
    bias (h, n, m), flat softmax: the spatial fold's case)."""
    import torch
    import torch.nn.functional as F

    from ctpa_torch.core.config import CTViTConfig
    from ctpa_torch.ops import flash_attention as fa
    from ctpa_torch.ops.attention_ops import l2norm

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    bf16 = torch.bfloat16
    cfg = CTViTConfig()
    b, heads, n, d = TRAIN_BATCH * cfg.temporal_tokens, cfg.heads, cfg.spatial_tokens, cfg.dim_head
    scale = 8.0

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def inputs(n_q, bias_form, dtype):
        q = l2norm(randn(b, heads, n_q, d)).to(dtype)
        k = l2norm(randn(b, heads, n, d)).to(dtype)
        v, do = randn(b, heads, n, d).to(dtype), randn(b, heads, n_q, d).to(dtype)
        shape = {"h": (heads, n_q, n), "1": (1, n_q, n), "bh": (b, heads, n_q, n)}
        bias = None if bias_form is None else (0.5 * randn(*shape[bias_form])).to(dtype)
        return q, k, v, bias, do

    cases = [("bias (h,n,m), bound", n, "h", True), ("bias (1,n,m), bound", n, "1", True),
             ("bias (b,h,n,m), bound", n, "bh", True), ("bias (h,n,m), online softmax", n, "h", False),
             ("no bias, online softmax", n, None, False),
             (f"ragged n={RAGGED_N}, bias (h,n,m), bound", RAGGED_N, "h", True)]
    errs = {}
    for dtype, atol, rtol in ((bf16, BF16_ATOL, BF16_RTOL), (torch.float32, FP32_ATOL, FP32_RTOL)):
        for label, n_q, form, with_bound in cases:
            q, k, v, bias, do = inputs(n_q, form, dtype)
            lb = (scale + bias.max().float()) if with_bound else None
            tag = f"{dtype} {label}"
            out, lse = fa.flash_attention(q, k, v, bias=bias, scale=scale, logit_bound=lb,
                                          return_lse=True)
            ref_out, ref_lse = fa.flash_attention_plain(q, k, v, bias, scale, lb, return_lse=True)
            e = {"fwd": compare(f"flash_attention_fwd_lse out {tag}", out, ref_out, atol, rtol),
                 "lse": compare(f"flash_attention_fwd_lse lse {tag}", lse, ref_lse,
                                LSE_ATOL, LSE_RTOL)}
            delta = fa.flash_attention_bwd_delta(out, do)
            e["delta"] = compare(f"flash_attention_bwd_delta {tag}", delta,
                                 fa.flash_attention_bwd_delta_plain(out, do), FP32_ATOL, FP32_RTOL)
            args = (q, k, v, bias, lse, delta, do, scale)
            e["dq"] = compare(f"flash_attention_bwd_dq {tag}", fa.flash_attention_bwd_dq(*args),
                              fa.flash_attention_bwd_dq_plain(*args), atol, rtol)
            (dk, dv), (rdk, rdv) = fa.flash_attention_bwd_dkv(*args), fa.flash_attention_bwd_dkv_plain(*args)
            e["dkv"] = max(compare(f"flash_attention_bwd_dkv dk {tag}", dk, rdk, atol, rtol),
                           compare(f"flash_attention_bwd_dkv dv {tag}", dv, rdv, atol, rtol))
            if bias is not None:
                e["dbias"] = compare(f"flash_attention_bwd_dbias {tag}",
                                     fa.flash_attention_bwd_dbias(*args),
                                     fa.flash_attention_bwd_dbias_plain(*args), atol, rtol)
            if dtype == bf16 and label == cases[0][0]:
                errs = e
            del q, k, v, bias, do, out, lse, ref_out, ref_lse, delta, args

    # timing at the spatial fold's case, bf16
    q, k, v, bias, do = inputs(n, "h", bf16)
    lb = scale + bias.max().float()
    out, lse = fa.flash_attention(q, k, v, bias=bias, scale=scale, logit_bound=lb, return_lse=True)
    delta = fa.flash_attention_bwd_delta(out, do)
    args = (q, k, v, bias, lse, delta, do, scale)
    timed = {
        "flash_attention_fwd_lse": (
            lambda: fa.flash_attention(q, k, v, bias=bias, scale=scale, logit_bound=lb,
                                       return_lse=True),
            lambda: fa.flash_attention_plain(q, k, v, bias, scale, lb, return_lse=True)),
        "flash_attention_bwd_delta": (lambda: fa.flash_attention_bwd_delta(out, do),
                                      lambda: fa.flash_attention_bwd_delta_plain(out, do)),
        "flash_attention_bwd_dq": (lambda: fa.flash_attention_bwd_dq(*args),
                                   lambda: fa.flash_attention_bwd_dq_plain(*args)),
        "flash_attention_bwd_dkv": (lambda: fa.flash_attention_bwd_dkv(*args),
                                    lambda: fa.flash_attention_bwd_dkv_plain(*args)),
        "flash_attention_bwd_dbias": (lambda: fa.flash_attention_bwd_dbias(*args),
                                      lambda: fa.flash_attention_bwd_dbias_plain(*args)),
    }
    for name in TRAIN_KERNELS[1:]:
        repeatable(f"{name} bf16 bias (h,n,m)", timed[name][0])
    # yardsticks, never called by the port: the library forward, its forward
    # plus backward with a bias that requires grad, and that backward alone
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, bias[None])]

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3], scale=scale)
        torch.autograd.grad(o, leaves, grad_outputs=do)

    lib_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                                                scale=scale))
    lib_fwd_bwd_ms = cuda_ms(sdpa_fwd_bwd)
    lib_bwd = sdpa_backward(
        lambda: F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3], scale=scale),
        leaves, do)
    lib_bwd_ms = cuda_ms(lib_bwd)
    backend = sdpa_backend(sdpa_fwd_bwd)
    print(f"  scaled_dot_product_attention forward {lib_fwd_ms:.4f} ms, forward+backward "
          f"{lib_fwd_bwd_ms:.4f} ms, backward alone {lib_bwd_ms:.4f} ms (device "
          f"{device_ms(lib_bwd):.4f}; bias requires grad); its kernels: {backend}")

    # bytes each function must move and the operations it does (bf16 = 2 bytes)
    qkv = b * heads * n * d * 2                       # one of q, k, v, out, dO, dq, ...
    rowf = b * heads * n * 4                          # one fp32 (b, h, n) row vector
    slab = heads * n * n * 2                          # the (h, n, m) bias
    prod = 2.0 * b * heads * n * n * d                # one (n, m, d) product, all slabs
    work = {"flash_attention_fwd_lse": (4 * qkv + slab + rowf + 4, 2 * prod),
            "flash_attention_bwd_delta": (2 * qkv + rowf, 2.0 * b * heads * n * d),
            "flash_attention_bwd_dq": (5 * qkv + slab + 2 * rowf, 3 * prod),
            "flash_attention_bwd_dkv": (6 * qkv + slab + 2 * rowf, 4 * prod),
            "flash_attention_bwd_dbias": (4 * qkv + 2 * slab + 2 * rowf, 2 * prod)}
    err_key = {"flash_attention_fwd_lse": "fwd", "flash_attention_bwd_delta": "delta",
               "flash_attention_bwd_dq": "dq", "flash_attention_bwd_dkv": "dkv",
               "flash_attention_bwd_dbias": "dbias"}
    rows = {}
    for name in TRAIN_KERNELS:
        kernel_fn, plain_fn = timed[name]
        ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn)
        b_ms, b_by = bound_ms(*work[name])
        lib_ms = lib_fwd_ms if name == "flash_attention_fwd_lse" else lib_bwd_ms
        source, replaces = FLASH_SOURCES[name]
        rows[name] = dict(name=name, route="cuda", source=source, replaces=replaces,
                          max_abs_err=max(errs[err_key[name]], errs["lse"])
                          if name == "flash_attention_fwd_lse" else errs[err_key[name]],
                          ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=lib_ms)
        print(f"  {name}: {ms:.4f} ms (device {device_ms(kernel_fn):.4f})  plain "
              f"{plain_ms:.4f} ms  bound {b_ms * 1e3:.1f} us "
              f"({b_by}: {work[name][0] / 1e6:.1f} MB, {work[name][1] / 1e9:.2f} GFLOP)  "
              f"library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}")
    k3 = sum(rows[name]["ms"] for name in TRAIN_KERNELS[1:])
    print(f"  K3 in all (delta + dq + dkv + dbias): {k3:.4f} ms; scaled_dot_product_attention "
          f"backward {lib_bwd_ms:.4f} ms, forward+backward {lib_fwd_bwd_ms:.4f} ms")
    return rows


def spatial_fold_grads(model) -> dict:
    """Gradients of the parameters whose gradient passes through the flash
    kernels: the spatial fold's attention projections and scales and the
    CPB MLP.  The CPB's to_heads.bias is left out: it shifts every logit of
    a head alike, so softmax ignores it and its gradient is zero up to
    rounding noise."""
    out = {}
    for name, p in model.named_parameters():
        attn = "enc_spatial_transformer" in name and any(
            key in name for key in ("attn.to_q", "attn.to_kv", "attn.q_scale", "attn.k_scale"))
        if attn or ("spatial_rel_pos_bias" in name and not name.endswith("to_heads.bias")):
            out[name] = p.grad.detach().float().clone()
    return out


def build_training(dev, flash_axial: bool):
    """CTCLIP at the shipped geometry for training: fp32 parameters, block
    remat, the plain patch embed (the patchify kernel is forward-only)."""
    import torch

    from ctpa_torch.core.config import BertConfig, CTCLIPConfig, CTViTConfig
    from ctpa_torch.models.ctclip import CTCLIP

    vit_cfg = dataclasses.replace(CTViTConfig(), flash_axial=flash_axial, pallas_patchify=False)
    return CTCLIP(CTCLIPConfig(), vit_cfg, BertConfig(), device=dev, dtype=torch.float32,
                  remat=True)


def make_train_batch(model, dev) -> dict:
    """2 synthetic raw (160, 512, 512) volumes at two spacings, preprocessed
    on the card by preprocess_batch, and random 512-token reports."""
    import torch

    from ctpa_torch.core.config import PreprocessConfig
    from ctpa_torch.ops.preprocess import preprocess_batch

    vit_cfg = model.visual_transformer.cfg
    grid = (vit_cfg.temporal_size, vit_cfg.image_size, vit_cfg.image_size)
    cfg = dataclasses.replace(PreprocessConfig.train(), target_shape=grid)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    raws = torch.randint(-24, 3000, (TRAIN_BATCH,) + RAW_SHAPE, generator=gen,
                         device=dev).to(torch.float32)
    video = preprocess_batch(raws, [1.0] * TRAIN_BATCH, [-1024.0] * TRAIN_BATCH,
                             TRAIN_SPACINGS, cfg, device=dev)
    vocab = model.text_transformer.cfg.vocab_size
    ids = torch.randint(1, vocab, (TRAIN_BATCH, TEXT_LEN), generator=gen, device=dev)
    return {"input_ids": ids, "attention_mask": torch.ones_like(ids), "video": video}


def train(dev, rows: dict):
    """Phase 9: 4 steps through CTClipTrainer.  Returns the first step's loss,
    its spatial-fold gradients, the initial parameters and VQ state, and the
    batch."""
    import torch

    from ctpa_torch.core.config import OptimizerConfig, TrainConfig
    from ctpa_torch.core.init import random_init_
    from ctpa_torch.ops.flash_attention import LAUNCHES
    from ctpa_torch.ops.vq import VQState, vq_init
    from ctpa_torch.train.clip_trainer import CTClipTrainer
    from ctpa_torch.train.optim import get_optimizer
    from ctpa_torch.train.train_state import CLIPTrainState

    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = random_init_(build_training(dev, flash_axial=True), gen)
    vit_cfg = model.visual_transformer.cfg
    vq = vq_init(gen, vit_cfg.codebook_size, vit_cfg.dim, device=dev)
    start = ({k: v.clone() for k, v in model.state_dict().items()},
             VQState(*(t.clone() for t in vq)))
    batch = make_train_batch(model, dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  CTCLIP: {n_params / 1e6:.1f} M parameters (fp32), batch {TRAIN_BATCH}, "
          f"video {tuple(batch['video'].shape)}, text {tuple(batch['input_ids'].shape)}")
    # each step sees the batch with a small shift of the volumes, as
    # bench_clip_train.py does
    loader = (dict(batch, video=batch["video"] + 1e-3 * i) for i in itertools.count())
    cfg = TrainConfig(precision="bf16", results_dir="build/chip_smoke/results",
                      checkpoint_dir="build/chip_smoke/checkpoints")
    opt_cfg = OptimizerConfig()
    state = CLIPTrainState.create(model, get_optimizer(opt_cfg, model), vq)
    trainer = CTClipTrainer(model, state, loader, cfg=cfg, opt_cfg=opt_cfg)
    expect = dict.fromkeys(LAUNCHES, 0)
    expect["flash_attention_fwd_lse"] = 2 * vit_cfg.spatial_depth     # remat runs it twice
    for name in TRAIN_KERNELS[1:]:
        expect[name] = vit_cfg.spatial_depth
    torch.cuda.synchronize()
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    first = None
    for i in range(TRAIN_STEPS):
        before = dict(LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = trainer.train_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m = {k: float(v) for k, v in metrics.items()}
        launched = {key: LAUNCHES[key] - before[key] for key in LAUNCHES}
        print(f"  step {i}: wall {wall * 1e3:.1f} ms  loss {m['loss']:.6f}  grad norm "
              f"{m['grad_norm']:.6f}  temperature {m['temperature']:.6f}  vq commit "
              f"{m['vq_commit']:.6f}  peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        print("    launches " + " ".join(f"{k.removeprefix('flash_attention_')} {v}"
                                         for k, v in launched.items()))
        if not math.isfinite(m["loss"]) or not m["grad_norm"] > 0:
            raise AssertionError(f"step {i}: loss {m['loss']}, grad norm {m['grad_norm']}")
        if launched != expect:
            raise AssertionError(f"step {i}: launches {launched}, expected {expect}")
        if i == 0:
            first = (m["loss"], spatial_fold_grads(model))
    print(f"  main path ({TRAIN_STEPS} steps): " + " ".join(
        f"{k} {LAUNCHES[k]}" for k in TRAIN_KERNELS))
    for name in TRAIN_KERNELS:
        rows[name]["launches"] = LAUNCHES[name]
        if LAUNCHES[name] == 0:
            raise AssertionError(f"{name} never launched on the training path")
    return first, start, batch


def train_plain(dev, first, start, batch) -> None:
    """Phase 10: the first step from the same state with flash_axial off."""
    import torch

    from ctpa_torch.core.config import OptimizerConfig
    from ctpa_torch.core.precision import Policy
    from ctpa_torch.ops.flash_attention import LAUNCHES
    from ctpa_torch.train.clip_trainer import make_clip_train_step
    from ctpa_torch.train.optim import get_optimizer
    from ctpa_torch.train.train_state import CLIPTrainState

    params, vq = start
    model = build_training(dev, flash_axial=False)
    model.load_state_dict(params)
    tx = get_optimizer(OptimizerConfig(), model)
    step = make_clip_train_step(model, tx, vq_decay=model.visual_transformer.cfg.vq_decay,
                                policy=Policy())
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    _, m = step(CLIPTrainState.create(model, tx, vq), batch)
    torch.cuda.synchronize()
    if any(LAUNCHES.values()):
        raise AssertionError(f"the plain path launched hand kernels: {LAUNCHES}")
    loss_k, grads_k = first
    loss_p = float(m["loss"])
    print(f"  loss: kernel path {loss_k:.6f}, plain path {loss_p:.6f}, |diff| "
          f"{abs(loss_k - loss_p):.3e} (<= {TRAIN_LOSS_ATOL})")
    worst = 1.0
    for name, g in spatial_fold_grads(model).items():
        cos = torch.nn.functional.cosine_similarity(grads_k[name].flatten(), g.flatten(),
                                                    dim=0).item()
        worst = min(worst, cos)
        print(f"  grad cos {cos:.6f}  {name}")
    print(f"  spatial-fold gradients: min cosine {worst:.6f} (>= {TRAIN_GRAD_MIN_COS}) over "
          f"{len(grads_k)} tensors")
    if abs(loss_k - loss_p) > TRAIN_LOSS_ATOL or worst < TRAIN_GRAD_MIN_COS:
        raise AssertionError("training step: kernel path and plain path disagree")


def decode_cache(gen, dev, cfg, b: int, m: int, kvh: int, quant: bool):
    """A full stacked cache (L, b, kvh, m, hd) of random rows, bf16 or int8
    with its fp32 scales."""
    import torch

    shape = (cfg.num_layers, b, kvh, m, cfg.head_dim)
    if not quant:
        return (*(torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2)), None, None)
    rows = [torch.randint(-127, 128, shape, generator=gen, device=dev).to(torch.int8)
            for _ in range(2)]
    scales = [0.001 + 0.02 * torch.rand(shape[:4], generator=gen, device=dev) for _ in range(2)]
    return (*rows, *scales)


def prompt_validity(dev, m: int):
    """(4, m) slot validity after the main path's prefill: each lane's real
    prompt slots, the pads between them and slot 512 invalid, the decode
    slots valid."""
    import torch

    n = max(PROMPT_LENS)
    slot = torch.arange(m, device=dev)
    lens = torch.tensor(PROMPT_LENS, device=dev)
    return (slot[None] < lens[:, None]) | (slot[None] >= n)


def check_report_kernels(dev) -> dict:
    """Phase 11: K8 against its plain version at the decode shape of
    Meditron-7B (a 608-slot cache): b 4 with a bf16 cache, with holes, with
    an int8 cache and GQA rep 4, b 32 (the quant headline's prompts repeated)
    with int8 and bf16 caches; each form called twice for bits; the kernel
    with its planted fault (KERNEL_FAULTS["K8"]) refused by the gate.  Then
    each of the b 4 / b 32, bf16 / int8 caches timed after an idle second,
    call and device time, cycling over the 32 layers (so each launch reads
    planes that are not in the L2 cache, as on the decode path), beside the
    plain version, scaled_dot_product_attention (float caches) and the
    bound."""
    import torch
    import torch.nn.functional as F

    from ctpa_torch.core.config import LLMConfig
    from ctpa_torch.ops import decode_attention as da

    cfg = LLMConfig()
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    m, h, hd, L, kvh = max(PROMPT_LENS) + NEW_TOKENS, cfg.num_heads, cfg.head_dim, \
        cfg.num_layers, cfg.num_kv_heads
    scale = hd ** -0.5
    b4, b32 = len(PROMPT_LENS), QUANT_B32
    holes = {b4: prompt_validity(dev, m), b32: prompt_validity(dev, m).repeat(b32 // b4, 1)}
    qs = {b: torch.randn(b, h, hd, generator=gen, device=dev).to(torch.bfloat16) for b in (b4, b32)}

    def cycled(fn):
        it = itertools.cycle(range(L))
        return lambda: fn(next(it))

    errs, timed = {}, {}
    # (label, batch, kv heads, int8 cache, all slots valid, timed)
    for label, b, heads, quant, full, timing in (
            ("b 4 bf16 full", b4, kvh, False, True, False),
            ("b 4 bf16", b4, kvh, False, False, True),
            ("b 4 int8", b4, kvh, True, False, True),
            ("b 4 bf16 GQA rep 4", b4, kvh // 4, False, False, False),
            ("b 32 int8", b32, kvh, True, False, True),
            ("b 32 bf16", b32, kvh, False, False, True)):
        ck, cv, ks, vs = decode_cache(gen, dev, cfg, b, m, heads, quant)
        q, valid = qs[b], torch.ones_like(holes[b]) if full else holes[b]

        def kernel(i):
            return da.decode_attention(q, ck, cv, valid, i, ks, vs, scale)

        def plain(i):
            return da.decode_attention_plain(q, ck, cv, valid, i, ks, vs, scale)

        splits = da.split_count(b * heads, m, hd, torch.cuda.get_device_properties(0)
                                .multi_processor_count)
        print(f"  {label}: b {b}, h {h}, kvh {heads}, m {m}, hd {hd}, "
              f"{int(valid.sum().item())} of {b * m} slots valid, clusters of {splits}")
        for layer in (0, L - 1):
            errs[label, layer] = compare(f"decode_attention {label}, layer {layer}",
                                         kernel(layer), plain(layer), BF16_ATOL, BF16_RTOL)
        repeatable(f"decode_attention {label}", lambda: kernel(L - 1))
        if label == "b 4 bf16":
            ref = plain(L - 1)
            fault_refused("K8", "the cluster merge one rank short", lambda: kernel(L - 1),
                          lambda got: compare("decode_attention with the planted fault", got, ref,
                                              BF16_ATOL, BF16_RTOL))
        if timing:
            n_valid = int(valid.sum().item())
            rows_ = n_valid * heads
            io = 2 * b * h * hd * 2 + b * m               # q and out in bf16, valid
            nbytes = 2 * rows_ * hd + 2 * rows_ * 4 if quant else 2 * rows_ * hd * 2
            # the kernel loads the K and V rows (and scales) of the valid
            # slots only, so the bound counts this run's valid rows
            bound = bound_ms(nbytes + io, 4.0 * n_valid * h * hd)
            call_ms = cuda_ms(cycled(kernel), iters=2 * L)
            dev_ms = idle_ms(cycled(kernel), iters=2 * L)
            plain_ms = cuda_ms(cycled(plain), iters=4, warmup=1)
            lib_ms = None
            if not quant:
                # yardstick only, never called by the port
                lib_ms = idle_ms(cycled(lambda i: F.scaled_dot_product_attention(
                    q[:, :, None], ck[i], cv[i], attn_mask=valid[:, None, None, :],
                    scale=scale)), iters=2 * L)
            timed[label] = (call_ms, dev_ms, plain_ms, bound, lib_ms)
        del ck, cv, ks, vs
        torch.cuda.empty_cache()
    for label, (call_ms, dev_ms, plain_ms, (b_ms, b_by), lib_ms) in timed.items():
        print(f"  decode_attention {label} cache: {call_ms:.4f} ms a call, device {dev_ms:.4f} "
              f"ms ({b_ms / dev_ms:.2f} of the bound {b_ms * 1e3:.2f} us, {b_by})  plain "
              f"{plain_ms:.4f} ms  library "
              f"{'%.4f ms (scaled_dot_product_attention)' % lib_ms if lib_ms else 'none'}")
    _, dev_ms, plain_ms, (b_ms, b_by), lib_ms = timed["b 4 bf16"]
    return {"decode_attention": dict(
        name="decode_attention", route="cuda", source="ctpa_torch/csrc/decode_attention.cu",
        replaces="ctpa/ops/pallas/decode_attention.py:124", max_abs_err=max(errs.values()),
        ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)}


def report_inputs(vit_cfg, llm_cfg, dev):
    """4 inference-path volumes preprocessed on the device and 4 prompts
    right-padded to 512 tokens, all from a seeded generator."""
    import torch

    from ctpa_torch.core.config import PreprocessConfig
    from ctpa_torch.ops.preprocess import preprocess_volume_inference

    grid = (vit_cfg.temporal_size, vit_cfg.image_size, vit_cfg.image_size)
    cfg = dataclasses.replace(PreprocessConfig.inference(), target_shape=grid)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    video = torch.stack([
        preprocess_volume_inference(torch.rand(INFER_SHAPE, generator=gen, device=dev) * 2 - 1,
                                    cfg, device=dev) for _ in PROMPT_LENS]).to(torch.bfloat16)
    n = max(PROMPT_LENS)
    mask = (torch.arange(n, device=dev)[None] < torch.tensor(PROMPT_LENS, device=dev)[:, None])
    ids = torch.randint(1, llm_cfg.vocab_size, (len(PROMPT_LENS), n), generator=gen, device=dev)
    return video, ids * mask, mask.long()


def twin(model, vit_cfg=None, **llm_changes):
    """A CTReportGenerator on the same tensors (no copy), computing in the same
    dtype, with other LLM settings (and another CTViT configuration)."""
    from ctpa_torch.models.layers import set_compute_dtype
    from ctpa_torch.models.report_generator import CTReportGenerator

    out = CTReportGenerator(dataclasses.replace(model.llm_cfg, **llm_changes),
                            vit_cfg or model.vit_cfg, model.gen_cfg, device="meta")
    out.load_state_dict(model.state_dict(), assign=True)
    return set_compute_dtype(out, getattr(model, "compute_dtype", None)).eval()


def step_timer(model):
    """CUDA events recorded at the start of every trunk call (prefill, then
    one per decode step) and once at the end: step times on the device's
    clock, each including the host's gaps."""
    import torch

    events = []

    def mark(*_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    handle = model.llm.model.register_forward_pre_hook(mark)
    return events, mark, handle


def report(dev, rows: dict):
    """Phase 12: CTReportGenerator at Meditron-7B width on the kernel path."""
    import torch

    from ctpa_torch.core.config import CTViTConfig, LLMConfig, ReportGenConfig
    from ctpa_torch.core.init import random_init_
    from ctpa_torch.models.report_generator import CTReportGenerator
    from ctpa_torch.ops import decode_attention as da
    from ctpa_torch.ops.patchify import patchify_project

    llm_cfg = dataclasses.replace(LLMConfig(), flash_decode=True)
    vit_cfg = dataclasses.replace(CTViTConfig(), pallas_patchify=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    model = random_init_(CTReportGenerator(llm_cfg, vit_cfg, ReportGenConfig(), device=dev,
                                           dtype=torch.bfloat16), gen).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  CTReportGenerator: {n_params / 1e9:.3f} B parameters (bf16) built on the card "
          f"in {time.perf_counter() - t0:.1f} s")
    video, ids, mask = report_inputs(vit_cfg, llm_cfg, dev)
    b, n = ids.shape
    layers = llm_cfg.num_layers
    with torch.inference_mode():
        model.generate(video[:1], ids[:1, :8], mask[:1, :8], 2, -1, greedy=True)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events, mark, handle = step_timer(model)
        patchify_project.launches = 0
        da.LAUNCHES["decode_attention"] = 0
        mark()
        # no EOS and no pad id: a slot left unfilled reads -1, and a
        # generated id 0 counts as a token
        res = model.generate(video, ids, mask, NEW_TOKENS, eos_token_id=-1, pad_token_id=-1,
                             greedy=True)
        mark()
        torch.cuda.synchronize()
        handle.remove()
        k1, k8 = patchify_project.launches, da.LAUNCHES["decode_attention"]
    ms = [a.elapsed_time(z) for a, z in zip(events, events[1:])]
    vision_ms, prefill_ms, steps = ms[0], ms[1], sorted(ms[2:])
    decode_s = sum(steps) / 1e3
    print(f"  generate: vision {vision_ms:.2f} ms  prefill ({b} x {n}) {prefill_ms:.2f} ms  "
          f"decode step median {steps[len(steps) // 2]:.3f} ms (min {steps[0]:.3f}, max "
          f"{steps[-1]:.3f}, {len(steps)} steps)  {b * len(steps) / decode_s:.1f} tokens/s  "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  main path launches: patchify_project {k1}, decode_attention {k8} "
          f"({layers} layers x {NEW_TOKENS - 1} steps = {layers * (NEW_TOKENS - 1)})")
    tokens = res.tokens
    if tokens.shape != (b, NEW_TOKENS) or not ((tokens >= 0) & (tokens < llm_cfg.vocab_size)).all() \
            or not (res.lengths == NEW_TOKENS).all():
        raise AssertionError(f"generate: tokens {tuple(tokens.shape)}, lengths {res.lengths}")
    if k1 != b or k8 != layers * (NEW_TOKENS - 1):
        raise AssertionError(f"launches: patchify {k1} (expected {b}), decode_attention {k8} "
                             f"(expected {layers * (NEW_TOKENS - 1)})")
    # the patchify_project row keeps the serving path's count; this path's
    # (4) is printed and checked above
    rows["decode_attention"]["launches"] = k8
    print("  tokens lane 0: " + " ".join(map(str, tokens[0, :24].tolist())) + " ...")

    int8 = twin(model, kv_quant="int8")
    with torch.inference_mode():
        da.LAUNCHES["decode_attention"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res8 = int8.generate(video, ids, mask, INT8_NEW_TOKENS, eos_token_id=-1,
                             pad_token_id=-1, greedy=True)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k8_int8 = da.LAUNCHES["decode_attention"]
    same = (res8.tokens == tokens[:, :INT8_NEW_TOKENS]).float().mean().item()
    print(f"  int8 KV cache: {INT8_NEW_TOKENS} tokens in {wall * 1e3:.1f} ms, decode_attention "
          f"launches {k8_int8}; tokens equal to the bf16 cache's on {same:.1%} of positions")
    if k8_int8 != layers * (INT8_NEW_TOKENS - 1) or not (res8.lengths == INT8_NEW_TOKENS).all():
        raise AssertionError(f"int8 KV cache: launches {k8_int8}, lengths {res8.lengths}")
    return model, (video, ids, mask), tokens


def teacher_forced_logits(model, video, ids, mask, tokens, vision=None, steps=None):
    """The fused logits generate computes at each of its steps, with
    ``tokens`` (b, steps) fed back in: (b, steps, vocab) fp32.  ``vision``:
    a vision feature to use instead of extracting one from ``video``.  With
    ``tokens`` None, generate's greedy tokens are fed back for ``steps``."""
    import torch

    from ctpa_torch.models.llm import KVCache

    b, n = ids.shape
    steps = steps if tokens is None else tokens.shape[1]
    if vision is None:
        vision = model.extract_vision(video)
    cache = KVCache.create(model.llm_cfg, b, max_len=n + steps, dtype=model.cache_dtype(),
                           device=ids.device)
    hidden, cache = model.llm.model(ids, mask, cache, shared_kv_offset=True)
    last = torch.clamp(mask.sum(-1) - 1, min=0)
    out = [model._fused_logits(hidden[torch.arange(b), last][:, None], vision)[:, 0].float()]
    for i in range(1, steps):
        fed = out[-1].argmax(-1, keepdim=True) if tokens is None else tokens[:, i - 1:i]
        hidden, cache = model.llm.model(fed, None, cache, shared_kv_offset=True)
        out.append(model._fused_logits(hidden, vision)[:, 0].float())
    return torch.stack(out, 1)


def fp32_twin(model):
    """The same weights in fp32 (a copy), flash_decode and the patchify
    kernel off: the reference both bf16 paths approximate."""
    from ctpa_torch.models.report_generator import CTReportGenerator

    out = CTReportGenerator(dataclasses.replace(model.llm_cfg, flash_decode=False),
                            dataclasses.replace(model.vit_cfg, pallas_patchify=False),
                            model.gen_cfg, device="meta")
    out.load_state_dict({k: v.float() for k, v in model.state_dict().items()}, assign=True)
    return out.eval()


def logit_distance(got, ref) -> tuple[float, float, float]:
    """(worst per-step max |diff| / max |ref logit|, mean |diff|, top-1
    agreement) of two (b, steps, vocab) teacher-forced logits."""
    diff = (got - ref).abs()
    rel = (diff.amax(dim=(0, 2)) / ref.abs().amax(dim=(0, 2))).max().item()
    return rel, diff.mean().item(), (got.argmax(-1) == ref.argmax(-1)).float().mean().item()


def report_gate(label: str, got, plain, fp32, p_f, ratio: float = REPORT_FP32_RATIO,
                slack: float = REPORT_FP32_TOP1_SLACK, top1_min: float = REPORT_TOP1_MIN) -> bool:
    """Print the distances of teacher-forced logits ``got`` to the plain
    path's and the fp32 reference's, and whether they pass the gates."""
    g_p, g_f = logit_distance(got, plain), logit_distance(got, fp32)
    ok = (g_f[0] <= ratio * p_f[0] and g_f[1] <= ratio * p_f[1]
          and g_f[2] >= p_f[2] - slack and g_p[2] >= top1_min)
    for other, (rel, mean, top1) in (("plain", g_p), ("fp32", g_f)):
        print(f"    {label + ' vs ' + other:<30} {rel:.4f}  {mean:.5f}  {top1:.4f}")
    print(f"    {label}: distance to fp32 / plain path's {g_f[0] / p_f[0]:.3f} and "
          f"{g_f[1] / p_f[1]:.3f} (<= {ratio}); top-1 with fp32 {g_f[2]:.4f} vs "
          f"{p_f[2]:.4f} (slack {slack}); top-1 with plain {g_p[2]:.4f} "
          f"(>= {top1_min}): {'pass' if ok else 'FAIL'}")
    return ok


@contextlib.contextmanager
def planted_fault(kind: str, n_prompt: int):
    """The flash_decode path with a deliberate fault in what it hands the
    kernel: "holes ignored" (the padded prompt slots count as valid) or
    "wrong layer" (layer i reads layer i + 1's planes)."""
    from ctpa_torch.models import llm

    kernel = llm.decode_attention

    def faulty(q, ck, cv, valid, layer_idx, *args, **kw):
        if kind == "holes ignored":
            valid = valid.clone()
            valid[:, :n_prompt] = True
        else:
            layer_idx = (layer_idx + 1) % ck.shape[0]
        return kernel(q, ck, cv, valid, layer_idx, *args, **kw)

    llm.decode_attention = faulty
    try:
        yield
    finally:
        llm.decode_attention = kernel


def report_plain(model, inputs, tokens) -> None:
    """Phase 13: the kernel path, the plain path and the fp32 plain path
    teacher-forced on the kernel path's tokens; then the kernel path with
    each of two planted faults, which the gates must reject."""
    import torch

    from ctpa_torch.ops import decode_attention as da

    with torch.inference_mode():
        kernel = teacher_forced_logits(model, *inputs, tokens)
        before = da.LAUNCHES["decode_attention"]
        plain = teacher_forced_logits(twin(model, flash_decode=False), *inputs, tokens)
        if da.LAUNCHES["decode_attention"] != before:
            raise AssertionError("the plain path launched the decode-attention kernel")
        reference = fp32_twin(model)
        fp32 = teacher_forced_logits(reference, *inputs, tokens)
        del reference
        faults = {}
        for kind in ("holes ignored", "wrong layer"):
            with planted_fault(kind, inputs[1].shape[1]):
                faults[kind] = teacher_forced_logits(model, *inputs, tokens)
    if not all(torch.isfinite(x).all() for x in (kernel, plain, fp32)):
        raise AssertionError("non-finite logits")
    if not torch.equal(kernel.argmax(-1), tokens):
        raise AssertionError("teacher-forced kernel path does not give back its generated tokens")
    p_f = logit_distance(plain, fp32)
    steps = tokens.shape[1]
    print(f"  fused logits over {steps} steps, {tokens.numel()} (lane, step) pairs: worst max "
          f"|diff| / max |logit| per step, mean |diff|, top-1 agreement")
    print(f"    {'plain vs fp32':<30} {p_f[0]:.4f}  {p_f[1]:.5f}  {p_f[2]:.4f}")
    if not report_gate("kernel", kernel, plain, fp32, p_f):
        raise AssertionError("report generation: the kernel path is farther from the fp32 "
                             "reference than the plain path")
    for kind, got in faults.items():
        if report_gate(f"planted fault: {kind}", got, plain, fp32, p_f):
            raise AssertionError(f"the gates do not see a planted decode-attention fault "
                                 f"({kind})")



def visited_tiles(kv_mask, causal: bool, q_offset: int, n: int, m: int, block: int = 64):
    """(forward and dQ, dK/dV) counts of the (64 query rows, 64 keys) tiles
    the head-dim-128 kernels compute for one head, summed over the batch:
    they skip the tiles past the causal diagonal and those with no real key."""
    fwd = dkv = 0
    for row in kv_mask.tolist():
        live = [any(row[j:j + block]) for j in range(0, m, block)]
        for r0 in range(0, n, block):
            end = max(0, min(m, r0 + block + q_offset)) if causal else m
            fwd += sum(live[: (end + block - 1) // block])
        for c, ok in enumerate(live):
            first = max(0, c * block - q_offset) // block * block if causal else 0
            dkv += len(range(first, n, block)) if ok else 0
    return fwd, dkv


def masked_case(gen, dev, shape, d, dtype, form, bias_form):
    """Inputs and masks of one masked form: "holes" puts a hole at key 0 (so
    with causal row 0 has no valid key) and others inside the sequence."""
    import torch

    from ctpa_torch.ops import flash_attention as fa

    b, h, n, m = shape
    q, k = (torch.randn(b, h, x, d, generator=gen, device=dev).to(dtype) for x in (n, m))
    v = torch.randn(b, h, m, d, generator=gen, device=dev).to(dtype)
    do = torch.randn(b, h, n, d, generator=gen, device=dev).to(dtype)
    bias_shape = {"h": (h, n, m), "1": (1, n, m), "bh": (b, h, n, m), None: None}[bias_form]
    bias = None if bias_shape is None else \
        (0.5 * torch.randn(bias_shape, generator=gen, device=dev)).to(dtype)
    kv = None
    if "holes" in form:
        kv = torch.rand(b, m, generator=gen, device=dev) > 0.2
        kv[:, 0] = False
        kv[-1, m // 3: m // 2] = False
    qo = int(form.split("q_offset ")[1].split()[0]) if "q_offset" in form else None
    masks = fa.make_masks(form.startswith("causal"), kv, qo, b, m, dev)
    return q, k, v, bias, do, masks


def check_masked(tag, q, k, v, bias, do, masks, scale) -> dict:
    """Each masked kernel against its plain version; their max abs errors."""
    import torch

    from ctpa_torch.ops import flash_attention as fa

    bf16 = q.dtype == torch.bfloat16
    atol, rtol = (BF16_ATOL, BF16_RTOL) if bf16 else (FP32_ATOL, FP32_RTOL)
    out, lse = fa._forward(q, k, v, bias, scale, None, True, masks)
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, bias, scale, return_lse=True,
                                                masks=masks)
    e = {"fwd": compare(f"fwd_lse out {tag}", out, ref_out, atol, rtol),
         "lse": compare(f"fwd_lse lse {tag}", lse, ref_lse, LSE_ATOL, LSE_RTOL)}
    e["fwd"] = max(e["fwd"], compare(f"fwd {tag}", fa._forward(q, k, v, bias, scale, None,
                                                               False, masks)[0],
                                     ref_out, atol, rtol))
    delta = fa.flash_attention_bwd_delta(out, do)
    e["delta"] = compare(f"bwd_delta {tag}", delta, fa.flash_attention_bwd_delta_plain(out, do),
                         FP32_ATOL, FP32_RTOL)
    args = (q, k, v, bias, lse, delta, do, scale, masks)
    e["dq"] = compare(f"bwd_dq {tag}", fa.flash_attention_bwd_dq(*args),
                      fa.flash_attention_bwd_dq_plain(*args), atol, rtol)
    (dk, dv), (rdk, rdv) = fa.flash_attention_bwd_dkv(*args), fa.flash_attention_bwd_dkv_plain(*args)
    e["dkv"] = max(compare(f"bwd_dkv dk {tag}", dk, rdk, atol, rtol),
                   compare(f"bwd_dkv dv {tag}", dv, rdv, atol, rtol))
    if bias is not None and q.shape[-1] < 128:
        e["dbias"] = compare(f"bwd_dbias {tag}", fa.flash_attention_bwd_dbias(*args),
                             fa.flash_attention_bwd_dbias_plain(*args), atol, rtol)
    return e


def check_report_train_kernels(dev) -> dict:
    """Phase 14: the masked forms of K2 and K3 against their plain versions,
    then the head-dim-128 kernels timed at report training's shape."""
    import torch
    import torch.nn.functional as F

    from ctpa_torch.core.config import LLMConfig
    from ctpa_torch.ops import flash_attention as fa

    cfg = LLMConfig()
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bf16 = torch.bfloat16
    b, h, n, d = len(TRAIN_LENS), cfg.num_heads, max(TRAIN_LENS), cfg.head_dim
    scale = d ** -0.5
    pad = torch.arange(n, device=dev)[None] < torch.tensor(TRAIN_LENS, device=dev)[:, None]
    main = fa.make_masks(True, pad, None, b, n, dev)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)

    q, k, v, do = randn(b, h, n, d), randn(b, h, n, d), randn(b, h, n, d), randn(b, h, n, d)
    errs = check_masked(f"d128 training shape {(b, h, n, d)} causal lengths {TRAIN_LENS}",
                        q, k, v, None, do, main, scale)
    # q_offset 1 puts the last causal key of a block of 64 rows on the first
    # key of a tile: an off-by-one in the tile skips shows there
    forms = ("causal", "causal q_offset 1", "causal q_offset 5", "causal q_offset -3", "holes",
             "causal holes", "causal q_offset 7 holes")
    for d_ in (16, 32, 64, 128):
        for dtype in ((bf16, torch.float32) if d_ < 128 else (bf16,)):
            for form in forms:
                for bias_form in (None, "h", "1", "bh"):
                    if bias_form not in (None, "h") and form not in ("causal holes",):
                        continue
                    case = masked_case(gen, dev, MASKED_SHAPE, d_, dtype, form, bias_form)
                    check_masked(f"d{d_} {str(dtype)[6:]} {form} bias {bias_form}", *case,
                                 d_ ** -0.5)

    # timed at the training shape
    out, lse = fa._forward(q, k, v, None, scale, None, True, main)
    delta = fa.flash_attention_bwd_delta(out, do)
    args = (q, k, v, None, lse, delta, do, scale, main)
    timed = {
        "flash_attention_fwd_lse_d128": (
            lambda: fa._forward(q, k, v, None, scale, None, True, main),
            lambda: fa.flash_attention_plain(q, k, v, None, scale, return_lse=True,
                                             masks=main)),
        "flash_attention_bwd_delta": (lambda: fa.flash_attention_bwd_delta(out, do),
                                      lambda: fa.flash_attention_bwd_delta_plain(out, do)),
        "flash_attention_bwd_dq_d128": (lambda: fa.flash_attention_bwd_dq(*args),
                                        lambda: fa.flash_attention_bwd_dq_plain(*args)),
        "flash_attention_bwd_dkv_d128": (lambda: fa.flash_attention_bwd_dkv(*args),
                                         lambda: fa.flash_attention_bwd_dkv_plain(*args)),
    }
    # yardsticks, never called by the port: the same boolean mask, and
    # is_causal without the key mask as the library's floor
    allowed = (torch.arange(n, device=dev)[None] <= torch.arange(n, device=dev)[:, None])[None]
    attn_mask = (allowed & pad[:, None, :])[:, None]             # (b, 1, n, m)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def sdpa_fwd_bwd(**kw):
        o = F.scaled_dot_product_attention(*leaves, scale=scale, **kw)
        torch.autograd.grad(o, leaves, grad_outputs=do)

    lib_bwd = sdpa_backward(lambda: F.scaled_dot_product_attention(
        *leaves, attn_mask=attn_mask, scale=scale), leaves, do)
    lib_fwd = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,  # noqa: E731
                                                     scale=scale)
    lib = {"fwd": cuda_ms(lib_fwd), "fwd device": device_ms(lib_fwd),
           "fwd_bwd": cuda_ms(lambda: sdpa_fwd_bwd(attn_mask=attn_mask)),
           "causal fwd": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                         scale=scale)),
           "causal fwd_bwd": cuda_ms(lambda: sdpa_fwd_bwd(is_causal=True)),
           "bwd": cuda_ms(lib_bwd)}
    print(f"  scaled_dot_product_attention, boolean mask: forward {lib['fwd']:.4f} ms (device "
          f"{lib['fwd device']:.4f}), "
          f"backward alone {lib['bwd']:.4f} ms (device {device_ms(lib_bwd):.4f}), "
          f"forward+backward {lib['fwd_bwd']:.4f} ms (kernels: "
          f"{sdpa_backend(lambda: sdpa_fwd_bwd(attn_mask=attn_mask))}); is_causal without the "
          f"key mask: forward {lib['causal fwd']:.4f} ms, forward+backward "
          f"{lib['causal fwd_bwd']:.4f} ms (kernels: "
          f"{sdpa_backend(lambda: sdpa_fwd_bwd(is_causal=True))})")

    fwd_tiles, dkv_tiles = visited_tiles(pad, True, 0, n, n)
    tile = 2.0 * 64 * 64 * d * h                     # one product over one tile, every head
    qkv = b * h * n * d * 2                           # one of q, out, dO, dq, dk, dv
    # one of k, v over the real keys only: no result depends on a padded key's
    live = h * d * 2 * int(pad.sum())
    rowf = b * h * n * 4
    work = {"flash_attention_fwd_lse_d128": (2 * qkv + 2 * live + rowf + b * n,
                                             2 * tile * fwd_tiles),
            "flash_attention_bwd_delta": (2 * qkv + rowf, 2.0 * b * h * n * d),
            "flash_attention_bwd_dq_d128": (3 * qkv + 2 * live + 2 * rowf + b * n,
                                            3 * tile * fwd_tiles),
            "flash_attention_bwd_dkv_d128": (4 * qkv + 2 * live + 2 * rowf + b * n,
                                             4 * tile * dkv_tiles)}
    print(f"  tiles visited per head: forward and dQ {fwd_tiles}, dK/dV {dkv_tiles} of "
          f"{b * (n // 64) ** 2}")
    fwd, bwd = "ctpa_torch/csrc/flash_attention.cu", "ctpa_torch/csrc/flash_attention_bwd.cu"
    sources = {"flash_attention_fwd_lse_d128": (fwd, "ctpa/ops/pallas/flash_attention.py:270"),
               "flash_attention_bwd_delta": (bwd, "ctpa/ops/pallas/flash_attention.py:597"),
               "flash_attention_bwd_dq_d128": (bwd, "ctpa/ops/pallas/flash_attention.py:505"),
               "flash_attention_bwd_dkv_d128": (bwd, "ctpa/ops/pallas/flash_attention.py:451")}
    repeatable("flash_attention_fwd_lse_d128 at the training shape",
               timed["flash_attention_fwd_lse_d128"][0])
    for label in ("dq", "dkv"):
        fn = getattr(fa, f"flash_attention_bwd_{label}")
        repeatable(f"flash_attention_bwd_{label}_d128 at the training shape", lambda: fn(*args))
    err_key = dict(zip(REPORT_TRAIN_KERNELS, ("fwd", "delta", "dq", "dkv")))
    rows = {}
    for name in REPORT_TRAIN_KERNELS:
        kernel_fn, plain_fn = timed[name]
        ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn)
        b_ms, b_by = bound_ms(*work[name])
        lib_ms = lib["fwd"] if name == "flash_attention_fwd_lse_d128" else lib["bwd"]
        source, replaces = sources[name]
        row = name + ("_d128" if name == "flash_attention_bwd_delta" else "")
        err = errs[err_key[name]]
        rows[row] = dict(name=row, route="cuda", source=source, replaces=replaces,
                         max_abs_err=max(err, errs["lse"]) if err_key[name] == "fwd" else err,
                         ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms)
        print(f"  {row}: {ms:.4f} ms (device {device_ms(kernel_fn):.4f})  plain "
              f"{plain_ms:.4f} ms  bound {b_ms * 1e3:.1f} us "
              f"({b_by}: {work[name][0] / 1e6:.1f} MB, {work[name][1] / 1e9:.2f} GFLOP)  "
              f"library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}")
    k3 = sum(rows[r]["ms"] for r in ("flash_attention_bwd_delta_d128",
                                     "flash_attention_bwd_dq_d128",
                                     "flash_attention_bwd_dkv_d128"))
    print(f"  K2-lse + K3 at head dim 128: {rows['flash_attention_fwd_lse_d128']['ms'] + k3:.4f} "
          f"ms (K3 {k3:.4f}); scaled_dot_product_attention backward {lib['bwd']:.4f} ms, "
          f"forward+backward {lib['fwd_bwd']:.4f} ms")

    # the masked forms at head dim 64 (K2 and K3 on the tensor cores), timed
    # for PERF.md, with bounds over what the masks leave: k and v of the real
    # keys, the bias cells some batch item reads, the products over the valid
    # cells.  The kernels and K2's yardstick take tens of microseconds: 200
    # calls each, so the card's clocks have settled
    d64, scale64 = 64, 64 ** -0.5
    q, k, v, bias, do, masks = masked_case(gen, dev, (b, h, n, n), d64, bf16, "causal holes", "h")
    out, lse = fa._forward(q, k, v, bias, scale64, None, True, masks)
    delta = fa.flash_attention_bwd_delta(out, do)
    args = (q, k, v, bias, lse, delta, do, scale64, masks)
    valid = fa._valid(masks, n, n, dev)                         # (b, 1, n, m)
    cells = h * int(valid.sum())
    qkv, live = b * h * n * d64 * 2, h * d64 * 2 * int(masks.kv_mask.sum())
    bias_read = h * int(valid.any(0).sum()) * 2
    work64 = {"fwd_lse": (2 * qkv + 2 * live + bias_read + rowf + b * n, 4 * d64 * cells),
              "bwd_dq": (3 * qkv + 2 * live + bias_read + 2 * rowf + b * n, 6 * d64 * cells),
              "bwd_dkv": (4 * qkv + 2 * live + bias_read + 2 * rowf + b * n, 8 * d64 * cells),
              "bwd_dbias": (2 * qkv + 2 * live + bias_read + h * n * n * 2 + 2 * rowf + b * n,
                            4 * d64 * cells)}
    for label, kernel_fn, plain_fn in (
            ("fwd_lse", lambda: fa._forward(q, k, v, bias, scale64, None, True, masks),
             lambda: fa.flash_attention_plain(q, k, v, bias, scale64, return_lse=True,
                                              masks=masks)),
            ("bwd_dq", lambda: fa.flash_attention_bwd_dq(*args),
             lambda: fa.flash_attention_bwd_dq_plain(*args)),
            ("bwd_dkv", lambda: fa.flash_attention_bwd_dkv(*args),
             lambda: fa.flash_attention_bwd_dkv_plain(*args)),
            ("bwd_dbias", lambda: fa.flash_attention_bwd_dbias(*args),
             lambda: fa.flash_attention_bwd_dbias_plain(*args))):
        b_ms, b_by = bound_ms(*work64[label])
        print(f"  masked flash_attention_{label} at head dim 64 ({b}, {h}, {n}, 64) bf16, "
              f"causal with holes, bias (h, n, m): {cuda_ms(kernel_fn, 200):.4f} ms (device "
              f"{device_ms(kernel_fn):.4f})  plain "
              f"{cuda_ms(plain_fn):.4f} ms  bound {b_ms * 1e3:.1f} us ({b_by}: "
              f"{work64[label][0] / 1e6:.1f} MB, {work64[label][1] / 1e9:.2f} GFLOP)")
    repeatable("masked flash_attention_bwd_delta d64",
               lambda: fa.flash_attention_bwd_delta(out, do))
    for label in ("dq", "dkv", "dbias"):
        fn = getattr(fa, f"flash_attention_bwd_{label}")
        repeatable(f"masked flash_attention_bwd_{label} d64", lambda: fn(*args))
    # yardstick: the bias and the masks as one additive float mask, which
    # does not require grad (with the -inf cells, its gradient is not d(bias))
    lib_mask = bias[None].float().masked_fill(~valid, float("-inf")).to(bf16)
    leaves64 = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def sdpa64_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves64, attn_mask=lib_mask, scale=scale64)
        torch.autograd.grad(o, leaves64, grad_outputs=do)

    fwd64 = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask,
                                                           scale=scale64), 200)
    bwd64 = sdpa_backward(lambda: F.scaled_dot_product_attention(
        *leaves64, attn_mask=lib_mask, scale=scale64), leaves64, do)
    print(f"  scaled_dot_product_attention at head dim 64, bias and masks as one float mask: "
          f"forward {fwd64:.4f} ms, backward alone {cuda_ms(bwd64, 200):.4f} ms (device "
          f"{device_ms(bwd64):.4f}; no d(bias)), "
          f"forward+backward {cuda_ms(sdpa64_fwd_bwd):.4f} ms")
    return rows


def report_train_shell(model, flash_prefill: bool):
    """The report phase's CTReportGenerator as the report CLI trains it with
    --flash-prefill, on the meta device: LoRAConfig() (rank 16, alpha 32 on
    q, k, v, o), CTViTConfig() without the patchify kernel (the CLI's)."""
    from ctpa_torch.core.config import LoRAConfig, ReportGenConfig
    from ctpa_torch.models.report_generator import CTReportGenerator

    lora = LoRAConfig()
    return CTReportGenerator(dataclasses.replace(model.llm_cfg, flash_prefill=flash_prefill,
                                                 flash_decode=False),
                             dataclasses.replace(model.vit_cfg, pallas_patchify=False),
                             ReportGenConfig(lora=lora), lora=lora, device="meta")


def report_train_start(model, dev, seed: int = SEED + 8) -> dict:
    """fp32 starting values of the trainable tensors: the cross-attention
    copied from the base, LoRA A ~ N(0, 1/rank) (ctpa's initializer) and B ~
    N(0, 2e-3) (ctpa starts B at zero, which makes A's first gradient exactly
    zero and the gradient comparison empty), drawn from ``seed``."""
    import torch

    from ctpa_torch.train.report_trainer import trainable_labels

    shell = report_train_shell(model, True)
    labels = trainable_labels(shell)
    base = model.state_dict()
    gen = torch.Generator(device=dev).manual_seed(seed)
    start = {}
    for name, p in shell.named_parameters():
        if labels[name] == "frozen":
            continue
        if name in base:
            start[name] = base[name].float().clone()
        else:
            std = 1.0 / shell.gen_cfg.lora.rank if name.endswith("lora_a") else 2e-3
            start[name] = std * torch.randn(p.shape, generator=gen, device=dev)
    return start


def report_train_model(model, start: dict, flash_prefill: bool = True):
    """A report-training model on the report phase's bf16 tensors (shared, not
    copied: the card holds one 13.5 GB base) with fp32 copies of ``start`` as
    its trainable tensors, computing in bf16 (ctpa's CLI model dtype).  ctpa
    keeps the frozen base in fp32 and casts it to bf16 at every use; storing
    it in bf16 rounds it once, which gives the same bf16 operands.  The
    trainable tensors and their AdamW moments stay fp32, as ctpa's."""
    import torch

    from ctpa_torch.models.layers import set_compute_dtype

    out = report_train_shell(model, flash_prefill)
    state = dict(model.state_dict())
    state.update({k: v.clone() for k, v in start.items()})
    out.load_state_dict(state, assign=True)
    return set_compute_dtype(out, torch.bfloat16)


def report_train_batches(vit_cfg, llm_cfg, dev, count: int, seed: int = SEED + 9) -> list:
    """``count`` batches of 2 samples: one inference-path volume each (the
    report phase's shape), token ids right-padded to 512 with real lengths
    512 and 384, drawn from ``seed``."""
    import torch

    from ctpa_torch.core.config import PreprocessConfig
    from ctpa_torch.ops.preprocess import preprocess_volume_inference

    grid = (vit_cfg.temporal_size, vit_cfg.image_size, vit_cfg.image_size)
    cfg = dataclasses.replace(PreprocessConfig.inference(), target_shape=grid)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = max(TRAIN_LENS)
    mask = (torch.arange(n, device=dev)[None] < torch.tensor(TRAIN_LENS, device=dev)[:, None])
    batches = []
    for _ in range(count):
        video = torch.stack([preprocess_volume_inference(
            torch.rand(INFER_SHAPE, generator=gen, device=dev) * 2 - 1, cfg, device=dev)
            for _ in TRAIN_LENS])
        ids = torch.randint(1, llm_cfg.vocab_size, (len(TRAIN_LENS), n), generator=gen,
                            device=dev)
        batches.append({"video": video, "input_ids": ids * mask,
                        "attention_mask": mask.long()})
    return batches


def trainable_grads(model) -> dict:
    """The LoRA and head gradients after a step (clipped in place by it)."""
    return {n: p.grad.detach().float().clone() for n, p in model.named_parameters()
            if p.requires_grad}


# kinds of kernel in a traced step, by the first pattern found in the name
# (lower case)
KERNEL_KINDS = (("flash (hand kernels)", ("flash_bwd_delta", "_mma_kernel")),
                ("GEMM", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
                ("softmax", ("softmax",)),
                ("reduction", ("reduce",)),
                ("elementwise and copies", ("elementwise", "copy", "cat", "fill", "index")))


def traced_step(step, state, batch) -> None:
    """Two more steps under ``torch.profiler`` (the first absorbs its
    start-up); prints the second's wall time, its kernels' summed device time,
    the device-busy share (their ratio: one stream), and the device time by
    kind of kernel and by kernel, largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        # user annotations (the optimizer's step range) overlap the kernels
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(ev, "is_user_annotation", False):
            per_kernel[ev.name][0] += ev.time_range.elapsed_us() / 1e3
            per_kernel[ev.name][1] += 1
    print(f"  traced step: wall {wall_ms:.3f} ms")
    if not per_kernel:
        print("  device time: not measured (the trace holds no CUDA kernels)")
        return
    device_ms = sum(ms for ms, _ in per_kernel.values())
    print(f"  device time {device_ms:.3f} ms in {sum(n for _, n in per_kernel.values())} "
          f"launches; device busy {100 * device_ms / wall_ms:.1f}% of the step")
    per_kind = collections.defaultdict(lambda: [0.0, 0])
    for name, (ms, n) in per_kernel.items():
        kind = next((k for k, pats in KERNEL_KINDS if any(p in name.lower() for p in pats)),
                    "other")
        per_kind[kind][0] += ms
        per_kind[kind][1] += n
    for label, table, top in (("kind", per_kind, None), ("kernel", per_kernel, 15)):
        print(f"    device ms  launches  share  {label}")
        for name, (ms, n) in sorted(table.items(), key=lambda kv: -kv[1][0])[:top]:
            print(f"    {ms:9.3f} {n:9d} {100 * ms / device_ms:5.1f}%  {name[:100]}")


def report_train(dev, rows: dict, model):
    """Phase 15: the LoRA fine-tune on the kernel path.  Returns the trainable
    tensors' start, the first step's loss and gradients, and its batch."""
    import torch

    from ctpa_torch.core.config import TrainConfig
    from ctpa_torch.ops.flash_attention import LAUNCHES
    from ctpa_torch.train.report_trainer import ReportTrainer, make_partitioned_report_step
    from ctpa_torch.train.train_state import SimpleTrainState

    start = report_train_start(model, dev)
    twin = report_train_model(model, start)
    total = REPORT_TRAIN_STEPS + REPORT_EPOCH_BATCHES
    step, tx = make_partitioned_report_step(twin, twin.gen_cfg, total_steps=total)
    batches = report_train_batches(model.vit_cfg, model.llm_cfg, dev, total)
    n_train = sum(p.numel() for p in tx.params)
    print(f"  CTReportGenerator with LoRA: {sum(p.numel() for p in twin.parameters()) / 1e9:.3f} "
          f"B parameters, {n_train / 1e6:.2f} M trainable (fp32; {len(tx.params)} tensors); "
          f"batch {tuple(batches[0]['input_ids'].shape)}, video "
          f"{tuple(batches[0]['video'].shape)}")
    layers = model.llm_cfg.num_layers
    expect = dict.fromkeys(LAUNCHES, 0)
    for name in REPORT_TRAIN_KERNELS:
        expect[name] = layers
    state = SimpleTrainState.create(twin, tx)
    torch.cuda.synchronize()
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    walls, first = [], None
    for i in range(REPORT_TRAIN_STEPS):
        before = dict(LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        launched = {key: LAUNCHES[key] - before[key] for key in LAUNCHES}
        print(f"  step {i}: wall {walls[-1] * 1e3:.1f} ms  loss {loss:.6f}  grad norm "
              f"{norm:.6f}  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        print("    launches " + " ".join(f"{k.removeprefix('flash_attention_')} {v}"
                                         for k, v in launched.items() if v))
        if not math.isfinite(loss) or not norm > 0:
            raise AssertionError(f"step {i}: loss {loss}, grad norm {norm}")
        if launched != expect:
            raise AssertionError(f"step {i}: launches {launched}, expected {expect}")
        if i == 0:
            first = (loss, trainable_grads(twin))
    shutil.rmtree(REPORT_CKPT_DIR, ignore_errors=True)
    trainer = ReportTrainer(twin, state, tx, cfg=TrainConfig(
        results_dir="build/chip_smoke/report_results", checkpoint_dir=REPORT_CKPT_DIR),
        step_fn=step)
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    res = trainer.train_epoch(iter(batches[REPORT_TRAIN_STEPS:]), epoch=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trainer.close()
    launched = {key: LAUNCHES[key] - before[key] for key in LAUNCHES}
    saved = trainer.ckpt.all_steps()
    print(f"  ReportTrainer.train_epoch over {REPORT_EPOCH_BATCHES} batches: {wall * 1e3:.1f} ms "
          f"(checkpoint write included), mean loss {res['mean_loss']:.6f}, best-by-loss "
          f"checkpoint at step {saved}")
    if trainer.state.step != total or saved != [total] or not math.isfinite(res["mean_loss"]) \
            or launched != {k: v * REPORT_EPOCH_BATCHES for k, v in expect.items()}:
        raise AssertionError(f"train_epoch: step {trainer.state.step}, checkpoints {saved}, "
                             f"mean loss {res['mean_loss']}, launches {launched}")
    traced_step(step, trainer.state, batches[0])
    rest = sorted(walls[1:])
    print(f"  step time: first {walls[0] * 1e3:.1f} ms, then median "
          f"{rest[len(rest) // 2] * 1e3:.1f} ms (min {rest[0] * 1e3:.1f}, max "
          f"{rest[-1] * 1e3:.1f}, {len(rest)} steps)")
    print(f"  main path ({total + 2} steps): " + " ".join(f"{k} {LAUNCHES[k]}"
                                                         for k in REPORT_TRAIN_KERNELS))
    for name in REPORT_TRAIN_KERNELS:
        row = name + ("_d128" if name == "flash_attention_bwd_delta" else "")
        rows[row]["launches"] = LAUNCHES[name]
        if LAUNCHES[name] == 0:
            raise AssertionError(f"{name} never launched on the report training path")
    del trainer, state, twin, tx, step
    return start, first, batches[0]


@contextlib.contextmanager
def planted_flash_fault(kind: str, module=None):
    """A flash path with a deliberate fault in what it hands the kernels, in
    ``module`` (by default the LLM's flash prefill, ``models.llm``): "q_offset
    1" (each query sees the next token too), "causal off" (every query sees
    every real key), "causal on" (each query sees only the keys up to its
    own position: a non-causal fold made causal) or "last FUSED_FAULT_ROWS
    keys masked" (a biased call's bias hides the last keys of each slab, as
    a kernel that skips its last key tile would)."""
    import torch

    from ctpa_torch.models import llm

    module = module or llm
    kernel = module.flash_attention

    def faulty(*args, **kw):
        if kind == "q_offset 1":
            kw["q_offset"] = 1
        elif kind == f"last {FUSED_FAULT_ROWS} keys masked":
            skipped = torch.zeros(kw["bias"].shape[-1], dtype=torch.bool,
                                  device=kw["bias"].device)
            skipped[-FUSED_FAULT_ROWS:] = True
            kw["bias"] = kw["bias"].masked_fill(skipped, -3e4)
        else:
            kw["causal"] = kind == "causal on"
        return kernel(*args, **kw)

    module.flash_attention = faulty
    try:
        yield
    finally:
        module.flash_attention = kernel


def report_train_gate(label: str, loss, grads, ref_loss, ref_grads) -> bool:
    """Print the loss difference and the worst gradient cosine of a first
    step against the dense path's, and whether they pass the gates.  The
    cross-attention's q and k get exactly zero gradients on both paths (a
    softmax over one key): those must stay zero, the rest are held by
    cosine."""
    import torch

    zero = [n for n, g in ref_grads.items() if not g.any()]
    cos = {n: torch.nn.functional.cosine_similarity(g.flatten(), ref_grads[n].flatten(),
                                                    dim=0).item()
           for n, g in grads.items() if n not in zero}
    worst = min(cos, key=cos.get)
    head = [c for n, c in cos.items() if "cross_attention" in n]
    ok = (abs(loss - ref_loss) <= REPORT_TRAIN_LOSS_ATOL and cos[worst] >= REPORT_TRAIN_GRAD_MIN_COS
          and not any(grads[n].any() for n in zero))
    print(f"    {label}: loss {loss:.6f} vs {ref_loss:.6f}, |diff| {abs(loss - ref_loss):.3e} "
          f"(<= {REPORT_TRAIN_LOSS_ATOL}); gradient cosine min {cos[worst]:.6f} "
          f"(>= {REPORT_TRAIN_GRAD_MIN_COS}; {worst}), median "
          f"{sorted(cos.values())[len(cos) // 2]:.6f}, head min {min(head):.6f} over "
          f"{len(cos)} tensors, {len(zero)} zero on both: {'pass' if ok else 'FAIL'}")
    return ok


def report_train_plain(dev, model, start, first, batch) -> None:
    """Phase 16: the first step from the same state on the dense path, then
    the kernel path with each of two planted faults, which the gates must
    reject; then the kernel and dense paths from further seeded states and
    batches, which the gates must pass."""
    import torch

    from ctpa_torch.ops.flash_attention import LAUNCHES
    from ctpa_torch.train.report_trainer import make_partitioned_report_step
    from ctpa_torch.train.train_state import SimpleTrainState

    def first_step(flash_prefill: bool, start, batch):
        twin = report_train_model(model, start, flash_prefill)
        step, tx = make_partitioned_report_step(twin, twin.gen_cfg, total_steps=1)
        _, m = step(SimpleTrainState.create(twin, tx), batch)
        torch.cuda.synchronize()
        return float(m["loss"]), trainable_grads(twin)

    for key in LAUNCHES:
        LAUNCHES[key] = 0
    ref_loss, ref_grads = first_step(False, start, batch)
    if any(LAUNCHES.values()):
        raise AssertionError(f"the dense path launched flash kernels: {LAUNCHES}")
    if not report_train_gate("kernel path", *first, ref_loss, ref_grads):
        raise AssertionError("report training: the kernel path and the dense path disagree")
    for kind in ("q_offset 1", "causal off"):
        with planted_flash_fault(kind):
            faulty = first_step(True, start, batch)
        if report_train_gate(f"planted fault: {kind}", *faulty, ref_loss, ref_grads):
            raise AssertionError(f"the gates do not see a planted flash fault ({kind})")
    for seed in REPORT_TRAIN_SOUND_SEEDS:
        start = report_train_start(model, dev, seed=SEED + seed)
        batch = report_train_batches(model.vit_cfg, model.llm_cfg, dev, 1, seed=SEED + seed)[0]
        if not report_train_gate(f"kernel path, seed {SEED + seed}",
                                 *first_step(True, start, batch),
                                 *first_step(False, start, batch)):
            raise AssertionError(f"report training: the kernel path and the dense path "
                                 f"disagree from seed {SEED + seed}")


# ------------------------------------------------------------------ int4 serving

def _quant_copies(gen, dev, d_in: int, d_out: int):
    """Seeded int4 weights (in/2, out) with their scales: enough copies to
    pass 150 MB, so timed launches that cycle over them read from memory, as
    the decode path does, not from the 50 MB L2 cache."""
    import torch

    from ctpa_torch.ops.quant import quantize_int4

    copies = min(32, max(2, math.ceil(150e6 / (d_in * d_out / 2))))
    return [quantize_int4(0.02 * torch.randn(d_in, d_out, generator=gen, device=dev))
            for _ in range(copies)]


def int4pack_yardstick(w4, scale):
    """The same int4 values re-packed for ``torch._weight_int4pack_mm``
    (unsigned nibbles q + 8 of the (out, in) weight, zero points 0, bf16
    scales), timed beside K5 and never called by the port."""
    import torch

    from ctpa_torch.ops.quant import GROUP, _unpack_int4

    d_in = w4.shape[0] * 2
    q = (_unpack_int4(w4, GROUP).reshape(d_in, -1).T.to(torch.int32) + 8).contiguous()
    packed = torch._convert_weight_to_int4pack((q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8), 8)
    sz = torch.stack([scale, torch.zeros_like(scale)], dim=-1).to(torch.bfloat16).contiguous()
    return lambda x: torch._weight_int4pack_mm(x, packed, GROUP, sz)


QUANT_FORMS = (("int4_matmul", False, "ctpa/ops/quant.py:315", "ctpa_torch/csrc/int4_matmul.cu"),
               ("int4_matmul_a8", True, "ctpa/ops/quant.py:722", "ctpa_torch/csrc/int4_matmul.cu"),
               ("int4_ffn", False, "ctpa/ops/quant.py:610", "ctpa_torch/csrc/int4_ffn.cu"),
               ("int4_ffn_a8", True, "ctpa/ops/quant.py:651", "ctpa_torch/csrc/int4_ffn.cu"))


def a8_atol_needed(got, ref) -> float:
    """The least atol, as a share of max|ref|, with which |got - ref| <=
    atol * max|ref| + QUANT_A8_RTOL |ref|."""
    got, ref = got.float(), ref.float()
    need = ((got - ref).abs() - QUANT_A8_RTOL * ref.abs()).max().item()
    return need / max(ref.abs().max().item(), 1e-30)


def quant_check(errs: dict, name: str, a8: bool, label: str, got, ref) -> None:
    """A quantized kernel form against its plain version: bf16's bound, or
    with int8 activations QUANT_A8_ATOL max|p| + QUANT_A8_RTOL |p| (and the
    atol it needed printed); the largest error kept in ``errs``."""
    tol = (BF16_ATOL, BF16_RTOL)
    if a8:
        print(f"    {name} {label}: atol needed beside rtol 2^-7, as a share of max|p|: "
              f"{a8_atol_needed(got, ref):.3e}")
        tol = (QUANT_A8_ATOL * ref.float().abs().max().item(), QUANT_A8_RTOL)
    errs[name] = max(errs[name], compare(f"{name} {label}", got, ref, *tol))


def check_quant_kernels(dev) -> dict:
    """Phase 17: the four K5 and K7 forms against their plain versions at the
    shapes int4 serving gives them at Meditron-7B width (decode at batch 4
    and 32, 33 and 128 rows, prefill of 4 x 512 tokens, and a ragged case),
    then timed beside the plain version, the bound and, for K5 w4,
    torch._weight_int4pack_mm (K5's prefill forms also beside dense bf16
    torch.matmul); the batch-32 prefill (32 x 512 rows) checked untimed.
    The w4a8 forms are held to QUANT_A8_ATOL max|p| + QUANT_A8_RTOL |p|,
    which ctpa's per-row xla FFN must fail.  K5's and K7's decode kernels
    (batch 4 and 32) and prefill kernels (2,048 rows) are called twice for
    bits, and a threshold table times the decode kernels beside the prefill
    kernels at 4-33 rows; the planted K5 and K7 faults (FAULT_BUILDS, one in
    each design) must fail their gates."""
    import torch

    from ctpa_torch.core.config import LLMConfig
    from ctpa_torch.ops import quant

    cfg = LLMConfig()
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    d, i, vocab = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    prefill = len(PROMPT_LENS) * max(PROMPT_LENS)
    prefill_b32 = QUANT_B32 * max(PROMPT_LENS)
    decode = len(PROMPT_LENS)
    # (label, in, out, timed row counts, checked-only row counts); generate's
    # lm_head sees one row a sequence, a full forward (training, scoring)
    # every prompt row
    # the decode kernel's last row count checked, the prefill kernel's first
    # timed
    edge = quant.STREAM_MAX_ROWS
    rows_timed = (decode, QUANT_B32, edge + 1, 128, prefill)
    matmuls = (("qkv_proj", d, qkv, rows_timed, (prefill_b32, edge)),
               ("o_proj", d, d, rows_timed, (prefill_b32,)),
               ("lm_head", d, vocab, (decode, QUANT_B32, prefill), ()),
               ("ragged", d, 1000, (5,), (prefill + 5,)))
    errs = collections.defaultdict(float)
    table = {}
    bf16 = torch.bfloat16

    def check(name, a8, label, got, ref):
        quant_check(errs, name, a8, label, got, ref)

    for label, d_in, d_out, timed, checked in matmuls:
        weights = _quant_copies(gen, dev, d_in, d_out)
        library = [int4pack_yardstick(*w) for w in weights]
        n_g = d_in // quant.GROUP
        for m in timed + checked:
            x = torch.randn(m, d_in, generator=gen, device=dev).to(bf16)
            for name, a8, _, _ in QUANT_FORMS[:2]:
                w4, s = weights[0]
                check(kernel_key(name, m), a8, f"{label} m {m}",
                      quant.int4_matmul(x, w4, s, act_quant=a8),
                      quant.int4_matmul_plain(x, w4, s, act_quant=a8))
                if m not in timed:
                    continue
                if m in (decode, QUANT_B32, prefill):
                    repeatable(f"{name} {label} m {m}",
                               lambda: quant.int4_matmul(x, w4, s, act_quant=a8))
                it = itertools.cycle(weights)
                fn = lambda: quant.int4_matmul(x, *next(it), act_quant=a8)  # noqa: E731
                ms, dev_ms = cuda_ms(fn, iters=2 * len(weights)), device_ms(fn, 2 * len(weights))
                plain_ms = cuda_ms(lambda: quant.int4_matmul_plain(x, *next(it), act_quant=a8),
                                   iters=3, warmup=1)
                nbytes = m * d_in * 2 + d_in // 2 * d_out + n_g * d_out * 4 + m * d_out * 2
                b_ms, b_by = bound_ms(nbytes, 2.0 * m * d_in * d_out,
                                      PEAK_INT8_OPS if a8 else PEAK_BF16_FLOPS)
                lib_ms = lib_dev = None
                if not a8:
                    lib_it = itertools.cycle(library)
                    lib_fn = lambda: next(lib_it)(x)  # noqa: E731
                    lib_ms, lib_dev = (cuda_ms(lib_fn, iters=2 * len(weights)),
                                       device_ms(lib_fn, 2 * len(weights)))
                    diff = (library[0](x).float() - quant.int4_matmul(x, w4, s).float()).abs()
                    lib_note = (f"{lib_ms:.4f} ms, device {lib_dev:.4f} (_weight_int4pack_mm; "
                                f"max |diff| to the kernel {diff.max().item():.3e})")
                else:
                    lib_note = "none"
                if m > edge:
                    lib_note += f"; {dense_yardstick(x, weights, quant.dequantize_int4)}"
                table[name, label, m] = (ms, plain_ms, b_ms, b_by, lib_ms)
                print(f"    {name} {label} (m {m}, {d_in} -> {d_out}, "
                      f"{quant.int4_matmul_plan_on(x, d_out, quant.GROUP, a8)}):"
                      f" {ms:.4f} ms (device {dev_ms:.4f})  plain {plain_ms:.4f} ms  bound "
                      f"{b_ms * 1e3:.2f} us ({b_by})  library {lib_note}")
        if label in ("qkv_proj", "o_proj"):
            threshold_table("K5", lambda x, w, a8: quant.int4_matmul(x, *w, act_quant=a8),
                            weights, d_in, (4, 16, 32, 33), ("w4", "w4a8"))
        if label == "qkv_proj":
            x = torch.randn(prefill, d_in, generator=gen, device=dev).to(bf16)
            plain = quant.int4_matmul_plain(x, *weights[0], act_quant=True)
            fault_refused("K5 prefill", "sx of the pair's other token",
                          lambda: quant.int4_matmul(x, *weights[0], act_quant=True),
                          lambda got: quant_check(collections.defaultdict(float),
                                                  "int4_matmul_a8", True,
                                                  f"{label} m {prefill}, planted fault", got,
                                                  plain))
        del weights, library
    rows_act = check_act_quant(gen, dev, d, (decode, QUANT_B32, prefill))
    ffn = _ffn_copies(gen, dev, d, i)
    n_gh, n_gi = d // quant.GROUP, i // quant.GROUP
    per_row = {}
    for m in (decode, QUANT_B32, edge + 1, 128, prefill, 5, prefill_b32):
        x = torch.randn(m, d, generator=gen, device=dev).to(bf16)
        for name, a8, _, _ in QUANT_FORMS[2:]:
            plain = quant.int4_ffn_plain(x, *ffn[0], act_quant=a8)
            quant_check(errs, kernel_key(name, m), a8, f"m {m}",
                        quant.int4_ffn(x, *ffn[0], act_quant=a8), plain)
            if a8 and m in (decode, prefill):
                per_row[m] = a8_atol_needed(quant.int4_ffn(x, *ffn[0], impl="xla", act_quant=True),
                                            plain)
                print(f"    ctpa's xla FFN (h requantized per full row) against it: atol needed "
                      f"{per_row[m]:.3e} of max|p| (must pass {QUANT_A8_ATOL})")
            if m == prefill_b32:
                continue
            it = itertools.cycle(ffn)
            fn = lambda: quant.int4_ffn(x, *next(it), act_quant=a8)  # noqa: E731
            ms, dev_ms = cuda_ms(fn, iters=2 * len(ffn)), device_ms(fn, 2 * len(ffn))
            plain_ms = cuda_ms(lambda: quant.int4_ffn_plain(x, *next(it), act_quant=a8), iters=3,
                               warmup=1)
            nbytes = (m * d * 2 * 2 + 3 * d * i // 2 + 2 * n_gh * i * 4 + n_gi * d * 4)
            b_ms, b_by = bound_ms(nbytes, 6.0 * m * d * i, PEAK_INT8_OPS if a8 else PEAK_BF16_FLOPS)
            table[name, "ffn", m] = (ms, plain_ms, b_ms, b_by, None)
            print(f"    {name} (m {m}, {d} -> {i} -> {d}, "
                  f"{quant.int4_ffn_plan_on(x, i, quant.GROUP, a8)}): {ms:.4f} ms (device "
                  f"{dev_ms:.4f})  plain {plain_ms:.4f} ms  bound {b_ms * 1e3:.2f} us ({b_by})  "
                  f"library none")
    # K7: two calls give the same bits (decode and prefill kernels); the
    # decode kernels beside the prefill kernels forced at decode rows; the
    # planted faults fail the gate
    for m in (decode, QUANT_B32, prefill):
        x = torch.randn(m, d, generator=gen, device=dev).to(bf16)
        for name, a8, _, _ in QUANT_FORMS[2:]:
            repeatable(f"{name} {'decode' if m <= edge else 'prefill'} kernels m {m}",
                       lambda: quant.int4_ffn(x, *ffn[0], act_quant=a8))
    threshold_table("K7", lambda x, w, a8: quant.int4_ffn(x, *w, act_quant=a8), ffn, d,
                    (decode, QUANT_B32), ("w4", "w4a8"))
    x = torch.randn(decode, d, generator=gen, device=dev).to(bf16)
    plain = quant.int4_ffn_plain(x, *ffn[0], act_quant=True)
    fault_refused("K7", "row max over 128 columns",
                  lambda: quant.int4_ffn(x, *ffn[0], act_quant=True),
                  lambda got: quant_check(collections.defaultdict(float), "int4_ffn_a8", True,
                                          f"m {decode}, planted fault", got, plain))
    x = torch.randn(prefill, d, generator=gen, device=dev).to(bf16)
    plain = quant.int4_ffn_plain(x, *ffn[0])
    fault_refused("K7 prefill", "last k-step of each half group dropped",
                  lambda: quant.int4_ffn(x, *ffn[0]),
                  lambda got: quant_check(collections.defaultdict(float), "int4_ffn", False,
                                          f"m {prefill}, planted fault", got, plain))
    del ffn
    check_a8_bound_sees_j_blocks(per_row)
    rows = kernel_rows(QUANT_FORMS, table, errs, decode, prefill)
    rows.update(rows_act)
    return rows


def kernel_key(name: str, m: int) -> str:
    """A K4-K7 form's key in the error tables and the kernels' rows, its
    launch counter's (``ops/quant.py:kernel_name``): the prefill kernels
    (above STREAM_MAX_ROWS rows) apart from the decode kernels."""
    from ctpa_torch.ops import quant

    return quant.kernel_name(name, m)


PREFILL_SOURCE = "ctpa_torch/csrc/prefill_wgmma.cuh"


def kernel_rows(forms, table, errs, decode: int, prefill: int) -> dict:
    """The kernels' table rows at the main path's most frequent call (the
    fused qkv_proj for K4 and K5, the FFN for K6 and K7): the decode kernels
    at batch 4, and the prefill kernels ("<form>_prefill",
    prefill_wgmma.cuh) at 4 x 512 rows."""
    rows = {}
    for name, _, replaces, source in forms:
        shape = "ffn" if "ffn" in name else "qkv_proj"
        keys = [(name, source, shape, decode), (f"{name}_prefill", PREFILL_SOURCE, shape, prefill)]
        for key, src, shape, m in keys:
            ms, plain_ms, b_ms, b_by, lib_ms = table[name, shape, m]
            rows[key] = dict(name=key, route="cuda", source=src, replaces=replaces,
                             max_abs_err=errs[key], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib_ms)
    return rows


def threshold_table(kernel: str, call, weights, d_in: int, row_counts, forms) -> None:
    """A decode kernel (K4, K5 or K7) beside its prefill kernel at each row
    count, each forced by ``quant.STREAM_MAX_ROWS`` (0 sends every call to
    the prefill kernel): ``call(x, weights[j], a8)`` for the forms
    (weight-only, int8 activations), cycling the weights past the L2 cache.
    Above 32 rows, which the decode kernels do not take, the decode side is
    one call on each chunk of 32 rows."""
    import torch

    from ctpa_torch.ops import quant

    keep = quant.STREAM_MAX_ROWS
    dev = weights[0][0].device
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    try:
        for m in row_counts:
            x = torch.randn(m, d_in, generator=gen, device=dev).to(torch.bfloat16)
            chunks = [x[r:r + keep] for r in range(0, m, keep)]
            for form, a8 in zip(forms, (False, True)):
                times = {}
                for kind, limit, parts in (("stream", keep, chunks), ("wgmma", 0, [x])):
                    quant.STREAM_MAX_ROWS = limit
                    it = itertools.cycle(weights)

                    def fn():
                        w = next(it)
                        for part in parts:
                            call(part, w, a8)

                    kind = kind if len(parts) == 1 else f"stream ({len(parts)} calls)"
                    times[kind] = (cuda_ms(fn, iters=2 * len(weights)),
                                   device_ms(fn, 2 * len(weights)))
                print(f"    threshold {kernel}: m {m} {d_in} -> {weights[0][0].shape[1]} "
                      f"{form}: " + ", ".join(
                          f"{k} {ms:.4f} ms (device {dv:.4f})" for k, (ms, dv) in times.items()))
    finally:
        quant.STREAM_MAX_ROWS = keep


def dense_yardstick(x, weights, dequantize) -> str:
    """Dense bf16 ``torch.matmul`` of x with the first weight dequantized, a
    yardstick for the prefill kernels (not the same function, and never
    called by the port): its time, cycling over two copies."""
    dense = [dequantize(*w) for w in weights[:2]]
    it = itertools.cycle(dense)
    fn = lambda: x @ next(it)  # noqa: E731
    return f"dense bf16 torch.matmul {cuda_ms(fn, iters=4):.4f} ms, device {device_ms(fn, 4):.4f}"


def single_ms(fn) -> float:
    """One call's time by CUDA events (for a yardstick too slow to repeat)."""
    import torch

    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e)


def check_act_quant(gen, dev, d: int, row_counts) -> dict:
    """w4a8's activation quantization (one launch) bit for bit against
    ``quantize_act_int8`` at each row count, repeatable, and timed at the
    first (decode at batch 4) beside the plain version; no single library
    call computes it."""
    import torch

    from ctpa_torch.ops import quant

    for m in row_counts:
        x = torch.randn(m, d, generator=gen, device=dev).to(torch.bfloat16)
        got, ref = quant._quantize_act_kernel(x), quant.quantize_act_int8(x)
        same = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1].reshape(-1))
        print(f"  int4_act_quant m {m}: x8 and sx {'bitwise equal' if same else 'differ'} to "
              f"quantize_act_int8 (x8 off at {int((got[0] != ref[0]).sum())} places, sx at "
              f"{int((got[1] != ref[1].reshape(-1)).sum())})")
        if not same:
            raise AssertionError(f"int4_act_quant m {m}: not quantize_act_int8's bits")
        repeatable(f"int4_act_quant m {m}", lambda: quant._quantize_act_kernel(x))
    x = torch.randn(row_counts[0], d, generator=gen, device=dev).to(torch.bfloat16)
    fn = lambda: quant._quantize_act_kernel(x)  # noqa: E731
    ms, dev_ms = cuda_ms(fn, 200), device_ms(fn, 200)
    plain_fn = lambda: quant.quantize_act_int8(x)  # noqa: E731
    plain_ms, plain_dev = cuda_ms(plain_fn, 200), device_ms(plain_fn, 200)
    m = row_counts[0]
    b_ms, b_by = bound_ms(m * d * 2 + m * d + m * 4, 4.0 * m * d)
    print(f"  int4_act_quant (m {m}, {d}): {ms:.4f} ms (device {dev_ms:.4f})  plain "
          f"quantize_act_int8 {plain_ms:.4f} ms (device {plain_dev:.4f})  bound "
          f"{b_ms * 1e3:.3f} us ({b_by})  library none")
    return {"int4_act_quant": dict(
        name="int4_act_quant", route="cuda", source="ctpa_torch/csrc/int4_matmul.cu",
        replaces="ctpa/ops/quant.py:164 (quantize_act_int8, XLA before _q4_kernel_a8 at :722)",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None)}


def check_a8_bound_sees_j_blocks(per_row: dict) -> None:
    """The bound of the int8-activation forms must refuse an FFN that
    requantizes h per full row at every shape it was tried: else it cannot
    tell the j-block rule."""
    if not per_row or min(per_row.values()) <= QUANT_A8_ATOL:
        raise AssertionError(f"the int8-activation bound (atol {QUANT_A8_ATOL}) passes per-row "
                             f"requantization: atol needed {per_row}")


def _ffn_copies(gen, dev, d: int, i: int):
    import torch

    from ctpa_torch.ops.quant import quantize_int4

    copies = min(32, max(2, math.ceil(150e6 / (1.5 * d * i))))
    out = []
    for _ in range(copies):
        ws = []
        for a, b in ((d, i), (d, i), (i, d)):
            ws += list(quantize_int4(0.02 * torch.randn(a, b, generator=gen, device=dev)))
        out.append(ws)
    return out


def quant_launches() -> dict:
    from ctpa_torch.ops import decode_attention as da
    from ctpa_torch.ops import quant

    return {**quant.LAUNCHES, "decode_attention": da.LAUNCHES["decode_attention"]}


# ------------------------------------------------------------------ int8 serving

QUANT8_FORMS = (("int8_matmul", False, "ctpa/ops/quant.py:180", "ctpa_torch/csrc/int8_matmul.cu"),
                ("int8_matmul_a8", True, "ctpa/ops/quant.py:201", "ctpa_torch/csrc/int8_matmul.cu"),
                ("int8_ffn", False, "ctpa/ops/quant.py:455", "ctpa_torch/csrc/int8_ffn.cu"),
                ("int8_ffn_a8", True, "ctpa/ops/quant.py:485", "ctpa_torch/csrc/int8_ffn.cu"))


def _int8_copies(gen, dev, shapes) -> list:
    """Seeded int8 weights and their per-column scales, [w8, s, ...] for each
    (in, out) of ``shapes``: enough copies to pass 150 MB, so timed launches
    that cycle over them read from memory, not from the 50 MB L2 cache."""
    import torch

    from ctpa_torch.ops.quant import quantize_int8

    copies = min(32, max(2, math.ceil(150e6 / sum(a * b for a, b in shapes))))
    return [[t for a, b in shapes
             for t in quantize_int8(0.02 * torch.randn(a, b, generator=gen, device=dev))]
            for _ in range(copies)]


def int8_yardstick(a8: bool, weights: list, x):
    """One PyTorch call beside K4, never called by the port, cycling over
    ``weights``: for w8a8 ``torch._int_mm`` on the per-token int8 x (padded
    to 32 rows: it takes m > 16) -> int32 sums without the scaling; for w8
    ``torch._weight_int8pack_mm`` (x, the (out, in) weight, bf16 scales)
    where the card's PyTorch has a CUDA kernel for it.  -> (callable or None,
    a note for the log)."""
    import torch

    from ctpa_torch.ops.quant import quantize_act_int8

    if a8:
        x8 = quantize_act_int8(x)[0]
        x8 = torch.cat([x8, x8.new_zeros(max(0, 32 - x8.shape[0]), x8.shape[1])])
        calls = [lambda w=w: torch._int_mm(x8, w) for w, _ in weights]
        name = "_int_mm, int32 unscaled"
    else:
        packed = [(w.T.contiguous(), s.to(torch.bfloat16)) for w, s in weights]
        calls = [lambda w=w, s=s: torch._weight_int8pack_mm(x, w, s) for w, s in packed]
        name = "_weight_int8pack_mm"
    try:
        calls[0]()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        return None, f"none ({name} raised on torch {torch.__version__}: {str(exc)[:80]})"
    it = itertools.cycle(calls)
    return (lambda: next(it)()), name


# Planted faults in the kernels themselves: each source with its fault (in
# it or in a header it includes) is compiled into a library of its own in the
# background from phase build (one nvcc each) and swapped in for one call,
# which the kernel's gate must refuse.  {fault: (source, the file changed,
# (text, faulty text), entry points)}
#   K1: the staging writes each patch row's 16-byte chunk q where chunk q + 1
#       belongs in the 128-byte swizzle (patchify.cu);
#   K9: each patch's last k-block is left out of its LayerNorm sums
#       (resample_patchify.cu);
#   K6: the w8a8 decode requantization of h takes its row maximum over 128 of
#       a j-block's 256 columns, so the other half's larger values clip;
#   K7: the same in the w4a8 decode gate/up kernel;
#   K4: the cluster's sum leaves one split's sums out;
#   K6 prefill: the w8a8 prefill gate/up kernel's row maximum over one
#       consumer warpgroup's 128 columns of the j-block (prefill_wgmma.cuh);
#   K7 prefill: the w4 prefill kernels drop the last k-step of each half of
#       a scale group (prefill_wgmma.cuh);
#   K4 prefill: the projection kernel reads each column's scale from its
#       pair's other column (w8, w8a8; prefill_wgmma.cuh);
#   K5 prefill: the projection kernel scales each token by its pair's other
#       token's row scale (w4a8; prefill_wgmma.cuh);
#   K8: rank 0's merge of the cluster stops one rank short, so the last
#       block's slots add nothing (decode_attention.cu).
KERNEL_FAULTS = {
    "K1": ("patchify.cu", "patchify.cu",
           ("swizzle128(s * geo.w + wi, 16 * q)) =\n",
            "swizzle128(s * geo.w + wi, 16 * ((q + 1) & 7))) =\n"),
           ("patchify_project_launch",)),
    "K9": ("resample_patchify.cu", "resample_patchify.cu",
           ("          sum[s] += y[e];\n          sq[s] += y[e] * y[e];",
            "          sum[s] += (kb + 1) * kKB < geo.pd ? y[e] : 0.f;\n"
            "          sq[s] += (kb + 1) * kKB < geo.pd ? y[e] * y[e] : 0.f;"),
           ("resample3_patchify_project_launch",)),
    "K6": ("int8_ffn.cu", "int8_ffn.cu",
           ("      for (int w = 1; w < kGuWarps; ++w) mx = fmaxf(mx, red[w]);",
            "      for (int w = 1; w < kGuWarps / 2; ++w) mx = fmaxf(mx, red[w]);"),
           ("int8_ffn_stream_launch", "int8_ffn_stream_clusters")),
    "K7": ("int4_ffn.cu", "int4_ffn.cu",
           ("      for (int w = 1; w < kBJ / 32; ++w) mx = fmaxf(mx, red[sub][w]);",
            "      for (int w = 1; w < kBJ / 64; ++w) mx = fmaxf(mx, red[sub][w]);"),
           ("int4_ffn_stream_launch", "int4_ffn_stream_clusters")),
    "K4": ("int8_matmul.cu", "int8_matmul.cu",
           ("wstream::split_sum(cluster, part, tok * kSBN + cl, splits);",
            "wstream::split_sum(cluster, part, tok * kSBN + cl, splits - 1);"),
           ("int8_matmul_stream_launch", "int8_matmul_stream_clusters")),
    "K6 prefill": ("int8_ffn.cu", "prefill_wgmma.cuh",
                   ("      for (int k = 1; k < 8; ++k) m = fmaxf(m, red[k][tl]);",
                    "      for (int k = 1; k < 4; ++k) m = fmaxf(m, red[k][tl]);"),
                   ("int8_ffn_prefill_launch",)),
    "K7 prefill": ("int4_ffn.cu", "prefill_wgmma.cuh",
                   ("      for (int kk = 0; kk < G / 2; kk += 16) {",
                    "      for (int kk = 0; kk < G / 2 - 16; kk += 16) {"),
                   ("int4_ffn_prefill_launch",)),
    "K4 prefill": ("int8_matmul.cu", "prefill_wgmma.cuh",
                   ("cs[q] = !F::int4 && col + q < a.n ? a.scale[col + q] : 0.f;",
                    "cs[q] = !F::int4 && col + q < a.n ? a.scale[col + (q ^ 1)] : 0.f;"),
                   ("int8_matmul_prefill_launch", "int8_matmul_prefill_clusters")),
    "K5 prefill": ("int4_matmul.cu", "prefill_wgmma.cuh",
                   ("const float rs = F::a8 ? a.sx[tok] : 1.f;",
                    "const float rs = F::a8 ? a.sx[tok ^ 1] : 1.f;"),
                   ("int4_matmul_prefill_launch", "int4_matmul_prefill_clusters")),
    "K8": ("decode_attention.cu", "decode_attention.cu",
           ("if (k == a.ranks) break;   // the cluster merge, rank by rank",
            "if (k == a.ranks - 1) break;   // the cluster merge, rank by rank"),
           ("decode_attention_launch",)),
}
# the background builds of KERNEL_FAULTS, started in phase build
FAULT_BUILDS: dict = {}


def start_fault_builds() -> None:
    """Each KERNEL_FAULTS source with its fault planted, compiled into a
    library of its own in the background, into FAULT_BUILDS: {fault: (the
    nvcc process, the library's path)}.  A changed header sits beside the
    copied source, where its quoted #include finds it first."""
    from ctpa_torch.kernels import build

    for kernel, (source, changed, (text, faulty), _) in KERNEL_FAULTS.items():
        src = (build.CSRC_DIR / changed).read_text()
        if src.count(text) != 1:
            raise AssertionError(f"{kernel} fault: {text.strip()!r} is not once in {changed}")
        out = build.BUILD_DIR / f"fault_{kernel.replace(' ', '_')}.{os.getpid()}"
        out.mkdir(parents=True, exist_ok=True)
        shutil.copy(build.CSRC_DIR / source, out / source)
        (out / changed).write_text(src.replace(text, faulty))
        so = out / f"lib{kernel.replace(' ', '_')}_fault.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(build.CSRC_DIR), "-o",
               str(so), str(out / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        atexit.register(lambda p=proc: p.poll() is None and p.kill())   # a run that fails early
        FAULT_BUILDS[kernel] = (proc, so)


@contextlib.contextmanager
def planted_kernel_fault(kernel: str):
    """The kernel's entry points taken from its faulty library while the
    block runs (every other kernel from the real one)."""
    import ctypes

    from ctpa_torch.kernels import build

    proc, so = FAULT_BUILDS[kernel]
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"the {kernel} fault library failed to build:\n{log}")
    faulty = ctypes.CDLL(str(so))
    shutil.rmtree(so.parent, ignore_errors=True)
    names = KERNEL_FAULTS[kernel][3]
    for name in names:
        getattr(faulty, name).argtypes = list(build.SIGNATURES[name])
        getattr(faulty, name).restype = ctypes.c_int
    real = build.library()

    class Mixed:
        def __getattr__(self, name):
            return getattr(faulty if name in names else real.lib, name)

    keep = build.library
    build.library = lambda: build.KernelLibrary(Mixed(), real.ptxas_log, real.seconds)
    try:
        yield
    finally:
        build.library = keep


def fault_refused(kernel: str, label: str, fn, gate) -> None:
    """``fn()`` with the kernel's planted fault, then ``gate(got)``, which
    must raise AssertionError; raises if the gate passes the fault."""
    import torch

    with planted_kernel_fault(kernel):
        got = fn()
        torch.cuda.synchronize()
    try:
        gate(got)
    except AssertionError as exc:
        print(f"    planted {kernel} fault ({label}) refused: {str(exc)[:120]}")
    else:
        raise AssertionError(f"the {kernel} gate passed its planted fault ({label})")


def check_quant8_kernels(dev) -> dict:
    """Phase 20: the four K4 and K6 forms against their plain versions at the
    shapes int8 serving gives them at Meditron-7B width (decode at batch 4
    and 32, 33 and 128 rows, prefill of 4 x 512 tokens, ragged cases; K4
    also at the gateup and down shapes of the unfused FFN), then timed
    beside the plain version, the bound and, for K4, ``int8_yardstick`` (the
    prefill forms also beside dense bf16 torch.matmul); the batch-32
    prefill (32 x 512 rows) checked untimed.  The w8a8 forms are held to
    QUANT_A8_ATOL max|p| + QUANT_A8_RTOL |p|, which the FFN with h
    requantized per full row must fail.  K4's and K6's decode kernels
    (batch 4 and 32) and prefill kernels (2,048 rows) are called twice for
    bits, K4 w8a8 must equal the plain version bit for bit at every row
    count, and the planted K4 and K6 faults (FAULT_BUILDS) must fail their
    gates; a threshold table times K4's decode kernel beside its prefill
    kernel at 4-33 rows."""
    import torch

    from ctpa_torch.core.config import LLMConfig
    from ctpa_torch.ops import quant

    cfg = LLMConfig()
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    d, i, vocab = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    prefill = len(PROMPT_LENS) * max(PROMPT_LENS)
    prefill_b32 = QUANT_B32 * max(PROMPT_LENS)
    decode = len(PROMPT_LENS)
    edge = quant.STREAM_MAX_ROWS
    timed = (decode, QUANT_B32, prefill)
    timed_edge = (decode, QUANT_B32, edge + 1, 128, prefill)
    # (label, in, out, timed row counts, checked-only row counts)
    matmuls = (("qkv_proj", d, qkv, timed_edge, (prefill_b32,)),
               ("o_proj", d, d, timed_edge, (prefill_b32,)),
               ("lm_head", d, vocab, timed, ()),
               ("gateup_proj", d, 2 * i, timed, (edge + 1, 128)),
               ("down_proj", i, d, timed, (edge + 1, 128)),
               ("ragged", d, 1000, (5,), (prefill + 5,)),
               ("ragged in", 513, 1000, (), (5, QUANT_B32, edge + 1, prefill + 5)))
    errs = collections.defaultdict(float)
    table = {}
    bf16 = torch.bfloat16
    for label, d_in, d_out, rows_timed, rows_checked in matmuls:
        weights = [tuple(c) for c in _int8_copies(gen, dev, ((d_in, d_out),))]
        for m in rows_timed + rows_checked:
            x = torch.randn(m, d_in, generator=gen, device=dev).to(bf16)
            for name, a8, _, _ in QUANT8_FORMS[:2]:
                w8, s = weights[0]
                got = quant.int8_matmul(x, w8, s, act_quant=a8)
                ref = quant.int8_matmul_plain(x, w8, s, act_quant=a8)
                quant_check(errs, kernel_key(name, m), a8, f"{label} m {m}", got, ref)
                # w8a8's exact int32 sums scaled as the plain version
                # scales them: its bits, from both kernels
                if a8 and not torch.equal(got, ref):
                    raise AssertionError(f"{name} {label} m {m}: not int8_matmul_plain's "
                                         f"bits ({int((got != ref).sum())} differ)")
                if m in (decode, QUANT_B32, prefill) and label in ("qkv_proj", "o_proj"):
                    repeatable(f"{name} {label} m {m}",
                               lambda: quant.int8_matmul(x, w8, s, act_quant=a8))
                if m not in rows_timed:
                    continue
                it = itertools.cycle(weights)
                fn = lambda: quant.int8_matmul(x, *next(it), act_quant=a8)  # noqa: E731
                ms, dev_ms = cuda_ms(fn, iters=2 * len(weights)), device_ms(fn, 2 * len(weights))
                plain_ms = cuda_ms(lambda: quant.int8_matmul_plain(x, *next(it), act_quant=a8),
                                   iters=3, warmup=1)
                nbytes = m * d_in * 2 + d_in * d_out + d_out * 4 + m * d_out * 2
                b_ms, b_by = bound_ms(nbytes, 2.0 * m * d_in * d_out,
                                      PEAK_INT8_OPS if a8 else PEAK_BF16_FLOPS)
                library, note = int8_yardstick(a8, weights, x)
                lib_ms = None
                if library is not None and not a8 and m > edge:
                    # _weight_int8pack_mm took 224 ms at qkv_proj's prefill:
                    # one call
                    lib_ms = single_ms(library)
                    note = f"{lib_ms:.4f} ms, one call ({note})"
                elif library is not None:
                    lib_ms = cuda_ms(library, iters=2 * len(weights))
                    note = (f"{lib_ms:.4f} ms, device {device_ms(library, 2 * len(weights)):.4f} "
                            f"({note})")
                if m > edge:
                    note += f"; {dense_yardstick(x, weights, quant.dequantize_int8)}"
                table[name, label, m] = (ms, plain_ms, b_ms, b_by, lib_ms)
                print(f"    {name} {label} (m {m}, {d_in} -> {d_out}, "
                      f"{quant.int8_matmul_plan_on(x, d_out, a8)}): {ms:.4f} ms (device "
                      f"{dev_ms:.4f})  plain {plain_ms:.4f} ms  bound {b_ms * 1e3:.2f} us "
                      f"({b_by})  library {note}")
        if label in ("qkv_proj", "o_proj"):
            threshold_table("K4", lambda x, w, a8: quant.int8_matmul(x, *w, act_quant=a8),
                            weights, d_in, (decode, 16, QUANT_B32, edge + 1), ("w8", "w8a8"))
        if label == "qkv_proj":
            x = torch.randn(decode, d_in, generator=gen, device=dev).to(bf16)
            plain = quant.int8_matmul_plain(x, *weights[0])
            fault_refused("K4", "one split left out",
                          lambda: quant.int8_matmul(x, *weights[0]),
                          lambda got: quant_check(collections.defaultdict(float), "int8_matmul",
                                                  False, f"{label} m {decode}, planted fault",
                                                  got, plain))
            x = torch.randn(prefill, d_in, generator=gen, device=dev).to(bf16)
            plain = quant.int8_matmul_plain(x, *weights[0], act_quant=True)
            fault_refused("K4 prefill", "column scales of the pair's other column",
                          lambda: quant.int8_matmul(x, *weights[0], act_quant=True),
                          lambda got: quant_check(collections.defaultdict(float),
                                                  "int8_matmul_a8", True,
                                                  f"{label} m {prefill}, planted fault", got,
                                                  plain))
        del weights
    ffn = _int8_copies(gen, dev, ((d, i), (d, i), (i, d)))
    per_row = {}
    for m in (decode, QUANT_B32, QUANT_B32 + 1, 128, prefill, 5, prefill_b32):
        x = torch.randn(m, d, generator=gen, device=dev).to(bf16)
        for name, a8, _, _ in QUANT8_FORMS[2:]:
            plain = quant.int8_ffn_plain(x, *ffn[0], act_quant=a8)
            quant_check(errs, kernel_key(name, m), a8, f"m {m}",
                        quant.int8_ffn(x, *ffn[0], act_quant=a8), plain)
            if a8 and m in (decode, prefill):
                per_row[m] = a8_atol_needed(
                    quant.int8_ffn_plain(x, *ffn[0], act_quant=True, block_j=i), plain)
                print(f"    the FFN with h requantized per full row against it: atol needed "
                      f"{per_row[m]:.3e} of max|p| (must pass {QUANT_A8_ATOL})")
            if m == prefill_b32:
                continue
            it = itertools.cycle(ffn)
            fn = lambda: quant.int8_ffn(x, *next(it), act_quant=a8)  # noqa: E731
            ms, dev_ms = cuda_ms(fn, iters=2 * len(ffn)), device_ms(fn, 2 * len(ffn))
            plain_ms = cuda_ms(lambda: quant.int8_ffn_plain(x, *next(it), act_quant=a8), iters=3,
                               warmup=1)
            nbytes = m * d * 2 * 2 + 3 * d * i + 2 * i * 4 + d * 4
            b_ms, b_by = bound_ms(nbytes, 6.0 * m * d * i, PEAK_INT8_OPS if a8 else PEAK_BF16_FLOPS)
            table[name, "ffn", m] = (ms, plain_ms, b_ms, b_by, None)
            print(f"    {name} (m {m}, {d} -> {i} -> {d}, "
                  f"{quant.int8_ffn_plan_on(x, i, a8)}): {ms:.4f} ms (device {dev_ms:.4f})  "
                  f"plain {plain_ms:.4f} ms  bound {b_ms * 1e3:.2f} us ({b_by})  library none")
    # K6: two calls give the same bits (decode and prefill kernels); the
    # planted faults fail the gate
    for m in (decode, QUANT_B32, prefill):
        x = torch.randn(m, d, generator=gen, device=dev).to(bf16)
        for name, a8, _, _ in QUANT8_FORMS[2:]:
            repeatable(f"{name} {'decode' if m <= QUANT_B32 else 'prefill'} kernels m {m}",
                       lambda: quant.int8_ffn(x, *ffn[0], act_quant=a8))
    x = torch.randn(decode, d, generator=gen, device=dev).to(bf16)
    plain = quant.int8_ffn_plain(x, *ffn[0], act_quant=True)
    fault_refused("K6", "row max over 128 columns",
                  lambda: quant.int8_ffn(x, *ffn[0], act_quant=True),
                  lambda got: quant_check(collections.defaultdict(float), "int8_ffn_a8", True,
                                          f"m {decode}, planted fault", got, plain))
    x = torch.randn(prefill, d, generator=gen, device=dev).to(bf16)
    plain = quant.int8_ffn_plain(x, *ffn[0], act_quant=True)
    fault_refused("K6 prefill", "row max over 128 columns",
                  lambda: quant.int8_ffn(x, *ffn[0], act_quant=True),
                  lambda got: quant_check(collections.defaultdict(float), "int8_ffn_a8", True,
                                          f"m {prefill}, planted fault", got, plain))
    del ffn
    check_a8_bound_sees_j_blocks(per_row)
    return kernel_rows(QUANT8_FORMS, table, errs, decode, prefill)


def quant_kernel_names(cfg) -> tuple[str, str]:
    """The launch keys of a quantized LLM's projection kernel and FFN kernel:
    K4 / K6 for int8 weights, K5 / K7 for int4, "_a8" with quant_act."""
    bits = "int8" if cfg.weight_quant == "int8" else "int4"
    a8 = "_a8" if cfg.quant_act else ""
    return f"{bits}_matmul{a8}", f"{bits}_ffn{a8}"


def quant_kernel_launches(cfg, rows: int, head_rows: int) -> dict:
    """The quantized kernels' launches in one forward of a quantized LLM
    (fused qkv, the fused FFN) on ``rows`` token rows, prefill or decode
    step, whose lm_head takes ``head_rows`` (a prefill's last prompt
    tokens): per layer one projection launch (K4 or K5) each for qkv_proj
    and o_proj and one for the lm_head (``ops/quant.py:int8_matmul_launches``
    / ``int4_matmul_launches``: a split contraction is added inside the
    launch, no reduction kernel), and per layer the FFN's two (K6 or K7,
    ``int8_ffn_launches`` / ``int4_ffn_launches``), each under its decode
    or its prefill kernel's name by its rows; with int8 activations one
    activation quantization per projection and FFN call."""
    from ctpa_torch.ops import quant

    layers, a8 = cfg.num_layers, cfg.quant_act
    if cfg.weight_quant == "int8":
        projection = quant.int8_matmul_launches
        ffn = quant.int8_ffn_launches(rows, cfg.hidden_size, cfg.intermediate_size, a8)
    else:
        projection = quant.int4_matmul_launches
        ffn = quant.int4_ffn_launches(rows, cfg.hidden_size, cfg.intermediate_size, quant.GROUP,
                                      a8)
    launches = collections.Counter()
    for calls in ({k: v * 2 * layers for k, v in projection(rows, a8).items()},
                  projection(head_rows, a8), {k: v * layers for k, v in ffn.items()}):
        launches.update(calls)
    return {k: v for k, v in launches.items() if v}


def quant_generate(model, video, ids, mask, new_tokens: int, label: str) -> tuple:
    """One timed generate on a quantized model; checks the launches of every
    prefill and decode step exactly (``quant_kernel_launches``).  ->
    (tokens, launches by kernel, the prefill kernels' under
    "<projection>_prefill" and "<ffn>_prefill", the vision feature generate
    computed)."""
    import torch

    cfg = model.llm_cfg
    layers = cfg.num_layers
    mm, ffn = quant_kernel_names(cfg)
    with torch.inference_mode():
        model.generate(video[:1], ids[:1, :8], mask[:1, :8], 2, -1, greedy=True)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events, mark, handle = step_timer(model)
        counts, vision = [quant_launches()], []
        snap = model.llm.model.register_forward_pre_hook(lambda *_: counts.append(quant_launches()))
        keep = model.vision_feature_extractor.register_forward_hook(
            lambda _m, _i, out: vision.append(out))
        mark()
        # no EOS and no pad id, as in the report phase
        res = model.generate(video, ids, mask, new_tokens, eos_token_id=-1, pad_token_id=-1,
                             greedy=True)
        mark()
        counts.append(quant_launches())
        torch.cuda.synchronize()
        for h in (handle, snap, keep):
            h.remove()
    b, n = ids.shape
    ms = [a.elapsed_time(z) for a, z in zip(events, events[1:])]
    prefill_ms, steps = ms[1], sorted(ms[2:])
    tokens = res.tokens
    print(f"  {label}: prefill ({b} x {n}) {prefill_ms:.2f} ms  decode step median "
          f"{steps[len(steps) // 2]:.3f} ms (min {steps[0]:.3f}, max {steps[-1]:.3f}, "
          f"{len(steps)} steps)  {b * len(steps) / (sum(steps) / 1e3):.1f} tokens/s  peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    per_step = [{k: z[k] - a[k] for k in a} for a, z in zip(counts, counts[1:])]
    # the intervals: vision, prefill (with the lm_head on the last prompt
    # tokens), then one per decode step
    want_prefill = {**quant_kernel_launches(cfg, b * n, b), "decode_attention": 0}
    want_step = {**quant_kernel_launches(cfg, b, b), "decode_attention": layers}
    for j, got in enumerate(per_step[1:]):
        want = want_prefill if j == 0 else want_step
        got = {k: v for k, v in got.items() if v}
        if got != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"{label}: {'prefill' if j == 0 else f'step {j}'} launched "
                                 f"{got}, expected {want}")
    if any(per_step[0].values()):
        raise AssertionError(f"{label}: the vision extractor launched {per_step[0]}")
    total = {k: counts[-1][k] - counts[0][k] for k in counts[0]}
    keys = (mm, f"{mm}_prefill", ffn, f"{ffn}_prefill", "int4_act_quant")
    print("    launches: " + ", ".join(f"{k} {total[k]}" for k in keys)
          + f", decode_attention {total['decode_attention']} (per prefill "
          + " / ".join(str(want_prefill.get(k, 0)) for k in keys) + ", per decode step "
          + " / ".join(str(want_step.get(k, 0)) for k in keys)
          + f" / {layers}, exactly; no reduction kernel)")
    if tokens.shape != (b, new_tokens) or not ((tokens >= 0) & (tokens < model.llm_cfg.vocab_size)
                                               ).all() or not (res.lengths == new_tokens).all():
        raise AssertionError(f"{label}: tokens {tuple(tokens.shape)}, lengths {res.lengths}")
    if not all(total[k] for k in (mm, ffn, f"{mm}_prefill", f"{ffn}_prefill",
                                  "decode_attention")):
        raise AssertionError(f"{label}: a kernel of the path never launched: {total}")
    return tokens, total, vision[0]


FUSED_MEMBERS = {"qkv_proj": ("q_proj", "k_proj", "v_proj"), "gateup_proj": ("gate_proj", "up_proj")}


def dequantized_projection(kernel_q, scale) -> tuple:
    """A bundle projection dequantized in fp32, (in, out), and the norm its
    rounding alone gives (each element off by a uniform share of its step,
    step^2 / 12): int8 with a per-column ``scale`` (out,), or packed int4
    with group scales (in/group, out)."""
    import torch

    from ctpa_torch.ops.quant import GROUP, dequantize_int4, dequantize_int8

    if scale.ndim == 1:
        deq = dequantize_int8(kernel_q, scale, torch.float32)
        per_step = kernel_q.shape[0]
    else:
        deq = dequantize_int4(kernel_q, scale, GROUP, torch.float32)
        per_step = deq.shape[0] // scale.shape[0]
    return deq, math.sqrt(per_step * scale.double().square().sum().item() / 12)


def merge_reading(deq, rounding: float, w, delta, dtype) -> tuple[float, float]:
    """One dequantized projection ``deq`` against its source: the base ``w``
    and the LoRA ``delta`` (both (in, out) fp32, delta None where no adapter
    was merged), merged in the base's ``dtype`` (the export adds the delta
    to the base weight in its own dtype: bf16 here, whose rounding is 3% of
    int8's).  -> (the error's norm over ``rounding``, the norm that
    quantization alone gives; the departure from w projected on delta, nan
    without one)."""
    merged = w if delta is None else (w + delta).to(dtype).float()
    ratio = (deq - merged).double().norm().item() / rounding
    coef = math.nan
    if delta is not None:
        coef = ((deq - w).double() * delta).sum().item() / delta.double().square().sum().item()
    return ratio, coef


def merge_ok(ratio: float, coef: float) -> bool:
    return ratio <= QUANT_MERGE_ERR_MAX and (math.isnan(coef) or abs(coef - 1) <= QUANT_MERGE_COEF)


def check_bundle_source(qmodel, base: dict, trained: dict, lora_scale: float) -> None:
    """Every quantized projection of the bundle against W + (alpha / rank) (A
    B) taken from the bf16 base and the trained tensors (``merge_reading``,
    gated by ``merge_ok``); then the first merged projection re-quantized
    from its base with the delta left out, added twice and with its first
    square block transposed, each of which the gate must refuse."""
    import torch

    from ctpa_torch.ops.quant import quantize_int4, quantize_int8

    def source(key):
        return (trained[key] if key in trained else base[key]).float()

    bits = qmodel.llm_cfg.weight_quant
    quantize = quantize_int8 if bits == "int8" else quantize_int4
    leaf = "scale" if bits == "int8" else "scale_g"
    src = qmodel.state_dict()
    dtype = next(v.dtype for k, v in base.items() if k.endswith("base.weight"))
    readings, planted_on = {}, None
    for key, wq in src.items():
        if not key.endswith(".kernel_q"):
            continue
        parent, proj = key[:-len(".kernel_q")].rsplit(".", 1)
        ws, ds = [], []
        for member in FUSED_MEMBERS.get(proj, (proj,)):
            m = f"{parent}.{member}."
            ws.append(source(m + "base.weight" if m + "base.weight" in base else m + "weight").T)
            ds.append(lora_scale * (source(m + "lora_a") @ source(m + "lora_b"))
                      if m + "lora_a" in trained else torch.zeros_like(ws[-1]))
        w, delta = torch.cat(ws, 1), torch.cat(ds, 1)
        if not delta.any():
            delta = None
        elif planted_on is None and w.shape[1] >= w.shape[0]:
            planted_on = (key, w, delta)
        readings[key] = merge_reading(
            *dequantized_projection(wq, src[key[:-len("kernel_q")] + leaf]), w, delta, dtype)
    ratios = [r for r, _ in readings.values()]
    coefs = [c for _, c in readings.values() if not math.isnan(c)]
    print(f"  bundle vs its source, {len(readings)} projections ({len(coefs)} with a merged LoRA "
          f"delta): error / {bits} rounding {min(ratios):.4f}-{max(ratios):.4f} (<= "
          f"{QUANT_MERGE_ERR_MAX}); delta coefficient {min(coefs):.4f}-{max(coefs):.4f} "
          f"(1 +- {QUANT_MERGE_COEF})")
    bad = {k: v for k, v in readings.items() if not merge_ok(*v)}
    if bad or not coefs:
        raise AssertionError(f"the bundle's projections do not match their source: {bad}")
    key, w, delta = planted_on
    d_in = w.shape[0]
    for kind, wrong in (("delta left out", w), ("delta merged twice", w + 2 * delta),
                        ("delta's first square block transposed",
                         w + torch.cat([delta[:, :d_in].T, delta[:, d_in:]], 1))):
        reading = merge_reading(*dequantized_projection(*quantize(wrong)), w, delta, dtype)
        print(f"    planted on {key}, {kind}: error / {bits} rounding {reading[0]:.4f}, delta "
              f"coefficient {reading[1]:.4f}")
        if merge_ok(*reading):
            raise AssertionError(f"the bundle check does not see a planted merge fault ({kind})")


def save_base(model) -> str:
    """The report phase's bf16 model written with torch.save: the base both
    quantized tiers export from (the port's checkpoints hold only the
    trained tensors)."""
    import torch

    shutil.rmtree(QUANT_DIR, ignore_errors=True)
    os.makedirs(QUANT_DIR)
    base = os.path.join(QUANT_DIR, "base.pt")
    t0 = time.perf_counter()
    torch.save(model.state_dict(), base)
    print(f"  the report phase's bf16 base: {os.path.getsize(base) / 1e9:.2f} GB written in "
          f"{time.perf_counter() - t0:.1f} s; {shutil.disk_usage(QUANT_DIR).free / 1e9:.0f} GB "
          f"free there")
    return base


def quant_report(dev, rows: dict, model, inputs, base: str, bits: int) -> tuple:
    """Phases 16 (``bits`` 4) and 19 (8): the report-train phase's checkpoint
    and the report phase's bf16 base (``base``) through
    ctpa_torch.cli.export_serving into two bundles (fused FFN, int8 KV cache,
    flash_decode; the second with --act-quant), each loaded with
    load_serving_bundle (its directory deleted once loaded; the second
    model then shares the first's tensors, which must be equal) and run
    through generate: weight-only and with int8 activations at batch 4 x 512
    tokens, then with int8 activations at batch 32 (the report phase's
    volumes and prompts repeated), 96 greedy tokens each.  The w8a8 bundle's
    directory (``RF_BUNDLE``) stays for phase report-files."""
    import torch

    from ctpa_torch.cli import export_serving
    from ctpa_torch.core.checkpoint import CheckpointManager
    from ctpa_torch.ops import quant

    tiers = (f"w{bits}", f"w{bits}a8")
    models = {}
    for label, extra in zip(tiers, ([], ["--act-quant"])):
        out = os.path.join(QUANT_DIR, f"bundle_{label}")
        t0 = time.perf_counter()
        rc = export_serving.main(["--checkpoint-dir", REPORT_CKPT_DIR, "--base", base, "--out",
                                  out, "--quant", f"int{bits}", "--ffn-kernel", "--kv-quant",
                                  "int8", "--flash-decode", "--device", dev, *extra])
        torch.cuda.synchronize()
        if rc != 0:
            raise AssertionError(f"export_serving exited {rc}")
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        qmodel, meta = export_serving.load_serving_bundle(out, vit_cfg=model.vit_cfg,
                                                          gen_cfg=model.gen_cfg, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(out) for f in fs)
        if out != RF_BUNDLE:           # phase report-files serves that one from disk
            shutil.rmtree(out)
        state = qmodel.state_dict()
        qbytes = sum(t.numel() * t.element_size() for n, t in state.items()
                     if n.rsplit(".", 1)[0] + ".kernel_q" in state
                     and n.endswith((".kernel_q", ".scale", ".scale_g")))
        del state              # it would keep the second bundle's tensors once shared
        print(f"  bundle {label}: exported in {export_s:.1f} s, {size / 1e9:.2f} GB on disk "
              f"({qbytes / 1e9:.2f} GB of int{bits} projections and scales), loaded in "
              f"{load_s:.1f} s; metadata {meta}")
        if meta["lora_merged"] is None or not qmodel.llm_cfg.quant_ffn_kernel or \
                qmodel.llm_cfg.quant_act != (label == tiers[1]) or \
                meta["weight_quant"] != f"int{bits}":
            raise AssertionError(f"bundle {label}: metadata {meta}, config {qmodel.llm_cfg}")
        models[label] = qmodel
    trained = CheckpointManager(REPORT_CKPT_DIR).restore(
        map_location=model.llm.model.embed_tokens.weight.device)["params"]
    lora = meta["lora_merged"]
    with torch.no_grad():
        check_bundle_source(models[tiers[0]], model.state_dict(), trained,
                            lora["alpha"] / lora["rank"])
    first, second = (models[t].state_dict() for t in tiers)
    if not all(torch.equal(t, second[k]) for k, t in first.items()):
        raise AssertionError("the two bundles' tensors differ")
    models[tiers[1]].load_state_dict(first, assign=True)
    del trained, first, second
    torch.cuda.empty_cache()
    video, ids, mask = inputs
    tokens, vision, launched = {}, {}, collections.Counter()
    for label, qmodel in models.items():
        tokens[label], total, vision[label] = quant_generate(
            qmodel, video, ids, mask, QUANT_NEW_TOKENS, f"{label} batch {ids.shape[0]}")
        launched.update(total)
    rep = QUANT_B32 // ids.shape[0]
    _, total, _ = quant_generate(models[tiers[1]], video.repeat(rep, 1, 1, 1, 1),
                                 ids.repeat(rep, 1), mask.repeat(rep, 1), QUANT_NEW_TOKENS,
                                 f"{tiers[1]} batch {QUANT_B32}")
    launched.update(total)
    for name, _, _, _ in (QUANT_FORMS if bits == 4 else QUANT8_FORMS):
        # the decode kernels' launches, and the prefill kernels' apart
        for key in (name, f"{name}_prefill"):
            rows[key]["launches"] = launched[key]
    # the activation quantization serves both tiers' int8-activation forms
    rows["int4_act_quant"]["launches"] = (rows["int4_act_quant"].get("launches", 0)
                                          + launched["int4_act_quant"])
    print("  main path launches: " + ", ".join(f"{k} {launched[k]}" for k in quant.LAUNCHES
                                               if k.startswith(f"int{bits}_")))
    same = (tokens[tiers[0]] == tokens[tiers[1]]).float().mean().item()
    print(f"  {tiers[1]} tokens equal to weight-only's on {same:.1%} of positions")
    return models, tokens, vision


def dequantized_fp32(qmodel):
    """A float CTReportGenerator in fp32 (no kernels, fp32 KV cache) whose
    projections are the bundle's int8 or int4 weights dequantized in fp32:
    the reference both paths of a tier approximate."""
    from ctpa_torch.models.report_generator import CTReportGenerator

    c = qmodel.llm_cfg
    qkv = (c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim, c.num_kv_heads * c.head_dim)
    src = qmodel.state_dict()
    leaf = "scale" if c.weight_quant == "int8" else "scale_g"
    state = {}
    for key, value in src.items():
        prefix = key.rsplit(".", 1)[0] + "."
        if prefix + "kernel_q" not in src:
            state[key] = value.float()
            continue
        if not key.endswith("kernel_q"):
            continue
        w = dequantized_projection(value, src[prefix + leaf])[0].T
        if prefix.endswith("qkv_proj."):
            parent = prefix[:-len("qkv_proj.")]
            for name, part in zip(("q_proj", "k_proj", "v_proj"), w.split(qkv)):
                state[f"{parent}{name}.base.weight"] = part.contiguous()
        elif prefix.endswith("o_proj."):
            state[prefix + "base.weight"] = w.contiguous()
        else:
            state[prefix + "weight"] = w.contiguous()
    cfg = dataclasses.replace(c, weight_quant=None, quant_act=False, quant_ffn_kernel=False,
                              quant_impl="pallas", kv_quant=None, flash_decode=False)
    out = CTReportGenerator(cfg, dataclasses.replace(qmodel.vit_cfg, pallas_patchify=False),
                            qmodel.gen_cfg, device="meta")
    out.load_state_dict(state, assign=True)
    return out.eval()


@contextlib.contextmanager
def planted_quant8_fault(kind: str):
    """The int8 kernels fed tampered inputs: "scale rolled" (each output
    column takes its neighbour's scale) or "contraction shifted" (the
    weights' rows rolled by one, so each input meets its neighbour's row)."""
    import torch

    from ctpa_torch.models import llm

    matmul, ffn = llm.int8_matmul, llm.int8_ffn

    def weight(w8):
        return torch.roll(w8, 1, dims=0) if kind == "contraction shifted" else w8

    def scale(s):
        return torch.roll(s, 1, dims=0) if kind == "scale rolled" else s

    def faulty_matmul(x, w8, s, *args, **kw):
        return matmul(x, weight(w8), scale(s), *args, **kw)

    def faulty_ffn(x, wg, sg, wu, su, wd, sd, *args, **kw):
        return ffn(x, weight(wg), scale(sg), weight(wu), scale(su), weight(wd), scale(sd),
                   *args, **kw)

    llm.int8_matmul, llm.int8_ffn = faulty_matmul, faulty_ffn
    try:
        yield
    finally:
        llm.int8_matmul, llm.int8_ffn = matmul, ffn


@contextlib.contextmanager
def planted_quant_fault(kind: str):
    """The int4 kernels fed tampered inputs: "nibble halves swapped" (every
    packed byte re-packed with its two nibbles exchanged) or "scale_g rolled"
    (each group takes the previous group's scale row)."""
    import torch

    from ctpa_torch.models import llm

    matmul, ffn = llm.int4_matmul, llm.int4_ffn
    swapped = {}

    def weight(w4):
        if kind != "nibble halves swapped":
            return w4
        if w4.data_ptr() not in swapped:
            b = w4.view(torch.uint8)
            swapped[w4.data_ptr()] = ((b << 4) | (b >> 4)).view(torch.int8)
        return swapped[w4.data_ptr()]

    def scale(s):
        return torch.roll(s, 1, dims=0) if kind == "scale_g rolled" else s

    def faulty_matmul(x, w4, s, *args, **kw):
        return matmul(x, weight(w4), scale(s), *args, **kw)

    def faulty_ffn(x, wg, sg, wu, su, wd, sd, *args, **kw):
        return ffn(x, weight(wg), scale(sg), weight(wu), scale(su), weight(wd), scale(sd),
                   *args, **kw)

    llm.int4_matmul, llm.int4_ffn = faulty_matmul, faulty_ffn
    try:
        yield
    finally:
        llm.int4_matmul, llm.int4_ffn = matmul, ffn


QUANT_FAULTS = {"int4": (planted_quant_fault, ("nibble halves swapped", "scale_g rolled")),
                "int8": (planted_quant8_fault, ("scale rolled", "contraction shifted"))}


def quant_plain(model, qmodels: dict, inputs, tokens: dict, vision: dict) -> None:
    """Phases 17 (int4) and 20 (int8): each tier's kernel path, the same
    bundle with quant_impl="xla" (ctpa's plain composition) and an fp32
    reference of the same dequantized weights, teacher-forced on the kernel
    path's tokens, against the gates; then the kernel path fed each of two
    planted faults (``QUANT_FAULTS``) over the first ``QUANT_FAULT_STEPS``
    steps, which the gates, read over those steps, must reject.  Prints,
    ungated, the top-1 agreement with the bf16 model the bundle was made
    from (its LoRA adapters unmerged).

    The kernel and xla paths take the vision feature generate computed
    (``vision``): the patchify kernel sums its per-patch statistics with
    shared-memory atomics, so a second extraction can differ in the last
    bits, and with int8 activations the lm_head's int8 grid turns such a
    difference into whole levels, which can move a near-tie's argmax.  The
    fp32 reference and the bf16 model extract their own."""
    import torch

    from ctpa_torch.core.checkpoint import CheckpointManager
    from ctpa_torch.ops import quant

    trained = CheckpointManager(REPORT_CKPT_DIR).restore(
        map_location=model.llm.model.embed_tokens.weight.device)["params"]
    bf16_lora = report_train_model(model, trained, flash_prefill=False).eval()
    bits = next(iter(qmodels.values())).llm_cfg.weight_quant
    planted, kinds = QUANT_FAULTS[bits]
    reference = dequantized_fp32(next(iter(qmodels.values())))
    for label, qmodel in qmodels.items():
        with torch.inference_mode():
            again = qmodel.extract_vision(inputs[0])
            print(f"  {label}: a second vision extraction differs from generate's by max "
                  f"|diff| {(again - vision[label]).abs().max().item():.3e}")
            kernel = teacher_forced_logits(qmodel, *inputs, tokens[label], vision[label])
            before = dict(quant.LAUNCHES)
            plain = teacher_forced_logits(twin(qmodel, quant_impl="xla"), *inputs, tokens[label],
                                          vision[label])
            if quant.LAUNCHES != before:
                raise AssertionError(f"the xla path launched a {bits} kernel")
            fp32 = teacher_forced_logits(reference, *inputs, tokens[label])
            bf16 = teacher_forced_logits(bf16_lora, *inputs, tokens[label])
            faults = {}
            for kind in kinds:
                with planted(kind):
                    faults[kind] = teacher_forced_logits(
                        qmodel, *inputs, tokens[label][:, :QUANT_FAULT_STEPS], vision[label])
        if not all(torch.isfinite(x).all() for x in (kernel, plain, fp32)):
            raise AssertionError(f"{label}: non-finite logits")
        if not torch.equal(kernel.argmax(-1), tokens[label]):
            raise AssertionError(f"{label}: the teacher-forced kernel path does not give back its "
                                 f"generated tokens")
        p_f = logit_distance(plain, fp32)
        print(f"  {label}: fused logits over {tokens[label].shape[1]} steps, "
              f"{tokens[label].numel()} (lane, step) pairs: worst max |diff| / max |logit| per "
              f"step, mean |diff|, top-1 agreement")
        print(f"    {'xla vs fp32':<30} {p_f[0]:.4f}  {p_f[1]:.5f}  {p_f[2]:.4f}")
        gate = dict(ratio=QUANT_FP32_RATIO, slack=QUANT_FP32_TOP1_SLACK, top1_min=QUANT_TOP1_MIN)
        if not report_gate(f"{label} kernel", kernel, plain, fp32, p_f, **gate):
            raise AssertionError(f"{label}: the {bits} kernel path is farther from the fp32 "
                                 "reference than the xla path")
        first = (plain[:, :QUANT_FAULT_STEPS], fp32[:, :QUANT_FAULT_STEPS])
        for kind, got in faults.items():
            if report_gate(f"{label} planted fault: {kind}", got, *first, logit_distance(*first),
                           **gate):
                raise AssertionError(f"the gates do not see a planted {bits} fault ({kind})")
        rel, mean, top1 = logit_distance(kernel, bf16)
        print(f"    {label} kernel vs the bf16 model (LoRA unmerged), not gated: {rel:.4f}  "
              f"{mean:.5f}  top-1 {top1:.4f}")
        del kernel, plain, fp32, bf16, faults
    del reference, bf16_lora

class FixedPrompt:
    """bench_stream.py's prompt as a tokenizer: 16 seeded random ids, every
    one real (``bench_stream.py:333-335``)."""

    def __init__(self, vocab_size: int):
        import numpy as np

        self.ids = np.random.default_rng(1).integers(3, vocab_size, size=STREAM_PROMPT_LEN)

    def __call__(self, texts, max_length=None):
        import numpy as np

        return {"input_ids": self.ids[None], "attention_mask": np.ones((1, self.ids.size), np.int64)}


def stream_scans(count: int) -> list:
    """bench_stream.py's burst: raw int16 (160, 512, 512) volumes from a seed
    (``bench_stream.py:49-63``) with its rescale tags and spacing."""
    import numpy as np

    rng = np.random.default_rng(SEED + 20)
    return [dict(volume=rng.integers(-24, 3000, size=RAW_SHAPE).astype(np.int16), **STREAM_RAW)
            for _ in range(count)]


def stream_launches() -> dict:
    """The serving path's kernel counters: K1, K8, and K4-K7 by
    ``ops/quant.py:kernel_name``."""
    from ctpa_torch.ops import decode_attention as da
    from ctpa_torch.ops import quant
    from ctpa_torch.ops.patchify import patchify_project

    return {**quant.LAUNCHES, "decode_attention": da.LAUNCHES["decode_attention"],
            "patchify_project": patchify_project.launches}


def launch_delta(after: dict, before: dict) -> collections.Counter:
    return collections.Counter({k: after[k] - before[k] for k in after if after[k] != before[k]})


def stream_step_launches(cfg, tier: str) -> dict:
    """One step of a chunk over STREAM_LANES lanes: a plain decode step (K8
    a layer with flash_decode; the quantized kernels at ``lanes`` rows) or a
    verify over lanes x (K + 1) rows (the quantized kernels' prefill forms
    above 32 rows; the attention dense)."""
    rows = STREAM_LANES if tier == "plain" else STREAM_LANES * (STREAM_K + 1)
    out = collections.Counter(quant_kernel_launches(cfg, rows, rows) if cfg.weight_quant else {})
    if tier == "plain" and cfg.flash_decode:
        out["decode_attention"] += cfg.num_layers
    return {k: v for k, v in out.items() if v}


def admission_launches(cfg, rows: int) -> dict:
    """A first-token sample on ``rows`` rows: the quantized lm_head alone."""
    from ctpa_torch.ops import quant

    if cfg.weight_quant is None:
        return {}
    fn = quant.int4_matmul_launches if cfg.weight_quant == "int4" else quant.int8_matmul_launches
    return {k: v for k, v in fn(rows, cfg.quant_act).items() if v}


def stream_pipeline(model, dev, tier: str, new_tokens: int, visions: list, sampled: bool = False,
                    eos: int = -1):
    """bench_stream's pipeline on one tier: a ContinuousBatcher of
    STREAM_LANES lanes (greedy, or sampled at STREAM_TEMPERATURE from a
    seeded generator on the card) behind StreamingReportPipeline, whose
    encoder (preprocess_volume, then extract_vision) appends each feature
    to ``visions``."""
    import torch

    from ctpa_torch.core.config import PreprocessConfig
    from ctpa_torch.ops.preprocess import preprocess_volume
    from ctpa_torch.pipelines import streaming

    spec = tier == "spec"
    slack = STREAM_K + 1 if spec else STREAM_STEPS
    batcher = streaming.ContinuousBatcher(
        model, num_lanes=STREAM_LANES, max_len=STREAM_PROMPT_LEN + new_tokens + slack,
        eos_token_id=eos, greedy=not sampled, temperature=STREAM_TEMPERATURE,
        generator=torch.Generator(device=dev).manual_seed(SEED + 22),
        steps_per_sync=STREAM_STEPS, spec_lookup=STREAM_K if spec else None)
    pre = PreprocessConfig.train()

    def encode_fn(vol, slope, intercept, spacing):
        video = preprocess_volume(vol, slope, intercept, spacing, pre, device=dev)
        visions.append(model.extract_vision(video[None].to(torch.bfloat16))[0])
        return visions[-1]

    return batcher, lambda: streaming.StreamingReportPipeline(
        encode_fn, batcher, FixedPrompt(model.llm_cfg.vocab_size), "",
        max_new_tokens=new_tokens, prompt_len=STREAM_PROMPT_LEN)


def stream_wall(model, dev, tier: str, volumes: int = STREAM_VOLUMES) -> tuple:
    """The burst served greedily with nothing recorded or patched ->
    (seconds on the host clock, the (volumes, tokens) tokens)."""
    import torch

    pipe = stream_pipeline(model, dev, tier, STREAM_NEW_TOKENS, [])[1]()
    scans = stream_scans(volumes)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = pipe.run(scans)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, torch.tensor([results[r].tokens for r in range(volumes)], device=dev)


class StreamRun:
    """One ``StreamingReportPipeline.run`` of bench_stream's burst on one
    tier, instrumented from outside the batcher: each chunk's host time and
    launches, each admission's launches, the device reads (the module's
    ``fetch``), the vision features, and on the plain tier the fused logits
    of each request's steps in order.  ``faults``: (module, name, value)
    set for the run.  Greedy with no EOS, every request fills its budget;
    ``sampled`` or ``eos`` >= 0, each request's tokens are held to its
    budget, to valid ids and to no EOS among them, and ``tokens`` is None."""

    def __init__(self, model, dev, tier: str, label: str, volumes: int = STREAM_VOLUMES,
                 new_tokens: int = STREAM_NEW_TOKENS, faults=(), sampled: bool = False,
                 eos: int = -1):
        import torch

        from ctpa_torch.pipelines import streaming

        self.model, self.tier, self.label, self.new_tokens = model, tier, label, new_tokens
        spec = tier == "spec"
        self.visions, self.chunk_ms, self.chunk_launches, self.admissions = [], [], [], []
        batcher, pipeline = stream_pipeline(model, dev, tier, new_tokens, self.visions,
                                            sampled, eos)
        self.steps = batcher.spec_steps if spec else STREAM_STEPS
        # the synchronizing CUDA calls of each chunk (torch's sync debug
        # mode): the fetch of its wire, and nothing else
        self.syncs, self.sync_sites = [], []
        self.logits, self.wires, admitting = collections.defaultdict(list), [], []

        real_fetch, real_step = streaming.fetch, batcher.step
        real_first, real_admit = batcher._first_token, batcher._admit_shared_batch
        fused = model._fused_logits

        def fetch(t):
            self.wires.append(real_fetch(t))
            return self.wires[-1]

        def step():
            before = stream_launches()
            with warnings.catch_warnings(record=True) as caught:
                # every one, not the first at each line; other warnings as
                # they were
                warnings.filterwarnings("always", message=".*synchronizing CUDA operation")
                torch.cuda.set_sync_debug_mode("warn")
                t0 = time.perf_counter()
                try:
                    out = real_step()
                finally:
                    self.chunk_ms.append((time.perf_counter() - t0) * 1e3)
                    torch.cuda.set_sync_debug_mode("default")
            sites = [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                     if "synchronizing CUDA operation" in str(w.message)]
            self.syncs.append(len(sites))
            if len(sites) != 1:
                self.sync_sites.append(sites)
            self.chunk_launches.append(launch_delta(stream_launches(), before))
            return out

        def first_token(h, vision, generator):
            before = stream_launches()
            out = real_first(h, vision, generator)
            self.admissions.append((len(self.chunk_ms), h.shape[0],
                                    launch_delta(stream_launches(), before)))
            return out

        def admit(batch):
            admitting[:] = [req.request_id for _, req in batch]
            try:
                real_admit(batch)
            finally:
                admitting.clear()

        def record(hidden, vision):
            out = fused(hidden, vision)
            if not spec and hidden.shape[1] == 1:
                ids = admitting or [r.request_id if r else None for r in batcher.lane_req]
                for row, rid in enumerate(ids):
                    if rid is not None:
                        self.logits[rid].append(out[row, 0].float())
            return out

        batcher.step, batcher._first_token = step, first_token
        batcher._admit_shared_batch = admit
        model._fused_logits = record
        patched = [(streaming, "fetch", fetch), *faults]
        undo = [(module, name, getattr(module, name)) for module, name, _ in patched]
        for module, name, value in patched:
            setattr(module, name, value)
        try:
            pipe = pipeline()
            scans = stream_scans(volumes)
            with torch.inference_mode():
                torch.cuda.synchronize()
                start = stream_launches()
                t0 = time.perf_counter()
                results = pipe.run(scans)
                torch.cuda.synchronize()
                self.wall = time.perf_counter() - t0
                self.total = launch_delta(stream_launches(), start)
        finally:
            for module, name, value in reversed(undo):
                setattr(module, name, value)
            del model._fused_logits
        self.prompt = torch.as_tensor(pipe.prompt_ids, device=dev)
        self.vision = torch.stack(self.visions)
        served = [results[r].tokens for r in range(volumes)]
        self.lengths = [len(t) for t in served]
        full = not sampled and eos < 0
        if not all(results[r].finished for r in range(volumes)) or any(
                n > new_tokens or (full and n != new_tokens) for n in self.lengths) or any(
                not 0 <= t < model.llm_cfg.vocab_size or t == eos for t in sum(served, [])):
            raise AssertionError(f"{label}: {len(results)} results, token counts "
                                 f"{self.lengths} for a budget of {new_tokens}")
        self.tokens = torch.tensor(served, device=dev) if full else None

    def recorded_logits(self):
        """(requests, tokens, vocab) fp32: the plain tier's fused logits of
        each request's first token and of each of its decode steps."""
        import torch

        return torch.stack([torch.stack(self.logits[r][:self.new_tokens])
                            for r in range(self.tokens.shape[0])])

    def emits(self) -> collections.Counter:
        """Tokens emitted per (live lane, verify) -> their counts, from the
        wires: a live lane emits at least one a verify, a finished one none."""
        out = collections.Counter()
        for w in self.wires:
            e = w[1:].reshape(-1, STREAM_K + 2, w.shape[1])[:, 0]
            out.update(int(n) for n in e.ravel() if n > 0)
        return out

    def tokens_per_verify(self) -> float:
        emits = self.emits()
        return sum(n * c for n, c in emits.items()) / max(sum(emits.values()), 1)

    def report(self) -> None:
        """Print the run's numbers and hold its launches and device reads: one
        read a chunk; each admission's launches its lm_head's; each chunk's,
        less its admissions', exactly its steps'; K1 once a volume; every
        kernel of the tier launched."""
        cfg = self.model.llm_cfg
        chunks = len(self.chunk_ms)
        reqs, toks = len(self.lengths), sum(self.lengths)
        ms = sorted(self.chunk_ms)
        extra = (f", {self.tokens_per_verify():.3f} tokens emitted per verify"
                 if self.tier == "spec" else "")
        print(f"  {self.label}: {reqs} volumes in {self.wall:.3f} s ({reqs / self.wall:.3f} "
              f"volumes/s), {toks} tokens ({toks / self.wall:.1f} tokens/s), "
              f"{chunks} chunks, chunk median {ms[chunks // 2]:.2f} ms (min {ms[0]:.2f}, max "
              f"{ms[-1]:.2f}){extra}")
        print(f"    host reads: {len(self.wires)} fetches in {chunks} chunks; synchronizing CUDA "
              f"calls a chunk (torch's sync debug mode): "
              + ", ".join(f"{n} in {c} chunks" for n, c in sorted(collections.Counter(
                  self.syncs).items())))
        for sites in self.sync_sites:
            print("    a chunk's synchronizing calls at: " + ", ".join(sites))
        if len(self.wires) != chunks or any(n != 1 for n in self.syncs):
            raise AssertionError(f"{self.label}: {len(self.wires)} fetches and {sum(self.syncs)} "
                                 f"synchronizing calls in {chunks} chunks, one each expected")
        step = stream_step_launches(cfg, self.tier)
        want = {k: v * self.steps for k, v in step.items()}
        for i, got in enumerate(self.chunk_launches):
            got = collections.Counter(got)
            for chunk, rows, adm in self.admissions:
                if chunk != i:
                    continue
                if dict(adm) != admission_launches(cfg, rows):
                    raise AssertionError(f"{self.label}: an admission of {rows} rows launched "
                                         f"{dict(adm)}, expected {admission_launches(cfg, rows)}")
                got.subtract(adm)
            got = {k: v for k, v in got.items() if v}
            if got != want:
                raise AssertionError(f"{self.label}: chunk {i} launched {got} besides its "
                                     f"admissions, expected {want}")
        kind = "decode steps" if self.tier == "plain" else "verify" + ("s" if self.steps > 1 else "")
        print(f"    launches a chunk ({self.steps} {kind} of {STREAM_LANES} lanes, exactly): "
              + (", ".join(f"{k} {v}" for k, v in sorted(want.items())) or "none")
              + "; an admission: " + ", ".join(f"{rows} rows {dict(adm) or 'none'}"
                                               for _, rows, adm in self.admissions[:2]))
        print("    launches in the run: " + ", ".join(f"{k} {v}" for k, v in
                                                      sorted(self.total.items())))
        if self.total.get("patchify_project", 0) != reqs:
            raise AssertionError(f"{self.label}: patchify_project launched "
                                 f"{self.total.get('patchify_project')} times for {reqs} volumes")
        missing = [k for k in step if not self.total.get(k)]
        if missing:
            raise AssertionError(f"{self.label}: {missing} never launched")


def sequence_logits(model, prompt, tokens, vision):
    """The fused logits that predict each of ``tokens`` (b, t) after the
    shared prompt, from one forward over prompt + tokens[:-1] without a
    cache: the fp32 references' teacher forcing."""
    import torch

    b = tokens.shape[0]
    n = prompt.shape[0]
    seq = torch.cat([prompt[None].expand(b, n), tokens[:, :-1]], 1)
    hidden, _ = model.llm.model(seq)
    return model._fused_logits(hidden[:, n - 1:], vision.float()).float()


def lanes_forced(model, run, tokens=None):
    """generate's fused logits teacher-forced on a run's tokens, at batch =
    lanes (``teacher_forced_logits`` with the run's vision features)."""
    import torch

    tokens = run.tokens if tokens is None else tokens
    b = tokens.shape[0]
    ids = run.prompt[None].expand(b, -1)
    mask = torch.ones_like(ids)
    return torch.cat([teacher_forced_logits(model, None, ids[i:i + STREAM_LANES],
                                            mask[i:i + STREAM_LANES], tokens[i:i + STREAM_LANES],
                                            run.vision[i:i + STREAM_LANES])
                      for i in range(0, b, STREAM_LANES)])


def stream_logit_gate(label: str, run, model, reference, bounds: dict) -> tuple:
    """The plain tier's recorded logits against the fp32 ``reference`` on its
    tokens, within ``bounds`` of generate at batch = lanes teacher-forced on
    them (report_gate) -> (passed, recorded logits, fp32 logits)."""
    import torch

    with torch.inference_mode():
        got = run.recorded_logits()
        if not torch.equal(got.argmax(-1), run.tokens):
            raise AssertionError(f"{label}: the recorded logits do not give the served tokens")
        plain = lanes_forced(model, run)
        fp32 = sequence_logits(reference, run.prompt, run.tokens, run.vision)
    p_f = logit_distance(plain, fp32)
    print(f"    {label}: {run.tokens.numel()} (request, step) pairs; generate at batch "
          f"{STREAM_LANES} vs fp32 {p_f[0]:.4f}  {p_f[1]:.5f}  {p_f[2]:.4f}")
    return report_gate(label, got, plain, fp32, p_f, **bounds), got, fp32


def stream_spec_gate(label: str, spec, plain_tokens, plain_got, plain_fp32, model, reference,
                     bounds: dict, plain_name: str = "the plain tier") -> bool:
    """The speculative tier's tokens: (1) the plain tier's (or another
    greedy path's: ``plain_name``) up to the first near tie of the fp32
    reference (top-2 gap below twice the plain tier's worst |logit - fp32|
    at that position); (2) teacher-forced, generate's argmax on at least
    bounds["top1_min"] of them, and fp32's at most bounds["slack"] less
    often than generate's argmax is fp32's."""
    import torch

    ok = True
    firsts = []
    for r in range(spec.tokens.shape[0]):
        diff = (spec.tokens[r] != plain_tokens[r]).nonzero()
        if not diff.numel():
            firsts.append("equal")
            continue
        t = int(diff[0, 0])
        top2 = plain_fp32[r, t].topk(2).values
        gap = float(top2[0] - top2[1])
        margin = 2 * float((plain_got[r, t] - plain_fp32[r, t]).abs().max())
        ok &= gap < margin
        firsts.append(f"{t} (gap {gap:.4f}, margin {margin:.4f})")
    print(f"    {label}: first position differing from {plain_name}, per request: "
          + "; ".join(firsts))
    with torch.inference_mode():
        forced = lanes_forced(model, spec).argmax(-1)
        fp32 = sequence_logits(reference, spec.prompt, spec.tokens, spec.vision).argmax(-1)
    g_p = (spec.tokens == forced).float().mean().item()
    g_f = (spec.tokens == fp32).float().mean().item()
    p_f = (forced == fp32).float().mean().item()
    ok &= g_p >= bounds["top1_min"] and g_f >= p_f - bounds["slack"]
    print(f"    {label}: tokens = generate's teacher-forced argmax {g_p:.4f} (>= "
          f"{bounds['top1_min']}), = fp32's {g_f:.4f} against generate's {p_f:.4f} (slack "
          f"{bounds['slack']}): {'pass' if ok else 'FAIL'}")
    return ok


STREAM_REPORT_BOUNDS = dict(ratio=REPORT_FP32_RATIO, slack=REPORT_FP32_TOP1_SLACK,
                            top1_min=REPORT_TOP1_MIN)
STREAM_QUANT_BOUNDS = dict(ratio=QUANT_FP32_RATIO, slack=QUANT_FP32_TOP1_SLACK,
                           top1_min=QUANT_TOP1_MIN)


def check_stream_kernels(dev, qmodel) -> None:
    """The stream's kernel shapes that no earlier phase checks, against the
    plain versions: K8 at b 4 on the plain tier's 88-slot ring (not a
    multiple of its 32-slot tile) with each lane's valid window wrapped
    round the plane's end, bf16 and int8 caches; K5 and K7 w4a8 on the
    verify's 4 x 9 = 36 rows (their prefill kernels' cluster-split forms) on
    the bundle's first layer."""
    import torch

    from ctpa_torch.ops import decode_attention as da
    from ctpa_torch.ops import quant

    cfg = qmodel.llm_cfg
    m = STREAM_PROMPT_LEN + STREAM_NEW_TOKENS + STREAM_STEPS
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    slot = torch.arange(m, device=dev)
    start = torch.tensor([m - 16, m - 40, 50, 7], device=dev)[:, None]
    valid = (slot[None] - start) % m < torch.tensor([80, 64, 45, 3], device=dev)[:, None]
    q = torch.randn(STREAM_LANES, cfg.num_heads, cfg.head_dim, generator=gen, device=dev)
    q = q.to(torch.bfloat16)
    for quant_cache in (False, True):
        ck, cv, ks, vs = decode_cache(gen, dev, cfg, STREAM_LANES, m, cfg.num_kv_heads,
                                      quant_cache)
        for layer in (0, cfg.num_layers - 1):
            args = (q, ck, cv, valid, layer, ks, vs, cfg.head_dim ** -0.5)
            compare(f"decode_attention b 4 m {m} wrapped {'int8' if quant_cache else 'bf16'}, "
                    f"layer {layer}", da.decode_attention(*args), da.decode_attention_plain(*args),
                    BF16_ATOL, BF16_RTOL)
        del ck, cv, ks, vs
    rows = STREAM_LANES * (STREAM_K + 1)
    x = torch.randn(rows, cfg.hidden_size, generator=gen, device=dev).to(torch.bfloat16)
    attn, mlp = qmodel.llm.model.layers[0].self_attn, qmodel.llm.model.layers[0].mlp
    errs = collections.defaultdict(float)
    w = (attn.qkv_proj.kernel_q, attn.qkv_proj.scale_g)
    quant_check(errs, "int4_matmul_a8", True, f"qkv_proj m {rows}",
                quant.int4_matmul(x, *w, quant.GROUP, "pallas", True),
                quant.int4_matmul_plain(x, *w, quant.GROUP, True))
    f = (mlp.gate_proj.kernel_q, mlp.gate_proj.scale_g, mlp.up_proj.kernel_q, mlp.up_proj.scale_g,
         mlp.down_proj.kernel_q, mlp.down_proj.scale_g)
    quant_check(errs, "int4_ffn_a8", True, f"m {rows}",
                quant.int4_ffn(x, *f, group=quant.GROUP, impl="pallas", act_quant=True),
                quant.int4_ffn_plain(x, *f, group=quant.GROUP, act_quant=True))


def head_twin(model):
    """``twin(model)`` with the lm_head of STREAM_HEAD_ROWS of the model's
    rows times STREAM_HEAD_SCALE and zeros elsewhere (a new weight; the
    model's stays as it is)."""
    import torch

    out = twin(model)
    weight = model.llm.lm_head.weight
    head = torch.zeros_like(weight)
    head[:STREAM_HEAD_ROWS] = weight[:STREAM_HEAD_ROWS] * STREAM_HEAD_SCALE
    out.llm.lm_head.weight = torch.nn.Parameter(head, requires_grad=False)
    return out


def stream(dev, model, qmodel) -> dict:
    """Phase 23: bench_stream's burst through StreamingReportPipeline.run on
    the plain and speculative tiers of the report phase's bf16 model and of
    quant-report's int4 w4a8 bundle; one wave of 4 volumes on the plain tier
    with the int4 KV cache, with the int8 cache's integer dots, and sampled
    as config 5 samples; on ``head_twin(model)`` a greedy speculative wave,
    where drafts must be accepted in part, and a sampled one that must end
    a request at EOS.  Then the bf16 model's burst again on each tier with
    nothing recorded, for its times."""
    import torch

    with torch.inference_mode():
        check_stream_kernels(dev, qmodel)
    head = head_twin(model)
    runs = {}
    for label, m, tier, volumes, sampling in (
            ("bf16 plain", model, "plain", STREAM_VOLUMES, {}),
            ("bf16 spec", model, "spec", STREAM_VOLUMES, {}),
            ("int4 w4a8 plain", qmodel, "plain", STREAM_VOLUMES, {}),
            ("int4 w4a8 spec", qmodel, "spec", STREAM_VOLUMES, {}),
            ("bf16 int4 KV plain", twin(model, kv_quant="int4", flash_decode=False), "plain",
             STREAM_LANES, {}),
            ("bf16 int8 KV dots plain", twin(model, kv_quant="int8", kv_int8_dots=True,
                                             flash_decode=False), "plain", STREAM_LANES, {}),
            ("bf16 sampled plain", model, "plain", STREAM_LANES,
             dict(sampled=True, eos=STREAM_EOS)),
            ("head twin spec", head, "spec", STREAM_LANES, {}),
            ("head twin sampled spec", head, "spec", STREAM_LANES,
             dict(sampled=True, eos=STREAM_HEAD_EOS))):
        runs[label] = StreamRun(m, dev, tier, label, volumes, **sampling)
        runs[label].report()
        if sampling:
            print(f"    {label}: tokens a request {runs[label].lengths} (budget "
                  f"{STREAM_NEW_TOKENS}; EOS id {sampling['eos']} never among them)")
    if all(n == STREAM_NEW_TOKENS for n in runs["head twin sampled spec"].lengths):
        raise AssertionError("head twin sampled spec: no request ended at EOS")
    for label in ("head twin spec", "head twin sampled spec"):
        emits = runs[label].emits()
        print(f"  {label}: tokens emitted per verify: "
              + ", ".join(f"{n}: {c}" for n, c in sorted(emits.items())))
    emits = runs["head twin spec"].emits()
    if runs["head twin spec"].tokens_per_verify() <= 1 or not any(
            1 < n <= STREAM_K for n in emits):
        raise AssertionError("head twin spec: no verify accepted part of its drafts")
    for label in ("bf16", "int4 w4a8"):
        same = (runs[f"{label} spec"].tokens == runs[f"{label} plain"].tokens).float().mean()
        print(f"  {label}: speculative tokens equal to the plain tier's on {same.item():.1%} of "
              f"positions")
    print("  the burst with nothing recorded (no sync debug mode, launch counters, logits or "
          "wire copies), host clock:")
    for label, tier in (("bf16 plain", "plain"), ("bf16 spec", "spec")):
        wall, tokens = stream_wall(model, dev, tier)
        same = (tokens == runs[label].tokens).float().mean().item()
        print(f"    {label}: {STREAM_VOLUMES} volumes in {wall:.3f} s ({STREAM_VOLUMES / wall:.3f} "
              f"volumes/s, {tokens.numel() / wall:.1f} tokens/s; instrumented "
              f"{runs[label].wall:.3f} s); tokens equal to the instrumented run's on {same:.1%}")
    return runs


def ring_rotated_too_far(lane, clock):
    """Planted fault: the lane rotated one slot further than the clock asks
    (its offset still the clock), so the first decode write lands on its
    last prompt row."""
    from ctpa_torch.models.llm import align_lane_to_clock

    out = align_lane_to_clock(lane, clock + 1)
    return out._replace(write_offset=out.write_offset - 1)


def rollback_skipped(cache, pre_off, pre_tl, committed, draft_len):
    """Planted fault: the rejected rows stay valid and the offsets stay past
    them.  (Leaving them valid alone is harmless: the next verify writes its
    K + 1 rows from the committed offset, over every rejected slot.)"""
    return cache


def stream_plain(dev, model, qmodel, runs: dict) -> None:
    """Phase 24: the stream phase's gates (the plain tiers' logits and the
    speculative tiers' tokens against fp32 references, beside generate at
    batch = lanes), then two planted faults, each served on one wave of the
    bf16 model, which the gates must fail."""
    import torch

    from ctpa_torch.pipelines import streaming

    reference = fp32_twin(model)
    failed = []
    plain = runs["bf16 plain"]
    ok, got, fp32 = stream_logit_gate("bf16 plain", plain, model, reference, STREAM_REPORT_BOUNDS)
    failed += [] if ok else ["bf16 plain"]
    if not stream_spec_gate("bf16 spec", runs["bf16 spec"], plain.tokens, got, fp32, model,
                            reference, STREAM_REPORT_BOUNDS):
        failed.append("bf16 spec")
    # the head twin's greedy speculative wave against generate's greedy
    # tokens for the same requests at batch = lanes, near ties judged by
    # the fp32 reference with the same head on logits 0-2 (argmax never
    # picks a token past 2)
    spec = runs["head twin spec"]
    head, head_ref = head_twin(model), head_twin(reference)
    ids = spec.prompt[None].expand(spec.tokens.shape[0], -1)
    with torch.inference_mode():
        gen = teacher_forced_logits(head, None, ids, torch.ones_like(ids), None, spec.vision,
                                    STREAM_NEW_TOKENS)
        gen_fp32 = sequence_logits(head_ref, spec.prompt, gen.argmax(-1), spec.vision)
    keep = slice(0, STREAM_HEAD_ROWS + 1)
    if not stream_spec_gate("head twin spec", spec, gen.argmax(-1), gen[..., keep],
                            gen_fp32[..., keep], head, head_ref, STREAM_REPORT_BOUNDS,
                            "generate's greedy tokens"):
        failed.append("head twin spec")
    del head, head_ref, gen, gen_fp32
    for label, changes in (("bf16 int4 KV plain", dict(kv_quant="int4", flash_decode=False)),
                           ("bf16 int8 KV dots plain", dict(kv_quant="int8", kv_int8_dots=True,
                                                           flash_decode=False))):
        if not stream_logit_gate(label, runs[label], twin(model, **changes), reference,
                                 STREAM_QUANT_BOUNDS)[0]:
            failed.append(label)
    # the faults serve the first wave's first STREAM_FAULT_TOKENS tokens;
    # the sound plain tier's are the prefix of its run (causal: the same
    # logits)
    wave = (slice(0, STREAM_LANES), slice(0, STREAM_FAULT_TOKENS))
    for label, tier, fault in (
            ("planted fault: ring rotated one slot too far", "plain",
             (streaming, "align_lane_to_clock", ring_rotated_too_far)),
            ("planted fault: rollback skipped", "spec", (streaming, "_rollback", rollback_skipped))):
        bad = StreamRun(model, dev, tier, label, STREAM_LANES, STREAM_FAULT_TOKENS, [fault])
        if tier == "plain":
            caught = not stream_logit_gate(label, bad, model, reference, STREAM_REPORT_BOUNDS)[0]
        else:
            caught = not stream_spec_gate(label, bad, plain.tokens[wave], got[wave], fp32[wave],
                                          model, reference, STREAM_REPORT_BOUNDS)
        if not caught:
            raise AssertionError(f"the stream gates do not see a planted fault ({label})")
    del got, fp32
    del reference
    torch.cuda.empty_cache()
    reference = dequantized_fp32(qmodel)
    ok, got, fp32 = stream_logit_gate("int4 w4a8 plain", runs["int4 w4a8 plain"], qmodel,
                                      reference, STREAM_QUANT_BOUNDS)
    failed += [] if ok else ["int4 w4a8 plain"]
    if not stream_spec_gate("int4 w4a8 spec", runs["int4 w4a8 spec"],
                            runs["int4 w4a8 plain"].tokens, got, fp32, qmodel, reference,
                            STREAM_QUANT_BOUNDS):
        failed.append("int4 w4a8 spec")
    del reference
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"stream gates failed: {failed}")


def reference_ctclip_state(vit_cfg, bert_cfg, clip_cfg, gen, dev, std: float = ZS_WEIGHT_STD):
    """A CT-CLIP_v2.pt state dict from ``gen``: the reference's parameter
    names and torch layouts (ct_clip.py, ctvit.py and attention.py module
    trees; tests/test_ctclip_import.py's state dict at any widths), every
    tensor ``ctpa_torch.data.hf_import.import_ctclip`` reads.  Weights and
    biases normal(0, std); LayerNorm weights, RMS gains and q/k scales 1 +
    normal(0, std); the log-temperature 1; the VQ codebook l2-normalised
    rows."""
    import torch

    from ctpa_torch.ops.attention_ops import l2norm

    d, dh, heads = vit_cfg.dim, vit_cfg.dim_head, vit_cfg.heads
    inner, pd, hid = dh * heads, vit_cfg.patch_dim, bert_cfg.hidden_size
    ff_inner = int(d * vit_cfg.ff_mult * 2 / 3)
    side = vit_cfg.image_size // vit_cfg.patch_size

    def t(*shape):
        return std * torch.randn(shape, generator=gen, device=dev)

    def gain(*shape):
        return 1 + t(*shape)

    sd = {"temperature": torch.ones((), device=dev),
          "to_text_latent.weight": t(clip_cfg.dim_latent, hid),
          "to_visual_latent.weight": t(clip_cfg.dim_latent, side * side * d)}
    p = "text_transformer."
    sd[p + "embeddings.word_embeddings.weight"] = t(bert_cfg.vocab_size, hid)
    sd[p + "embeddings.position_embeddings.weight"] = t(bert_cfg.max_position_embeddings, hid)
    sd[p + "embeddings.token_type_embeddings.weight"] = t(bert_cfg.type_vocab_size, hid)
    sd[p + "embeddings.LayerNorm.weight"] = gain(hid)
    sd[p + "embeddings.LayerNorm.bias"] = t(hid)
    for i in range(bert_cfg.num_layers):
        lp = p + f"encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key", "attention.self.value",
                     "attention.output.dense"):
            sd[lp + name + ".weight"] = t(hid, hid)
            sd[lp + name + ".bias"] = t(hid)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[lp + name + ".weight"] = gain(hid)
            sd[lp + name + ".bias"] = t(hid)
        sd[lp + "intermediate.dense.weight"] = t(bert_cfg.intermediate_size, hid)
        sd[lp + "intermediate.dense.bias"] = t(bert_cfg.intermediate_size)
        sd[lp + "output.dense.weight"] = t(hid, bert_cfg.intermediate_size)
        sd[lp + "output.dense.bias"] = t(hid)
    v = "visual_transformer."
    sd[v + "to_patch_emb.1.weight"] = gain(pd)
    sd[v + "to_patch_emb.1.bias"] = t(pd)
    sd[v + "to_patch_emb.2.weight"] = t(d, pd)
    sd[v + "to_patch_emb.2.bias"] = t(d)
    sd[v + "to_patch_emb.3.weight"] = gain(d)
    sd[v + "to_patch_emb.3.bias"] = t(d)
    sd[v + "spatial_rel_pos_bias.net.0.0.weight"] = t(d, 2)
    sd[v + "spatial_rel_pos_bias.net.0.0.bias"] = t(d)
    sd[v + "spatial_rel_pos_bias.net.1.0.weight"] = t(d, d)
    sd[v + "spatial_rel_pos_bias.net.1.0.bias"] = t(d)
    sd[v + "spatial_rel_pos_bias.net.2.weight"] = t(heads, d)
    sd[v + "spatial_rel_pos_bias.net.2.bias"] = t(heads)
    for name, depth in (("enc_spatial_transformer", vit_cfg.spatial_depth),
                        ("enc_temporal_transformer", vit_cfg.temporal_depth)):
        base = v + name
        sd[base + ".norm_out.gamma"] = gain(d)
        for i in range(depth):
            lp = f"{base}.layers.{i}"
            sd[lp + ".0.dsconv.weight"] = t(d, 1, 3, 3, 3)
            sd[lp + ".0.dsconv.bias"] = t(d)
            sd[lp + ".1.norm.gamma"] = gain(d)
            sd[lp + ".1.to_q.weight"] = t(inner, d)
            sd[lp + ".1.to_kv.weight"] = t(inner * 2, d)
            sd[lp + ".1.to_out.weight"] = t(d, inner)
            sd[lp + ".1.q_scale"] = gain(dh)
            sd[lp + ".1.k_scale"] = gain(dh)
            sd[lp + ".3.0.weight"] = gain(d)
            sd[lp + ".3.0.bias"] = t(d)
            sd[lp + ".3.1.weight"] = t(ff_inner * 2, d)
            sd[lp + ".3.4.weight"] = t(d, ff_inner)
    sd[v + "vq._codebook.embed"] = l2norm(
        torch.randn(1, vit_cfg.codebook_size, d, generator=gen, device=dev))
    return sd


def zeroshot_files(dev) -> None:
    """Phase zeroshot-files: the zero-shot evaluation a user runs from files,
    at the shipped CT-CLIP geometry, in a temporary directory."""
    import tempfile

    import numpy as np
    import torch

    from ctpa_torch.cli import preprocess as pre_cli
    from ctpa_torch.cli import zeroshot_infer as zs_cli
    from ctpa_torch.core.checkpoint import CheckpointManager
    from ctpa_torch.core.config import BertConfig, CTCLIPConfig, CTViTConfig, PreprocessConfig
    from ctpa_torch.data import nifti
    from ctpa_torch.data.datasets import CTReportInferenceDataset
    from ctpa_torch.data.manifests import write_csv
    from ctpa_torch.data.tokenizer import SimpleWordTokenizer
    from ctpa_torch.eval.zeroshot import PATHOLOGIES
    from ctpa_torch.models.ctclip import CTCLIP
    from ctpa_torch.models.pretrained import build_ctclip
    from ctpa_torch.ops.flash_attention import LAUNCHES
    from ctpa_torch.ops.patchify import patchify_project
    from ctpa_torch.ops.vq import VQState

    vit_cfg, bert_cfg, clip_cfg = CTViTConfig(), BertConfig(), CTCLIPConfig()
    kernel_cfg = dataclasses.replace(vit_cfg, pallas_patchify=True, flash_axial=True,
                                     peg_reference_layout=True)
    bf16 = torch.bfloat16
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zeroshot_") as tmp:
        pt = os.path.join(tmp, "CT-CLIP_v2.pt")
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(SEED + 30)
        sd = reference_ctclip_state(vit_cfg, bert_cfg, clip_cfg, gen, dev)
        n_params = sum(x.numel() for x in sd.values())
        torch.save({k: x.cpu() for k, x in sd.items()}, pt)
        del sd
        print(f"  CT-CLIP_v2.pt: {n_params / 1e6:.1f} M values, "
              f"{os.path.getsize(pt) / 1e9:.3f} GB, written in {time.perf_counter() - t0:.2f} s")

        raw_dir, data_dir = os.path.join(tmp, "nifti"), os.path.join(tmp, "npz")
        os.makedirs(raw_dir)
        rng = np.random.default_rng(SEED + 31)
        names = [f"zs{i:03d}" for i in range(ZS_VOLUMES)]
        for name in names:
            stored = rng.integers(0, 3000, size=ZS_NIFTI_SHAPE, dtype=np.int16)
            nifti.save(os.path.join(raw_dir, name + ".nii"), stored, spacing=ZS_SPACING,
                       scl_slope=1.0, scl_inter=-1024.0)
        t0 = time.perf_counter()
        grid = (vit_cfg.temporal_size, vit_cfg.image_size, vit_cfg.image_size)
        pre_cli.main(["--input-dir", raw_dir, "--output-dir", data_dir, "--split", "valid",
                      "--window", "inference", "--target-shape", *map(str, grid)], device=dev)
        torch.cuda.synchronize()
        npz = sorted(f for _, _, files in os.walk(data_dir) for f in files if f.endswith(".npz"))
        meta = [f for f in ("train_metadata.csv", "test_metadata.csv")
                if os.path.exists(os.path.join(data_dir, f))]
        print(f"  preprocess CLI: {len(npz)} npz, {meta}, {time.perf_counter() - t0:.2f} s")
        if npz != [n + ".npz" for n in names] or len(meta) != 2:
            raise AssertionError(f"preprocess CLI wrote {npz} and {meta}")

        reports, labels = os.path.join(tmp, "reports.csv"), os.path.join(tmp, "labels.csv")
        write_csv(reports, [{"impression_id": n, "impressions": f"Findings of {n}."}
                            for n in names])
        # every column holds both classes
        onehot = [[(i + j) % 2 for j in range(len(PATHOLOGIES))] for i in range(len(names))]
        write_csv(labels, [{"VolumeName": n, **dict(zip(PATHOLOGIES, row))}
                           for n, row in zip(names, onehot)])
        dataset = CTReportInferenceDataset(data_dir, reports, labels, PATHOLOGIES)
        if len(dataset) != len(names):
            raise AssertionError(f"the dataset found {len(dataset)} of {len(names)} volumes")
        pre_cfg = dataclasses.replace(PreprocessConfig.inference(), target_shape=grid)
        tok = SimpleWordTokenizer(bert_cfg.vocab_size, bert_cfg.max_position_embeddings)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre = build_ctclip(pt, vit_cfg=kernel_cfg, dtype=bf16, device=dev)
        torch.cuda.synchronize()
        print(f"  build_ctclip({os.path.basename(pt)}, bf16): {time.perf_counter() - t0:.2f} s, "
              f"skipped {pre.skipped}")
        if pre.skipped:
            raise AssertionError(f"the import skipped {pre.skipped}")
        model, vq = pre.model.eval(), pre.vq_state

        encode = model.encode_image
        encode_s = []

        def timed_encode(video, vq_state=None):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = encode(video, vq_state)
            torch.cuda.synchronize()
            encode_s.append(time.perf_counter() - t)
            return out

        model.encode_image = timed_encode
        out_k, out_p = os.path.join(tmp, "kernels"), os.path.join(tmp, "plain")
        torch.cuda.reset_peak_memory_stats()
        patchify_project.launches = 0
        for key in LAUNCHES:
            LAUNCHES[key] = 0
        t0 = time.perf_counter()
        summary = zs_cli.run_zeroshot(model, vq, dataset, tok, out_k, pre_cfg=pre_cfg,
                                      batch_size=1)
        wall = time.perf_counter() - t0
        k1, k2 = patchify_project.launches, LAUNCHES["flash_attention_fwd"]
        peak = torch.cuda.max_memory_allocated()
        print(f"  run_zeroshot (kernels): {summary}, {wall:.2f} s for {len(names)} volumes "
              f"({wall / len(names) * 1e3:.1f} ms a volume, prompts and evaluation included); "
              f"encode_image {statistics.median(encode_s) * 1e3:.1f} ms a volume (median, "
              f"preprocess excluded); peak memory {peak / 2**30:.2f} GiB; launches "
              f"patchify_project {k1}, flash_attention_fwd {k2}")
        if (k1, k2) != (len(names), vit_cfg.spatial_depth * len(names)):
            raise AssertionError(f"launches (patchify, flash) {(k1, k2)}, expected "
                                 f"{(len(names), vit_cfg.spatial_depth * len(names))}")
        if not math.isfinite(summary["mean_auc"]) or summary["n"] != len(names):
            raise AssertionError(f"run_zeroshot returned {summary}")

        plain = CTCLIP(clip_cfg, dataclasses.replace(kernel_cfg, pallas_patchify=False,
                                                     flash_axial=False),
                       bert_cfg, device=dev, dtype=bf16).eval()
        plain.load_state_dict(model.state_dict())
        zs_cli.run_zeroshot(plain, vq, dataset, tok, out_p, pre_cfg=pre_cfg, batch_size=1)
        if (patchify_project.launches, LAUNCHES["flash_attention_fwd"]) != (k1, k2):
            raise AssertionError("the plain path launched a kernel")
        got = np.load(os.path.join(out_k, "predicted_weights.npz"))["data"]
        ref = np.load(os.path.join(out_p, "predicted_weights.npz"))["data"]
        dp = float(np.abs(got - ref).max())
        print(f"  kernels vs plain: max |prob diff| {dp:.3e} (<= {PROB_ATOL}) over "
              f"{got.shape} probabilities")
        if got.shape != (len(names), len(PATHOLOGIES)) or not dp <= PROB_ATOL:
            raise AssertionError(f"kernel path and plain path disagree by {dp}")
        del plain

        ckpt, out_cli, out_ref = (os.path.join(tmp, d) for d in ("ckpt", "cli", "ref"))
        CheckpointManager(ckpt).save(0, {"params": model.state_dict(),
                                         "vq_state": vq._asdict()})
        del model, pre
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rc = zs_cli.main(["--data-dir", data_dir, "--reports-csv", reports, "--labels-csv",
                          labels, "--checkpoint-dir", ckpt, "--out-dir", out_cli], device=dev)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        missing = [f for f in ("labels_weights.npz", "predicted_weights.npz", "accessions.txt",
                               "aurocs.csv", "bootstrap_cis.csv")
                   if not os.path.exists(os.path.join(out_cli, f))]
        if rc != 0 or missing:
            raise AssertionError(f"zeroshot_infer.main returned {rc}, missing {missing}")
        state = CheckpointManager(ckpt).restore(map_location=dev)
        twin = CTCLIP(clip_cfg, vit_cfg, bert_cfg, device=dev).eval()
        twin.load_state_dict(state["params"])
        vq32 = VQState(**{k: torch.as_tensor(x, device=dev)
                          for k, x in state["vq_state"].items()})
        zs_cli.run_zeroshot(twin, vq32, dataset, tok, out_ref, pre_cfg=pre_cfg)
        got = np.load(os.path.join(out_cli, "predicted_weights.npz"))["data"]
        ref = np.load(os.path.join(out_ref, "predicted_weights.npz"))["data"]
        dcli = float(np.abs(got - ref).max())
        # the rows come in the dataset's order, which os.walk gives
        want = np.asarray([onehot[names.index(vid)] for _, vid in dataset.samples], np.float32)
        same_labels = np.array_equal(np.load(os.path.join(out_cli, "labels_weights.npz"))["data"],
                                     want)
        print(f"  zeroshot_infer.main (CTViTConfig() fp32, no kernels): {cli_s:.2f} s, "
              f"artifacts complete; predictions vs run_zeroshot on the restored state: "
              f"max |diff| {dcli:.3e} (<= {ZS_CLI_ATOL}); labels equal {same_labels}")
        if not dcli <= ZS_CLI_ATOL or not same_labels:
            raise AssertionError("zeroshot_infer.main disagrees with run_zeroshot")
        del twin, state


def rf_volume(gen, shape) -> "np.ndarray":
    """A seeded uniform(-1, 1) fp32 volume drawn on the card's generator."""
    import torch

    return (torch.rand(shape, generator=gen, device=gen.device) * 2 - 1).cpu().numpy()


def rf_write_files(root: str, dev) -> dict:
    """Phase report-files' inputs under ``root``, from a seed: RF_ITEMS
    pre-normalised inference volumes (INFER_SHAPE, (h, w, d)) with reports
    (gen.jsonl); RF_TRAIN_ITEMS + 1 volumes on the training grid (240, 480,
    480) (train.jsonl, val.jsonl), their reports 100-600 words (cut at 512
    tokens); the tiny (16, 32, 32) ones for the --tiny runs, and a VQA
    manifest.  -> the manifests' paths."""
    import numpy as np
    import torch

    from ctpa_torch.core.config import CTViTConfig

    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    rng = np.random.default_rng(SEED + 30)
    vit, tiny = CTViTConfig(), CTViTConfig.tiny()
    train_grid = (vit.temporal_size, vit.image_size, vit.image_size)
    tiny_grid = (tiny.temporal_size, tiny.image_size, tiny.image_size)
    paths = {}

    def manifest(name, shape, count, words, vqa=False):
        rows = []
        for i in range(count):
            vol = os.path.join(root, f"{name}_{i}.npz")
            np.savez(vol, rf_volume(gen, shape))
            text = " ".join(rng.choice(RF_WORDS, size=int(rng.integers(*words))))
            rows.append({"image_path": vol, "question": "Is there a pulmonary embolism?",
                         "answer": text} if vqa else {"image_path": vol, "report": text})
        paths[name] = os.path.join(root, f"{name}.jsonl")
        with open(paths[name], "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)

    manifest("gen", INFER_SHAPE, RF_ITEMS, (20, 60))
    manifest("train", train_grid, RF_TRAIN_ITEMS, (100, 600))
    manifest("val", train_grid, 1, (20, 60))
    manifest("tiny_train", tiny_grid, 4, (4, 12))
    manifest("tiny_val", tiny_grid, 1, (4, 12))
    manifest("tiny_vqa", tiny_grid, 4, (2, 6), vqa=True)
    return paths


@functools.cache
def stable_word_tokenizer():
    """SimpleWordTokenizer with its word ids from CRC-32 in place of Python's
    salted ``hash``: the same ids in every process, so phase report-files
    generates, trains and gates on the same tokens in every run."""
    import zlib

    from ctpa_torch.data.tokenizer import SimpleWordTokenizer

    class StableWordTokenizer(SimpleWordTokenizer):
        def _tok(self, word: str) -> int:
            return self._reserved + zlib.crc32(word.encode()) % (self.vocab_size - self._reserved)

    return StableWordTokenizer


@contextlib.contextmanager
def recording_decode():
    """generate_report's SimpleWordTokenizer replaced by the stable one,
    recording the ids of every ``decode`` (the CLI's generated tokens, in
    item order); yields the list they go to."""
    from ctpa_torch.cli import generate_report

    plain, decoded = generate_report.SimpleWordTokenizer, []

    class Recording(stable_word_tokenizer()):
        def decode(self, ids):
            decoded.append([int(i) for i in ids])
            return super().decode(ids)

    generate_report.SimpleWordTokenizer = Recording
    try:
        yield decoded
    finally:
        generate_report.SimpleWordTokenizer = plain


@contextlib.contextmanager
def recording_requests():
    """generate_report's Request replaced by a function that records each
    request's vision feature (in item order) and makes the request; yields
    the list they go to."""
    from ctpa_torch.cli import generate_report

    plain, visions = generate_report.Request, []

    def recording(**fields):
        visions.append(fields["vision"])
        return plain(**fields)

    generate_report.Request = recording
    try:
        yield visions
    finally:
        generate_report.Request = plain


def rf_results(out_dir: str) -> tuple[list, dict]:
    with open(os.path.join(out_dir, "evaluation_results.json")) as f:
        payload = json.load(f)
    return payload["samples"], payload["metrics"]


def rf_generate(dev, rows: dict, root: str, paths: dict, qmodel) -> str:
    """generate_report.main at Meditron-7B width from the w8a8 bundle: the
    launches of K4, K6 and K8, the predictions and metrics; then the CLI's
    tokens teacher-forced through the bundle's model (the CLI's plain patch
    embed), through the same tensors with the plain versions (quant_impl
    "xla", flash_decode off) and through an fp32 model of the dequantized
    weights, under quant-plain's gates; the give-back of the CLI's tokens
    and the vision feature each request carried, each against a planted CLI
    fault; then one item through --speculative.  -> the results JSON."""
    import torch

    from ctpa_torch.cli import generate_report
    from ctpa_torch.core.config import CTViTConfig, PreprocessConfig
    from ctpa_torch.data.datasets import ReportGenDataset
    from ctpa_torch.ops import decode_attention as da
    from ctpa_torch.ops import quant
    from ctpa_torch.ops.preprocess import preprocess_volume_inference

    argv = ["--jsonl", paths["gen"], "--serving-bundle", RF_BUNDLE, "--greedy",
            "--max-new-tokens", str(RF_NEW_TOKENS), "--num-lanes", str(RF_LANES)]
    out = os.path.join(root, "generated")
    torch.cuda.synchronize()
    for counts in (quant.LAUNCHES, da.LAUNCHES):
        for key in counts:
            counts[key] = 0
    t0 = time.perf_counter()
    with recording_decode() as decoded, recording_requests() as visions:
        rc = generate_report.main(argv + ["--out-dir", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {**{k: v for k, v in quant.LAUNCHES.items() if v}, **da.LAUNCHES}
    samples, metrics = rf_results(out)
    print(f"  generate_report.main (w8a8 bundle, {RF_ITEMS} items, {RF_LANES} lanes, "
          f"{RF_NEW_TOKENS} greedy tokens; bundle load included): {wall:.2f} s; tokens "
          f"{[r['tokens'] for r in samples]}; launches {launched}")
    print("  metrics " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    need = ("int8_matmul_a8", "int8_matmul_a8_prefill", "int8_ffn_a8", "int8_ffn_a8_prefill",
            "decode_attention")
    if rc != 0 or any(not launched.get(k) for k in need) or len(samples) != RF_ITEMS \
            or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"generate_report: rc {rc}, launches {launched}, "
                             f"{len(samples)} records, metrics {metrics}")
    for key, n in launched.items():
        rows[key]["launches"] += n

    # the gates, teacher-forced on the CLI's tokens
    t0 = time.perf_counter()
    steps = min(len(t) for t in decoded[:RF_ITEMS])
    tokens = torch.tensor([t[:steps] for t in decoded[:RF_ITEMS]], device=dev)
    ds = ReportGenDataset(paths["gen"])
    items = [ds[i] for i in range(RF_ITEMS)]
    video = torch.stack([preprocess_volume_inference(it["volume"], PreprocessConfig.inference(),
                                                     device=dev) for it in items])
    toks = stable_word_tokenizer()(vocab_size=qmodel.llm_cfg.vocab_size)(
        [it["prompt"] for it in items], max_length=64)
    ids, mask = (torch.as_tensor(toks[k], device=dev).long()
                 for k in ("input_ids", "attention_mask"))
    cli = twin(qmodel, vit_cfg=CTViTConfig())
    with torch.inference_mode():
        vision = cli.extract_vision(video)
        kernel = teacher_forced_logits(cli, video, ids, mask, tokens, vision)
        plain = teacher_forced_logits(twin(cli, quant_impl="xla", flash_decode=False), video,
                                      ids, mask, tokens, vision)
        reference = dequantized_fp32(cli)
        fp32 = teacher_forced_logits(reference, video, ids, mask, tokens)
        del reference
        # planted CLI faults, over their first RF_FAULT_STEPS steps: the
        # tokens a CLI that drops the prompt's first token would emit, and
        # the records of a CLI that gives each item its neighbour's lane (not
        # gated by the give-back: the seeded model's tokens hang on the
        # prompt far more than on the vision feature)
        pad = torch.zeros_like(ids[:, :1])
        shifted = teacher_forced_logits(cli, video, torch.cat([ids[:, 1:], pad], 1),
                                        torch.cat([mask[:, 1:], pad], 1), None, vision,
                                        RF_FAULT_STEPS)
        give_back = {label: (teacher_forced_logits(cli, video, ids, mask, t, vision).argmax(-1)
                             == t).float().mean().item()
                     for label, t in (("prompt shifted", shifted.argmax(-1)),
                                      ("neighbour lane", tokens.roll(1, 0)[:, :RF_FAULT_STEPS]))}
        del shifted
    again = (kernel.argmax(-1) == tokens).float().mean().item()
    again_first = (kernel.argmax(-1) == tokens)[:, :RF_FAULT_STEPS].float().mean().item()
    # the vision feature each request carried against the twin's for its item
    # (the twin extracts at batch RF_ITEMS, the CLI one item at a time)
    carried, own = torch.stack(visions[:RF_ITEMS]).float(), vision.float()

    def vision_err(v) -> float:
        return ((v - own).flatten(1).abs().amax(1) / own.flatten(1).abs().amax(1)).max().item()

    v_err, v_fault = vision_err(carried), vision_err(carried.roll(1, 0))
    p_f = logit_distance(plain, fp32)
    print(f"  the CLI's {tokens.numel()} (item, step) tokens, teacher-forced: the bundle's "
          f"kernel path gives {again:.4f} of them back (>= {RF_GIVE_BACK_MIN}); over the first "
          f"{RF_FAULT_STEPS} steps {again_first:.4f}, and planted, the prompt shifted by one "
          f"token {give_back['prompt shifted']:.4f} (< {RF_GIVE_BACK_MIN}), each item given its "
          f"neighbour's lane {give_back['neighbour lane']:.4f} (not gated)")
    print(f"  the vision feature each request carried: max |diff| / max |feature| from the "
          f"twin's for its item {v_err:.3e} (<= {RF_VISION_RTOL}); planted, its neighbour's "
          f"{v_fault:.3e} (> {RF_VISION_RTOL})")
    print("  worst max |diff| / max |logit| per step, mean |diff|, top-1")
    print(f"    {'plain vs fp32':<30} {p_f[0]:.4f}  {p_f[1]:.5f}  {p_f[2]:.4f}")
    ok = report_gate("generate_report w8a8", kernel, plain, fp32, p_f, ratio=QUANT_FP32_RATIO,
                     slack=QUANT_FP32_TOP1_SLACK, top1_min=QUANT_TOP1_MIN)
    if not ok or again < RF_GIVE_BACK_MIN or v_err > RF_VISION_RTOL:
        raise AssertionError("generate_report's kernel path fails the plain path's gates")
    if give_back["prompt shifted"] >= RF_GIVE_BACK_MIN or v_fault <= RF_VISION_RTOL:
        raise AssertionError(f"a planted CLI fault passes: give-back {give_back}, vision "
                             f"{v_fault:.3e}")
    print(f"  gates: {time.perf_counter() - t0:.2f} s")
    del kernel, plain, fp32, cli
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    spec_out = os.path.join(root, "speculative")
    spec_argv = argv[:argv.index("--max-new-tokens")] + ["--max-new-tokens", str(RF_SPEC_TOKENS)]
    with recording_decode() as spec_tokens:
        rc = generate_report.main(spec_argv + ["--speculative", str(RF_SPEC_K), "--max-samples",
                                               "1", "--out-dir", spec_out])
    spec, spec_metrics = rf_results(spec_out)
    first = next((j for j, (a, b) in enumerate(zip(spec_tokens[0], decoded[0])) if a != b), None)
    print(f"  generate_report.main --speculative {RF_SPEC_K} (1 item, {RF_SPEC_TOKENS} tokens; "
          f"bundle load included): {time.perf_counter() - t0:.2f} s; {spec[0]['tokens']} tokens "
          f"in {spec[0]['verify_steps']} verifies; the batcher's tokens "
          f"{'throughout' if first is None else f'up to position {first}'} (not gated: the "
          f"verify's 5-row forms and dense attention round otherwise than the decode steps)")
    if rc != 0 or spec[0]["tokens"] < 1 or spec[0]["verify_steps"] < 1 \
            or not all(math.isfinite(v) for v in spec_metrics.values()):
        raise AssertionError(f"generate_report --speculative: rc {rc}, {spec}")
    torch.cuda.empty_cache()
    return os.path.join(out, "evaluation_results.json")


BERT_LAYER_SHAPES = {"attention.self.query": "hh", "attention.self.key": "hh",
                     "attention.self.value": "hh", "attention.output.dense": "hh",
                     "intermediate.dense": "ih", "output.dense": "hi"}


def bert_snapshot(root: str, gen) -> str:
    """A seeded BERT at BertConfig() geometry (CXR-BERT's) as a local HF
    snapshot: every tensor in one BF16 safetensors shard (normal(0,
    RF_BERT_STD), LayerNorm gains 1), and a BERT WordPiece tokenizer as
    files (vocab.txt and tokenizer_config.json, as a hub snapshot has them;
    transformers 5 drops the vocabulary of a tokenizer built from
    ``vocab_file`` and saved, so nothing is built here)."""
    import torch

    from ctpa_torch.core.config import BertConfig

    cfg = BertConfig()
    dims = {"h": cfg.hidden_size, "i": cfg.intermediate_size}
    shapes = {"embeddings.word_embeddings.weight": (cfg.vocab_size, cfg.hidden_size),
              "embeddings.position_embeddings.weight": (cfg.max_position_embeddings,
                                                        cfg.hidden_size),
              "embeddings.token_type_embeddings.weight": (cfg.type_vocab_size, cfg.hidden_size),
              "embeddings.LayerNorm.weight": (cfg.hidden_size,),
              "embeddings.LayerNorm.bias": (cfg.hidden_size,)}
    for i in range(cfg.num_layers):
        for name, (o, n) in BERT_LAYER_SHAPES.items():
            shapes[f"encoder.layer.{i}.{name}.weight"] = (dims[o], dims[n])
            shapes[f"encoder.layer.{i}.{name}.bias"] = (dims[o],)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes[f"encoder.layer.{i}.{ln}.weight"] = (cfg.hidden_size,)
            shapes[f"encoder.layer.{i}.{ln}.bias"] = (cfg.hidden_size,)
    snap = os.path.join(root, "cxr_bert")
    os.makedirs(snap)
    header, blobs, offset = {}, [], 0
    for name, shape in shapes.items():
        value = (torch.ones(shape, device=gen.device) if name.endswith("LayerNorm.weight")
                 else RF_BERT_STD * torch.randn(shape, generator=gen, device=gen.device))
        raw = value.to(torch.bfloat16).view(torch.int16).cpu().numpy().tobytes()
        header[name] = {"dtype": "BF16", "shape": list(shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header).encode()
    with open(os.path.join(snap, "model.safetensors"), "wb") as f:
        f.write(len(text).to_bytes(8, "little") + text + b"".join(blobs))
    with open(os.path.join(snap, "vocab.txt"), "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *RF_WORDS]) + "\n")
    with open(os.path.join(snap, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "BertTokenizer", "do_lower_case": True,
                   "model_max_length": cfg.max_position_embeddings}, f)
    return snap


def rf_evaluate(dev, root: str, results: str) -> None:
    """evaluate.main nlg on generate_report's results with BERTScore from a
    BF16 CXR-BERT-geometry snapshot (IDF weighted), then --compute-baseline
    over the references and predictions."""
    import numpy as np
    import torch

    from ctpa_torch.cli import evaluate
    from ctpa_torch.data.hf_import import load_safetensors

    t0 = time.perf_counter()
    snap = bert_snapshot(root, torch.Generator(device=dev).manual_seed(SEED + 31))
    st = load_safetensors(os.path.join(snap, "model.safetensors"))
    word = st["embeddings.word_embeddings.weight"]
    print(f"  BF16 snapshot: {len(st)} tensors, {sum(v.size for v in st.values()) / 1e6:.1f} M "
          f"values, {os.path.getsize(os.path.join(snap, 'model.safetensors')) / 1e6:.1f} MB, "
          f"read as {word.dtype}; written and read back in {time.perf_counter() - t0:.2f} s")
    if word.dtype != np.float32 or np.any(word.view(np.uint32) & 0xFFFF):
        raise AssertionError("the BF16 shard did not read as its bf16 values in fp32")
    del st, word
    from ctpa_torch.data.tokenizer import HFTokenizer

    ids = HFTokenizer(snap, max_length=8)([" ".join(RF_WORDS[:3])])["input_ids"][0].tolist()
    if ids != [2, 5, 6, 7, 3, 0, 0, 0]:
        raise AssertionError(f"the snapshot's tokenizer gives {ids} for {RF_WORDS[:3]}")
    samples, _ = rf_results(os.path.dirname(results))
    corpus = os.path.join(root, "corpus.txt")
    with open(corpus, "w") as f:
        f.write("\n".join(r[k] for r in samples for k in ("reference", "prediction")) + "\n")
    outputs = {}
    for label, argv in (("nlg --idf", ["nlg", "--results", results, "--encoder-path", snap,
                                       "--idf"]),
                        ("nlg --compute-baseline", ["nlg", "--compute-baseline",
                                                    "--encoder-path", snap, "--corpus", corpus,
                                                    "--baseline-out",
                                                    os.path.join(root, "baseline.json")])):
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = evaluate.main(argv)
        torch.cuda.synchronize()
        outputs[label] = json.loads(buf.getvalue())
        print(f"  evaluate.main {label}: {time.perf_counter() - t0:.2f} s; "
              + ", ".join(f"{k} {v:.4f}" for k, v in outputs[label].items()))
        if rc != 0 or not all(math.isfinite(v) for v in outputs[label].values()):
            raise AssertionError(f"evaluate {label}: rc {rc}, {outputs[label]}")
    if not 0 < outputs["nlg --idf"].get("bertscore_f1", 0) < 1:
        raise AssertionError("evaluate nlg gave no BERTScore")


def rf_train(dev, rows: dict, paths: dict, root: str, model) -> None:
    """train_report's pieces at Meditron-7B width with --flash-prefill on the
    report phase's bf16 base (LoRA rank 16; trainable tensors fp32): its
    loader (batch 2 x 512 tokens) and eval_fn, and a ReportTrainer epoch of
    partitioned steps; the first step's loss against the dense path's on
    the same state and batch (report-train-plain's loss gate)."""
    import torch

    from ctpa_torch.cli import train_report
    from ctpa_torch.core.config import TrainConfig
    from ctpa_torch.data.datasets import ReportGenDataset
    from ctpa_torch.ops.flash_attention import LAUNCHES
    from ctpa_torch.train.report_trainer import ReportTrainer, make_partitioned_report_step
    from ctpa_torch.train.train_state import SimpleTrainState

    t0 = time.perf_counter()
    start = report_train_start(model, dev, seed=SEED + 32)
    kernel_m = report_train_model(model, start)
    tok = stable_word_tokenizer()(vocab_size=model.llm_cfg.vocab_size, max_length=512)
    train_ds, val_ds = ReportGenDataset(paths["train"]), ReportGenDataset(paths["val"])
    loader = train_report.make_loader(train_ds, tok, 2, 512)
    first = {k: torch.as_tensor(v).to(dev) for k, v in next(loader()).items()}
    lens = first["attention_mask"].sum(-1).tolist()
    with torch.no_grad():
        dense = report_train_model(model, start, flash_prefill=False)
        ref_loss = float(dense.loss(first["video"], first["input_ids"], first["attention_mask"]))
        del dense
    steps = RF_TRAIN_ITEMS // 2
    step_fn, tx = make_partitioned_report_step(kernel_m, kernel_m.gen_cfg, total_steps=steps)
    trainer = ReportTrainer(
        kernel_m, SimpleTrainState.create(kernel_m, tx), tx,
        cfg=TrainConfig(results_dir=os.path.join(root, "train_results"),
                        checkpoint_dir=os.path.join(root, "train_checkpoints")),
        eval_fn=train_report.make_eval_fn(kernel_m, tok, val_ds, kernel_m.gen_cfg),
        step_fn=step_fn)
    torch.cuda.synchronize()
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    t1 = time.perf_counter()
    res = trainer.train_epoch(loader(), 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    trainer.close()
    hist = trainer.metrics.history
    losses = [v for _, v in hist["loss"]]
    launched = {k: LAUNCHES[k] for k in REPORT_TRAIN_KERNELS}
    val = {k.removeprefix("val/"): v[-1][1] for k, v in hist.items() if k.startswith("val/")}
    print(f"  train_report pieces (--flash-prefill, batch 2 x 512, real lengths {lens}): "
          f"{steps} steps and eval_fn in {wall:.2f} s (set-up {t1 - t0:.2f} s); losses "
          f"{[round(x, 6) for x in losses]}, dense path's first {ref_loss:.6f} (|diff| "
          f"{abs(losses[0] - ref_loss):.2e} <= {REPORT_TRAIN_LOSS_ATOL}); val composite "
          f"{val.get('composite', float('nan')):.4f}; checkpoints {trainer.ckpt.all_steps()}; "
          f"launches {launched}")
    expect = model.llm_cfg.num_layers * steps
    if len(losses) != steps or not all(math.isfinite(x) for x in losses) \
            or abs(losses[0] - ref_loss) > REPORT_TRAIN_LOSS_ATOL \
            or any(n != expect for n in launched.values()) or "composite" not in val \
            or trainer.ckpt.all_steps() != [steps, steps + 1] \
            or not math.isfinite(res["mean_loss"]):
        raise AssertionError(f"train_report pieces: losses {losses} vs {ref_loss}, launches "
                             f"{launched} (expected {expect} each), val {val}")
    for name, n in launched.items():
        rows[name + ("_d128" if name == "flash_attention_bwd_delta" else "")]["launches"] += n
    del trainer, kernel_m, step_fn, tx, first
    torch.cuda.empty_cache()


def rf_tiny(dev, root: str, paths: dict) -> None:
    """The three CLIs' main() at --tiny on the card: train_report (an epoch,
    then its VQA mode), generate_report from that checkpoint directory (its
    base.pt and latest step), evaluate nlg on the results."""
    import torch

    from ctpa_torch.cli import evaluate, generate_report, train_report

    t0 = time.perf_counter()
    ckpt, res, gen = (os.path.join(root, f"tiny_{n}") for n in ("ckpt", "results", "generated"))
    common = ["--tiny", "--epochs", "1", "--max-length", "32"]
    rcs = [train_report.main(["--train-jsonl", paths["tiny_train"], "--val-jsonl",
                              paths["tiny_val"], "--checkpoint-dir", ckpt, "--results-dir", res,
                              *common]),
           train_report.main(["--train-jsonl", paths["tiny_vqa"], "--mode", "vqa",
                              "--checkpoint-dir", ckpt + "_vqa", "--results-dir", res + "_vqa",
                              *common]),
           generate_report.main(["--jsonl", paths["tiny_val"], "--tiny", "--checkpoint-dir", ckpt,
                                 "--greedy", "--max-new-tokens", "8", "--out-dir", gen])]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rcs.append(evaluate.main(["nlg", "--results",
                                  os.path.join(gen, "evaluation_results.json")]))
    torch.cuda.synchronize()
    metrics = json.loads(buf.getvalue())
    print(f"  --tiny on the card: train_report (report, vqa), generate_report, evaluate: exit "
          f"codes {rcs}, {time.perf_counter() - t0:.2f} s; checkpoint directory "
          f"{sorted(os.listdir(ckpt))}; composite {metrics['composite']:.4f}")
    if any(rcs) or "base.pt" not in os.listdir(ckpt):
        raise AssertionError(f"--tiny CLIs: exit codes {rcs}")


def rf_vqa(dev) -> None:
    """MedicalVQAModel at BertConfig() width with the shipped CTViT patch
    embed (LoRA rank 16 on the BERT q/k/v), seeded: logits, loss, one
    make_vqa_optimizer step and a short greedy generate."""
    import torch

    from ctpa_torch.core.config import BertConfig, CTViTConfig
    from ctpa_torch.core.init import random_init_
    from ctpa_torch.models.vqa_bert import MedicalVQAModel, make_vqa_optimizer

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 33)
    bert, vit = BertConfig(), CTViTConfig()
    model = random_init_(MedicalVQAModel(bert, vit, lora_rank=16, lora_alpha=32.0, device=dev),
                         gen)
    video = torch.rand(1, 1, vit.temporal_size, vit.image_size, vit.image_size, generator=gen,
                       device=dev) * 2 - 1
    ids = torch.randint(1, bert.vocab_size, (1, 24), generator=gen, device=dev)
    mask = torch.ones_like(ids)
    opt = make_vqa_optimizer(model)
    logits = model(video, ids, mask)
    loss = model.loss(video, ids, mask)
    loss.backward()
    opt.step(0)
    out, lengths = model.generate(video, ids[:, :16], mask[:, :16], 4, sep_token_id=102)
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in opt.params)
    print(f"  MedicalVQAModel (BertConfig(), CTViTConfig() patch embed): "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters, "
          f"{n_train / 1e6:.2f} M trainable; logits {tuple(logits.shape)}, loss "
          f"{loss.item():.4f}, generated {out[0, 16:].tolist()}; {time.perf_counter() - t0:.2f} s")
    if tuple(logits.shape) != (1, 24, bert.vocab_size) or not torch.isfinite(logits).all() \
            or not math.isfinite(loss.item()) or not 16 < int(lengths[0]) <= 20 \
            or not all(torch.isfinite(p).all() for p in opt.params):
        raise AssertionError("MedicalVQAModel at BertConfig() width")
    del model, opt, logits, loss
    torch.cuda.empty_cache()


def report_files(dev, rows: dict, model, qmodel, card: str) -> None:
    """Phase report-files: the report workload a user runs from files, in a
    temporary directory; ``card`` is nvidia-smi's name and power limit."""
    import tempfile

    print(f"  on {card}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_report_files_") as root:
        t0 = time.perf_counter()
        paths = rf_write_files(root, dev)
        print(f"  files: {time.perf_counter() - t0:.2f} s")
        results = rf_generate(dev, rows, root, paths, qmodel)
        rf_evaluate(dev, root, results)
        rf_train(dev, rows, paths, root, model)
        rf_tiny(dev, root, paths)
        rf_vqa(dev)


def fused_name(kernel: str) -> str:
    """The kernels line's name of a flash kernel at the fused sequence."""
    return f"{kernel}_n{FUSED_SHAPE[2]}"


def by_head(fn, *args):
    """A plain flash function one head at a time, the heads concatenated:
    the 4-d and 3-d (lse, delta) tensors among ``args`` are sliced."""
    import torch

    outs = []
    for i in range(args[0].shape[1]):
        part = [a[:, i:i + 1] if torch.is_tensor(a) and a.ndim in (3, 4) else a for a in args]
        outs.append(fn(*part))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(xs, dim=1) for xs in zip(*outs))
    return torch.cat(outs, dim=1)


def fused_tolerance(ref, dtype) -> tuple[float, float]:
    """(atol, rtol) of a fused-form kernel's output against its plain
    version ``ref``: FP32's in fp32, else an atol of FUSED_ATOL_RMS times
    the RMS of ``ref``."""
    import torch

    if dtype == torch.float32:
        return FP32_ATOL, FP32_RTOL
    return FUSED_ATOL_RMS * ref.float().square().mean().sqrt().item(), BF16_RTOL


def rejects(got, ref, atol: float, rtol: float) -> bool:
    """Whether |got - ref| > atol + rtol * |ref| anywhere."""
    got, ref = got.float(), ref.float()
    return bool(((got - ref).abs() > atol + rtol * ref.abs()).any())


def fused_faults(q, k, v, lse, delta, do, scale: float, bound) -> dict:
    """What kernels that skip the last FUSED_FAULT_ROWS keys (the forward's
    output, dQ) or queries (dK, dV) would return at the fused form, from the
    plain versions: {"out", "dq", "dk", "dv"}."""
    from ctpa_torch.ops import flash_attention as fa

    r = FUSED_FAULT_ROWS
    out = by_head(fa.flash_attention_plain, q, k[:, :, :-r], v[:, :, :-r], None, scale, bound)
    dq = by_head(fa.flash_attention_bwd_dq_plain, q, k[:, :, :-r], v[:, :, :-r], None, lse,
                 delta, do, scale)
    dk, dv = by_head(fa.flash_attention_bwd_dkv_plain, q[:, :, :-r], k, v, None,
                     lse[:, :, :-r], delta[:, :, :-r], do[:, :, :-r], scale)
    return {"out": out, "dq": dq, "dk": dk, "dv": dv}


def fused_compare(name: str, got, ref, fault) -> float:
    """``compare`` under the fused form's bf16 limit, after checking that
    the limit rejects ``fault`` (a kernel that skips a tile); prints the
    least atol, in RMS of ``ref``, that each of the two needs."""
    atol, rtol = fused_tolerance(ref, got.dtype)
    rms = ref.float().square().mean().sqrt()

    def need(x) -> float:
        return (((x.float() - ref.float()).abs() - rtol * ref.float().abs()).max() / rms).item()

    print(f"  {name}: least atol the kernel needs {need(got):.4f} RMS, a kernel skipping the "
          f"last {FUSED_FAULT_ROWS} rows {need(fault):.4f} RMS (limit {FUSED_ATOL_RMS} RMS "
          f"= {atol:.3e})")
    if not rejects(fault, ref, atol, rtol):
        raise AssertionError(f"{name}: the limit passes a kernel that skips the last tile")
    return compare(name, got, ref, atol, rtol)


def clip_cli_files(root: str) -> dict:
    """CF_VOLUMES raw int16 training volumes with a metadata CSV and CF_VALID
    pre-normalised validation volumes with an 18-pathology labels CSV, one
    reports CSV for both, under ``root``; the paths by role."""
    import numpy as np

    from ctpa_torch.data.manifests import write_csv
    from ctpa_torch.eval.zeroshot import PATHOLOGIES

    paths = {k: os.path.join(root, k) for k in ("train", "valid")}
    paths.update({k: os.path.join(root, f"{k}.csv") for k in ("reports", "meta", "labels")})
    os.makedirs(paths["train"])
    os.makedirs(paths["valid"])
    rng = np.random.default_rng(SEED + 40)
    reports, meta, labels = [], [], []
    for i in range(CF_VOLUMES):
        name = f"cf{i:03d}"
        np.savez(os.path.join(paths["train"], name + ".npz"),
                 rng.integers(-24, 3000, size=RAW_SHAPE, dtype=np.int16))
        reports.append({"impression_id": name,
                        "impressions": f"Findings of {name}: no pulmonary embolism."})
        meta.append({"VolumeName": name + ".nii.gz", "RescaleSlope": 1.0,
                     "RescaleIntercept": -1024.0, "ZSpacing": RAW_SPACING[0],
                     "XYSpacing": RAW_SPACING[1]})
    for i in range(CF_VALID):
        name = f"cv{i:03d}"
        np.savez(os.path.join(paths["valid"], name + ".npz"),
                 rng.uniform(-1, 1, size=INFER_SHAPE).astype(np.float32))
        reports.append({"impression_id": name, "impressions": f"Findings of {name}."})
        # every column holds both classes
        labels.append({"VolumeName": name, **{p: (i + j) % 2 for j, p in enumerate(PATHOLOGIES)}})
    write_csv(paths["reports"], reports)
    write_csv(paths["meta"], meta)
    write_csv(paths["labels"], labels)
    return paths


def clip_files(dev) -> None:
    """Phase clip-files: train_clip.main at full width from files, then the
    SSL step's kernel and plain paths."""
    import tempfile

    import torch

    from ctpa_torch.cli import train_clip as tc_cli
    from ctpa_torch.core.checkpoint import CheckpointManager
    from ctpa_torch.core.config import CTViTConfig
    from ctpa_torch.core.profiling import TRACE_FILE
    from ctpa_torch.ops.flash_attention import LAUNCHES

    depth = CTViTConfig().spatial_depth
    steps, evals = [], []

    class Timed(tc_cli.CTClipTrainer):
        """The CLI's trainer, each step and eval timed with its launches."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            inner = self.eval_fn

            def timed_eval(state, step):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = LAUNCHES["flash_attention_fwd"]
                t = time.perf_counter()
                out = inner(state, step)
                torch.cuda.synchronize()
                evals.append((step, time.perf_counter() - t, out,
                              torch.cuda.max_memory_allocated(),
                              LAUNCHES["flash_attention_fwd"] - before))
                return out

            self.eval_fn = None if inner is None else timed_eval

        def train_step(self):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = dict(LAUNCHES)
            t = time.perf_counter()
            metrics = super().train_step()
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t, {k: LAUNCHES[k] - before[k] for k in LAUNCHES},
                          {k: float(v) for k, v in metrics.items()},
                          torch.cuda.max_memory_allocated()))
            return metrics

    with tempfile.TemporaryDirectory(prefix="chip_smoke_clip_") as tmp:
        t0 = time.perf_counter()
        paths = clip_cli_files(tmp)
        print(f"  files: {CF_VOLUMES} raw {RAW_SHAPE} int16 volumes with metadata, {CF_VALID} "
              f"pre-normalised {INFER_SHAPE} validation volumes with labels, written in "
              f"{time.perf_counter() - t0:.2f} s")
        res, ckpt, prof = (os.path.join(tmp, d) for d in ("results", "ckpt", "profile"))
        argv = ["--data-dir", paths["train"], "--reports-csv", paths["reports"],
                "--metadata-csv", paths["meta"], "--valid-data-dir", paths["valid"],
                "--valid-labels-csv", paths["labels"], "--eval-every", str(CF_EVAL_EVERY),
                "--batch-size", str(TRAIN_BATCH), "--num-steps", str(CF_STEPS),
                "--results-dir", res, "--checkpoint-dir", ckpt, "--profile-dir", prof]
        for key in LAUNCHES:
            LAUNCHES[key] = 0
        tc_cli.CTClipTrainer, plain_trainer = Timed, tc_cli.CTClipTrainer
        try:
            t0 = time.perf_counter()
            rc = tc_cli.main(argv, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            tc_cli.CTClipTrainer = plain_trainer
        expect = dict.fromkeys(LAUNCHES, 0)
        for name in TRAIN_KERNELS:
            expect[name] = depth
        for i, (s, launched, m, peak) in enumerate(steps):
            print(f"  step {i + 1}: wall {s * 1e3:.1f} ms (profiler on)  loss {m['loss']:.6f}  "
                  f"grad norm {m['grad_norm']:.6f}  temperature {m['temperature']:.6f}  vq "
                  f"commit {m['vq_commit']:.6f}  peak memory {peak / 2**30:.2f} GiB")
            print("    launches " + " ".join(f"{k.removeprefix('flash_attention_')} {v}"
                                             for k, v in launched.items() if v))
            if launched != expect or not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"CLI step {i + 1}: launches {launched} (expected "
                                     f"{expect}), metrics {m}")
        trace = os.path.join(prof, TRACE_FILE)
        size = os.path.getsize(trace) if os.path.exists(trace) else 0
        artifacts = os.path.join(res, f"zeroshot_step{CF_EVAL_EVERY}")
        missing = [f for f in ("labels_weights.npz", "predicted_weights.npz", "accessions.txt",
                               "aurocs.csv", "bootstrap_cis.csv")
                   if not os.path.exists(os.path.join(artifacts, f))]
        saved = CheckpointManager(ckpt).all_steps()
        for step, secs, out, peak, k2 in evals:
            print(f"  eval at step {step}: {secs:.2f} s, {out}, peak memory "
                  f"{peak / 2**30:.2f} GiB, flash_attention_fwd {k2}")
        print(f"  train_clip.main: rc {rc}, {wall:.2f} s in all (the profiler on); checkpoints "
              f"{saved}; trace {trace.removeprefix(tmp)} {size / 2**20:.1f} MiB; eval "
              f"artifacts {'complete' if not missing else f'missing {missing}'}")
        if rc != 0 or len(steps) != CF_STEPS or saved != [CF_STEPS] or not size or missing:
            raise AssertionError("train_clip.main did not train, evaluate, trace and save")
        if [e[0] for e in evals] != [CF_EVAL_EVERY] or evals[0][2]["n"] != CF_VALID \
                or not math.isfinite(evals[0][2]["mean_auc"]) \
                or evals[0][4] != depth * -(-CF_VALID // 4):
            raise AssertionError(f"the periodic eval: {evals}")
    ssl_step(dev)


def ssl_step(dev) -> None:
    """One step with the MLM and SimCLR objectives and CLOOB's projections at
    full width (bf16, remat) on the kernel path, a plain CLIP step and a
    second SSL step for the time ratio, then the first step again from the
    same state with flash_axial off, under the CLIP gates."""
    import torch

    from ctpa_torch.core.config import (BertConfig, CTCLIPConfig, CTViTConfig,
                                        OptimizerConfig)
    from ctpa_torch.core.init import random_init_
    from ctpa_torch.core.precision import Policy
    from ctpa_torch.models.ctclip import CTCLIP
    from ctpa_torch.ops.flash_attention import LAUNCHES
    from ctpa_torch.ops.vq import vq_init
    from ctpa_torch.train.clip_trainer import make_clip_train_step
    from ctpa_torch.train.optim import get_optimizer
    from ctpa_torch.train.train_state import CLIPTrainState

    clip_cfg = dataclasses.replace(CTCLIPConfig(), extra_latent_projection=True, use_mlm=True)

    def build(flash: bool):
        vit = dataclasses.replace(CTViTConfig(), flash_axial=flash, pallas_patchify=False)
        return CTCLIP(clip_cfg, vit, BertConfig(), device=dev, dtype=torch.float32, remat=True)

    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    model = random_init_(build(True), gen)
    vit_cfg = model.visual_transformer.cfg
    vq = vq_init(gen, vit_cfg.codebook_size, vit_cfg.dim, device=dev)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    batch = make_train_batch(model, dev)

    def step(model, ssl: bool):
        tx = get_optimizer(OptimizerConfig(), model)
        fn = make_clip_train_step(model, tx, vq_decay=vit_cfg.vq_decay, policy=Policy(),
                                  use_mlm=ssl, use_visual_ssl=ssl)
        for key in LAUNCHES:
            LAUNCHES[key] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        _, m = fn(CLIPTrainState.create(model, tx, vq), batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        m = {k: float(v) for k, v in m.items()}
        print(f"    {'SSL' if ssl else 'CLIP'} step: wall {wall * 1e3:.1f} ms  "
              + "  ".join(f"{k} {v:.6f}" for k, v in m.items())
              + f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        return wall, m, dict(LAUNCHES)

    n_params = sum(p.numel() for p in model.parameters())
    print(f"  SSL step: CTCLIP + MLM head + CLOOB projections, {n_params / 1e6:.1f} M "
          f"parameters (fp32), bf16 compute, remat, batch {TRAIN_BATCH}; kernel path:")
    _, first, launched = step(model, True)
    expect = dict.fromkeys(LAUNCHES, 0)
    expect["flash_attention_fwd_lse"] = 2 * 3 * vit_cfg.spatial_depth   # remat, 3 encodes
    for name in TRAIN_KERNELS[1:]:
        expect[name] = 3 * vit_cfg.spatial_depth
    print("    launches " + " ".join(f"{k.removeprefix('flash_attention_')} {v}"
                                     for k, v in launched.items() if v))
    if launched != expect:
        raise AssertionError(f"SSL step launches {launched}, expected {expect}")
    grads = spatial_fold_grads(model)
    clip_wall, _, _ = step(model, False)
    ssl_wall, _, _ = step(model, True)
    print(f"  SSL step {ssl_wall * 1e3:.1f} ms against a CLIP step {clip_wall * 1e3:.1f} ms on "
          f"the same model: {ssl_wall / clip_wall:.2f}x")
    del model
    torch.cuda.empty_cache()
    plain = build(False)
    plain.load_state_dict(start)
    print("  plain path (flash_axial off), the first step from the same state:")
    _, ref, launched = step(plain, True)
    if any(launched.values()):
        raise AssertionError(f"the plain path launched hand kernels: {launched}")
    worst = min(torch.nn.functional.cosine_similarity(g.flatten(), grads_p.flatten(),
                                                      dim=0).item()
                for g, grads_p in zip(grads.values(), spatial_fold_grads(plain).values()))
    gaps = {k: abs(first[k] - ref[k]) for k in ("loss", "mlm_loss", "visual_ssl_loss")}
    print(f"  kernel vs plain: |loss diff| {gaps['loss']:.3e} (<= {TRAIN_LOSS_ATOL}), mlm_loss "
          f"{gaps['mlm_loss']:.3e}, visual_ssl_loss {gaps['visual_ssl_loss']:.3e} (each <= "
          f"{SSL_LOSS_ATOL}); spatial-fold gradients: min cosine {worst:.6f} "
          f"(>= {TRAIN_GRAD_MIN_COS}) over {len(grads)} tensors")
    if gaps["loss"] > TRAIN_LOSS_ATOL or worst < TRAIN_GRAD_MIN_COS \
            or max(gaps["mlm_loss"], gaps["visual_ssl_loss"]) > SSL_LOSS_ATOL:
        raise AssertionError("SSL step: kernel path and plain path disagree")


def check_fused_kernels(dev) -> dict:
    """K2-lse and the delta, dQ and dK/dV passes of K3 at the fused encoder's
    form (FUSED_SHAPE, bf16, no bias, the cosine bound) against their plain
    versions, twice for bits, then timed beside scaled_dot_product_attention
    and the bound."""
    import torch
    import torch.nn.functional as F

    from ctpa_torch.ops import flash_attention as fa
    from ctpa_torch.ops.attention_ops import l2norm

    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    b, h, n, d = FUSED_SHAPE
    bf16, scale = torch.bfloat16, 8.0

    def randn():
        return torch.randn(b, h, n, d, generator=gen, device=dev)

    q, k = l2norm(randn()).to(bf16), l2norm(randn()).to(bf16)
    v, do = randn().to(bf16), randn().to(bf16)
    # |s| <= scale * max|q_scale| * max|k_scale|, unit scales here
    bound = torch.tensor(scale, device=dev)
    out, lse = fa.flash_attention(q, k, v, scale=scale, logit_bound=bound, return_lse=True)
    ref_out, ref_lse = by_head(lambda *a: fa.flash_attention_plain(*a, return_lse=True),
                               q, k, v, None, scale, bound)
    tag = f"n {n}, no bias"
    delta = fa.flash_attention_bwd_delta(out, do)
    args = (q, k, v, None, lse, delta, do, scale)
    fault = fused_faults(q, k, v, lse, delta, do, scale, bound)
    errs = {"fwd": fused_compare(f"flash_attention_fwd_lse out {tag}", out, ref_out,
                                 fault["out"]),
            "lse": compare(f"flash_attention_fwd_lse lse {tag}", lse, ref_lse, LSE_ATOL,
                           LSE_RTOL)}
    del ref_out, ref_lse
    errs["delta"] = compare(f"flash_attention_bwd_delta {tag}", delta,
                            fa.flash_attention_bwd_delta_plain(out, do), FP32_ATOL, FP32_RTOL)
    errs["dq"] = fused_compare(f"flash_attention_bwd_dq {tag}", fa.flash_attention_bwd_dq(*args),
                               by_head(fa.flash_attention_bwd_dq_plain, *args), fault["dq"])
    (dk, dv), (rdk, rdv) = fa.flash_attention_bwd_dkv(*args), by_head(
        fa.flash_attention_bwd_dkv_plain, *args)
    errs["dkv"] = max(fused_compare(f"flash_attention_bwd_dkv dk {tag}", dk, rdk, fault["dk"]),
                      fused_compare(f"flash_attention_bwd_dkv dv {tag}", dv, rdv, fault["dv"]))
    del dk, dv, rdk, rdv, fault
    timed = {
        "flash_attention_fwd_lse": (
            lambda: fa.flash_attention(q, k, v, scale=scale, logit_bound=bound, return_lse=True),
            lambda: by_head(lambda *a: fa.flash_attention_plain(*a, return_lse=True),
                            q, k, v, None, scale, bound)),
        "flash_attention_bwd_delta": (lambda: fa.flash_attention_bwd_delta(out, do),
                                      lambda: fa.flash_attention_bwd_delta_plain(out, do)),
        "flash_attention_bwd_dq": (lambda: fa.flash_attention_bwd_dq(*args),
                                   lambda: by_head(fa.flash_attention_bwd_dq_plain, *args)),
        "flash_attention_bwd_dkv": (lambda: fa.flash_attention_bwd_dkv(*args),
                                    lambda: by_head(fa.flash_attention_bwd_dkv_plain, *args)),
    }
    for name in FUSED_KERNELS:
        repeatable(f"{name} {tag}", timed[name][0])
    # yardsticks, never called by the port: the library forward and its backward alone
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
    lib_bwd = sdpa_backward(lambda: F.scaled_dot_product_attention(*leaves, scale=scale),
                            leaves, do)
    lib_bwd_ms = cuda_ms(lib_bwd)
    backend = sdpa_backend(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves, scale=scale), leaves, grad_outputs=do))
    print(f"  scaled_dot_product_attention forward {lib_fwd_ms:.4f} ms, backward alone "
          f"{lib_bwd_ms:.4f} ms; its kernels: {backend}")
    qkv, rowf = b * h * n * d * 2, b * h * n * 4
    prod = 2.0 * b * h * n * n * d
    work = {"flash_attention_fwd_lse": (4 * qkv + rowf + 4, 2 * prod),
            "flash_attention_bwd_delta": (2 * qkv + rowf, 2.0 * b * h * n * d),
            "flash_attention_bwd_dq": (5 * qkv + 2 * rowf, 3 * prod),
            "flash_attention_bwd_dkv": (6 * qkv + 2 * rowf, 4 * prod)}
    err = {"flash_attention_fwd_lse": max(errs["fwd"], errs["lse"]),
           "flash_attention_bwd_delta": errs["delta"], "flash_attention_bwd_dq": errs["dq"],
           "flash_attention_bwd_dkv": errs["dkv"]}
    exps = b * h * n * n
    print(f"  bounds count the tensor-core products at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; the "
          f"softmax's {exps:.3e} exponentials (once in the forward, again in dQ and in dK/dV) "
          f"are not counted")
    rows = {}
    for name in FUSED_KERNELS:
        kernel_fn, plain_fn = timed[name]
        ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn, iters=3, warmup=1)
        b_ms, b_by = bound_ms(*work[name])
        source, replaces = FLASH_SOURCES[name]
        lib_ms = lib_fwd_ms if name == "flash_attention_fwd_lse" else lib_bwd_ms
        rows[fused_name(name)] = dict(
            name=fused_name(name), route="cuda", source=source, replaces=replaces,
            max_abs_err=err[name], ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None if name == "flash_attention_bwd_delta" else lib_ms)
        print(f"  {name} at n {n}: {ms:.4f} ms (device {device_ms(kernel_fn, 5):.4f})  plain "
              f"{plain_ms:.4f} ms (one head at a time)  bound {b_ms:.4f} ms ({b_by}: "
              f"{work[name][0] / 1e6:.1f} MB, {work[name][1] / 1e9:.1f} GFLOP; "
              f"{b_ms / ms:.2f} of it)")
    k3 = sum(rows[fused_name(name)]["ms"] for name in FUSED_KERNELS[1:])
    print(f"  K3 in all (delta + dq + dkv): {k3:.4f} ms; scaled_dot_product_attention backward "
          f"{lib_bwd_ms:.4f} ms")
    return rows


def fused_grads(model) -> dict:
    """Gradients of the fused stack's parameters whose gradient passes
    through the flash kernels: its attention projections and scales."""
    return {name: p.grad.detach().float().clone() for name, p in model.named_parameters()
            if "enc_fused_transformer" in name and any(
                key in name for key in ("attn.to_q", "attn.to_kv", "attn.q_scale", "attn.k_scale"))}


def fused_step(dev, rows: dict) -> None:
    """A CLIP step with the fused encoder (FUSED_DEPTH blocks over all
    13,824 tokens of each volume; fp32 parameters, bf16 compute, remat,
    batch 2) on the kernel path, twice, then the first step again from the
    same state with the fused stack's attention on the plain cosine
    attention, under the CLIP gates, at the same depth (remat keeps one
    block's (2, 8, n, n) fp32 scores and their gradients live at a time)."""
    import torch

    from ctpa_torch.core.config import BertConfig, CTCLIPConfig, CTViTConfig, OptimizerConfig
    from ctpa_torch.core.init import random_init_
    from ctpa_torch.core.precision import Policy
    from ctpa_torch.models.ctclip import CTCLIP
    from ctpa_torch.ops.flash_attention import LAUNCHES
    from ctpa_torch.ops.vq import vq_init
    from ctpa_torch.train.clip_trainer import make_clip_train_step
    from ctpa_torch.train.optim import get_optimizer
    from ctpa_torch.train.train_state import CLIPTrainState

    vit_cfg = dataclasses.replace(CTViTConfig(), fused_attention=True, fused_depth=FUSED_DEPTH)

    def build():
        return CTCLIP(CTCLIPConfig(), vit_cfg, BertConfig(), device=dev, dtype=torch.float32,
                      remat=True)

    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    model = random_init_(build(), gen)
    vq = vq_init(gen, vit_cfg.codebook_size, vit_cfg.dim, device=dev)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    batch = make_train_batch(model, dev)

    def step(model, label: str):
        tx = get_optimizer(OptimizerConfig(), model)
        fn = make_clip_train_step(model, tx, vq_decay=vit_cfg.vq_decay, policy=Policy())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        _, m = fn(CLIPTrainState.create(model, tx, vq), batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        m = {k: float(v) for k, v in m.items()}
        print(f"  {label}: wall {wall * 1e3:.1f} ms  loss {m['loss']:.6f}  grad norm "
              f"{m['grad_norm']:.6f}  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB")
        return m

    for key in LAUNCHES:
        LAUNCHES[key] = 0
    first = step(model, f"kernel path, fused_depth {FUSED_DEPTH}, step 1")
    launched = dict(LAUNCHES)
    expect = dict.fromkeys(LAUNCHES, 0)
    expect["flash_attention_fwd_lse"] = 2 * FUSED_DEPTH          # remat runs it twice
    for name in FUSED_KERNELS[1:]:
        expect[name] = FUSED_DEPTH
    print("    launches " + " ".join(f"{k.removeprefix('flash_attention_')} {v}"
                                     for k, v in launched.items() if v))
    if launched != expect or not math.isfinite(first["loss"]):
        raise AssertionError(f"fused step: launches {launched} (expected {expect}), {first}")
    for name in FUSED_KERNELS:
        rows[fused_name(name)]["launches"] = launched[name]
    grads = fused_grads(model)
    step(model, "kernel path, step 2")
    del model
    torch.cuda.empty_cache()
    plain = build()
    plain.load_state_dict(start)
    for block in plain.visual_transformer.enc_fused_transformer.blocks:
        block.attn.use_flash = False
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    ref = step(plain, f"plain path (cosine attention), fused_depth {FUSED_DEPTH}, step 1")
    if any(LAUNCHES.values()):
        raise AssertionError(f"the plain path launched hand kernels: {LAUNCHES}")
    worst = 1.0
    for (name, g), g_p in zip(grads.items(), fused_grads(plain).values()):
        worst = min(worst, torch.nn.functional.cosine_similarity(
            g.flatten(), g_p.flatten(), dim=0).item())
    gap = abs(first["loss"] - ref["loss"])
    print(f"  kernel vs plain: |loss diff| {gap:.3e} (<= {TRAIN_LOSS_ATOL}); fused-stack "
          f"attention gradients: min cosine {worst:.6f} (>= {TRAIN_GRAD_MIN_COS}) over "
          f"{len(grads)} tensors")
    if gap > TRAIN_LOSS_ATOL or worst < TRAIN_GRAD_MIN_COS:
        raise AssertionError("fused step: kernel path and plain path disagree")


# ------------------------------------------------------------ the VQGAN path

def vqgan_config(**over):
    """ctpa's VQGAN CLI's CTViT: CTViTConfig() with the decoder."""
    from ctpa_torch.core.config import CTViTConfig

    return dataclasses.replace(CTViTConfig(), use_decoder=True, **over)


def vqgan_nets(cfg, dev, seed: int):
    """The generator (fp32 parameters, bf16 compute), Discriminator() and
    PerceptualNet() on ``dev``, seeded as train_vqgan's init_state seeds
    them, and the VQ state; then the discriminator's and the perceptual
    net's weights drawn again at sqrt(2 / fan_in) (He's scale): at
    init_state's 0.02 their features die out layer by layer, the logits
    are their last biases and R1 is about 0, so the gates would not see
    them."""
    import torch

    from ctpa_torch.cli.train_vqgan import init_state
    from ctpa_torch.models.ctvit import CTViT
    from ctpa_torch.models.discriminator import Discriminator, PerceptualNet
    from ctpa_torch.models.layers import set_compute_dtype

    model = CTViT(cfg, device=dev)
    disc = Discriminator(image_size=cfg.image_size, device=dev)
    perc = PerceptualNet(device=dev)
    vq = init_state(model, disc, perc, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        for net in (disc, perc):
            for p in net.parameters():
                if p.ndim >= 2:
                    p.copy_(torch.randn(p.shape, generator=gen, device=dev)
                            * math.sqrt(2.0 / (p[0].numel())))
    return set_compute_dtype(model, torch.bfloat16), disc, perc, vq


def vqgan_video(cfg, dev, seed: int, batch: int = VQGAN_BATCH):
    """Canonical-grid volumes (batch, 1, T, H, W) in [-1, 1], fp32."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (batch, 1, cfg.temporal_size, cfg.image_size, cfg.image_size)
    return torch.rand(shape, generator=gen, device=dev) * 2 - 1


def vqgan_group(name: str, disc: bool = False):
    """The gate's parameter group of a generator (or discriminator)
    parameter, or None for the patch embed and the CPB's to_heads.bias,
    which shifts every logit of a head alike: softmax ignores it, and its
    gradient is zero up to rounding noise (as in spatial_fold_grads)."""
    if disc:
        return "discriminator"
    if name == "spatial_rel_pos_bias.to_heads.bias":
        return None
    if name.startswith(("dec_", "to_pixels")):
        return "decoder"
    head = name.split(".", 1)[0]
    return head if head in VQGAN_GROUPS else None


@contextlib.contextmanager
def pinned_codes(indices):
    """CTViT's VQ (``models.ctvit.vq_encode``) with its argmax replaced by
    ``indices`` (b, n): the rest of ``ops.vq.vq_encode`` as it is -- the
    straight-through quantized tokens, the commitment loss, the counts and
    sums -- on the pinned codes."""
    import torch

    from ctpa_torch.models import ctvit
    from ctpa_torch.ops.attention_ops import l2norm
    from ctpa_torch.ops.vq import VQOutput

    encode = ctvit.vq_encode

    def pinned(state, x, mask=None):
        shape, d = x.shape, x.shape[-1]
        flat = x.reshape(-1, d).to(torch.float32)
        nf, cb = l2norm(flat), l2norm(state.codebook.to(torch.float32))
        idx = indices.reshape(-1).long()
        quant = cb[idx]
        m = (mask.reshape(-1).to(torch.float32) if mask is not None
             else torch.ones(flat.shape[0], device=x.device))
        diff = torch.sum((nf - quant.detach()) ** 2, dim=-1)
        commit = torch.sum(diff * m) / torch.clamp(torch.sum(m), min=1.0)
        counts = torch.zeros(cb.shape[0], device=x.device).index_add_(0, idx, m)
        sums = torch.zeros_like(cb).index_add_(0, idx, nf * m[:, None])
        quant_st = flat + (quant - flat).detach()
        return VQOutput(quantized=quant_st.reshape(shape).to(x.dtype),
                        indices=idx.reshape(shape[:-1]).to(torch.int32),
                        commit_loss=commit, counts=counts, sums=sums)

    ctvit.vq_encode = pinned
    try:
        yield
    finally:
        ctvit.vq_encode = encode


def vqgan_step_run(nets, start, video, counter: int, flash: bool, codes) -> dict:
    """One VQGAN step from the ``start`` weights at step count ``counter``
    (R1 where it is a multiple of 16), with the spatial fold's attention on
    the flash kernels or on the plain cosine attention, quantizing to
    ``codes``: the metrics, wall ms, peak GiB, flash launches and each
    group's gradients."""
    import torch

    from ctpa_torch.ops.flash_attention import LAUNCHES
    from ctpa_torch.train.vqgan_trainer import VQGANState, adam, make_vqgan_train_step

    model, disc, perc, vq = nets
    model.load_state_dict(start[0])
    disc.load_state_dict(start[1])
    for block in model.enc_spatial_transformer.blocks:
        block.attn.use_flash = flash
    gen_tx, disc_tx = adam(model, 3e-4), adam(disc, 3e-4)
    step = make_vqgan_train_step(model, disc, perc, gen_tx, disc_tx)
    state = VQGANState(gen=model, disc=disc, perc=perc, gen_opt=gen_tx, disc_opt=disc_tx,
                       vq_state=vq, step=counter)
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with pinned_codes(codes):
        _, m = step(state, video)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    grads = collections.defaultdict(list)
    for net, is_disc in ((model, False), (disc, True)):
        for name, p in net.named_parameters():
            group = vqgan_group(name, is_disc)
            if group is not None:
                grads[group].append(p.grad.detach().float().clone())
    return dict(metrics={k: float(v) for k, v in m.items()}, ms=wall,
                peak=torch.cuda.max_memory_allocated() / 2**30, launches=dict(LAUNCHES),
                grads=dict(grads))


def vqgan_cosines(got: dict, ref: dict) -> dict:
    """Each group's gradient cosine, over all of its tensors at once."""
    out = {}
    for group in VQGAN_GROUPS:
        dot = na = nb = 0.0
        for a, b in zip(got[group], ref[group]):
            a, b = a.double(), b.double()
            dot, na, nb = dot + (a * b).sum().item(), na + (a * a).sum().item(), \
                nb + (b * b).sum().item()
        out[group] = dot / max(math.sqrt(na * nb), 1e-300)
    return out


def vqgan_gate(label: str, got: dict, ref: dict, tag: str) -> bool:
    """Print each loss term's gap and each group's gradient cosine of a step
    against the plain path's, and whether they pass the ``tag`` ("fp32" or
    "bf16") gates."""
    atol, min_cos = ((VQGAN_FP32_LOSS_ATOL, VQGAN_FP32_MIN_COS) if tag == "fp32"
                     else (TRAIN_LOSS_ATOL, TRAIN_GRAD_MIN_COS))
    gaps = {k: abs(got["metrics"][k] - ref["metrics"][k]) for k in VQGAN_METRICS}
    cos = vqgan_cosines(got["grads"], ref["grads"])
    ok = max(gaps.values()) <= atol and min(cos.values()) >= min_cos
    print(f"    {label}: loss gaps " + " ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f" (each <= {atol}); gradient cosines "
          + " ".join(f"{k} {v:.8f}" for k, v in cos.items())
          + f" (each >= {min_cos}): {'pass' if ok else 'FAIL'}")
    return ok


def vqgan_codes(model, vq, video, flash: bool):
    """The VQ codes of ``video`` with the spatial fold on the flash kernels
    or on the plain attention."""
    import torch

    for block in model.enc_spatial_transformer.blocks:
        block.attn.use_flash = flash
    with torch.no_grad():
        return model(video, vq)[1].indices


def vqgan_steps(dev, cfg=None, batch: int = VQGAN_BATCH) -> tuple:
    """Part 1 of phase vqgan: the step on the kernel path and on the plain
    path, in fp32 and in bf16, with R1 and without, both quantizing to the
    plain path's codes, gated; the planted faults refused.  Returns the
    networks (bf16 compute), their start weights and the volumes."""
    import torch

    from ctpa_torch.models import attention
    from ctpa_torch.models.layers import set_compute_dtype
    from ctpa_torch.ops.patchify import patchify_project

    cfg = cfg or vqgan_config(flash_axial=True)
    nets = vqgan_nets(cfg, dev, SEED + 50)
    model, disc, perc, vq = nets
    start = ({k: v.clone() for k, v in model.state_dict().items()},
             {k: v.clone() for k, v in disc.state_dict().items()})
    video = vqgan_video(cfg, dev, SEED + 51, batch)
    sizes = [sum(p.numel() for p in net.parameters()) / 1e6 for net in (model, disc, perc)]
    print(f"  generator {sizes[0]:.1f} M parameters (fp32), discriminator {sizes[1]:.1f} M, "
          f"perceptual net {sizes[2]:.2f} M (frozen); video {tuple(video.shape)}")
    expect = dict.fromkeys(TRAIN_KERNELS, cfg.spatial_depth)
    k1 = patchify_project.launches
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    runs, codes = {}, {}
    for tag, dtype in dtypes.items():
        set_compute_dtype(model, dtype)
        model.load_state_dict(start[0])
        both = [vqgan_codes(model, vq, video, flash) for flash in (True, False)]
        codes[tag] = both[1]
        print(f"  {tag} compute: the kernel and plain paths' own codes equal on "
              f"{(both[0] == both[1]).float().mean().item():.5f} of the tokens; both steps "
              f"quantize to the plain path's")
        for flash in (True, False):
            for counter in (0, 1):
                run = vqgan_step_run(nets, start, video, counter, flash, codes[tag])
                runs[tag, flash, counter] = run
                launched = {k: v for k, v in run["launches"].items() if v}
                m = run["metrics"]
                print(f"  {tag} {'kernel' if flash else 'plain'} path, step count {counter} "
                      f"({'R1' if counter == 0 else 'no R1'}): wall {run['ms']:.1f} ms  peak "
                      f"{run['peak']:.2f} GiB  "
                      + "  ".join(f"{k} {m[k]:.6f}" for k in VQGAN_METRICS))
                print("    launches " + (" ".join(f"{k.removeprefix('flash_attention_')} {v}"
                                                  for k, v in launched.items()) or "none"))
                if launched != (expect if flash else {}) \
                        or not all(math.isfinite(v) for v in m.values()):
                    raise AssertionError(f"VQGAN step: launches {launched} (expected "
                                         f"{expect if flash else {}}), metrics {m}")
                if (m["r1"] > 0) != (counter == 0):
                    raise AssertionError(f"VQGAN step count {counter}: r1 {m['r1']}")
    if patchify_project.launches != k1:
        raise AssertionError("the VQGAN step launched K1")
    failed = [f"{tag} step count {counter}: kernel path and plain path disagree"
              for tag in dtypes for counter in (0, 1)
              if not vqgan_gate(f"{tag}, kernel vs plain, step count {counter}",
                                runs[tag, True, counter], runs[tag, False, counter], tag)]
    for tag, faults in (("fp32", VQGAN_FAULTS), ("bf16", VQGAN_FAULTS[:1])):
        set_compute_dtype(model, dtypes[tag])
        for fault in faults:
            with planted_flash_fault(fault, attention):
                faulty = vqgan_step_run(nets, start, video, 0, True, codes[tag])
            if vqgan_gate(f"{tag}, planted fault: {fault}", faulty, runs[tag, False, 0], tag):
                failed.append(f"the {tag} gate does not see a planted flash fault ({fault})")
    print(f"  bf16 step wall: kernel path {runs['bf16', True, 1]['ms']:.1f} ms, plain path "
          f"{runs['bf16', False, 1]['ms']:.1f} ms (no R1; with R1 "
          f"{runs['bf16', True, 0]['ms']:.1f} and {runs['bf16', False, 0]['ms']:.1f} ms); peak "
          f"{runs['bf16', True, 1]['peak']:.2f} and {runs['bf16', False, 1]['peak']:.2f} GiB")
    del runs, faulty
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("VQGAN step: " + "; ".join(failed))
    return nets, start, video


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN's deterministic convolutions and PyTorch's deterministic
    algorithms (warnings, not errors, where an op has none), restored after:
    the resumed and the uninterrupted CLI runs then differ only by what
    resuming changes, not by the card's unordered sums (index_add_'s
    atomics, cuDNN's weight gradients), which Adam turns into moves of lr
    where a gradient is noise-sized."""
    import torch

    before = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
              torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before[:2]
        torch.use_deterministic_algorithms(before[2], warn_only=before[3])


def vqgan_cli(dev) -> None:
    """Part 2 of phase vqgan: train_vqgan.main from canonical-grid npz files
    (ctpa's configuration), VQGAN_CLI_STEPS steps, --resume to one more,
    and an uninterrupted run."""
    import tempfile

    import numpy as np
    import torch

    from ctpa_torch.cli import train_vqgan as tv_cli
    from ctpa_torch.core.checkpoint import CheckpointManager
    from ctpa_torch.ops.flash_attention import LAUNCHES
    from ctpa_torch.ops.patchify import patchify_project

    cfg = vqgan_config()
    runs = []
    inner = tv_cli.make_vqgan_train_step

    def timed(*args, **kwargs):
        step_fn, record = inner(*args, **kwargs), []
        runs.append(record)

        def step(state, video):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, video)
            torch.cuda.synchronize()
            record.append((state.step, (time.perf_counter() - t0) * 1e3,
                           {k: float(v) for k, v in m.items()}))
            return state, m
        return step

    with tempfile.TemporaryDirectory(prefix="chip_smoke_vqgan_") as tmp:
        rng = np.random.default_rng(SEED + 52)
        data = os.path.join(tmp, "volumes")
        os.makedirs(data)
        t0 = time.perf_counter()
        for i in range(VQGAN_BATCH):
            np.savez(os.path.join(data, f"vq{i:03d}.npz"), rng.uniform(
                -1, 1, size=(cfg.temporal_size, cfg.image_size, cfg.image_size)).astype(np.float32))
        print(f"  files: {VQGAN_BATCH} canonical-grid ({cfg.temporal_size}, {cfg.image_size}, "
              f"{cfg.image_size}) fp32 npz volumes, written in {time.perf_counter() - t0:.2f} s")
        for key in LAUNCHES:
            LAUNCHES[key] = 0
        k1 = patchify_project.launches

        def run(ckpt: str, steps: int, *extra) -> list:
            argv = ["--data-dir", data, "--batch-size", str(VQGAN_BATCH), "--num-steps",
                    str(steps), "--save-every", str(VQGAN_CLI_STEPS), "--log-every", "1",
                    "--checkpoint-dir", os.path.join(tmp, ckpt), *extra]
            t = time.perf_counter()
            if tv_cli.main(argv, device=dev) != 0:
                raise AssertionError(f"train_vqgan.main {argv}: not 0")
            print(f"  train_vqgan.main {' '.join(extra) or ''}--num-steps {steps}: "
                  f"{time.perf_counter() - t:.2f} s in all")
            for step, ms, m in runs[-1]:
                print(f"    step {step}: {ms:.1f} ms  " + "  ".join(
                    f"{k} {m[k]:.6f}" for k in VQGAN_METRICS))
            return runs[-1]

        tv_cli.make_vqgan_train_step = timed
        try:
            with deterministic_algorithms():
                first = run("a", VQGAN_CLI_STEPS)
                mgr = CheckpointManager(os.path.join(tmp, "a"))
                saved = mgr.all_steps()
                size = sum(os.path.getsize(os.path.join(r, f))
                           for r, _, fs in os.walk(os.path.join(tmp, "a", str(VQGAN_CLI_STEPS)))
                           for f in fs)
                resumed = run("a", VQGAN_CLI_STEPS + 1, "--resume")
                whole = run("c", VQGAN_CLI_STEPS + 1)
        finally:
            tv_cli.make_vqgan_train_step = inner
        steps_after = mgr.all_steps()
        print(f"  checkpoints {saved} then {steps_after}; step {VQGAN_CLI_STEPS}'s on disk "
              f"{size / 2**20:.1f} MiB (deleted with the directory)")
        if [s for s, _, _ in first] != list(range(1, VQGAN_CLI_STEPS + 1)) \
                or [s for s, _, _ in resumed] != [VQGAN_CLI_STEPS + 1] \
                or saved != [VQGAN_CLI_STEPS] or steps_after != [VQGAN_CLI_STEPS,
                                                                 VQGAN_CLI_STEPS + 1]:
            raise AssertionError(f"train_vqgan.main did not train, save and resume: {first}, "
                                 f"{resumed}, {saved}, {steps_after}")
        got, ref = resumed[0][2], whole[-1][2]
        gaps = {k: abs(got[k] - ref[k]) for k in VQGAN_METRICS}
        print(f"  resumed step {VQGAN_CLI_STEPS + 1} against the uninterrupted run's: gaps "
              + " ".join(f"{k} {v:.3e} ({v / max(abs(ref[k]), 1e-30):.3e} relative)"
                         for k, v in gaps.items())
              + f" (each <= {VQGAN_CLI_ATOL} + {VQGAN_CLI_RTOL} relative)")
        if any(gaps[k] > VQGAN_CLI_ATOL + VQGAN_CLI_RTOL * abs(ref[k]) for k in gaps):
            raise AssertionError("the resumed run's step differs from the uninterrupted run's")
        if any(LAUNCHES.values()) or patchify_project.launches != k1:
            raise AssertionError(f"ctpa's configuration launched hand kernels: {LAUNCHES}")


def rel_rms(got, ref) -> float:
    """RMS of got - ref over the RMS of ref."""
    got, ref = got.float(), ref.float()
    return ((got - ref).square().mean().sqrt() / ref.square().mean().sqrt()).item()


def encoder_taps(model, video, vq) -> tuple:
    """``model.reconstruct(video, vq)`` under no_grad, keeping on the way
    the encoder's tokens before the VQ (``enc_temporal_transformer``'s
    output) and each spatial block's attention output: (recon, VQOutput,
    tokens, [attention outputs])."""
    import torch

    taps = []
    hooks = [block.attn.register_forward_hook(lambda m, i, o: taps.append(o))
             for block in model.enc_spatial_transformer.blocks]
    hooks.append(model.enc_temporal_transformer.register_forward_hook(
        lambda m, i, o: taps.append(o)))
    try:
        with torch.no_grad():
            recon, vq_out = model.reconstruct(video, vq)
    finally:
        for hook in hooks:
            hook.remove()
    depth = len(model.enc_spatial_transformer.blocks)
    return recon, vq_out, taps[depth], taps[:depth]


def vqgan_reconstruct(dev, nets, start, video) -> None:
    """Part 3 of phase vqgan: reconstruct under no_grad with pallas_patchify
    and flash_axial (K1 and K2) and decode_from_codebook_indices on its
    codes, against the plain path.  Gated by relative RMS: the encoder's
    tokens before the VQ (VQGAN_TOKENS_RMS) and each spatial block's
    attention output (VQGAN_ATTN_RMS), limits the planted key-skipping
    fault must exceed.  Printed: the share of tokens whose codes agree and
    the voxels' relative RMS."""
    import torch

    from ctpa_torch.models import attention
    from ctpa_torch.ops.flash_attention import LAUNCHES
    from ctpa_torch.ops.patchify import patchify_project

    model, _, _, vq = nets
    model.load_state_dict(start[0])
    b = video.shape[0]

    def use(fast: bool):
        cfg = dataclasses.replace(model.cfg, pallas_patchify=fast, flash_axial=fast)
        model.cfg = model.patch_embed.cfg = cfg
        for block in model.enc_spatial_transformer.blocks:
            block.attn.use_flash = fast
        return cfg

    out = {}
    for fast in (True, False):
        cfg = use(fast)
        for key in LAUNCHES:
            LAUNCHES[key] = 0
        k1 = patchify_project.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recon, vq_out, tokens, attn = encoder_taps(model, video, vq)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            indices = vq_out.indices.reshape(b, -1)
            dec = model.decode_from_codebook_indices(indices, vq)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launched = (patchify_project.launches - k1, LAUNCHES["flash_attention_fwd"])
        print(f"  reconstruct ({'K1 + K2' if fast else 'plain'}): {(t1 - t0) * 1e3:.1f} ms, "
              f"decode_from_codebook_indices {(t2 - t1) * 1e3:.1f} ms; launches "
              f"patchify_project {launched[0]}, flash_attention_fwd {launched[1]}")
        others = sum(v for k, v in LAUNCHES.items() if k != "flash_attention_fwd")
        if launched != ((b, cfg.spatial_depth) if fast else (0, 0)) or others:
            raise AssertionError(f"reconstruct launches {launched}, {dict(LAUNCHES)}")
        if recon.shape != video.shape or not torch.isfinite(recon).all():
            raise AssertionError(f"reconstruct: shape {tuple(recon.shape)} or non-finite voxels")
        out[fast] = (tokens, attn, recon, indices, dec)
    use(True)
    fault = VQGAN_FAULTS[1]
    with planted_flash_fault(fault, attention):
        _, _, *faulty = encoder_taps(model, video, vq)
    (tk, ak, rk, ik, dk), (tp, ap, rp, ip, dp) = out[True], out[False]

    def errs(tokens, attn) -> tuple:
        return rel_rms(tokens, tp), max(rel_rms(a, r) for a, r in zip(attn, ap))

    (tok, att), (tok_f, att_f) = errs(tk, ak), errs(*faulty)
    print(f"  kernel vs plain, relative RMS: encoder tokens before the VQ {tok:.4e} (<= "
          f"{VQGAN_TOKENS_RMS}), spatial attention outputs at most {att:.4e} (<= "
          f"{VQGAN_ATTN_RMS}); with the planted fault ({fault}) {tok_f:.4e} and {att_f:.4e}")
    print(f"  voxels, kernel vs plain (not gated): codes equal on "
          f"{(ik == ip).float().mean().item():.4f} of the tokens; relative RMS reconstruct "
          f"{rel_rms(rk, rp):.3e}, decode_from_codebook_indices {rel_rms(dk, dp):.3e}; the "
          f"kernel path's decode of its codes against its reconstruct {rel_rms(dk, rk):.3e}")
    failed = []
    if tok > VQGAN_TOKENS_RMS or att > VQGAN_ATTN_RMS:
        failed.append("the kernel path's encoder disagrees with the plain path's")
    if tok_f <= VQGAN_TOKENS_RMS and att_f <= VQGAN_ATTN_RMS:
        failed.append(f"the gate does not see a planted flash fault ({fault})")
    if failed:
        raise AssertionError("reconstruct: " + "; ".join(failed))


def vqgan(dev) -> None:
    """Phase vqgan: the step, the CLI, reconstruct."""
    import torch

    nets, start, video = vqgan_steps(dev)
    vqgan_reconstruct(dev, nets, start, video)
    del nets, start, video
    torch.cuda.empty_cache()
    vqgan_cli(dev)


# ------------------------------------------------------------- parallelism

def free_port() -> int:
    """A free TCP port on the loopback interface (the NCCL group's
    rendezvous; nothing leaves the host)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_clip_cli(dev, port: int) -> None:
    """(a): train_clip.main on one NCCL rank (--coordinator) and alone, from
    the same files and weights; the first call starts the process group."""
    import tempfile

    import torch

    from ctpa_torch.cli import train_clip as tc_cli
    from ctpa_torch.core.config import CTViTConfig
    from ctpa_torch.ops.flash_attention import LAUNCHES

    runs = {}

    class Kept(tc_cli.CTClipTrainer):
        """The CLI's trainer, its metrics kept."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.steps = []

        def train_step(self):
            metrics = super().train_step()
            self.steps.append({k: float(v) for k, v in metrics.items()})
            return metrics

        def close(self):
            super().close()
            runs[label] = ([dict(s) for s in self.steps],
                           {k: v.detach().clone() for k, v in self.model.state_dict().items()})

    depth = CTViTConfig().spatial_depth
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        paths = clip_cli_files(tmp)
        for label, extra in (("nccl", ["--coordinator", f"127.0.0.1:{port}", "--num-processes",
                                       "1", "--process-id", "0"]), ("alone", [])):
            argv = ["--data-dir", paths["train"], "--reports-csv", paths["reports"],
                    "--metadata-csv", paths["meta"], "--batch-size", str(TRAIN_BATCH),
                    "--num-steps", str(PAR_STEPS), "--results-dir", os.path.join(tmp, label),
                    "--checkpoint-dir", os.path.join(tmp, label, "ckpt"), *extra]
            for key in LAUNCHES:
                LAUNCHES[key] = 0
            tc_cli.CTClipTrainer, plain_trainer = Kept, tc_cli.CTClipTrainer
            try:
                t0 = time.perf_counter()
                rc = tc_cli.main(argv, device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                tc_cli.CTClipTrainer = plain_trainer
            launched = {k: v for k, v in LAUNCHES.items() if v}
            print(f"  train_clip.main {label}{' ' + ' '.join(extra) if extra else ''}: rc {rc}, "
                  f"{wall:.2f} s, launches {launched}")
            if rc != 0 or any(launched.get(k, 0) != depth * PAR_STEPS for k in TRAIN_KERNELS):
                raise AssertionError(f"train_clip.main {label}: rc {rc}, launches {launched}")
            torch.cuda.empty_cache()
    (m_n, p_n), (m_a, p_a) = runs["nccl"], runs["alone"]
    worst, bits = 0.0, True
    for i, (a, b) in enumerate(zip(m_n, m_a)):
        for key in ("loss", "grad_norm", "temperature", "vq_commit"):
            rel = abs(a[key] - b[key]) / max(abs(b[key]), 1e-30)
            worst, bits = max(worst, rel), bits and a[key] == b[key]
        print(f"  step {i + 1}: loss {a['loss']:.6f} / {b['loss']:.6f}, grad norm "
              f"{a['grad_norm']:.6f} / {b['grad_norm']:.6f} (one NCCL rank / alone)")
    for key, ref in p_a.items():
        got = p_n[key]
        rel = ((got.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(
            1e-30)).item()
        worst, bits = max(worst, rel), bits and torch.equal(got, ref)
    print(f"  --coordinator on one NCCL rank against the run alone: largest relative difference "
          f"{worst:.3e} over the metrics and {len(p_a)} parameter tensors (<= {PAR_RTOL}); "
          f"bit-equal: {bits}")
    if len(m_n) != PAR_STEPS or len(m_a) != PAR_STEPS or worst > PAR_RTOL:
        raise AssertionError("train_clip --coordinator on one rank differs from the run alone")


def cp_rank_run(q, k, v, do, r: int, p: int, **kw):
    """Rank r of p through the factored per-rank body: its n/p query rows
    over all n keys forward (K2-lse) and backward (K3) by autograd; (out,
    lse, dq, dk partial, dv partial)."""
    import torch

    from ctpa_torch.parallel.context import rank_attention

    nl = q.shape[2] // p
    rows = slice(r * nl, (r + 1) * nl)
    leaves = [q[:, :, rows].detach().clone().requires_grad_(),
              k.detach().clone().requires_grad_(), v.detach().clone().requires_grad_()]
    with torch.enable_grad():
        out, lse = rank_attention(*leaves, return_lse=True, impl="flash", **kw)
        out.backward(do[:, :, rows])
    return out.detach(), lse, leaves[0].grad, leaves[1].grad, leaves[2].grad


def cp_unsharded(q, k, v, do, scale: float, bound, masks):
    """The unsharded kernel call: K2-lse and the three K3 passes."""
    from ctpa_torch.ops import flash_attention as fa

    out, lse = fa._forward(q, k, v, None, scale, bound, True, masks)
    delta = fa.flash_attention_bwd_delta(out, do)
    args = (q, k, v, None, lse, delta, do, scale, masks)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    return out, lse, fa.flash_attention_bwd_dq(*args), dk, dv


def cp_rows(tag: str, names: dict, q_r, k, v, do_r, scale: float, bound, masks, work: dict,
            tols, launches_form: str, lib_mask=None) -> dict:
    """Kernel-line rows of one rank's form: each kernel held against its
    plain version on the same inputs (``tols(part, ref)``: the gate's atol
    and rtol for out, lse, delta, dq, dk, dv) and timed beside it, the bound
    of this rank's work and the library's call.  ``launches_form`` says
    which form the launches that the main path adds to each row are of."""
    import torch
    import torch.nn.functional as F

    from ctpa_torch.ops import flash_attention as fa

    out, lse = fa._forward(q_r, k, v, None, scale, bound, True, masks)
    delta = fa.flash_attention_bwd_delta(out, do_r)
    args = (q_r, k, v, None, lse, delta, do_r, scale, masks)
    plain = (lambda fn, *a: by_head(fn, *a)) if q_r.shape[-1] < 128 else (lambda fn, *a: fn(*a))
    timed = {
        "fwd": (lambda: fa._forward(q_r, k, v, None, scale, bound, True, masks),
                lambda: plain(lambda *a: fa.flash_attention_plain(*a, return_lse=True,
                                                                  masks=masks),
                              q_r, k, v, None, scale, bound)),
        "delta": (lambda: fa.flash_attention_bwd_delta(out, do_r),
                  lambda: fa.flash_attention_bwd_delta_plain(out, do_r)),
        "dq": (lambda: fa.flash_attention_bwd_dq(*args),
               lambda: plain(fa.flash_attention_bwd_dq_plain, *args)),
        "dkv": (lambda: fa.flash_attention_bwd_dkv(*args),
                lambda: plain(fa.flash_attention_bwd_dkv_plain, *args))}
    parts = {"fwd": ("out", "lse"), "delta": ("delta",), "dq": ("dq",), "dkv": ("dk", "dv")}
    leaves = [t.detach().clone().requires_grad_() for t in (q_r, k, v)]
    kw = dict(scale=scale) if lib_mask is None else dict(scale=scale, attn_mask=lib_mask)
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q_r, k, v, **kw))
    with torch.enable_grad():
        lib_bwd = cuda_ms(sdpa_backward(lambda: F.scaled_dot_product_attention(*leaves, **kw),
                                        leaves, do_r))
    rows = {}
    for part, name in names.items():
        kernel_fn, plain_fn = timed[part]
        got, ref = kernel_fn(), plain_fn()
        if not isinstance(got, tuple):
            got, ref = (got,), (ref,)
        err = max(compare(f"{name} {what} ({tag}) against its plain version", g, r_,
                          *tols(what, r_)) for what, g, r_ in zip(parts[part], got, ref))
        del got, ref
        ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn, iters=3, warmup=1)
        b_ms, b_by = bound_ms(*work[part])
        source, replaces = FLASH_SOURCES[name.split("_cp")[0].replace("_d128", "")]
        lib = None if part == "delta" else (lib_fwd if part == "fwd" else lib_bwd)
        rows[name] = dict(name=name, route="cuda", source=source, replaces=replaces,
                          max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=lib, launches_form=launches_form)
        print(f"  {name} ({tag}): {ms:.4f} ms (device {device_ms(kernel_fn, 5):.4f})  plain "
              f"{plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}: {work[part][0] / 1e6:.1f} MB, "
              f"{work[part][1] / 1e9:.2f} GFLOP)  library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}")
    return rows


def check_cp_kernels(dev, rows: dict) -> dict:
    """(b), rank by rank: K2-lse and K3 at each emulated rank's form of the
    fused encoder and of the LLM's causal sequence, against the unsharded
    call and the plain versions; the planted faults; the new rows."""
    import torch

    from ctpa_torch.ops import flash_attention as fa
    from ctpa_torch.ops.attention_ops import l2norm
    from ctpa_torch.parallel.context import rank_offset

    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    bf16, p = torch.bfloat16, CP_RANKS
    new = {}

    # the fused encoder's form: no bias, no mask, the cosine bound
    b, h, n, d = FUSED_SHAPE
    nl = n // p
    q, k = (l2norm(torch.randn(b, h, n, d, generator=gen, device=dev)).to(bf16) for _ in "qk")
    v, do = (torch.randn(b, h, n, d, generator=gen, device=dev).to(bf16) for _ in "vd")
    scale, bound = 8.0, torch.tensor(8.0, device=dev)
    full = cp_unsharded(q, k, v, do, scale, bound, fa.NO_MASKS)
    ranks = [cp_rank_run(q, k, v, do, r, p, scale=scale, logit_bound=bound) for r in range(p)]
    got = (torch.cat([x[0] for x in ranks], 2), torch.cat([x[1] for x in ranks], 2),
           torch.cat([x[2] for x in ranks], 2), sum(x[3] for x in ranks), sum(x[4] for x in ranks))
    tag = f"{p} ranks of {nl} x {n} keys"
    for i, part in enumerate(("out", "lse", "dq", "dk", "dv")):
        if part == "lse":
            compare(f"K2-lse lse, {tag}", got[1], full[1], LSE_ATOL, LSE_RTOL)
            continue
        atol, rtol = fused_tolerance(full[i], bf16)
        how = "summed over ranks" if part in ("dk", "dv") else "ranks concatenated"
        compare(f"{part} ({how}), {tag}", got[i], full[i], atol, rtol)
    bits = all(torch.equal(a, b_) for a, b_ in zip(got[:3], full[:3]))
    print(f"  the ranks' out, lse and dq bit-equal to the unsharded call's: {bits}")
    atol, rtol = fused_tolerance(full[3], bf16)
    if not rejects(ranks[0][3], full[3], atol, rtol):
        raise AssertionError("the fused form's gate passes rank 0's dK partial alone")
    print("  planted: rank 0's dK partial left unsummed: refused")
    qkv_r, kv, rowf_r = b * h * nl * d * 2, b * h * n * d * 2, b * h * nl * 4
    prod = 2.0 * b * h * nl * n * d
    work = {"fwd": (2 * qkv_r + 2 * kv + rowf_r + 4, 2 * prod),
            "delta": (2 * qkv_r + rowf_r, 2.0 * b * h * nl * d),
            "dq": (3 * qkv_r + 2 * kv + 2 * rowf_r, 3 * prod),
            "dkv": (2 * qkv_r + 4 * kv + 2 * rowf_r, 4 * prod)}
    names = {part: f"{base}_cp{p}_n{nl}x{n}"
             for part, base in zip(("fwd", "delta", "dq", "dkv"), FUSED_KERNELS)}
    def fused_tols(what, ref):
        return {"lse": (LSE_ATOL, LSE_RTOL), "delta": (FP32_ATOL, FP32_RTOL)}.get(
            what) or fused_tolerance(ref, bf16)

    new.update(cp_rows(f"rank 0, {nl} of {n} rows", names, q[:, :, :nl].contiguous(), k, v,
                       do[:, :, :nl].contiguous(), scale, bound, fa.NO_MASKS, work, fused_tols,
                       f"p=1: {n} x {n}, the fused encoder under cp_mesh on one NCCL rank"))
    print("  unsharded at n 13,824 (phase fused-encoder): " + ", ".join(
        f"{k_} {rows[fused_name(k_)]['ms']:.4f} ms" for k_ in FUSED_KERNELS
        if fused_name(k_) in rows))
    del q, k, v, do, full, ranks, got

    # the LLM's causal sequence at head dim 128
    b, h, n, d = CP_LLM_SHAPE
    nl, scale = n // p, d ** -0.5
    q, k, v, do = (torch.randn(b, h, n, d, generator=gen, device=dev).to(bf16) for _ in "qkvd")
    causal = fa.make_masks(True, None, None, b, n, dev)
    full = cp_unsharded(q, k, v, do, scale, None, causal)
    ranks = []
    for r in range(p):
        off = rank_offset(r, nl, dev)
        ranks.append(cp_rank_run(q, k, v, do, r, p, scale=scale, causal=True, q_offset=off))
        rows_r = slice(r * nl, (r + 1) * nl)
        masks = fa.make_masks(True, None, off, b, n, dev)
        ref_out, ref_lse = fa.flash_attention_plain(q[:, :, rows_r], k, v, None, scale,
                                                    return_lse=True, masks=masks)
        ref_dq, ref_dk, ref_dv, _ = fa.flash_attention_bwd_plain(
            q[:, :, rows_r], k, v, None, ref_out, ref_lse, do[:, :, rows_r], scale, masks)
        label = f"rank {r} (q_offset {r * nl}, {nl} x {n})"
        for part, g, ref in zip(("out", "lse", "dq", "dk", "dv"), ranks[-1],
                                (ref_out, ref_lse, ref_dq, ref_dk, ref_dv)):
            tol = (LSE_ATOL, LSE_RTOL) if part == "lse" else (BF16_ATOL, BF16_RTOL)
            compare(f"d128 causal {part} {label}", g, ref, *tol)
        if r:
            # planted: this rank's block taken as rows 0 .. n/p - 1
            fault = cp_rank_run(q, k, v, do, r, p, scale=scale, causal=True, q_offset=None)
            if not rejects(fault[0], ref_out, BF16_ATOL, BF16_RTOL):
                raise AssertionError(f"the kernel gate passes rank {r} at q_offset 0")
    print("  planted: ranks 1-3 at q_offset 0: each refused")
    summed = (torch.cat([x[0] for x in ranks], 2), sum(x[3] for x in ranks),
              sum(x[4] for x in ranks))
    for part, g, ref in zip(("out", "dk", "dv"), summed, (full[0], full[3], full[4])):
        compare(f"d128 causal {part}, {p} ranks against the unsharded call", g, ref, BF16_ATOL,
                BF16_RTOL)
    if not rejects(ranks[-1][3], full[3], BF16_ATOL, BF16_RTOL):
        raise AssertionError("the kernel gate passes the last rank's dK partial alone")
    print("  planted: the last rank's dK partial left unsummed: refused")
    # the rows at the last rank: q_offset 384, the most tiles of any rank
    r, off = p - 1, (p - 1) * nl
    q_r, do_r = q[:, :, off:].contiguous(), do[:, :, off:].contiguous()
    masks = fa.make_masks(True, None, rank_offset(r, nl, dev), b, n, dev)
    ones = torch.ones(b, n, dtype=torch.bool, device=dev)
    fwd_tiles, dkv_tiles = visited_tiles(ones, True, off, nl, n)
    tile = 2.0 * 64 * 64 * d * h
    qkv_r, kv, rowf_r = b * h * nl * d * 2, b * h * n * d * 2, b * h * nl * 4
    work = {"fwd": (2 * qkv_r + 2 * kv + rowf_r + 4, 2 * tile * fwd_tiles),
            "delta": (2 * qkv_r + rowf_r, 2.0 * b * h * nl * d),
            "dq": (3 * qkv_r + 2 * kv + 2 * rowf_r + 4, 3 * tile * fwd_tiles),
            "dkv": (2 * qkv_r + 4 * kv + 2 * rowf_r + 4, 4 * tile * dkv_tiles)}
    allowed = (torch.arange(n, device=dev)[None] <= torch.arange(off, n, device=dev)[:, None])
    names = {"fwd": f"flash_attention_fwd_lse_d128_cp{p}_causal",
             "delta": f"flash_attention_bwd_delta_d128_cp{p}_causal",
             "dq": f"flash_attention_bwd_dq_d128_cp{p}_causal",
             "dkv": f"flash_attention_bwd_dkv_d128_cp{p}_causal"}
    def llm_tols(what, ref):
        return {"lse": (LSE_ATOL, LSE_RTOL), "delta": (FP32_ATOL, FP32_RTOL)}.get(
            what, (BF16_ATOL, BF16_RTOL))

    new.update(cp_rows(f"rank {r}, q_offset {off}, {nl} x {n}", names, q_r, k, v, do_r, scale,
                       None, masks, work, llm_tols,
                       f"p=1: {n} x {n} causal, context_parallel_attention on one NCCL rank",
                       lib_mask=allowed[None, None]))
    for r in range(p):
        o = r * nl
        m_r = fa.make_masks(True, None, rank_offset(r, nl, dev), b, n, dev)
        q_i = q[:, :, o:o + nl].contiguous()
        print(f"  rank {r} (q_offset {o}): K2-lse-d128 "
              f"{cuda_ms(lambda: fa._forward(q_i, k, v, None, scale, None, True, m_r)):.4f} ms")
    print("  unsharded (" + ", ".join(map(str, CP_LLM_SHAPE)) + ", causal): K2-lse-d128 "
          f"{cuda_ms(lambda: fa._forward(q, k, v, None, scale, None, True, causal)):.4f} ms")
    return new


def cp_main_path(dev, mesh, rows: dict) -> None:
    """The phase's main path on the one-rank NCCL mesh: the fused encoder
    forward and backward under cp_mesh against cp_mesh=None, then
    context_parallel_attention at the LLM form against flash_attention;
    each one's launches counted into its rows."""
    import torch

    from ctpa_torch.core.config import CTViTConfig
    from ctpa_torch.core.init import random_init_
    from ctpa_torch.models.ctvit import CTViT
    from ctpa_torch.models.layers import set_compute_dtype
    from ctpa_torch.ops.flash_attention import LAUNCHES, flash_attention
    from ctpa_torch.parallel.context import context_parallel_attention

    cfg = dataclasses.replace(CTViTConfig(), fused_attention=True, fused_depth=CP_FUSED_DEPTH)
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    video = torch.rand(1, 1, cfg.temporal_size, cfg.image_size, cfg.image_size, generator=gen,
                       device=dev) * 2 - 1
    results = {}
    for label, kw in (("cp_mesh", dict(cp_mesh=mesh, cp_axis="data")), ("alone", {})):
        model = CTViT(cfg, device=dev, **kw)
        random_init_(model, torch.Generator(device=dev).manual_seed(SEED + 52))
        set_compute_dtype(model, torch.bfloat16)
        for key in LAUNCHES:
            LAUNCHES[key] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.enable_grad():
            tokens = model.encode_tokens(model.patch_embed(video.to(torch.bfloat16)))
            tokens.float().square().mean().backward()
        torch.cuda.synchronize()
        launched = {k: v for k, v in LAUNCHES.items() if v}
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                 if "enc_fused_transformer" in n and p.grad is not None}
        results[label] = (tokens.detach(), grads, launched)
        print(f"  fused encoder (depth {CP_FUSED_DEPTH}, {label}): forward and backward "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms, launches {launched}")
        del model
    (tok_c, g_c, launched), (tok_a, g_a, _) = results["cp_mesh"], results["alone"]
    atol, rtol = fused_tolerance(tok_a, torch.bfloat16)
    compare("fused encoder tokens, cp_mesh (one NCCL rank) against cp_mesh=None", tok_c, tok_a,
            atol, rtol)
    worst = min(torch.nn.functional.cosine_similarity(g_c[n].flatten().float(),
                                                      g_a[n].flatten().float(), dim=0).item()
                for n in g_a)
    bits = torch.equal(tok_c, tok_a) and all(torch.equal(g_c[n], g_a[n]) for n in g_a)
    print(f"  fused-stack gradients: least cosine {worst:.7f} (>= {TRAIN_GRAD_MIN_COS}) over "
          f"{len(g_a)} tensors; tokens and gradients bit-equal: {bits}")
    if worst < TRAIN_GRAD_MIN_COS:
        raise AssertionError("the fused encoder under cp_mesh differs from cp_mesh=None")
    b, h, n, d = FUSED_SHAPE
    for base in FUSED_KERNELS:
        rows[f"{base}_cp{CP_RANKS}_n{n // CP_RANKS}x{n}"]["launches"] = launched.get(base, 0)

    b, h, n, d = CP_LLM_SHAPE
    q, k, v, do = (torch.randn(b, h, n, d, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in "qkvd")
    outs = {}
    for label in ("context_parallel_attention", "flash_attention"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        for key in LAUNCHES:
            LAUNCHES[key] = 0
        with torch.enable_grad():
            if label == "flash_attention":
                out = flash_attention(*leaves, causal=True)
            else:
                out = context_parallel_attention(*leaves, mesh, "data", impl="flash",
                                                 causal=True)
            out.backward(do)
        torch.cuda.synchronize()
        outs[label] = (out.detach(), *(t.grad for t in leaves), dict(LAUNCHES))
    got, ref = outs["context_parallel_attention"], outs["flash_attention"]
    for part, g, r in zip(("out", "dq", "dk", "dv"), got, ref):
        compare(f"context_parallel_attention (one NCCL rank, causal d128) {part}", g, r,
                BF16_ATOL, BF16_RTOL)
    launched = got[4]
    print(f"  context_parallel_attention launches {({k: v for k, v in launched.items() if v})}")
    for key, row in (("flash_attention_fwd_lse_d128", "flash_attention_fwd_lse_d128"),
                     ("flash_attention_bwd_delta", "flash_attention_bwd_delta_d128"),
                     ("flash_attention_bwd_dq_d128", "flash_attention_bwd_dq_d128"),
                     ("flash_attention_bwd_dkv_d128", "flash_attention_bwd_dkv_d128")):
        rows[f"{row}_cp{CP_RANKS}_causal"]["launches"] = launched.get(key, 0)
    for name, row in rows.items():
        if "_cp" in name and not row.get("launches"):
            raise AssertionError(f"{name}: never launched on the phase's main path")


def tp_serving(dev, mesh) -> None:
    """(c): ContinuousBatcher(mesh=...) on the one-rank NCCL group against
    the unmeshed batcher, Meditron-7B width, bf16, greedy."""
    import numpy as np
    import torch

    from ctpa_torch.core.config import CTViTConfig, LLMConfig, ReportGenConfig
    from ctpa_torch.core.init import random_init_
    from ctpa_torch.models.report_generator import CTReportGenerator
    from ctpa_torch.pipelines.streaming import ContinuousBatcher, Request

    llm_cfg = dataclasses.replace(LLMConfig(), flash_decode=False)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    model = random_init_(CTReportGenerator(llm_cfg, CTViTConfig(), ReportGenConfig(), device=dev,
                                           dtype=torch.bfloat16), gen).eval()
    torch.cuda.synchronize()
    print(f"  CTReportGenerator at Meditron-7B width (bf16) built in "
          f"{time.perf_counter() - t0:.1f} s")
    ids = torch.randint(3, llm_cfg.vocab_size, (TP_LANES, TP_PROMPT), generator=gen, device=dev)
    vision = torch.randn(TP_LANES, model.gen_cfg.vision_dim, generator=gen, device=dev)
    tokens = {}
    with torch.inference_mode():
        for label, kw in (("alone", {}), ("mesh", dict(mesh=mesh))):
            batcher = ContinuousBatcher(model, num_lanes=TP_LANES,
                                        max_len=TP_PROMPT + TP_NEW_TOKENS + 16, eos_token_id=-1,
                                        greedy=True, steps_per_sync=8, **kw)
            for i in range(TP_LANES):
                batcher.submit(Request(request_id=i, input_ids=ids[i].cpu().numpy(),
                                       attention_mask=np.ones(TP_PROMPT, np.int32),
                                       vision=vision[i], max_new_tokens=TP_NEW_TOKENS))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = batcher.run_until_done()
            torch.cuda.synchronize()
            tokens[label] = [res[i].tokens for i in range(TP_LANES)]
            print(f"  ContinuousBatcher ({label}): {TP_LANES} lanes x {TP_NEW_TOKENS} greedy "
                  f"tokens in {(time.perf_counter() - t0) * 1e3:.1f} ms; lane 0: "
                  f"{tokens[label][0]}")
            del batcher
    if tokens["mesh"] != tokens["alone"] or any(len(t) != TP_NEW_TOKENS for t in tokens["mesh"]):
        raise AssertionError(f"TP serving tokens {tokens['mesh']} != {tokens['alone']}")
    print("  TP serving on one NCCL rank: every lane's tokens equal the unmeshed batcher's")
    del model
    torch.cuda.empty_cache()


def parallel(dev, rows: dict) -> None:
    """Phase parallel: (a) the CLIP CLI on one NCCL rank, (b) the CP forms
    rank by rank and the CP main path, (c) TP serving."""
    import torch
    import torch.distributed as dist

    from ctpa_torch.core.mesh import create_mesh

    parallel_clip_cli(dev, free_port())
    if not dist.is_initialized() or dist.get_backend() != ("nccl" if dev == "cuda" else "gloo"):
        raise AssertionError("train_clip --coordinator started no process group of the device's "
                             "backend")
    mesh = create_mesh()
    print(f"  mesh: {mesh.shape} over {dist.get_world_size()} rank(s), backend "
          f"{dist.get_backend()}")
    torch.cuda.empty_cache()
    new = check_cp_kernels(dev, rows)
    rows.update(new)
    torch.cuda.empty_cache()
    cp_main_path(dev, mesh, rows)
    torch.cuda.empty_cache()
    tp_serving(dev, mesh)
    dist.destroy_process_group()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    from ctpa_torch.core.config import BertConfig, CTCLIPConfig, CTViTConfig
    from ctpa_torch.kernels import build
    from ctpa_torch.ops.flash_attention import LAUNCHES
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
        start_fault_builds()
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
            for key in LAUNCHES:
                LAUNCHES[key] = 0
            kernel_res = serve(model, vq, clf, requests, dev, dtype,
                               expect_launches=(1, vit_cfg.spatial_depth))
            rows["patchify_project"]["launches"] = patchify_project.launches
            rows["flash_attention_fwd"]["launches"] = LAUNCHES["flash_attention_fwd"]
            print(f"  main path: patchify_project launched {patchify_project.launches} times, "
                  f"flash_attention_fwd {LAUNCHES['flash_attention_fwd']} times for "
                  f"{len(requests)} volumes")
            for key in ("patchify_project", "flash_attention_fwd"):
                if rows[key]["launches"] == 0:
                    raise AssertionError(f"{key} never launched on the main path")

        with phase("plain"):
            plain_cfg = dataclasses.replace(vit_cfg, pallas_patchify=False, flash_axial=False)
            from ctpa_torch.models.ctclip import CTCLIP

            plain = CTCLIP(clip_cfg, plain_cfg, bert_cfg, device=dev, dtype=dtype).eval()
            plain.load_state_dict(model.state_dict())
            plain_res = serve(plain, vq, clf, requests, dev, dtype, expect_launches=(0, 0))
            compare_serving(model, plain, kernel_res, plain_res)
        del kernel_res, plain_res, requests
        with phase("raw-kernels"):
            rows.update(check_raw_kernels(dev))
        with phase("raw-serving"):
            raw_serving(model, plain, vq, clf, dev, rows)
        del model, plain, clf
    torch.cuda.empty_cache()

    # training runs outside inference_mode
    with phase("train-kernels"):
        rows.update(check_train_kernels(dev))
    torch.cuda.empty_cache()
    with phase("training"):
        first, start, batch = train(dev, rows)
    torch.cuda.empty_cache()
    with phase("train-plain"):
        train_plain(dev, first, start, batch)
    del first, start, batch
    torch.cuda.empty_cache()

    with phase("report-kernels"):
        with torch.inference_mode():
            rows.update(check_report_kernels(dev))
    torch.cuda.empty_cache()
    with phase("report"):
        model, inputs, tokens = report(dev, rows)
    with phase("report-plain"):
        report_plain(model, inputs, tokens)
    del inputs, tokens
    torch.cuda.empty_cache()

    with phase("report-train-kernels"):
        rows.update(check_report_train_kernels(dev))
    torch.cuda.empty_cache()
    with phase("report-train"):
        start, first, batch = report_train(dev, rows, model)
    torch.cuda.empty_cache()
    with phase("report-train-plain"):
        report_train_plain(dev, model, start, first, batch)
    del start, first, batch
    torch.cuda.empty_cache()

    with phase("quant-kernels"):
        with torch.inference_mode():
            rows.update(check_quant_kernels(dev))
    torch.cuda.empty_cache()
    with phase("quant-report"):
        # the report phase's volumes and prompts again, from their seed
        inputs = report_inputs(model.vit_cfg, model.llm_cfg, dev)
        base = save_base(model)
        qmodels, qtokens, qvision = quant_report(dev, rows, model, inputs, base, 4)
    with phase("quant-plain"):
        quant_plain(model, qmodels, inputs, qtokens, qvision)
    # the int4 models go before the int8 ones load, but for the w4a8
    # bundle, which the stream phases serve
    stream_q = qmodels["w4a8"]
    del qmodels, qtokens, qvision
    torch.cuda.empty_cache()

    with phase("quant8-kernels"):
        with torch.inference_mode():
            rows.update(check_quant8_kernels(dev))
    torch.cuda.empty_cache()
    with phase("quant8-report"):
        qmodels, qtokens, qvision = quant_report(dev, rows, model, inputs, base, 8)
        os.remove(base)
    with phase("quant8-plain"):
        quant_plain(model, qmodels, inputs, qtokens, qvision)
    with phase("report-files"):
        report_files(dev, rows, model, qmodels["w8a8"], smi)
    shutil.rmtree(QUANT_DIR, ignore_errors=True)
    del inputs, qmodels, qtokens, qvision
    torch.cuda.empty_cache()

    with phase("stream"):
        runs = stream(dev, model, stream_q)
    with phase("stream-plain"):
        stream_plain(dev, model, stream_q, runs)
    del model, stream_q, runs
    torch.cuda.empty_cache()

    with phase("zeroshot-files"):
        with torch.inference_mode():
            zeroshot_files(dev)
    torch.cuda.empty_cache()

    with phase("clip-files"):
        clip_files(dev)
    torch.cuda.empty_cache()
    with phase("fused-encoder"):
        rows.update(check_fused_kernels(dev))
        torch.cuda.empty_cache()
        fused_step(dev, rows)
    torch.cuda.empty_cache()
    with phase("parallel"):
        parallel(dev, rows)
    torch.cuda.empty_cache()
    with phase("vqgan"):
        vqgan(dev)
    torch.cuda.empty_cache()

    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    # a row whose main-path launches are of another form than it is timed
    # at (the CP rank forms: one rank launches the p=1 form) says which
    kernels = [{key: rows[k][key] for key in order
                + (("launches_form",) if "launches_form" in rows[k] else ())}
               for k in ("patchify_project", "flash_attention_fwd", "resample3_patchify_project")
               + TRAIN_KERNELS
               + ("decode_attention", "flash_attention_fwd_lse_d128",
                  "flash_attention_bwd_delta_d128", "flash_attention_bwd_dq_d128",
                  "flash_attention_bwd_dkv_d128")
               + tuple(f[0] for f in QUANT_FORMS) + ("int4_act_quant",)
               + tuple(f[0] for f in QUANT8_FORMS)
               + tuple(f"{f[0]}_prefill" for f in QUANT_FORMS + QUANT8_FORMS)
               + tuple(fused_name(k) for k in FUSED_KERNELS)
               + tuple(k for k in rows if "_cp" in k)]
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
