#!/usr/bin/env python3
"""Where one contrastive training step's device time goes, on one CUDA card.

    python3 profile_clip_train.py            # from the root of a checkout

Builds the training model as ``chip_smoke.py`` does (shipped geometry, fp32
parameters, bf16 compute, block remat, seeded random weights, 2 synthetic
volumes and 512-token reports), once with the flash kernels on the spatial
fold and once on its plain attention.  The kernels are built first.  For
each path it takes 2 steps to warm up, times 3 more (host clock, each
ending in ``torch.cuda.synchronize()``), then traces two steps with
``torch.profiler`` (the first absorbs the profiler's own start-up) and
prints the second's wall time, the summed device time of its kernels, the
device-busy share (their ratio; the kernels run on one stream), the
device time by kernel, largest first, and the port's flash kernels (K2, K3)
summed.  Where the trace holds no device time it says "not measured".
"""

from __future__ import annotations

import subprocess
import sys
import time
from collections import defaultdict

WARMUP, TIMED = 2, 3
HAND_FLASH = "(anonymous namespace)::flash_"   # the port's K2 and K3 kernels


def run(flash_axial: bool) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from ctpa_torch.core.config import OptimizerConfig
    from ctpa_torch.core.init import random_init_
    from ctpa_torch.core.precision import Policy
    from ctpa_torch.ops.vq import vq_init
    from ctpa_torch.train.clip_trainer import make_clip_train_step
    from ctpa_torch.train.optim import get_optimizer
    from ctpa_torch.train.train_state import CLIPTrainState

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    model = random_init_(cs.build_training(dev, flash_axial=flash_axial), gen)
    vit_cfg = model.visual_transformer.cfg
    vq = vq_init(gen, vit_cfg.codebook_size, vit_cfg.dim, device=dev)
    batch = cs.make_train_batch(model, dev)
    tx = get_optimizer(OptimizerConfig(), model)
    state = CLIPTrainState.create(model, tx, vq)
    step = make_clip_train_step(model, tx, vq_decay=vit_cfg.vq_decay, policy=Policy())
    label = "kernel path (flash_axial)" if flash_axial else "plain path"
    times = []
    for i in range(WARMUP + TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    steady = times[WARMUP:]
    print(f"{label}: step wall ms " + " ".join(f"{t:.1f}" for t in times)
          + f"  (steady mean {sum(steady) / len(steady):.1f}; loss {float(m['loss']):.6f})")
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3

    per_kernel = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        # user annotations (the optimizer's step range) overlap the kernels
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(ev, "is_user_annotation", False):
            per_kernel[ev.name][0] += ev.time_range.elapsed_us() / 1e3
            per_kernel[ev.name][1] += 1
    print(f"{label}: traced step wall time {wall_ms:.3f} ms")
    if not per_kernel:
        print("device time: not measured (the trace holds no CUDA kernels)")
        return
    device_ms = sum(ms for ms, _ in per_kernel.values())
    print(f"device time: {device_ms:.3f} ms in {sum(n for _, n in per_kernel.values())} "
          f"kernel launches; device busy {100 * device_ms / wall_ms:.1f}% of the step")
    print("device ms   launches  share  kernel")
    for name, (ms, n) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:30]:
        print(f"{ms:9.3f} {n:9d} {100 * ms / device_ms:5.1f}%  {name[:110]}")
    # the port's own flash kernels (K2, K3), whatever their rank
    hand = {name: v for name, v in per_kernel.items() if HAND_FLASH in name}
    print(f"hand-written flash kernels: {sum(ms for ms, _ in hand.values()):.3f} ms in "
          f"{sum(n for _, n in hand.values())} launches")
    for name, (ms, n) in sorted(hand.items(), key=lambda kv: -kv[1][0]):
        print(f"{ms:9.3f} {n:9d} {100 * ms / device_ms:5.1f}%  {name[:110]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_clip_train: no CUDA device", file=sys.stderr)
        return 1
    from ctpa_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}; nvcc {build.library().seconds:.2f} s")
    for flash_axial in (True, False):
        run(flash_axial)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
