#!/usr/bin/env python3
"""Where one zero-shot request's device time goes, on one CUDA card.

    python3 profile_zeroshot.py            # from the root of a checkout

Builds the serving model as ``chip_smoke.py`` does (shipped geometry, bf16,
seeded random weights, both hand kernels on), serves its requests once to
warm up, then traces one inference request with ``torch.profiler`` and
prints the request's wall time, the summed device time of its kernels, the
device-busy share (their ratio; the kernels run on one stream and do not
overlap) and the device time by kernel, largest first.  Where the trace
holds no device time it says "not measured".
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from collections import defaultdict


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_zeroshot: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ctpa_torch.core.config import BertConfig, CTCLIPConfig, CTViTConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}")
    dev, bf16 = "cuda", torch.bfloat16
    vit_cfg = dataclasses.replace(CTViTConfig(), pallas_patchify=True, flash_axial=True)
    with torch.inference_mode():
        model, vq, clf = cs.build_serving(vit_cfg, BertConfig(), CTCLIPConfig(), dev, bf16)
        requests = cs.make_requests(vit_cfg, dev, 2, cs.INFER_SHAPE, cs.RAW_SHAPE)
        cs.serve(model, vq, clf, requests, dev, bf16)          # warm-up
        _, preprocess = requests[1]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            latent, _ = model.encode_image(preprocess()[None].to(bf16), vq)
            clf.score(latent)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3

    per_kernel = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[ev.name][0] += ev.time_range.elapsed_us() / 1e3
            per_kernel[ev.name][1] += 1
    device_ms = sum(ms for ms, _ in per_kernel.values())
    print(f"request wall time (traced): {wall_ms:.3f} ms")
    if not per_kernel:
        print("device time: not measured (the trace holds no CUDA kernels)")
        return 0
    print(f"device time: {device_ms:.3f} ms in {sum(n for _, n in per_kernel.values())} "
          f"kernel launches; device busy {100 * device_ms / wall_ms:.1f}% of the request")
    print("device ms   launches  share  kernel")
    for name, (ms, n) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"{ms:9.3f} {n:9d} {100 * ms / device_ms:5.1f}%  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
