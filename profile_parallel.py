"""Parallelism across cards, each path against the same work on one card.

One process a card (NCCL), P ranks (default 4) in one (data P, model 1)
mesh, then a (data 1, model P) mesh for tensor parallelism:

  * context-parallel attention (`parallel/context.py`) at the fused
    encoder's form (1, 8, 13,824, 32) bf16 and at an LLM form
    (2, 32, 512, 128) causal, forward and backward, against the unsharded
    flash call on the rank's own card, under `chip_smoke.py`'s limits;
    times of both (CUDA events, the collectives inside);
  * a data-parallel CLIP step (`train/clip_trainer.py` with a mesh) at
    the tiny configuration, fp32, one row a rank, against the step on the
    P-row global batch on one card: loss and gradient norm within 1e-5
    relative, each reduced gradient within 1e-6 abs + 1e-4 rel of the
    global one, the VQ state within 1e-5 (at full width fp32 noise between
    a batch of 1 and of P flips VQ codes at near ties, which moves whole
    tokens' gradients);
  * tensor-parallel serving (`ContinuousBatcher(mesh=...)`) at
    Meditron-7B width in fp32, 4 lanes x 16 greedy tokens, against the
    unmeshed batcher on one card: tokens equal.

    python3 profile_parallel.py [--ranks P]

prints one line a check with the cards' name and power limit, and exits 1
when a check fails or fewer than P cards are present.  `--device cpu`
runs the same paths on P gloo processes at the tiny configurations (a
rehearsal; no time it prints is a card's).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

RESULTS = "build/profile_parallel"      # each rank's lines


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def events_ms(fn, dev, iters: int = 5) -> float:
    """Mean ms a call by CUDA events (host clock on the CPU), after one call."""
    import torch

    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_cp(mesh, dev, shape, causal: bool, say) -> None:
    """Context-parallel attention against the unsharded flash call, forward
    and backward, on the rank's card."""
    import torch

    import chip_smoke as cs
    from ctpa_torch.ops.attention_ops import l2norm
    from ctpa_torch.ops.flash_attention import flash_attention
    from ctpa_torch.parallel.context import context_parallel_attention

    b, h, n, d = shape
    gen = torch.Generator(device=dev).manual_seed(7)
    bf16 = torch.bfloat16 if dev.type == "cuda" else torch.float32
    q, k = (torch.randn(b, h, n, d, generator=gen, device=dev) for _ in "qk")
    if not causal:
        q, k = l2norm(q), l2norm(k)
    q, k = q.to(bf16), k.to(bf16)
    v, do = (torch.randn(b, h, n, d, generator=gen, device=dev).to(bf16) for _ in "vd")
    scale = d ** -0.5 if causal else 8.0
    bound = None if causal else torch.tensor(8.0, device=dev)

    def run(cp: bool):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        if cp:
            out = context_parallel_attention(*leaves, mesh, "data", scale=scale, impl="flash",
                                             causal=causal, logit_bound=bound)
        else:
            out = flash_attention(*leaves, causal=causal, scale=scale, logit_bound=bound)
        out.backward(do)
        return (out.detach(), *(t.grad for t in leaves))

    got, ref = run(True), run(False)
    worst = -float("inf")
    for name, g, r in zip(("out", "dq", "dk", "dv"), got, ref):
        atol, rtol = (cs.fused_tolerance(r, bf16) if not causal
                      else (cs.BF16_ATOL, cs.BF16_RTOL))
        excess = ((g.float() - r.float()).abs() - (atol + rtol * r.float().abs())).max().item()
        worst = max(worst, excess)
        if excess > 0:
            raise AssertionError(f"CP {shape} causal {causal}: {name} exceeds its limit by "
                                 f"{excess}")
    cp_ms, one_ms = events_ms(lambda: run(True), dev), events_ms(lambda: run(False), dev)
    say(f"CP {tuple(shape)} causal {causal}: within the limits (least margin {-worst:.3e}); "
        f"forward+backward {cp_ms:.4f} ms on {mesh.size('data')} ranks, {one_ms:.4f} ms "
        "unsharded on one card")


def check_dp(mesh, dev, say) -> None:
    """The data-parallel CLIP step against the global batch's step on one
    card, at the tiny configuration."""
    import torch

    from ctpa_torch.core.config import (BertConfig, CTCLIPConfig, CTViTConfig,
                                        OptimizerConfig)
    from ctpa_torch.core.init import random_init_
    from ctpa_torch.core.precision import policy
    from ctpa_torch.models.ctclip import CTCLIP
    from ctpa_torch.ops.vq import vq_init
    from ctpa_torch.train.clip_trainer import make_clip_train_step
    from ctpa_torch.train.optim import get_optimizer
    from ctpa_torch.train.train_state import CLIPTrainState

    vit, bert = CTViTConfig.tiny(), BertConfig.tiny()
    clip = CTCLIPConfig.tiny(vit, bert)
    p, r = mesh.size("data"), mesh.index("data")
    gen = torch.Generator(device=dev).manual_seed(11)
    seq = 32
    batch = {"input_ids": torch.randint(3, bert.vocab_size, (p, seq), generator=gen, device=dev),
             "attention_mask": torch.ones(p, seq, dtype=torch.long, device=dev),
             "video": torch.rand(p, 1, vit.temporal_size, vit.image_size, vit.image_size,
                                 generator=gen, device=dev) * 2 - 1}

    def step(rows, with_mesh):
        model = CTCLIP(clip, vit, bert, device=dev)
        g = torch.Generator(device=dev).manual_seed(12)
        random_init_(model, g)
        vq = vq_init(g, vit.codebook_size, vit.dim, device=dev)
        tx = get_optimizer(OptimizerConfig(lr=1e-3), model)
        fn = make_clip_train_step(model, tx, policy=policy("fp32"),
                                  mesh=mesh if with_mesh else None)
        t0 = time.perf_counter()
        state, m = fn(CLIPTrainState.create(model, tx, vq),
                      {k: v[rows] for k, v in batch.items()})
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        grads = {n: q.grad.detach().clone() for n, q in model.named_parameters()
                 if q.grad is not None}
        return {k: float(v) for k, v in m.items()}, grads, state.vq_state, wall

    m_dp, g_dp, vq_dp, wall_dp = step(slice(r, r + 1), True)
    m_one, g_one, vq_one, wall_one = step(slice(0, p), False)
    for key in ("loss", "grad_norm", "vq_commit"):
        rel = abs(m_dp[key] - m_one[key]) / max(abs(m_one[key]), 1e-30)
        if rel > 1e-5:
            raise AssertionError(f"DP CLIP step: {key} {m_dp[key]} against {m_one[key]}")
    for name, g in g_one.items():
        torch.testing.assert_close(g_dp[name], g, atol=1e-6, rtol=1e-4, msg=name)
    for a, b_ in zip(vq_dp, vq_one):
        torch.testing.assert_close(a, b_, atol=1e-5, rtol=0)
    say(f"DP CLIP step (tiny, fp32, {p} ranks x 1 row): loss "
        f"{m_dp['loss']:.6f} / {m_one['loss']:.6f}, grad norm {m_dp['grad_norm']:.6f} / "
        f"{m_one['grad_norm']:.6f} (global batch on one card); every gradient within 1e-6 + "
        f"1e-4 rel; step {wall_dp:.1f} ms a rank, {wall_one:.1f} ms for {p} rows on one card")


def check_tp(mesh, dev, say, tiny: bool) -> None:
    """TP serving against the unmeshed batcher on one card, fp32, greedy."""
    import numpy as np
    import torch

    from ctpa_torch.core.config import CTViTConfig, LLMConfig, ReportGenConfig
    from ctpa_torch.core.init import random_init_
    from ctpa_torch.models.report_generator import CTReportGenerator
    from ctpa_torch.pipelines.streaming import ContinuousBatcher, Request

    llm = LLMConfig.tiny() if tiny else LLMConfig()
    vit = CTViTConfig.tiny() if tiny else CTViTConfig()
    gen_cfg = ReportGenConfig(vision_dim=24) if tiny else ReportGenConfig()
    model = random_init_(CTReportGenerator(llm, vit, gen_cfg, device=dev),
                         torch.Generator(device=dev).manual_seed(13)).eval()
    gen = torch.Generator(device=dev).manual_seed(14)
    lanes, prompt, new = 4, 64, 16
    ids = torch.randint(3, llm.vocab_size, (lanes, prompt), generator=gen, device=dev)
    vision = torch.randn(lanes, gen_cfg.vision_dim, generator=gen, device=dev)
    tokens, walls = {}, {}
    with torch.inference_mode():
        for label, kw in (("one card", {}), ("mesh", dict(mesh=mesh))):
            batcher = ContinuousBatcher(model, num_lanes=lanes, max_len=prompt + new + 16,
                                        eos_token_id=-1, greedy=True, steps_per_sync=8, **kw)
            for i in range(lanes):
                batcher.submit(Request(request_id=i, input_ids=ids[i].cpu().numpy(),
                                       attention_mask=np.ones(prompt, np.int32),
                                       vision=vision[i], max_new_tokens=new))
            t0 = time.perf_counter()
            res = batcher.run_until_done()
            walls[label] = (time.perf_counter() - t0) * 1e3
            tokens[label] = [res[i].tokens for i in range(lanes)]
            del batcher
    if tokens["mesh"] != tokens["one card"]:
        raise AssertionError(f"TP tokens {tokens['mesh']} != {tokens['one card']}")
    say(f"TP serving ({'tiny' if tiny else 'Meditron-7B width'}, fp32, tp {mesh.size('model')}): "
        f"{lanes} lanes x {new} greedy tokens equal to one card's; {walls['mesh']:.1f} ms "
        f"against {walls['one card']:.1f} ms")


def worker(rank: int, ranks: int, port: int, device: str) -> None:
    import torch
    import torch.distributed as dist

    from ctpa_torch.core.config import MeshConfig
    from ctpa_torch.core.mesh import create_mesh, initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(f"cuda:{rank}" if device == "cuda" else "cpu")
    if dev.type == "cpu":
        torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", ranks, rank, device=dev)
    tiny = dev.type == "cpu"
    os.makedirs(RESULTS, exist_ok=True)
    log = open(os.path.join(RESULTS, f"rank{rank}.log"), "w")

    def say(line: str) -> None:
        log.write(line + "\n")
        log.flush()
        if rank == 0:
            print(line, flush=True)

    dp = create_mesh(MeshConfig(data_parallel=ranks, model_parallel=1))
    tp = create_mesh(MeshConfig(data_parallel=1, model_parallel=ranks))
    # a failing rank exits at once: spawn then stops the others, which would
    # otherwise wait in their next collective
    check_cp(dp, dev, (1, 4, 256, 16) if tiny else (1, 8, 13824, 32), False, say)
    check_cp(dp, dev, (2, 4, 256, 32) if tiny else (2, 32, 512, 128), True, say)
    check_dp(dp, dev, say)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check_tp(tp, dev, say, tiny)
    log.close()
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    import torch
    import torch.multiprocessing as mp

    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            print(f"profile_parallel: {args.ranks} cards needed, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip(), flush=True)
    mp.spawn(worker, args=(args.ranks, free_port(), args.device), nprocs=args.ranks, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
