"""Worker side of the port's multi-process CPU tests (no tests of its own).

``spawn(case, world, job, tmp_path)`` (called by
``tests/test_torch_parallel.py``, ``test_torch_context_parallel.py`` and
``test_torch_tp.py``) writes ``job`` (a dict of arrays and settings) to
``tmp_path``, starts ``world`` processes of this file, each of which joins
a gloo group through a ``FileStore`` file under ``tmp_path`` (no port, so
concurrent test processes never collide), runs ``CASES[case]`` and saves
what it returns; ``spawn`` returns the ranks' results in rank order.  The
workers import torch and the port only, never JAX.  A hard timeout kills
every worker, so a hung collective fails one test.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT_S = 120


def spawn(case: str, world: int, job: dict, tmp_path, timeout: float = SPAWN_TIMEOUT_S) -> list:
    """Run ``case`` on ``world`` gloo ranks; their results in rank order."""
    tmp = Path(tmp_path) / f"{case}_{world}_{time.monotonic_ns()}"
    tmp.mkdir(parents=True)
    torch.save(dict(job, case=case, world=world, store=str(tmp / "store")), tmp / "job.pt")
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, str(tmp), str(r)], cwd=ROOT, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        text = "\n".join(f"--- rank {r} (rc {procs[r].returncode}):\n"
                         + (tmp / f"rank{r}.log").read_text()[-4000:] for r in failed)
        raise AssertionError(f"{case} on {world} ranks failed or timed out:\n{text}")
    return [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(world)]


# --------------------------------------------------------------- the cases

def _t(x):
    return torch.from_numpy(np.array(x))


def _mesh(job, dp=None, mp=1):
    from ctpa_torch.core.config import MeshConfig
    from ctpa_torch.core.mesh import create_mesh

    return create_mesh(MeshConfig(data_parallel=dp or job["world"] // mp, model_parallel=mp))


def case_cp(job, rank):
    """Context-parallel attention: each form's output and gradients of
    sum(out * w); ``cp_faults`` re-run with every rank's offset 0."""
    from ctpa_torch.parallel import context

    mesh = _mesh(job)
    out = {}

    def run(form):
        leaves = {k: _t(form[k]).requires_grad_(form["grad"]) for k in ("q", "k", "v")}
        bias = None if form.get("bias") is None else _t(form["bias"]).requires_grad_(form["grad"])
        kv = None if form.get("kv_mask") is None else _t(form["kv_mask"])
        got = context.context_parallel_attention(
            leaves["q"], leaves["k"], leaves["v"], mesh, "data", bias=bias, kv_mask=kv,
            impl=form["impl"], causal=form["causal"])
        res = {"out": got.detach().numpy()}
        if form["grad"]:
            (got * _t(form["w"])).sum().backward()
            res.update({f"d{k}": t.grad.numpy() for k, t in leaves.items()})
            if bias is not None:
                res["dbias"] = bias.grad.numpy()
        return res

    for name, form in job["forms"].items():
        out[name] = run(form)
    q = torch.zeros(1, 1, job["indivisible"], 16)
    try:
        context.context_parallel_attention(q, q, q, mesh, "data", impl="dense")
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    if job.get("encoder") is not None:
        out["encoder"] = _cp_encoder(job["encoder"], mesh)
    # the planted fault: every rank's queries taken as rows 0 .. n/p - 1
    context.rank_offset = lambda r, n_local, device: torch.zeros((), dtype=torch.int32,
                                                                 device=device)
    out["faults"] = {name: run(job["forms"][name]) for name in job["cp_faults"]}
    return out


def _cp_encoder(enc, mesh):
    import dataclasses

    from ctpa_torch.core import config as tc
    from ctpa_torch.models.ctvit import CTViT

    cfg = dataclasses.replace(tc.CTViTConfig.tiny(), fused_attention=True,
                              fused_depth=enc["depth"])
    model = CTViT(cfg, device="cpu", cp_mesh=mesh, cp_axis="data")
    model.load_state_dict({k: _t(v) for k, v in enc["state"].items()})
    video = _t(enc["video"])
    with torch.no_grad():
        return model.encode_tokens(model.patch_embed(video)).numpy()


def case_dp_clip(job, rank):
    """The CLIP step over the data axis: each rank steps on its rows of
    each global batch; metrics, parameters and codebook after each run.
    Runs "honest" and then each planted fault from the same start."""
    from ctpa_torch.core import config as tc
    from ctpa_torch.core.precision import policy
    from ctpa_torch.models import ctclip
    from ctpa_torch.models.ctclip import CTCLIP
    from ctpa_torch.ops.vq import VQState
    from ctpa_torch.train import clip_trainer, optim
    from ctpa_torch.train.train_state import CLIPTrainState

    mesh = _mesh(job)
    vit, bert = tc.CTViTConfig.tiny(), tc.BertConfig.tiny()
    p, i = mesh.size("data"), mesh.index("data")

    def run(steps):
        model = CTCLIP(tc.CTCLIPConfig.tiny(vit, bert), vit, bert, device="cpu")
        model.load_state_dict({k: _t(v) for k, v in job["state"].items()})
        tx = optim.get_optimizer(tc.OptimizerConfig(lr=job["lr"]), model)
        state = CLIPTrainState.create(model, tx, VQState(*map(_t, job["vq"])))
        step = clip_trainer.make_clip_train_step(model, tx, policy=policy("fp32"), mesh=mesh)
        metrics, params = [], []
        for batch in job["batches"][:steps]:
            b = batch["input_ids"].shape[0] // p
            local = {k: _t(v[i * b:(i + 1) * b]) for k, v in batch.items()}
            local["input_ids"] = local["input_ids"].long()
            state, m = step(state, local)
            metrics.append({k: float(v) for k, v in m.items()})
            params.append({k: v.numpy().copy() for k, v in model.state_dict().items()})
            if len(params) == 1:        # the first step's reduced (and clipped) gradients
                grads = {n: t.grad.numpy().copy() for n, t in model.named_parameters()
                         if t.grad is not None}
        return {"metrics": metrics, "params": params, "grads": grads,
                "vq": [t.numpy() for t in state.vq_state]}

    out = {"honest": run(len(job["batches"]))}
    gather, reduce_vq = ctclip.all_gather_batch, clip_trainer.reduce_vq_stats
    try:
        # planted: local negatives only (no gather of the latents)
        ctclip.all_gather_batch = lambda x, mesh, axis="data": x
        out["local_negatives"] = run(1)
        ctclip.all_gather_batch = gather
        # planted: the VQ statistics left unreduced
        clip_trainer.reduce_vq_stats = lambda counts, sums, mesh, axis="data": (counts, sums)
        out["unreduced_ema"] = run(1)
    finally:
        ctclip.all_gather_batch, clip_trainer.reduce_vq_stats = gather, reduce_vq
    return out


def case_dp_ssl(job, rank):
    """One CLIP step with the MLM and SimCLR objectives on this rank's rows:
    the metrics and the reduced (clipped) gradients."""
    import dataclasses

    from ctpa_torch.core import config as tc
    from ctpa_torch.core.precision import policy
    from ctpa_torch.models.ctclip import CTCLIP
    from ctpa_torch.ops.vq import VQState
    from ctpa_torch.train import clip_trainer, optim
    from ctpa_torch.train.train_state import CLIPTrainState

    mesh = _mesh(job)
    p, i = mesh.size("data"), mesh.index("data")
    vit, bert = tc.CTViTConfig.tiny(), tc.BertConfig.tiny()
    model = CTCLIP(dataclasses.replace(tc.CTCLIPConfig.tiny(vit, bert), use_mlm=True), vit, bert,
                   device="cpu")
    model.load_state_dict({k: _t(v) for k, v in job["state"].items()})
    tx = optim.get_optimizer(tc.OptimizerConfig(lr=job["lr"]), model)
    state = CLIPTrainState.create(model, tx, VQState(*map(_t, job["vq"])))
    step = clip_trainer.make_clip_train_step(model, tx, policy=policy("fp32"), use_mlm=True,
                                             use_visual_ssl=True, seed=job["seed"], mesh=mesh)
    batch = job["batch"]
    b = batch["input_ids"].shape[0] // p
    local = {k: _t(v[i * b:(i + 1) * b]) for k, v in batch.items()}
    local["input_ids"] = local["input_ids"].long()
    _, m = step(state, local)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": {n: t.grad.numpy().copy() for n, t in model.named_parameters()
                      if t.grad is not None}}


def case_sharded_loss(job, rank):
    """contrastive_loss_sharded on this rank's latent rows, and its
    gradients, plain and decoupled."""
    from ctpa_torch.core.mesh import initialize_distributed
    from ctpa_torch.models.ctclip import contrastive_loss_sharded

    # a second call finds the group started and returns (ctpa's guard)
    initialize_distributed("file://" + job["store"], job["world"], rank, device="cpu")
    mesh = _mesh(job)
    p, i = mesh.size("data"), mesh.index("data")
    b = job["text"].shape[0] // p
    out = {}
    for decoupled in (False, True):
        t = _t(job["text"][i * b:(i + 1) * b]).requires_grad_()
        im = _t(job["image"][i * b:(i + 1) * b]).requires_grad_()
        loss = contrastive_loss_sharded(t, im, torch.tensor(job["temp"]), mesh, "data",
                                        decoupled=decoupled)
        loss.backward()
        out[decoupled] = {"loss": float(loss), "dt": t.grad.numpy(), "di": im.grad.numpy()}
    return out


def case_dp_report(job, rank):
    """The partitioned report step over the data axis, ranks holding
    unequal numbers of label tokens; then the mean of per-rank means."""
    from ctpa_torch.core import config as tc
    from ctpa_torch.models.report_generator import CTReportGenerator
    from ctpa_torch.train import report_trainer as trt
    from ctpa_torch.train.train_state import SimpleTrainState

    mesh = _mesh(job)
    p, i = mesh.size("data"), mesh.index("data")
    llm, vit = tc.LLMConfig(**job["llm"]), tc.CTViTConfig.tiny()
    lora = tc.LoRAConfig(**job["lora"])
    gen = tc.ReportGenConfig(vision_dim=job["vision_dim"], lora=lora, llm_lr=job["lr"],
                             cross_attn_lr=job["lr"])

    def run(steps):
        model = CTReportGenerator(llm, vit, gen, lora=lora, device="cpu")
        model.load_state_dict({k: _t(v) for k, v in job["state"].items()})
        step, tx = trt.make_partitioned_report_step(model, gen, total_steps=10, mesh=mesh)
        state = SimpleTrainState.create(model, tx)
        metrics, params = [], []
        for batch in job["batches"][:steps]:
            b = batch["input_ids"].shape[0] // p
            local = {k: _t(v[i * b:(i + 1) * b]) for k, v in batch.items()}
            for k in ("input_ids", "attention_mask"):
                local[k] = local[k].long()
            state, m = step(state, local)
            metrics.append({k: float(v) for k, v in m.items()})
            params.append({n: t.detach().numpy().copy() for n, t in model.named_parameters()
                           if t.requires_grad})
            if len(params) == 1:        # the first step's reduced (and clipped) gradients
                grads = {n: t.grad.numpy().copy() for n, t in model.named_parameters()
                         if t.grad is not None}
        return {"metrics": metrics, "params": params, "grads": grads}

    out = {"honest": run(len(job["batches"]))}
    # planted: each rank's own token mean, then the mean over ranks
    loss = trt._loss
    trt._loss = lambda model, batch, mesh=None: loss(model, batch, None)
    try:
        out["mean_of_means"] = run(1)
    finally:
        trt._loss = loss
    return out


def case_dp(job, rank):
    """The data-parallel cases in one world: each part of ``job`` (a case's
    own job) run by its case, in order."""
    return {name: CASES[name]({**part, "world": job["world"], "store": job["store"]}, rank)
            for name, part in job.items() if name not in ("case", "world", "store")}


def case_clip_cli(job, rank):
    """train_clip.main with --coordinator on this rank: its local batches,
    each step's metrics, the first step's reduced (and clipped) gradients,
    the final parameters and codebook."""
    from ctpa_torch.cli import train_clip

    seen, trainers, metrics, grads = [], [], [], {}

    class Recording(train_clip.CTClipTrainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trainers.append(self)

        def _place(self, batch):
            if len(seen) == 1:          # the step zeroes them after this
                grads.update({n: t.grad.numpy().copy()
                              for n, t in self.state.model.named_parameters()
                              if t.grad is not None})
            placed = super()._place(batch)
            seen.append({k: v.numpy().copy() for k, v in placed.items()})
            return placed

        def train_step(self):
            m = super().train_step()
            metrics.append({k: float(v) for k, v in m.items()})
            return m

    def init_state(model, seed=0):
        from ctpa_torch.ops.vq import VQState

        model.load_state_dict({k: _t(v) for k, v in job["state"].items()})
        return model, VQState(*map(_t, job["vq"]))

    train_clip.CTClipTrainer, train_clip.init_state = Recording, init_state
    rc = train_clip.main(job["argv"] + ["--coordinator", "file://" + job["store"],
                                        "--num-processes", str(job["world"]),
                                        "--process-id", str(rank)], device="cpu")
    state = trainers[0].state
    return {"rc": rc, "batches": seen, "metrics": metrics, "grads": grads,
            "params": {k: v.numpy() for k, v in state.model.state_dict().items()},
            "vq": [t.numpy() for t in state.vq_state], "step": state.step}


def case_vqgan_cli(job, rank):
    """train_vqgan.main in a world of ``world`` ranks (dp = gcd(batch,
    world)): each rank's local videos, and after each step its metrics,
    its gradients (averaged over the ranks), its networks and codebook."""
    import torch.distributed as dist

    from ctpa_torch.cli import train_vqgan
    from ctpa_torch.core.mesh import initialize_distributed

    initialize_distributed("file://" + job["store"], job["world"], rank, device="cpu")
    seen, steps = [], []
    make = train_vqgan.make_vqgan_train_step

    def recording_make(*args, **kwargs):
        fn = make(*args, **kwargs)

        def step(state, video):
            seen.append(video.numpy().copy())
            state, m = fn(state, video)
            nets = (("gen", state.gen), ("disc", state.disc))
            steps.append({
                "metrics": {k: float(v) for k, v in m.items()},
                "grads": {key: {k: None if p.grad is None else p.grad.numpy().copy()
                                for k, p in net.named_parameters()} for key, net in nets},
                **{key: {k: v.numpy().copy() for k, v in net.state_dict().items()}
                   for key, net in nets},
                "vq": [t.numpy().copy() for t in state.vq_state]})
            return state, m

        return step

    def init_state(model, disc, perc, seed=0):
        from ctpa_torch.ops.vq import VQState

        for net, key in ((model, "gen"), (disc, "disc"), (perc, "perc")):
            net.load_state_dict({k: _t(v) for k, v in job[key].items()})
        return VQState(*map(_t, job["vq"]))

    train_vqgan.make_vqgan_train_step, train_vqgan.init_state = recording_make, init_state
    rc = train_vqgan.main(job["argv"], device="cpu")
    dist.barrier()
    return {"rc": rc, "videos": seen, "steps": steps}


def case_tp(job, rank):
    """Tensor parallelism on a (dp, tp) mesh: the mesh's lines; the TP LLM's
    forward and cached decode logits; the TP batcher's greedy tokens (both
    tiers, the float and the int8 cache)."""
    import dataclasses

    import torch.distributed as dist

    from ctpa_torch.core import config as tc
    from ctpa_torch.models.llm import LlamaForCausalLM
    from ctpa_torch.models.report_generator import CTReportGenerator
    from ctpa_torch.parallel.sharding import rank_kv_cache, shard_llm_
    from ctpa_torch.pipelines.streaming import ContinuousBatcher, Request

    mesh = _mesh(job, dp=job["dp"], mp=job["tp"])
    out = {"coords": (mesh.index("data"), mesh.index("model"))}
    for axis in ("data", "model"):
        ranks = torch.zeros(dist.get_world_size())
        ranks[dist.get_rank()] = 1
        dist.all_reduce(ranks, group=mesh.group(axis))
        out[f"{axis}_line"] = ranks.nonzero().flatten().tolist()
    llm_cfg = tc.LLMConfig(**job["llm"])
    model = LlamaForCausalLM(llm_cfg, lora=tc.LoRAConfig(**job["lora"]), device="cpu")
    model.load_state_dict({k: _t(v) for k, v in job["llm_state"].items()})
    out["split"] = shard_llm_(model, mesh)
    out["shapes"] = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    ids, mask = _t(job["ids"]).long(), _t(job["mask"]).long()
    with torch.no_grad():
        out["logits"] = model(ids, mask)[0].numpy()
        cache = rank_kv_cache(model, ids.shape[0], 32, torch.float32, "cpu")
        out["cache_heads"] = cache.k.shape[2]
        logits, _, cache = model(ids, mask, cache)
        tok = logits[:, -1].float().argmax(-1)
        out["decode"] = model(tok[:, None], None, cache)[0][:, 0].numpy()

    gen = tc.ReportGenConfig(vision_dim=job["vision_dim"])
    results = {}
    for kv in (None, "int8"):
        rg = CTReportGenerator(dataclasses.replace(llm_cfg, kv_quant=kv), tc.CTViTConfig.tiny(),
                               gen, device="cpu")
        rg.load_state_dict({k: _t(v) for k, v in job["rg_state"].items()})
        for tier, kw in (("plain", dict(steps_per_sync=2)),
                         ("spec", dict(spec_lookup=2, steps_per_sync=3))):
            batcher = ContinuousBatcher(rg, num_lanes=2, max_len=32, eos_token_id=-1,
                                        greedy=True, mesh=mesh, **kw)
            for rid, (row, vision) in enumerate(zip(job["prompts"], job["visions"])):
                batcher.submit(Request(request_id=rid, input_ids=row,
                                       attention_mask=np.ones(len(row), np.int32),
                                       vision=_t(vision), max_new_tokens=job["new"]))
            res = batcher.run_until_done()
            results[(kv, tier)] = {rid: list(r.tokens) for rid, r in res.items()}
            results[(kv, tier, "cache_heads")] = batcher.cache.k.shape[2]
    out["tokens"] = results
    return out


CASES = {name.removeprefix("case_"): fn for name, fn in list(globals().items())
         if name.startswith("case_")}


def main(tmp: str, rank: int) -> None:
    torch.set_num_threads(1)
    job = torch.load(Path(tmp) / "job.pt", weights_only=False)
    if job["case"] not in ("clip_cli", "vqgan_cli"):
        from ctpa_torch.core.mesh import initialize_distributed

        initialize_distributed("file://" + job["store"], job["world"], rank, device="cpu")
    result = CASES[job["case"]](job, rank)
    torch.save(result, Path(tmp) / f"out{rank}.pt")
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    if "jax" in sys.modules:
        raise RuntimeError("a worker must not import JAX")
    main(sys.argv[1], int(sys.argv[2]))
    if "jax" in sys.modules or "ctpa" in sys.modules:
        raise RuntimeError("the worker imported JAX or ctpa")
