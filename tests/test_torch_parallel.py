"""Data parallelism of the port (``core/mesh.py``, ``comms/collectives.py``,
the ``mesh`` of the CLIP, report and VQGAN steps, ``train_clip
--coordinator``) against ctpa's global-batch semantics, on the CPU.

ctpa's pjit step sees the global batch.  The parent process computes
ctpa's single-device step on the global batch; the port's step runs in 2
torch-only gloo workers (``tests/test_torch_parallel_worker.py``), each on
its rows.  The two CLIs run in 2 workers each and are held against ctpa's
step, built as ctpa's CLI builds it, on the global batches the ranks read;
a transformation ahead of ctpa's optimizer keeps its step's gradients.

Bounds, fp32: losses and gradient norms of both steps within 1e-5 rel;
every parameter after the first step within 1e-6 abs where Adam's update
is not decided by a noise-sized gradient (see ``tests/test_torch_train.py``),
elsewhere within the largest move Adam makes in a step (such an element
moves by up to lr whichever way its noise points, which changes every
gradient of the second step a little: parameters are held after the first
step, the second step by its metrics); the VQ state after both steps within
1e-5 abs, and the ranks' codebooks and parameters equal bit for bit; the
CLIs: each step's metrics within 1e-5 rel, the first step's gradients
within 1e-6 abs + 1e-4 rel and the codebook within 1e-5 abs of ctpa's,
the ranks' parameters equal bit for bit.  Each planted fault (local negatives only, the VQ EMA left
unreduced, a mean of per-rank token means) must miss by more than 100
times its bound.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ctpa.core import config as jc
from ctpa.core.precision import Policy as JPolicy
from ctpa.models import discriminator as jdisc
from ctpa.models import report_generator as jrg
from ctpa.models.ctclip import CTCLIP as JCLIP
from ctpa.models.ctclip import contrastive_loss_sharded as j_sharded_loss
from ctpa.models.ctvit import CTViT as JViT
from ctpa.ops.vq import VQState as JVQState
from ctpa.train import optim as joptim
from ctpa.train import report_trainer as jrt
from ctpa.train.clip_trainer import make_clip_train_step as j_make_step
from ctpa.train.train_state import CLIPTrainState as JState
from ctpa.train.train_state import SimpleTrainState as JSimpleState
from ctpa.train.vqgan_trainer import VQGANState as JVQGANState
from ctpa.train.vqgan_trainer import make_vqgan_train_step as j_make_vqgan_step
from ctpa_torch.comms import collectives as col
from ctpa_torch.convert import flax_to_state_dict
from ctpa_torch.core import config as tc
from ctpa_torch.core.checkpoint import CheckpointManager
from ctpa_torch.core.mesh import (BatchSharding, Mesh, global_batch_from_local, local_batch_size,
                                  shard_batch, single_device_mesh)
from ctpa_torch.core.precision import policy
from ctpa_torch.data.manifests import write_csv
from ctpa_torch.data.prefetch import PrefetchIterator
from ctpa_torch.models.ctclip import CTCLIP
from ctpa_torch.ops.vq import VQState
from ctpa_torch.train import optim as toptim
from ctpa_torch.train.clip_trainer import make_clip_train_step
from ctpa_torch.train.train_state import CLIPTrainState
from ctpa_torch.train.vqgan_trainer import VQGANState, adam, make_vqgan_train_step
from test_torch_parallel_worker import spawn
from test_torch_vqgan import DISC_KW, JVIT, STAGES, _fill, _port_nets

torch.set_num_threads(1)
RTOL = 1e-5
VQ_ATOL = 1e-5
PARAM_ATOL = 1e-6
ADAM_SENSITIVE_BELOW = 1e-5
FAULT = 100
LR = 1e-3
KEY = jax.random.key(0)
VIT, BERT = tc.CTViTConfig.tiny(), tc.BertConfig.tiny()


def jcfg(cfg, **over):
    jtype = {tc.CTViTConfig: jc.CTViTConfig, tc.BertConfig: jc.BertConfig,
             tc.LLMConfig: jc.LLMConfig}[type(cfg)]
    return jtype(**{**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}, **over})


def np_params(tree, seed, kernel_scale=None):
    """Gains near 1, Dense kernels at 1/sqrt(fan_in) (or ``kernel_scale``),
    everything else at 0.1 (0.2 with a kernel scale)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = str(path[-1].key), np.shape(leaf)
        if name in ("gamma", "scale", "q_scale", "k_scale", "norm_in_scale", "temperature",
                    "weight"):
            val = 1 + 0.1 * rng.normal(size=shape)
        elif kernel_scale is not None:
            val = kernel_scale * rng.normal(size=shape)
        elif name.endswith("kernel") and len(shape) == 2:
            val = rng.normal(size=shape) / np.sqrt(shape[0])
        else:
            val = 0.1 * rng.normal(size=shape)
        return jnp.asarray(val, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _close_params(got: dict, ref: dict, grad: dict, lr: float, keys=None):
    """Every parameter after one step within PARAM_ATOL where its gradient
    (``grad``: the port's reduced one, unclipped) was not noise-sized, else
    within Adam's largest move of one step, lr; the nonzero noise-sized
    elements under 1% of all.  An attention key bias's gradient is 0 in
    exact arithmetic, and the ranks' partial sums leave rounding noise
    there; an unused embedding row's is 0 exactly on both sides."""
    noisy_total = total = 0
    for key in keys or ref:
        noisy = np.abs(grad.get(key, np.zeros(ref[key].shape))) < ADAM_SENSITIVE_BELOW
        diff = np.abs(got[key] - ref[key])
        assert diff[~noisy].max(initial=0) <= PARAM_ATOL, key
        assert diff[noisy].max(initial=0) <= lr, key
        noisy_total += (noisy & (grad[key] != 0)).sum()
        total += noisy.size
    assert noisy_total <= 0.01 * total, (noisy_total, total)


# --------------------------------------------------- mesh and collectives

def _fake_mesh(index, size=2, backend=None, group=None):
    return Mesh(("data", "model"), (size, 1), (index, 0), (group, None), backend,
                torch.device("cpu"))


def test_batch_rows_and_local_sizes():
    """Rank i of p holds rows [i b/p, (i + 1) b/p) of a global batch; a batch
    that p does not divide raises; process-local rows stay as they are."""
    batch = {"x": np.arange(12).reshape(6, 2), "t": torch.arange(6), "name": "b"}
    for i in range(3):
        mesh = _fake_mesh(i, 3)
        rows = shard_batch(mesh, batch)
        np.testing.assert_array_equal(rows["x"], batch["x"][2 * i:2 * i + 2])
        assert torch.equal(rows["t"], torch.arange(2 * i, 2 * i + 2)) and rows["name"] == "b"
        assert local_batch_size(6, mesh) == 2
        assert global_batch_from_local(mesh, rows)["x"] is rows["x"]
    with pytest.raises(ValueError, match="not divisible"):
        local_batch_size(7, _fake_mesh(0, 3))
    got = list(PrefetchIterator(iter([batch]), device="cpu",
                                sharding=BatchSharding(_fake_mesh(1, 3))))
    assert torch.equal(got[0]["x"], torch.as_tensor(batch["x"][2:4]))
    got = list(PrefetchIterator(iter([batch]), device="cpu", process_local=True,
                                sharding=BatchSharding(_fake_mesh(1, 3))))
    assert torch.equal(got[0]["t"], batch["t"])


def test_collectives_over_no_group_are_the_identity_and_backends_are_checked():
    """A single_device_mesh runs no collective; an NCCL mesh refuses a CPU
    tensor (no fallback to gloo), a gloo mesh a tensor off the CPU."""
    mesh = single_device_mesh("cpu")
    x = torch.randn(4, 3, requires_grad=True)
    for fn in (col.all_gather_batch, lambda t, m: col.all_gather(t, m, "data", 1),
               lambda t, m: col.shard(t, m, "data", 0),
               lambda t, m: col.gather_replicated(t, m, "data", 0),
               lambda t, m: col.all_reduce(t, m, "model")):
        assert torch.equal(fn(x, mesh), x)
    assert torch.equal(col.psum(x, mesh), x) and torch.equal(col.pmean(x, mesh), x)
    assert col.axis_present(mesh, "data") and not col.axis_present(None, "data")
    assert col.axis_index(mesh) == 0 and mesh.size("model") == 1
    with pytest.raises(ValueError, match="NCCL mesh takes CUDA"):
        col.psum(x, _fake_mesh(0, 2, "nccl", object()))
    with pytest.raises(ValueError, match="gloo mesh takes CPU"):
        _fake_mesh(0, 2, "gloo", object()).check(torch.empty(1, device="meta"))


# ------------------------------------------------------------- CLIP step

def _clip_batch(seed, b=4, seq=12):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, seq), np.int32)
    mask[1, 7:] = 0
    mask[3, 4:] = 0
    return {"input_ids": rng.integers(3, BERT.vocab_size, size=(b, seq)).astype(np.int32),
            "attention_mask": mask,
            "video": rng.uniform(-1, 1, size=(b, 1, VIT.temporal_size, VIT.image_size,
                                              VIT.image_size)).astype(np.float32)}


def _clip_setup():
    """ctpa's tiny CTCLIP, two global batches of 4, its numpy weights and a
    codebook."""
    jm = JCLIP(jc.CTCLIPConfig.tiny(jcfg(VIT), jcfg(BERT)), jcfg(VIT), jcfg(BERT))
    batches = [_clip_batch(40), _clip_batch(41)]
    b0 = batches[0]
    params = np_params(jax.eval_shape(lambda: jm.init(
        KEY, b0["input_ids"], b0["attention_mask"], b0["video"]))["params"], 42)
    rng = np.random.default_rng(43)
    cb = rng.normal(size=(VIT.codebook_size, VIT.dim)).astype(np.float32)
    cb /= np.linalg.norm(cb, axis=-1, keepdims=True)
    vq = (cb, np.abs(rng.normal(size=VIT.codebook_size)).astype(np.float32), cb.copy())
    return jm, batches, params, vq


def _ssl_setup():
    """The port's tiny CTCLIP with MLM, randomly initialised, a codebook and
    a global batch of 4."""
    from ctpa_torch.core.init import random_init_

    cfg = dataclasses.replace(tc.CTCLIPConfig.tiny(VIT, BERT), use_mlm=True)
    model = CTCLIP(cfg, VIT, BERT, device="cpu")
    random_init_(model, torch.Generator().manual_seed(5))
    rng = np.random.default_rng(45)
    cb = rng.normal(size=(VIT.codebook_size, VIT.dim)).astype(np.float32)
    return model, (cb, np.ones(VIT.codebook_size, np.float32), cb.copy()), _clip_batch(46)


def _loss_setup():
    """Unit text and image latents of a global batch of 6, a temperature."""
    rng = np.random.default_rng(44)
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)
    return (unit(rng.normal(size=(6, 8))).astype(np.float32),
            unit(rng.normal(size=(6, 8))).astype(np.float32), np.float32(2.5))


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The data-parallel steps on 2 ranks, in one spawn: the CLIP step and
    its planted faults, the SSL step, contrastive_loss_sharded and the
    report step and its planted fault; each part's results in rank order."""
    _, batches, params, vq = _clip_setup()
    ssl_model, ssl_vq, ssl_batch = _ssl_setup()
    text, image, temp = _loss_setup()
    _, rbatches, rparams = _report_setup()
    job = {"dp_clip": {"state": flax_to_state_dict(jax.tree.map(np.asarray, params)), "vq": vq,
                       "batches": batches, "lr": LR},
           "dp_ssl": {"state": {k: v.numpy() for k, v in ssl_model.state_dict().items()},
                      "vq": ssl_vq, "batch": ssl_batch, "lr": LR, "seed": 7},
           "sharded_loss": {"text": text, "image": image, "temp": float(temp)},
           "dp_report": {"state": flax_to_state_dict(jax.tree.map(np.asarray, rparams)),
                         "llm": dataclasses.asdict(RLLM), "lora": dataclasses.asdict(RLORA),
                         "vision_dim": RVDIM, "lr": LR, "batches": rbatches}}
    outs = spawn("dp", 2, job, tmp_path_factory.mktemp("dp"))
    return {part: [o[part] for o in outs] for part in job}


@pytest.fixture(scope="module")
def clip_run(dp_run):
    """ctpa's jitted step on two global batches of 4 (fp32, AdamW lr 1e-3,
    clip 0.5, the VQ EMA) and its gradients; the port's step on 2 ranks,
    and its planted faults."""
    jm, batches, params, vq = _clip_setup()
    pol = JPolicy(compute_dtype=jnp.float32)
    tx = joptim.get_optimizer(jc.OptimizerConfig(lr=LR))
    state = JState.create({"params": params}, tx, JVQState(*map(jnp.asarray, vq)))
    step = jax.jit(j_make_step(jm, tx, policy=pol))
    metrics, vqs, after = [], [], []
    for batch in batches:
        state, m = step(state, jax.tree.map(jnp.asarray, batch))
        metrics.append({k: float(v) for k, v in m.items()})
        vqs.append([np.asarray(t) for t in state.vq_state])
        after.append(flax_to_state_dict(jax.tree.map(np.asarray, state.params["params"])))
    ref = {"metrics": metrics, "vq": vqs[-1], "vq1": vqs[0], "params": after}
    return ref, dp_run["dp_clip"]


def test_dp_clip_step_matches_ctpa_global_batch(clip_run):
    """Two steps on 2 ranks of 2 rows each against ctpa's step on the 4-row
    global batch: the metrics (global InfoNCE, gradient norm after the
    reduction, commitment), every parameter after the first step, and the
    codebook, equal on both ranks."""
    ref, outs = clip_run
    for r, out in enumerate(outs):
        run = out["honest"]
        for i, m in enumerate(run["metrics"]):
            for key in ("loss", "grad_norm", "temperature", "vq_commit"):
                np.testing.assert_allclose(m[key], ref["metrics"][i][key], rtol=RTOL,
                                           err_msg=f"rank {r} step {i + 1} {key}")
        unclip = max(run["metrics"][0]["grad_norm"] / jc.OptimizerConfig().grad_clip_norm, 1.0)
        _close_params(run["params"][0], ref["params"][0],
                      {k: g * unclip for k, g in run["grads"].items()}, LR)
        for got, want in zip(run["vq"], ref["vq"]):
            np.testing.assert_allclose(got, want, atol=VQ_ATOL)
    for a, b in zip(outs[0]["honest"]["vq"], outs[1]["honest"]["vq"]):
        np.testing.assert_array_equal(a, b)
    for k, v in outs[0]["honest"]["params"][-1].items():
        np.testing.assert_array_equal(v, outs[1]["honest"]["params"][-1][k], err_msg=k)


def test_dp_clip_planted_faults_are_rejected(clip_run):
    """Local negatives only (each rank's InfoNCE over its own rows, the
    reference repo's bug) misses ctpa's loss; an unreduced VQ EMA leaves the
    ranks with different codebooks, each off ctpa's."""
    ref, outs = clip_run
    for r, out in enumerate(outs):
        loss = out["local_negatives"]["metrics"][0]["loss"]
        want = ref["metrics"][0]["loss"]
        assert abs(loss - want) > FAULT * RTOL * abs(want), (r, loss, want)
    ema = [out["unreduced_ema"]["vq"] for out in outs]
    # one step: the EMA sums part between the ranks and from ctpa's
    assert np.abs(ema[0][2] - ema[1][2]).max() > FAULT * VQ_ATOL
    for got in ema:
        assert np.abs(got[2] - ref["vq1"][2]).max() > FAULT * VQ_ATOL


def test_dp_ssl_step_matches_the_global_step(dp_run):
    """A CLIP step with the MLM and SimCLR objectives on 2 ranks of 2 rows
    against the port's single-process step on the 4-row batch (itself held
    against ctpa's with ctpa's draws in tests/test_torch_clip_variants.py):
    the draws are the global batch's, the MLM loss the global mean over the
    selected tokens, SimCLR's NT-Xent over the gathered views; the metrics
    within 1e-5 rel, every reduced gradient within 1e-6 abs + 1e-4 rel (the
    step's clip applied on both sides)."""
    model, vq, batch = _ssl_setup()
    tx = toptim.get_optimizer(tc.OptimizerConfig(lr=LR), model)
    state = CLIPTrainState.create(model, tx, VQState(*map(torch.from_numpy, vq)))
    step = make_clip_train_step(model, tx, policy=policy("fp32"), use_mlm=True,
                                use_visual_ssl=True, seed=7)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["input_ids"] = tb["input_ids"].long()
    _, m = step(state, tb)
    for r, out in enumerate(dp_run["dp_ssl"]):
        for key in ("loss", "mlm_loss", "visual_ssl_loss", "grad_norm", "vq_commit"):
            np.testing.assert_allclose(out["metrics"][key], float(m[key]), rtol=RTOL,
                                       err_msg=f"rank {r} {key}")
        for name, p in model.named_parameters():
            np.testing.assert_allclose(out["grads"][name], p.grad.numpy(), atol=1e-6, rtol=1e-4,
                                       err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("decoupled", [False, True])
def test_contrastive_loss_sharded_matches_ctpa(decoupled, dp_run):
    """contrastive_loss_sharded on 2 ranks of 3 latent rows against ctpa's
    under shard_map on 2 devices: the loss on every rank, and each rank's
    latent gradients, which are p times its rows of the global loss's
    gradient (the sum over ranks of the identical per-rank losses)."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh as JMesh
    from jax.sharding import PartitionSpec as P

    text, image, temp = _loss_setup()
    jmesh = JMesh(np.asarray(jax.devices()[:2]).reshape(2), ("data",))
    fn = shard_map(lambda t, i: j_sharded_loss(t, i, temp, "data", decoupled)[None],
                   mesh=jmesh, in_specs=(P("data"), P("data")), out_specs=P("data"),
                   check_rep=False)
    want = np.asarray(jax.jit(fn)(text, image))
    dt, di = jax.jit(jax.grad(lambda t, i: fn(t, i).sum(), argnums=(0, 1)))(text, image)
    for r, out in enumerate(o[decoupled] for o in dp_run["sharded_loss"]):
        np.testing.assert_allclose(out["loss"], want[r], rtol=RTOL)
        np.testing.assert_allclose(out["dt"], np.asarray(dt)[3 * r:3 * r + 3], atol=1e-6)
        np.testing.assert_allclose(out["di"], np.asarray(di)[3 * r:3 * r + 3], atol=1e-6)


# ----------------------------------------------------------- report step

RLLM = tc.LLMConfig.tiny()
RLORA = tc.LoRAConfig(rank=4, alpha=8.0)
RVDIM = 24
RLENS = (40, 36, 9, 5)          # rank 0 holds 74 label tokens, rank 1 12


def _report_batch(seed):
    rng = np.random.default_rng(seed)
    n = max(RLENS)
    mask = (np.arange(n)[None] < np.array(RLENS)[:, None]).astype(np.int32)
    return {"video": rng.uniform(-1, 1, size=(4, 1, VIT.temporal_size, VIT.image_size,
                                             VIT.image_size)).astype(np.float32),
            "input_ids": (rng.integers(1, RLLM.vocab_size, size=(4, n)) * mask).astype(np.int32),
            "attention_mask": mask}


def _report_setup():
    """ctpa's report generator (LoRA + cross-attention), two global batches
    of 4 rows whose halves hold 74 and 12 label tokens, numpy weights."""
    jlora = jc.LoRAConfig(rank=RLORA.rank, alpha=RLORA.alpha)
    jgen = jc.ReportGenConfig(vision_dim=RVDIM, lora=jlora, llm_lr=LR, cross_attn_lr=LR)
    jm = jrg.CTReportGenerator(jcfg(RLLM), jcfg(VIT), jgen, lora=jlora)
    batches = [_report_batch(50), _report_batch(51)]
    b0 = batches[0]
    params = np_params(jax.eval_shape(lambda: jm.init(KEY, *(jnp.asarray(b0[k]) for k in (
        "video", "input_ids", "attention_mask"))))["params"], 52, kernel_scale=0.2)
    return jm, batches, params


@pytest.fixture(scope="module")
def report_run(dp_run):
    """ctpa's partitioned report step (two OneCycle groups, clip 1.0) twice
    on the global batches; the port's on 2 ranks."""
    jm, batches, params = _report_setup()
    full = {"params": params}
    step_fn, opt0 = jrt.make_partitioned_report_step(jm, full, jm.gen_cfg, total_steps=10)
    step_fn = jax.jit(step_fn)
    state = JSimpleState(params=full, opt_state=opt0, step=jnp.zeros((), jnp.int32))
    metrics, after = [], []
    for batch in batches:
        state, m = step_fn(state, jax.tree.map(jnp.asarray, batch))
        metrics.append({k: float(v) for k, v in m.items()})
        after.append(flax_to_state_dict(jax.tree.map(np.asarray, state.params["params"])))
    return {"metrics": metrics, "params": after}, dp_run["dp_report"]


def test_dp_report_step_matches_ctpa_global_token_mean(report_run):
    """Two partitioned steps on 2 ranks holding 74 and 12 label tokens
    against ctpa's on the global batch: the loss is the global token mean,
    the gradient norm after the reduction, and every trainable parameter
    after the first step, equal on both ranks."""
    ref, outs = report_run
    for r, out in enumerate(outs):
        run = out["honest"]
        for i, m in enumerate(run["metrics"]):
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(m[key], ref["metrics"][i][key], rtol=RTOL,
                                           err_msg=f"rank {r} step {i + 1} {key}")
        unclip = max(run["metrics"][0]["grad_norm"], 1.0)          # clip 1.0
        _close_params(run["params"][0], ref["params"][0],
                      {k: g * unclip for k, g in run["grads"].items()}, LR,
                      keys=run["params"][0])
    for k, v in outs[0]["honest"]["params"][-1].items():
        np.testing.assert_array_equal(v, outs[1]["honest"]["params"][-1][k], err_msg=k)


def test_dp_report_mean_of_per_rank_means_is_rejected(report_run):
    """Each rank's own token mean averaged over the ranks weighs rank 1's 12
    tokens as much as rank 0's 74: its loss misses ctpa's."""
    ref, outs = report_run
    want = ref["metrics"][0]["loss"]
    for out in outs:
        loss = out["mean_of_means"]["metrics"][0]["loss"]
        assert abs(loss - want) > FAULT * RTOL * abs(want), (loss, want)


# ---------------------------------------------------------------- the CLIs

RAW = (20, 40, 40)


def _clip_files(root):
    rng = np.random.default_rng(60)
    os.makedirs(root / "train")
    reports, meta = [], []
    words = "lung nodule effusion clear opacity right left lobe embolism".split()
    for i in range(4):
        name = f"train_{i}"
        np.savez(root / "train" / f"{name}.npz",
                 rng.integers(-1000, 2000, size=RAW).astype(np.int16))
        reports.append({"impression_id": name, "impressions": " ".join(rng.choice(words, 6))})
        meta.append({"VolumeName": f"{name}.nii.gz", "RescaleSlope": 1.0,
                     "RescaleIntercept": -1024.0, "ZSpacing": 2.0, "XYSpacing": 0.75})
    write_csv(str(root / "reports.csv"), reports)
    write_csv(str(root / "meta.csv"), meta)


def _keeping_grads(tx):
    """``tx`` behind a transformation that keeps the gradients it is given
    in its state (``opt_state[0]``): ctpa's step's gradients, as they reach
    its optimizer; the updates are ``tx``'s."""
    keep = optax.GradientTransformation(lambda params: jax.tree.map(jnp.zeros_like, params),
                                        lambda updates, state, params=None: (updates, updates))
    return optax.chain(keep, tx)


def _close_grads(got: dict, want: dict, scale: float = 1.0, what: str = ""):
    """Each gradient (a missing one, or None, is zero) within 1e-6 abs +
    1e-4 rel of ``want``'s (torch names), after multiplying by ``scale``."""
    assert set(got) <= set(want), set(got) - set(want)
    for k, ref in want.items():
        g = got.get(k)
        g = np.zeros_like(ref) if g is None else g * scale
        np.testing.assert_allclose(g, ref, atol=1e-6, rtol=1e-4, err_msg=f"{what} {k}")


def test_train_clip_coordinator_matches_the_global_step(tmp_path):
    """train_clip.main --tiny --coordinator on 2 ranks (each a ProcessShard
    of the 4 volumes, --batch-size 4 global), 2 steps, against ctpa's step
    as ctpa's CLI builds it (the bf16 policy on an fp32 model, cosine
    schedule with restarts, lr 0.5, clip 0.5) on the global batches the
    ranks read (rank 0's rows, then rank 1's): each step's metrics within
    1e-5 rel, the first step's reduced gradients (unclipped) within 1e-6 abs
    + 1e-4 rel, the codebook after both steps within 1e-5 abs; both ranks
    end with the same parameters and codebook; one checkpoint, written by
    rank 0."""
    _clip_files(tmp_path)
    jvit, jbert = jcfg(VIT), jcfg(BERT)
    jm = JCLIP(jc.CTCLIPConfig.tiny(jvit, jbert), jvit, jbert)
    b0 = _clip_batch(40)
    params = np_params(jax.eval_shape(lambda: jm.init(
        KEY, b0["input_ids"], b0["attention_mask"], b0["video"]))["params"], 47)
    rng = np.random.default_rng(48)
    cb = rng.normal(size=(VIT.codebook_size, VIT.dim)).astype(np.float32)
    cb /= np.linalg.norm(cb, axis=-1, keepdims=True)
    vq = (cb, np.abs(rng.normal(size=VIT.codebook_size)).astype(np.float32), cb.copy())
    argv = ["--data-dir", str(tmp_path / "train"), "--reports-csv", str(tmp_path / "reports.csv"),
            "--metadata-csv", str(tmp_path / "meta.csv"), "--batch-size", "4", "--num-steps", "2",
            "--lr", "0.5", "--tiny", "--results-dir", str(tmp_path / "results"),
            "--checkpoint-dir", str(tmp_path / "ckpt")]
    outs = spawn("clip_cli", 2, {"argv": argv, "vq": vq, "state": flax_to_state_dict(
        jax.tree.map(np.asarray, params))}, tmp_path)
    assert [o["rc"] for o in outs] == [0, 0] and [o["step"] for o in outs] == [2, 2]
    assert all(len(o["batches"]) == 2 and o["batches"][0]["video"].shape[0] == 2 for o in outs)
    for k, v in outs[0]["params"].items():
        np.testing.assert_array_equal(v, outs[1]["params"][k], err_msg=k)
    for a, b in zip(outs[0]["vq"], outs[1]["vq"]):
        np.testing.assert_array_equal(a, b)
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps() == [2]
    # ctpa's step on the global batches, from the same start
    opt_cfg = jc.OptimizerConfig(lr=0.5, schedule="cosine_warmup_restarts", total_steps=2)
    tx = _keeping_grads(joptim.get_optimizer(opt_cfg, {"params": params}))
    state = JState.create({"params": params}, tx, JVQState(*map(jnp.asarray, vq)))
    step = jax.jit(j_make_step(jm, tx, policy=JPolicy()))
    for i in range(2):
        batch = {k: np.concatenate([o["batches"][i][k] for o in outs])
                 for k in outs[0]["batches"][i]}
        batch["input_ids"] = batch["input_ids"].astype(np.int32)
        batch["attention_mask"] = batch["attention_mask"].astype(np.int32)
        state, m = step(state, jax.tree.map(jnp.asarray, batch))
        for r, out in enumerate(outs):
            for key in ("loss", "grad_norm", "temperature", "vq_commit"):
                np.testing.assert_allclose(out["metrics"][i][key], float(m[key]), rtol=RTOL,
                                           err_msg=f"rank {r} step {i + 1} {key}")
        if i == 0:
            want = flax_to_state_dict(jax.tree.map(np.asarray, state.opt_state[0]["params"]))
            unclip = max(float(m["grad_norm"]) / opt_cfg.grad_clip_norm, 1.0)
            for r, out in enumerate(outs):
                _close_grads(out["grads"], want, unclip, f"rank {r}")
    for got, want in zip(outs[0]["vq"], state.vq_state):
        np.testing.assert_allclose(got, np.asarray(want), atol=VQ_ATOL)


def test_train_vqgan_cli_at_dp2_matches_the_global_step(tmp_path):
    """train_vqgan.main --tiny at batch 2 in a 2-rank world (dp = gcd(2, 2)
    = 2, a row each), 2 steps.  Against ctpa's jitted step as ctpa's CLI
    builds it (hinge losses, Adam lr 1e-3 with b1 0.5 and b2 0.9, R1 at the
    first step) on the global batch the ranks read: the first step's
    metrics within 1e-5 rel + 1e-6 abs and the codebook after it within
    1e-5 abs.  Against the port's single-process steps on the same global
    batches: each step's metrics within 1e-5 rel and the codebook within
    1e-5 abs, and the first step's gradients, averaged over the ranks,
    within 1e-6 abs + 1e-4 rel.  ctpa's gradients are not the reference:
    on these weights XLA's compiled step moves its generator's and
    discriminator's gradients by 1e-3 to 3e-3 of their largest element from
    the same step run eagerly (which the port matches within 4e-6, and
    which takes about 45 s on the CPU), and Adam's first moves, about lr times
    each gradient's sign, carry that into ctpa's second step.  The second
    step's gradients are not held either: where a gradient is fp32 noise,
    its sign, and so Adam's first move there, depends on the order of the
    ranks' sums.  Both ranks end with the same networks and codebook; one
    checkpoint, written by rank 0."""
    cfg = dataclasses.replace(VIT, use_decoder=True)
    rng = np.random.default_rng(61)
    (tmp_path / "vols").mkdir()
    for i in range(2):
        np.savez(tmp_path / "vols" / f"v{i}.npz", rng.uniform(
            -1, 1, size=(cfg.temporal_size, cfg.image_size, cfg.image_size)).astype(np.float32))
    jm = JViT(JVIT)
    jd, jp = jdisc.Discriminator(**DISC_KW), jdisc.PerceptualNet(stages=STAGES)
    cb = rng.normal(size=(cfg.codebook_size, cfg.dim)).astype(np.float32)
    cb /= np.linalg.norm(cb, axis=-1, keepdims=True)
    vq = (cb, np.abs(rng.normal(size=cfg.codebook_size)).astype(np.float32), cb.copy())
    video = np.zeros((1, 1, cfg.temporal_size, cfg.image_size, cfg.image_size), np.float32)
    mid = np.zeros((1, cfg.image_size, cfg.image_size, 1), np.float32)
    nets = {"gen": _fill(jax.eval_shape(lambda: jm.init(
                KEY, video, JVQState(*map(jnp.asarray, vq)), method=JViT.reconstruct))["params"],
                6),
            "disc": _fill(jax.eval_shape(lambda: jd.init(KEY, mid))["params"], 7),
            "perc": _fill(jax.eval_shape(lambda: jp.init(KEY, np.repeat(mid, 3, -1)))["params"],
                          8)}
    argv = ["--data-dir", str(tmp_path / "vols"), "--tiny", "--batch-size", "2", "--lr", "1e-3",
            "--disc-lr", "1e-3", "--num-steps", "2", "--log-every", "1", "--checkpoint-dir",
            str(tmp_path / "ckpt")]
    job = {"argv": argv, "vq": vq, **{n: {k: v.numpy() for k, v in net.state_dict().items()}
                                      for n, net in zip(("gen", "disc", "perc"),
                                                        _port_nets(nets))}}
    outs = spawn("vqgan_cli", 2, job, tmp_path)
    assert [o["rc"] for o in outs] == [0, 0]
    assert all(len(o["videos"]) == 2 and o["videos"][0].shape[0] == 1 for o in outs)
    steps = outs[0]["steps"]
    for key in ("gen", "disc"):
        for k, v in steps[-1][key].items():
            np.testing.assert_array_equal(v, outs[1]["steps"][-1][key][k], err_msg=f"{key} {k}")
    for a, b in zip(steps[-1]["vq"], outs[1]["steps"][-1]["vq"]):
        np.testing.assert_array_equal(a, b)
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps() == [2]
    videos = [np.concatenate([o["videos"][i] for o in outs]) for i in range(2)]
    # ctpa's first step on the global batch, from the same start
    tx = optax.adam(1e-3, b1=0.5, b2=0.9)
    gen, disc = {"params": nets["gen"]}, {"params": nets["disc"]}
    jstate = JVQGANState(gen_params=gen, disc_params=disc, perc_params={"params": nets["perc"]},
                         gen_opt=tx.init(gen), disc_opt=tx.init(disc),
                         vq_state=JVQState(*map(jnp.asarray, vq)), step=jnp.zeros((), jnp.int32))
    jstate, m = jax.jit(j_make_vqgan_step(jm, jd, jp, tx, tx, use_hinge=True))(
        jstate, jnp.asarray(videos[0]))
    for k in ("gen_loss", "disc_loss", "recon", "perceptual", "gen_gan", "commit", "r1"):
        np.testing.assert_allclose(steps[0]["metrics"][k], float(m[k]), rtol=RTOL, atol=1e-6,
                                   err_msg=f"ctpa step 1 {k}")
    assert float(m["r1"]) > 0
    for got, want in zip(steps[0]["vq"], jstate.vq_state):
        np.testing.assert_allclose(got, np.asarray(want), atol=VQ_ATOL)
    # the port's single-process steps on the same global batches
    model, tdisc, perc = _port_nets(nets)
    gen_tx, disc_tx = adam(model, 1e-3), adam(tdisc, 1e-3)
    state = VQGANState(gen=model, disc=tdisc, perc=perc, gen_opt=gen_tx, disc_opt=disc_tx,
                       vq_state=VQState(*map(torch.from_numpy, vq)))
    step = make_vqgan_train_step(model, tdisc, perc, gen_tx, disc_tx)
    for i, ranks in enumerate(steps):
        state, m = step(state, torch.from_numpy(videos[i]))
        for key, net in (("gen", model), ("disc", tdisc)) if i == 0 else ():
            want = {k: np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
                    for k, p in net.named_parameters()}
            _close_grads(ranks["grads"][key], want, what=f"{key} grad")
        for k in ("gen_loss", "disc_loss", "recon", "perceptual", "gen_gan", "commit", "r1"):
            np.testing.assert_allclose(ranks["metrics"][k], float(m[k]), rtol=RTOL, atol=1e-7,
                                       err_msg=f"step {i + 1} {k}")
        for got, want in zip(ranks["vq"], state.vq_state):
            np.testing.assert_allclose(got, want.numpy(), atol=VQ_ATOL)
