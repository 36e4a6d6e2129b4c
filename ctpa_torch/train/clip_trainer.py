"""Contrastive CLIP trainer (port of ``ctpa/train/clip_trainer.py``).

One step: forward of both towers in the policy's compute dtype,
bidirectional InfoNCE (plus the weighted VQ commitment loss when asked, and
the MLM and SimCLR objectives with their config weights), backward,
gradient clipping and AdamW (``train/optim.py``), then the VQ EMA codebook
update.  ctpa compiles this into one XLA program; the port runs it eagerly,
updates the parameters and moments in place, and reads nothing back to the
host: the metrics stay device tensors.

Data parallelism (``mesh``): each rank takes its rows of the global batch,
and the step equals ctpa's step on the global batch under pjit.  The
InfoNCE loss is taken over all-gathered latents (``CTCLIP.forward(mesh=)``),
whose backward sums each rank's latent gradient over the ranks, so every
rank's gradients are p times its rows' share of the global gradient; the
per-sample means (the commitment loss) give 1/p of the global mean's
share, and the MLM mean is scaled so (``mlm_loss(mesh=)``): averaging the
gradients over the ranks (``comms/collectives.py:average_gradients``) then
gives the global gradient on every rank, and the clip's global norm is
taken after that reduction.  The VQ assignment counts and sums are summed
over the ranks before ``ema_update``, so every rank keeps the same
codebook; the metrics are their means over the ranks.

The SSL objectives' random draws (the MLM masks, the two augmented views)
come from ``ssl_draws``, seeded by (seed, step) as ctpa folds the step into
its key; it is the one place they are drawn, so a test can put ctpa's own
draws in its stead.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Callable, Iterator, NamedTuple, Optional

import torch
from torch import nn

from ctpa_torch.comms.collectives import average_gradients, pmean, psum
from ctpa_torch.core.checkpoint import CheckpointManager
from ctpa_torch.core.config import OptimizerConfig, TrainConfig
from ctpa_torch.core.mesh import DATA_AXIS, is_primary
from ctpa_torch.core.precision import Policy, policy as precision_policy
from ctpa_torch.models.ctclip import CTCLIP
from ctpa_torch.models.layers import set_compute_dtype
from ctpa_torch.models.mlm import mlm_draws, mlm_loss
from ctpa_torch.models.visual_ssl import AugmentDraws, augment_draws, simclr_ssl_loss
from ctpa_torch.ops.vq import ema_update
from ctpa_torch.train.metrics import MetricsTracker
from ctpa_torch.train.optim import Optimizer, get_optimizer, global_norm
from ctpa_torch.train.train_state import CLIPTrainState


class SSLDraws(NamedTuple):
    """One step's draws: the MLM's (selection scores, replacement draws)
    and the two SimCLR views' ``AugmentDraws``; None where the objective is
    off."""

    mlm: Optional[tuple[torch.Tensor, torch.Tensor]]
    views: Optional[tuple[AugmentDraws, AugmentDraws]]


def _generator(device, seed: int, index: int) -> torch.Generator:
    if not 0 <= index < 2 ** 32:
        raise ValueError(f"draw index {index} out of range")
    return torch.Generator(device=device).manual_seed(seed * 2 ** 32 + index)


def ssl_draws(seed: int, step: int, input_ids: torch.Tensor, video: torch.Tensor,
              use_mlm: bool, use_visual_ssl: bool) -> SSLDraws:
    """The step's draws on the batch's device: the MLM's from a generator
    seeded by (seed, 2 step + 1), the views' from one seeded by (seed,
    2 step + 2), the indices ctpa folds into its key."""
    mlm = views = None
    if use_mlm:
        mlm = mlm_draws(input_ids, _generator(input_ids.device, seed, 2 * step + 1))
    if use_visual_ssl:
        gen = _generator(video.device, seed, 2 * step + 2)
        views = (augment_draws(video, gen), augment_draws(video, gen))
    return SSLDraws(mlm, views)


def rank_draws(seed: int, step: int, input_ids: torch.Tensor, video: torch.Tensor,
               use_mlm: bool, use_visual_ssl: bool, mesh, axis: str = DATA_AXIS) -> SSLDraws:
    """This rank's rows of ``ssl_draws`` made for the global batch (the same
    draws on every rank), from this rank's ``input_ids`` and ``video``."""
    p, i, b = mesh.size(axis), mesh.index(axis), input_ids.shape[0]

    def whole(x):
        return x[:1].expand((p * b,) + tuple(x.shape[1:]))

    def rows(x):
        return x[i * b:(i + 1) * b]

    draws = ssl_draws(seed, step, whole(input_ids), whole(video), use_mlm, use_visual_ssl)
    return SSLDraws(None if draws.mlm is None else tuple(rows(x) for x in draws.mlm),
                    None if draws.views is None else
                    tuple(v._replace(noise=rows(v.noise)) for v in draws.views))


def make_clip_train_step(model: CTCLIP, tx: Optimizer, vq_decay: float = 0.99,
                         commit_weight: float = 0.0, policy: Optional[Policy] = None,
                         use_mlm: bool = False, use_visual_ssl: bool = False,
                         mask_token_id: int = 103, seed: int = 0,
                         model_dtype: Optional[torch.dtype] = None, mesh=None,
                         axis: str = DATA_AXIS):
    """The (state, batch) -> (state, metrics) step.

    batch: {"input_ids": (B, L), "attention_mask": (B, L), "video": (B, c, T, H, W)},
    tensors on the model's device.  ``model`` and ``tx`` are the state's model
    and optimizer; their parameters and moments are updated in place, the
    returned state carries the new VQ state and step.  Metrics are 0-d
    tensors: loss, grad_norm (of the unclipped gradients), temperature
    (before the update), mlm_loss and visual_ssl_loss where on, and
    vq_commit.  The video is cast to the policy's compute dtype, and the
    model computes in ``model_dtype`` (ctpa's ``CTCLIP(dtype=...)``), by
    default the policy's compute dtype too (``policy("bf16")``: ctpa's
    ``CTCLIP(dtype=jnp.bfloat16)``; ``policy("fp32")``: its fp32 modules).
    With ``use_mlm`` (the model built with ``use_mlm``) and
    ``use_visual_ssl`` the loss adds ``text_ssl_loss_weight`` times the MLM
    loss and ``image_ssl_loss_weight`` times SimCLR's over two augmented
    views of the video.  The global norm is computed once and serves the
    metric and the clip.

    With ``mesh`` the batch is this rank's rows of the global batch, and
    the step is the global batch's (the module docstring); every rank
    returns the same metrics and keeps the same parameters and codebook."""
    policy = policy or Policy()
    set_compute_dtype(model, policy.compute_dtype if model_dtype is None else model_dtype)

    def train_step(state: CLIPTrainState, batch: dict):
        model.zero_grad(set_to_none=True)
        ids, mask = batch["input_ids"], batch["attention_mask"]
        video = policy.cast_to_compute(batch["video"])
        out = model(ids, mask, video, state.vq_state, return_loss=True, mesh=mesh, axis=axis)
        loss = out.loss
        if out.vq_commit_loss is not None and commit_weight > 0:
            loss = loss + commit_weight * out.vq_commit_loss
        extra = {}
        if (use_mlm or use_visual_ssl) and mesh is None:
            draws = ssl_draws(seed, state.step, ids, video, use_mlm, use_visual_ssl)
        elif use_mlm or use_visual_ssl:
            draws = rank_draws(seed, state.step, ids, video, use_mlm, use_visual_ssl, mesh, axis)
        if use_mlm:
            tl = mlm_loss(model.mlm_logits, ids, mask, draws.mlm, mask_token_id=mask_token_id,
                          mesh=mesh, axis=axis)
            loss = loss + model.cfg.text_ssl_loss_weight * tl
            extra["mlm_loss"] = tl.detach()
        if use_visual_ssl:
            vl = simclr_ssl_loss(model.visual_ssl_embed, video, draws.views, mesh=mesh,
                                 axis=axis)
            loss = loss + model.cfg.image_ssl_loss_weight * vl
            extra["visual_ssl_loss"] = vl.detach()
        loss.backward()
        if mesh is not None:
            average_gradients(model.parameters(), mesh, axis)
        norm = global_norm([p.grad for p in model.parameters() if p.grad is not None])
        metrics = {"loss": loss.detach(), "grad_norm": norm,
                   "temperature": torch.exp(model.temperature.detach()), **extra}
        tx.step(state.step, grad_norm=norm)
        vq_state = state.vq_state
        if vq_state is not None and out.vq_counts is not None:
            counts, sums = out.vq_counts, out.vq_sums
            if mesh is not None:
                counts, sums = reduce_vq_stats(counts, sums, mesh, axis)
            vq_state = ema_update(vq_state, counts, sums, decay=vq_decay)
        if out.vq_commit_loss is not None:
            metrics["vq_commit"] = out.vq_commit_loss.detach()
        if mesh is not None:
            for key in ("loss", "vq_commit", "mlm_loss"):
                if key in metrics:
                    metrics[key] = pmean(metrics[key], mesh, axis)
        return (CLIPTrainState(model=state.model, optimizer=state.optimizer, vq_state=vq_state,
                               step=state.step + 1), metrics)

    return train_step


def reduce_vq_stats(counts: torch.Tensor, sums: torch.Tensor, mesh, axis: str = DATA_AXIS):
    """The VQ assignment counts and sums of the global batch: this rank's,
    summed over ``axis``."""
    return psum(counts, mesh, axis), psum(sums, mesh, axis)


def clip_finetune_mask(model: nn.Module, unfreeze: tuple[str, ...] = (
        "visual_transformer", "text_transformer")) -> dict[str, bool]:
    """The reference fine-tune selection: every parameter frozen but those of
    the listed top-level modules (by default both towers; the latent
    projections and the temperature stay frozen)."""
    return {name: bool(set(name.split(".")) & set(unfreeze))
            for name, _ in model.named_parameters()}


class CTClipTrainer:
    """Training loop: data iterator -> step -> periodic eval and checkpoint.

    ``train_loader`` yields batches (dicts of arrays or tensors with the
    batch leading); they are moved to the model's device.
    ``eval_fn(state, step)`` is the zero-shot evaluation hook, run every
    ``cfg.save_results_every`` steps.  ``trainable_mask`` (name -> bool, or
    a callable model -> that) freezes the False parameters, e.g.
    ``clip_finetune_mask``.  ``model_dtype`` as in ``make_clip_train_step``
    (ctpa's training CLI trains an fp32 CTCLIP under the bf16 policy: the
    video is rounded to bf16, the model computes in fp32).

    With ``mesh`` (data parallelism) the loader yields this rank's rows
    (``data/prefetch.py`` with a sharding or ``process_local``), the step
    is the global batch's, and only the primary rank evaluates and writes
    checkpoints and the metrics file."""

    def __init__(self, model: CTCLIP, state: CLIPTrainState, train_loader: Iterator,
                 cfg: TrainConfig = TrainConfig(), opt_cfg: OptimizerConfig = OptimizerConfig(),
                 mesh=None, eval_fn: Optional[Callable[[CLIPTrainState, int], dict]] = None,
                 commit_weight: float = 0.0, trainable_mask: Optional[Any] = None,
                 model_dtype: Optional[torch.dtype] = None):
        self.mesh = mesh
        self.model = model
        self.cfg = cfg
        self.train_loader = train_loader
        self.eval_fn = eval_fn
        self.device = model.temperature.device
        mask = trainable_mask(model) if callable(trainable_mask) else trainable_mask
        self.tx = get_optimizer(opt_cfg, model, trainable=mask)
        if mask is None:
            # keep the moments the caller's state holds (a resumed run)
            for p in self.tx.params:
                if p in state.optimizer.opt.state:
                    self.tx.opt.state[p] = state.optimizer.opt.state[p]
        self.state = CLIPTrainState(model=model, optimizer=self.tx, vq_state=state.vq_state,
                                    step=state.step)
        # the EMA decay of the model's config (ctpa's trainer takes the
        # default, 0.99, which the config's default equals)
        self._step = make_clip_train_step(
            model, self.tx, vq_decay=model.visual_transformer.cfg.vq_decay,
            commit_weight=commit_weight, policy=precision_policy(cfg.precision),
            model_dtype=model_dtype, mesh=mesh)
        self.ckpt = CheckpointManager(cfg.checkpoint_dir)
        # the other ranks keep their metrics in memory only
        self.metrics = MetricsTracker(os.path.join(cfg.results_dir, "train_metrics.json"),
                                      flush_every=50 if is_primary() else math.inf)

    def _place(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def train_step(self) -> dict:
        self.state, metrics = self._step(self.state, self._place(next(self.train_loader)))
        return metrics

    def train(self, num_steps: Optional[int] = None) -> dict:
        num_steps = num_steps or self.cfg.num_train_steps
        last = {}
        t0 = time.time()
        while self.state.step < num_steps:
            metrics = self.train_step()
            step = self.state.step
            host = {k: float(v) for k, v in metrics.items()}
            host["steps_per_sec"] = 1.0 / max(time.time() - t0, 1e-9)
            t0 = time.time()
            self.metrics.log(step, host)
            last = host
            if self.eval_fn is not None and step % self.cfg.save_results_every == 0 \
                    and is_primary():
                eval_metrics = self.eval_fn(self.state, step)
                self.metrics.log(step, {f"eval/{k}": v for k, v in eval_metrics.items()})
            if step % self.cfg.save_model_every == 0:
                self.save(step)
        # always leave a final checkpoint (short runs never reach the interval)
        if self.state.step not in self.ckpt.all_steps():
            self.save(self.state.step)
        self._flush()
        return last

    def _flush(self) -> None:
        if is_primary():
            self.metrics.flush()

    def save(self, step: int) -> None:
        if is_primary():
            self.ckpt.save(step, self.state.state_dict())

    def close(self) -> None:
        self._flush()
        self.ckpt.wait()
        self.ckpt.close()

    def load(self, step: Optional[int] = None) -> CLIPTrainState:
        restored = self.ckpt.restore(step, map_location=self.device)
        if restored is not None:
            self.state.load_state_dict(restored)
        return self.state
