"""Report-generation fine-tuning (port of ``ctpa/train/report_trainer.py``).

AdamW with two learning-rate groups, each with its own OneCycle schedule:
the "head" (the cross-attention) at ``cross_attn_lr`` and the "llm" (the
LoRA adapters) at ``llm_lr``; weight decay 1e-2 on every trainable
parameter (optax's ``adamw`` without a mask); the gradients clipped to a
global norm of 1.0 on the device; the shifted-label cross-entropy of
``CTReportGenerator``; best-by-loss and best-by-val checkpoints.

ctpa's partitioned step differentiates only the trainable leaves by
closing over the frozen ones; here the frozen parameters get
``requires_grad=False``, so autograd keeps no gradient for them and builds
no graph through a trunk that has no trainable parameter.  The step reads
nothing back to the host; the trainer reads one stacked copy of the
metrics per step, for the log.  The model's compute dtype is the caller's
(``models.layers.set_compute_dtype``, ctpa's model ``dtype``); a frozen
base may be stored in that dtype, since rounding it once gives the same
operands as ctpa's cast at every use.

The labels follow ctpa's rule as it acts: ctpa also names
``vision_feature_extractor/proj`` and ``/norm`` as head parameters, but it
matches those strings against ``jax.tree_util.keystr`` paths, which join
keys as ``['a']['b']``, so they never match and the vision projection stays
frozen; likewise its ``train_full_llm`` (``"llm/"``) labels nothing, so
the port leaves that option out.

Data parallelism (``mesh``): each rank takes its rows of the global batch.
ctpa's loss under pjit is the global batch's token mean; ranks hold
different numbers of label tokens, so the kept-token count is summed over
the ranks and each rank's sum scaled to it (``CTReportGenerator._ce``),
never a mean of per-rank means.  The gradients are then averaged over the
ranks (``comms/collectives.py:average_gradients``) before the clip's norm,
and the loss metric is the mean over ranks of the ranks' scaled sums: the
global token mean.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Iterator, Optional

import numpy as np
import torch
from torch import nn

from ctpa_torch.comms.collectives import average_gradients, pmean
from ctpa_torch.core.checkpoint import CheckpointManager
from ctpa_torch.core.config import ReportGenConfig, TrainConfig
from ctpa_torch.core.mesh import DATA_AXIS, is_primary
from ctpa_torch.models.lora import is_lora
from ctpa_torch.models.report_generator import CTReportGenerator
from ctpa_torch.train.metrics import MetricsTracker
from ctpa_torch.train.optim import Optimizer, global_norm, onecycle
from ctpa_torch.train.train_state import SimpleTrainState

WEIGHT_DECAY = 1e-2


def trainable_labels(model: nn.Module) -> dict[str, str]:
    """Parameter name -> "head" (the cross-attention), "llm" (the LoRA
    adapters) or "frozen"."""

    def label(name: str) -> str:
        if "cross_attention" in name:
            return "head"
        return "llm" if is_lora(name) else "frozen"

    return {name: label(name) for name, _ in model.named_parameters()}


def make_report_optimizer(model: nn.Module, gen_cfg: ReportGenConfig, total_steps: int,
                          grad_clip: float = 1.0) -> Optimizer:
    """The two-group AdamW over the trainable parameters; the frozen ones get
    no update.  It clips by the norm the step hands it: over the trainable
    gradients in the partitioned step, over every gradient in
    ``make_report_train_step``, as ctpa's two variants do."""
    labels = trainable_labels(model)
    params = dict(model.named_parameters())
    groups = [([params[n] for n, lab in labels.items() if lab == group],
               onecycle(lr, total_steps), WEIGHT_DECAY)
              for group, lr in (("head", gen_cfg.cross_attn_lr), ("llm", gen_cfg.llm_lr))]
    return Optimizer(groups, grad_clip_norm=grad_clip)


def _loss(model: CTReportGenerator, batch: dict, mesh=None) -> torch.Tensor:
    if "vision" in batch:
        # precomputed features: the frozen trunk and the video stay out of the step
        return model.loss_from_vision(batch["vision"], batch["input_ids"],
                                      batch["attention_mask"], batch.get("label_mask"), mesh)
    return model.loss(batch["video"], batch["input_ids"], batch["attention_mask"],
                      batch.get("label_mask"), mesh)


def _update(state: SimpleTrainState, loss: torch.Tensor, params, mesh=None) -> tuple:
    params = list(params)
    if mesh is not None:
        average_gradients(params, mesh, DATA_AXIS)
    norm = global_norm([p.grad for p in params if p.grad is not None])
    state.optimizer.step(state.step, grad_norm=norm)
    loss = loss.detach() if mesh is None else pmean(loss, mesh, DATA_AXIS)
    return (SimpleTrainState(model=state.model, optimizer=state.optimizer, step=state.step + 1),
            {"loss": loss, "grad_norm": norm})


def make_report_train_step(model: CTReportGenerator, tx: Optimizer, mesh=None):
    """The step over the full tree: every parameter that requires grad gets a
    gradient, the clip's norm covers them all, and ``tx`` updates the
    trainable ones.  With ``mesh`` the batch is this rank's rows and the
    step is the global batch's (the module docstring)."""

    def step(state: SimpleTrainState, batch: dict):
        model.zero_grad(set_to_none=True)
        loss = model.loss(batch["video"], batch["input_ids"], batch["attention_mask"],
                          batch.get("label_mask"), mesh)
        loss.backward()
        return _update(state, loss, model.parameters(), mesh)

    return step


def make_partitioned_report_step(model: CTReportGenerator, gen_cfg: ReportGenConfig,
                                 total_steps: int, grad_clip: float = 1.0, mesh=None):
    """The LoRA-scale step: the frozen parameters stop requiring grad, so only
    the trainable ones get gradients, and the clip's norm covers them alone
    (ctpa's partitioned step).  Returns (step_fn, optimizer);
    ``step_fn(state, batch)`` takes a batch with ``"video"`` or precomputed
    ``"vision"`` features (``mesh`` as in ``make_report_train_step``)."""
    labels = trainable_labels(model)
    trainable = [p for n, p in model.named_parameters() if labels[n] != "frozen"]
    if not trainable:
        raise ValueError("no trainable parameters under the report labels")
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
    tx = make_report_optimizer(model, gen_cfg, total_steps, grad_clip)

    def step(state: SimpleTrainState, batch: dict):
        for p in trainable:
            p.grad = None
        loss = _loss(model, batch, mesh)
        loss.backward()
        return _update(state, loss, trainable, mesh)

    return step, tx


class ReportTrainer:
    """Epoch loop with best-by-loss and best-by-val checkpoints.  ``loader``
    batches (dicts of arrays or tensors) are moved to the model's device.
    ``eval_fn(state)`` returns validation scores; their "composite" (or
    their mean) decides best-by-val.  With ``mesh`` the loader yields this
    rank's rows, the default step is the data-parallel one (a ``step_fn``
    passed in must have been made with the same mesh), and only the primary
    rank writes checkpoints and the metrics file."""

    def __init__(self, model: CTReportGenerator, state: SimpleTrainState, tx: Optimizer,
                 cfg: TrainConfig = TrainConfig(), mesh=None,
                 eval_fn: Optional[Callable[[SimpleTrainState], dict]] = None,
                 eval_frequency: int = 1, step_fn=None):
        self.mesh = mesh
        self.model = model
        self.cfg = cfg
        self.eval_fn = eval_fn
        self.eval_frequency = eval_frequency
        # default: gradients of the full tree; pass make_partitioned_report_step's
        # step for a LoRA fine-tune at 7B
        self._step = step_fn or make_report_train_step(model, tx, mesh)
        self.state = state
        self.device = next(model.parameters()).device
        self.ckpt = CheckpointManager(cfg.checkpoint_dir)
        # the other ranks keep their metrics in memory only
        self.metrics = MetricsTracker(os.path.join(cfg.results_dir, "report_train_metrics.json"),
                                      flush_every=50 if is_primary() else math.inf)
        self.best_loss = float("inf")
        self.best_val = -float("inf")

    def _place(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def train_epoch(self, loader: Iterator, epoch: int) -> dict:
        losses = []
        for batch in loader:
            self.state, m = self._step(self.state, self._place(batch))
            # the one host read of a step: the metrics, stacked
            host = dict(zip(m, torch.stack([v.float() for v in m.values()]).tolist()))
            losses.append(host["loss"])
            self.metrics.log(self.state.step, host)
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        if mean_loss < self.best_loss and is_primary():
            self.best_loss = mean_loss
            self.ckpt.save(self.state.step, self.state.state_dict(),
                           metadata={"kind": "best_loss", "epoch": epoch, "loss": mean_loss})
        if self.eval_fn is not None and (epoch + 1) % self.eval_frequency == 0:
            scores = self.eval_fn(self.state)
            self.metrics.log(self.state.step, {f"val/{k}": v for k, v in scores.items()})
            # composite (ROUGE-L + BERTScore-F1) / 2, as ctpa's
            val = scores.get("composite", np.mean(list(scores.values())) if scores else 0.0)
            if val > self.best_val and is_primary():
                self.best_val = val
                self.ckpt.save(self.state.step + 1, self.state.state_dict(),
                               metadata={"kind": "best_val", "epoch": epoch, "score": val})
        return {"epoch": epoch, "mean_loss": mean_loss}

    def close(self) -> None:
        if is_primary():
            self.metrics.flush()
        self.ckpt.wait()
        self.ckpt.close()
