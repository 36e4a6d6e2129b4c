"""Optimizer and learning-rate schedules (port of ``ctpa/train/optim.py``).

ctpa chains optax's ``clip_by_global_norm`` and ``adamw`` with a schedule.
The port keeps optax's conventions on ``torch.optim.AdamW``:

* ``get_optimizer`` (the CLIP trainer's): two parameter groups, weight
  decay on parameters with ndim >= 2 only; the report trainer's optimizer
  (``train/report_trainer.py``) has two groups with their own schedules
  and decay on every parameter;
* the gradients are clipped by their global norm before the update, as
  optax's ``clip_by_global_norm`` does: scaled by ``max_norm / norm`` when
  the norm reaches ``max_norm``, selected on the device (no host sync);
* the learning rate of an update is the schedule read at the number of
  updates made before it, so step 0 of ``cosine_warmup_restarts`` has lr 0;
* decoupled weight decay is scaled by the learning rate, as in optax's
  ``adamw`` (``torch.optim.AdamW`` does the same);
* a trainable parameter without a gradient gets a zero one, so its moments
  decay and its weight decay applies, as optax's dense gradients do.

Schedules are plain functions of the step count returning a float.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from ctpa_torch.core.config import OptimizerConfig

Schedule = Callable[[int], float]


def weight_decay_mask(model: nn.Module) -> dict[str, bool]:
    """True (decay) for parameters with ndim >= 2."""
    return {name: p.ndim >= 2 for name, p in model.named_parameters()}


def cosine_warmup_restarts(eta_max: float, T_0: int, T_mult: int = 1, T_warmup: int = 10000,
                           gamma: float = 1.0) -> Schedule:
    """Linear warmup to ``eta_max`` over ``T_warmup`` steps, then cosine cycles
    of length ``T_0`` (growing by ``T_mult``), each ``gamma`` times lower."""

    def schedule(count: int) -> float:
        if count < T_warmup:
            return eta_max * count / max(T_warmup, 1)
        t = count - T_warmup
        if T_mult == 1:
            cycle = math.floor(t / T_0)
            t_cur, t_i = t - cycle * T_0, float(T_0)
        else:
            # cycle k starts at T_0 * (T_mult^k - 1) / (T_mult - 1)
            cycle = math.floor(math.log1p(t * (T_mult - 1) / T_0) / math.log(T_mult))
            t_cur = t - T_0 * (float(T_mult) ** cycle - 1.0) / (T_mult - 1)
            t_i = T_0 * float(T_mult) ** cycle
        return eta_max * gamma ** cycle * 0.5 * (1.0 + math.cos(math.pi * t_cur / t_i))

    return schedule


def onecycle(peak_lr: float, total_steps: int, pct_start: float = 0.3,
             div_factor: float = 25.0, final_div_factor: float = 1e4) -> Schedule:
    """OneCycle with cosine annealing: up from ``peak_lr / div_factor`` over
    ``pct_start`` of the steps, then down to that over ``final_div_factor``."""
    init_lr = peak_lr / div_factor
    final_lr = init_lr / final_div_factor
    warm_steps = max(int(total_steps * pct_start), 1)

    def schedule(count: int) -> float:
        if count < warm_steps:
            frac = min(count / warm_steps, 1.0)
            return init_lr + (peak_lr - init_lr) * 0.5 * (1.0 - math.cos(math.pi * frac))
        down = min(max((count - warm_steps) / max(total_steps - warm_steps, 1), 0.0), 1.0)
        return final_lr + (peak_lr - final_lr) * 0.5 * (1.0 + math.cos(math.pi * down))

    return schedule


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float = 0.0) -> Schedule:
    """Linear warmup then cosine decay to ``end_value`` at ``decay_steps``
    (optax's ``warmup_cosine_decay_schedule``)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return init_value + (peak_value - init_value) * count / warmup_steps
        t = min(count - warmup_steps, span)
        return peak_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / span)) + alpha)

    return schedule


def build_schedule(cfg: OptimizerConfig) -> Schedule:
    if cfg.schedule == "constant":
        return lambda count: cfg.lr
    if cfg.schedule == "cosine_warmup_restarts":
        return cosine_warmup_restarts(eta_max=cfg.lr, T_0=max(cfg.total_steps - cfg.warmup_steps, 1),
                                      T_warmup=cfg.warmup_steps)
    if cfg.schedule == "onecycle":
        return onecycle(peak_lr=cfg.lr, total_steps=cfg.total_steps)
    if cfg.schedule == "cosine":
        return warmup_cosine_decay(0.0, cfg.lr, cfg.warmup_steps, cfg.total_steps,
                                   end_value=cfg.lr * cfg.min_lr_ratio)
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in fp32."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor optax's ``clip_by_global_norm`` applies: 1 below
    ``max_norm``, ``max_norm / norm`` from it on; a device tensor."""
    return torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)


class Optimizer:
    """Gradient clipping, scheduled learning rates and AdamW (optax's
    ``chain(clip_by_global_norm, adamw)``, or with several groups
    ``chain(clip_by_global_norm, multi_transform({group: adamw}))``).
    ``groups`` holds (parameters, schedule, weight decay) triples; one
    global norm over every group's gradients is clipped.  ``masked`` says
    that the caller's ``grad_norm`` covers gradients the clip must not see
    (parameters that have a gradient but are frozen), so the clip's norm is
    computed here.  ``step(count)`` reads the gradients in ``p.grad``."""

    def __init__(self, groups: list[tuple[list[torch.Tensor], Schedule, float]],
                 betas=(0.9, 0.999), eps: float = 1e-8, grad_clip_norm: float | None = None,
                 masked: bool = False):
        groups = [g for g in groups if g[0]]
        self.schedules = [schedule for _, schedule, _ in groups]
        self.grad_clip_norm = grad_clip_norm
        self.masked = masked
        self.opt = torch.optim.AdamW(
            [{"params": params, "weight_decay": wd, "lr": schedule(0)}
             for params, schedule, wd in groups], betas=betas, eps=eps)

    @property
    def params(self) -> list[torch.Tensor]:
        return [p for group in self.opt.param_groups for p in group["params"]]

    @torch.no_grad()
    def step(self, count: int, grad_norm: torch.Tensor | None = None) -> None:
        """One update at schedule step ``count`` (updates made before it).
        ``grad_norm``: the global norm of the gradients, where the caller
        has it already; it is the clip's norm unless ``masked``."""
        params = self.params
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.grad_clip_norm and self.grad_clip_norm > 0:
            grads = [p.grad for p in params]
            norm = global_norm(grads) if grad_norm is None or self.masked else grad_norm
            torch._foreach_mul_(grads, clip_scale(norm, self.grad_clip_norm))
        for group, schedule in zip(self.opt.param_groups, self.schedules):
            group["lr"] = schedule(count)
        self.opt.step()

    def state_dict(self) -> dict:
        return self.opt.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state)


def get_optimizer(cfg: OptimizerConfig, model: nn.Module,
                  trainable: dict[str, bool] | None = None) -> Optimizer:
    """The optimizer of ``cfg`` over ``model``'s parameters, weight decay on
    those with ndim >= 2; with ``trainable`` (name -> bool) only the True
    ones are updated, the others stay frozen (optax's ``multi_transform``
    with ``set_to_zero``), and the clip's norm covers the trainable
    gradients only."""
    if cfg.name not in ("adam", "adamw"):
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    schedule = build_schedule(cfg)
    decay = weight_decay_mask(model)
    wd = 0.0 if cfg.name == "adam" or cfg.weight_decay == 0 else cfg.weight_decay
    named = [(n, p) for n, p in model.named_parameters() if trainable is None or trainable[n]]
    groups = [([p for n, p in named if decay[n]], schedule, wd),
              ([p for n, p in named if not decay[n]], schedule, 0.0)]
    return Optimizer(groups, betas=cfg.betas, eps=cfg.eps, grad_clip_norm=cfg.grad_clip_norm,
                     masked=len(named) < len(list(model.parameters())))
