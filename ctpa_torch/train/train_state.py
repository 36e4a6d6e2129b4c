"""The train states (port of ``ctpa/train/train_state.py``).

ctpa threads an immutable pytree (params, opt_state, vq_state, step) through
a jitted step.  In the port the parameters live in the model and the AdamW
moments in the optimizer, and the step updates both in place; the state
names them beside the VQ codebook state (CLIP) and the step count, so one
``state_dict()`` holds everything a checkpoint needs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ctpa_torch.ops.vq import VQState
from ctpa_torch.train.optim import Optimizer


@dataclass
class CLIPTrainState:
    model: nn.Module                 # the parameters
    optimizer: Optimizer             # the optimizer state
    vq_state: VQState | None
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, tx: Optimizer, vq_state: VQState | None = None):
        return cls(model=model, optimizer=tx, vq_state=vq_state, step=0)

    def state_dict(self) -> dict:
        return {"params": self.model.state_dict(), "opt_state": self.optimizer.state_dict(),
                "vq_state": None if self.vq_state is None else self.vq_state._asdict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        """Restore in place; the VQ state goes to the model's device."""
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        device = next(self.model.parameters()).device
        vq = state["vq_state"]
        self.vq_state = None if vq is None else VQState(
            **{k: torch.as_tensor(v, device=device) for k, v in vq.items()})
        self.step = int(state["step"])


@dataclass
class SimpleTrainState:
    """The report trainer's state: model, optimizer and step count.  Its
    ``state_dict`` holds the parameters the optimizer updates, not the
    frozen base: a LoRA fine-tune of a 7B model would otherwise write 13.5
    GB of unchanged weights per checkpoint (ctpa writes them); a restore
    loads into a model built on the same base.  ``frozen_state_dict`` is
    that base (every other entry of the model's ``state_dict``), which
    ``cli/train_report.py`` writes once per run beside the checkpoints
    (``core/checkpoint.py:save_base``)."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, tx: Optimizer):
        return cls(model=model, optimizer=tx, step=0)

    def _trained(self) -> dict[str, torch.Tensor]:
        ids = {id(p) for p in self.optimizer.params}
        return {n: p for n, p in self.model.named_parameters() if id(p) in ids}

    def state_dict(self) -> dict:
        return {"params": {n: p.detach() for n, p in self._trained().items()},
                "opt_state": self.optimizer.state_dict(), "step": self.step}

    def frozen_state_dict(self) -> dict[str, torch.Tensor]:
        trained = self._trained()
        return {n: t for n, t in self.model.state_dict().items() if n not in trained}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore in place; the saved parameters must be exactly those the
        optimizer updates."""
        own = self._trained()
        if set(state["params"]) != set(own):
            raise KeyError(f"checkpoint parameters {sorted(set(state['params']) ^ set(own))} "
                           "differ from the trained ones")
        for name, value in state["params"].items():
            own[name].copy_(value)
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])
