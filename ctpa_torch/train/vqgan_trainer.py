"""CTViT generative (VQGAN) trainer (port of ``ctpa/train/vqgan_trainer.py``):
reconstruction, perceptual, GAN and commitment losses with alternating
generator and discriminator updates, then the VQ EMA codebook update.

One step, in ctpa's order:
  1. the generator's loss, ``recon_weight`` * L1 + ``perceptual_weight`` *
     perceptual + ``gan_weight`` * GAN + ``commit_weight`` * commitment, from
     ``CTViT.reconstruct``; its gradient reaches the generator's parameters
     only (the discriminator is read, the perceptual net is frozen), and
     Adam updates them;
  2. the discriminator's loss on the real middle slices and on the detached
     reconstruction of that same forward (made with the weights from before
     the update), plus the R1 penalty when ``step % apply_r1_every == 0``
     (step 0 included); Adam updates the discriminator;
  3. ``ema_update`` with the forward's assignment counts and sums.

ctpa compiles this into one XLA program; the port runs it eagerly,
updates parameters and moments in place, and keeps the step count on the
host, so the R1 branch reads nothing from the device and the step makes no
host sync.  The generator computes in its modules' compute dtype
(``models.layers.set_compute_dtype``; ctpa's ``CTViT(dtype=...)``); the
discriminator and the perceptual net in their parameters' dtype.

Data parallelism (``mesh``): the video is this rank's rows of the global
batch.  Every loss is a mean over equally many items on each rank, so the
generator's and the discriminator's gradients are each averaged over the
ranks before their update (``comms/collectives.py:average_gradients``),
the VQ assignment counts and sums are summed before the EMA update, and
the metrics are means over the ranks: ctpa's step on the global batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ctpa_torch.comms.collectives import average_gradients, pmean, psum
from ctpa_torch.core.mesh import DATA_AXIS
from ctpa_torch.models.ctvit import CTViT
from ctpa_torch.models.discriminator import Discriminator, PerceptualNet, perceptual_loss
from ctpa_torch.ops.vq import VQState, ema_update
from ctpa_torch.train.gan_losses import (
    bce_d_loss,
    bce_g_loss,
    hinge_d_loss,
    hinge_g_loss,
    pick_middle_frames,
    r1_gradient_penalty,
)
from ctpa_torch.train.optim import Optimizer


def adam(module: nn.Module, lr: float, b1: float = 0.5, b2: float = 0.9) -> Optimizer:
    """optax's ``adam(lr, b1, b2)`` over ``module``'s parameters: a constant
    rate, no decay, no clipping (ctpa's CLI builds both VQGAN optimizers so)."""
    return Optimizer([(list(module.parameters()), lambda count: lr, 0.0)], betas=(b1, b2))


@dataclass
class VQGANState:
    gen: CTViT                   # the generator's parameters
    disc: Discriminator
    perc: PerceptualNet          # frozen
    gen_opt: Optimizer
    disc_opt: Optimizer
    vq_state: VQState
    step: int = 0

    def state_dict(self) -> dict:
        return {"gen_params": self.gen.state_dict(), "disc_params": self.disc.state_dict(),
                "perc_params": self.perc.state_dict(), "gen_opt": self.gen_opt.state_dict(),
                "disc_opt": self.disc_opt.state_dict(), "vq_state": self.vq_state._asdict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        """Restore in place; the VQ state goes to the generator's device."""
        self.gen.load_state_dict(state["gen_params"])
        self.disc.load_state_dict(state["disc_params"])
        self.perc.load_state_dict(state["perc_params"])
        self.gen_opt.load_state_dict(state["gen_opt"])
        self.disc_opt.load_state_dict(state["disc_opt"])
        device = next(self.gen.parameters()).device
        self.vq_state = VQState(**{k: torch.as_tensor(v, device=device)
                                   for k, v in state["vq_state"].items()})
        self.step = int(state["step"])


def make_vqgan_train_step(model: CTViT, disc: Discriminator, perc: PerceptualNet,
                          gen_tx: Optimizer, disc_tx: Optimizer, *, use_hinge: bool = True,
                          recon_weight: float = 1.0, perceptual_weight: float = 1.0,
                          gan_weight: float = 1.0, commit_weight: float = 1.0,
                          r1_weight: float = 10.0, apply_r1_every: int = 16,
                          vq_decay: float = 0.99, mesh=None, axis: str = DATA_AXIS):
    """The (state, video) -> (state, metrics) step.  ``video`` (b, c, T, H, W)
    on the generator's device; the state's modules and optimizers are these
    ones, updated in place.  Metrics are 0-d tensors: gen_loss, disc_loss
    (R1 included), recon, perceptual, gen_gan, commit, r1.  With ``mesh``
    the video is this rank's rows and the step the global batch's (the
    module docstring)."""
    g_loss_fn = hinge_g_loss if use_hinge else bce_g_loss
    d_loss_fn = hinge_d_loss if use_hinge else bce_d_loss
    perc.requires_grad_(False)
    gen_params, disc_params = list(model.parameters()), list(disc.parameters())

    def train_step(state: VQGANState, video: torch.Tensor):
        for p in gen_params + disc_params:
            p.grad = None
        recon, vq_out = model.reconstruct(video, state.vq_state)
        recon_l = torch.mean(torch.abs(recon.float() - video.float()))
        real_mid, fake_mid = pick_middle_frames(video), pick_middle_frames(recon)
        perc_l = perceptual_loss(perc, real_mid, fake_mid)
        gan_l = g_loss_fn(disc(fake_mid))
        g_loss = (recon_weight * recon_l + perceptual_weight * perc_l + gan_weight * gan_l
                  + commit_weight * vq_out.commit_loss)
        g_loss.backward(inputs=gen_params)
        if mesh is not None:
            average_gradients(gen_params, mesh, axis)
        gen_tx.step(state.step)

        fake_mid = fake_mid.detach()
        d_loss = d_loss_fn(disc(real_mid), disc(fake_mid))
        if state.step % apply_r1_every == 0:
            r1 = r1_gradient_penalty(disc, real_mid, r1_weight)
        else:
            r1 = torch.zeros((), device=video.device)
        d_total = d_loss + r1
        d_total.backward(inputs=disc_params)
        if mesh is not None:
            average_gradients(disc_params, mesh, axis)
        disc_tx.step(state.step)

        counts, sums = vq_out.counts, vq_out.sums
        if mesh is not None:
            counts, sums = psum(counts, mesh, axis), psum(sums, mesh, axis)
        vq_state = ema_update(state.vq_state, counts, sums, decay=vq_decay)
        metrics = {"gen_loss": g_loss.detach(), "disc_loss": d_total.detach(),
                   "recon": recon_l.detach(), "perceptual": perc_l.detach(),
                   "gen_gan": gan_l.detach(), "commit": vq_out.commit_loss.detach(),
                   "r1": r1.detach()}
        if mesh is not None:
            metrics = {k: pmean(v, mesh, axis) for k, v in metrics.items()}
        return (VQGANState(gen=state.gen, disc=state.disc, perc=state.perc,
                           gen_opt=state.gen_opt, disc_opt=state.disc_opt, vq_state=vq_state,
                           step=state.step + 1), metrics)

    return train_step
