"""GAN losses of the CTViT generative path (port of
``ctpa/train/gan_losses.py``): hinge and BCE discriminator and generator
losses, the R1 gradient penalty, the adaptive generator-loss weight, and
the discriminator's 2-D view of a volume."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def hinge_d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    return torch.mean(F.relu(1.0 - real_logits)) + torch.mean(F.relu(1.0 + fake_logits))


def hinge_g_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    return -torch.mean(fake_logits)


def bce_d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    return torch.mean(F.softplus(-real_logits)) + torch.mean(F.softplus(fake_logits))


def bce_g_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    return torch.mean(F.softplus(-fake_logits))


def r1_gradient_penalty(disc_fn: Callable[[torch.Tensor], torch.Tensor], real: torch.Tensor,
                        weight: float = 10.0) -> torch.Tensor:
    """weight * E[||d sum(D(x)) / dx||^2] on the real inputs.  The input
    gradient is taken with ``create_graph`` on a copy of ``real`` that
    requires grad, so the penalty's own gradient reaches the discriminator's
    parameters (as ctpa's ``jax.grad`` inside the loss does)."""
    x = real.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(disc_fn(x).sum(), x, create_graph=True)
    return weight * torch.mean(torch.sum(grads.reshape(real.shape[0], -1) ** 2, dim=-1))


def adaptive_gan_weight(recon_grad_norm: torch.Tensor, gan_grad_norm: torch.Tensor,
                        clamp: float = 1e4, eps: float = 1e-4) -> torch.Tensor:
    """lambda = ||grad recon|| / max(||grad gan||, eps), clipped to [0, clamp]."""
    return torch.clamp(recon_grad_norm / torch.clamp(gan_grad_norm, min=eps), 0.0, clamp)


def pick_middle_frames(video: torch.Tensor) -> torch.Tensor:
    """(b, c, t, h, w) -> the middle axial slice (b, c, h, w) (ctpa returns
    it as (b, h, w, c) for its NHWC convolutions)."""
    return video[:, :, video.shape[2] // 2]
