"""Visual self-supervised objectives (port of ``ctpa/models/visual_ssl.py``):
SimSiam and SimCLR (NT-Xent), the projector and predictor heads, and the
3D augmentation of a volume.

The encoder is passed in as ``encode_fn(view) -> features``.  The
augmentation's draws (two flips, an intensity scale, Gaussian noise) are
inputs of ``augment_volume_from``, which is exact given them;
``augment_draws`` draws them from a ``torch.Generator``.

ctpa's ``BatchNorm(use_running_average=True)`` always normalizes with the
running statistics, in training too, and never updates them; the port's
``FrozenBatchNorm`` does the same, with ctpa's ``batch_stats`` (``mean``,
``var``) as buffers."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ctpa_torch.models.layers import Dense
from ctpa_torch.ops.attention_ops import l2norm


class FrozenBatchNorm(nn.Module):
    """flax ``BatchNorm(use_running_average=True)``: (x - mean) /
    sqrt(var + eps) * scale + bias over the last axis."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, **fk))
        self.bias = nn.Parameter(torch.zeros(dim, **fk))
        self.register_buffer("mean", torch.zeros(dim, **fk))
        self.register_buffer("var", torch.ones(dim, **fk))

    def forward(self, x):
        return F.batch_norm(x, self.mean, self.var, self.weight, self.bias, training=False,
                            eps=self.eps)


class ProjectorMLP(nn.Module):
    """SimSiam/SimCLR projection head: (Dense -> FrozenBatchNorm -> ReLU)
    x (num_layers - 1), then Dense.  Submodules carry flax's automatic names
    (``Dense_0``, ``BatchNorm_0``, ...), so ``convert.load_flax_variables``
    takes ctpa's params and batch_stats as they are."""

    def __init__(self, in_dim: int, hidden: int = 512, out: int = 256, num_layers: int = 2,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.num_layers = num_layers
        width = in_dim
        for i in range(num_layers - 1):
            setattr(self, f"Dense_{i}", Dense(width, hidden, **fk))
            setattr(self, f"BatchNorm_{i}", FrozenBatchNorm(hidden, **fk))
            width = hidden
        setattr(self, f"Dense_{num_layers - 1}", Dense(width, out, **fk))

    def forward(self, x):
        for i in range(self.num_layers - 1):
            x = F.relu(getattr(self, f"BatchNorm_{i}")(getattr(self, f"Dense_{i}")(x)))
        return getattr(self, f"Dense_{self.num_layers - 1}")(x)


class PredictorMLP(nn.Module):
    """Dense -> ReLU -> Dense (flax names ``Dense_0``, ``Dense_1``)."""

    def __init__(self, in_dim: int, hidden: int = 512, out: int = 256, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.Dense_0 = Dense(in_dim, hidden, **fk)
        self.Dense_1 = Dense(hidden, out, **fk)

    def forward(self, x):
        return self.Dense_1(F.relu(self.Dense_0(x)))


def simsiam_loss(p1, z2, p2, z1) -> torch.Tensor:
    """Negative cosine, the targets detached."""

    def d(p, z):
        return -(l2norm(p) * l2norm(z.detach())).sum(-1).mean()

    return d(p1, z2) / 2 + d(p2, z1) / 2


def nt_xent_loss(z1: torch.Tensor, z2: torch.Tensor, temperature: float = 0.1) -> torch.Tensor:
    """SimCLR's NT-Xent over the 2b views: each view's positive is its twin."""
    b = z1.shape[0]
    z = l2norm(torch.cat([z1, z2], dim=0))
    sim = z @ z.T / temperature
    sim = sim.masked_fill(torch.eye(2 * b, dtype=torch.bool, device=sim.device),
                          torch.finfo(sim.dtype).min)
    idx = torch.arange(b, device=sim.device)
    targets = torch.cat([idx + b, idx])
    return -torch.log_softmax(sim, dim=-1).gather(-1, targets[:, None]).mean()


class AugmentDraws(NamedTuple):
    """One view's draws: flip over height, flip over width (0-d bool
    tensors), the intensity scale (a 0-d float), the additive noise (the
    volume's shape and dtype)."""

    flip_h: torch.Tensor
    flip_w: torch.Tensor
    scale: torch.Tensor
    noise: torch.Tensor


def augment_volume_from(video: torch.Tensor, draws: AugmentDraws) -> torch.Tensor:
    """The augmented view, fp32: flips over the last two axes where drawn,
    then video * scale + noise.  (ctpa's fp32 scale promotes a bf16 volume
    to fp32, so the view is fp32 either way.)"""
    video = torch.where(draws.flip_h, video.flip(-2), video)
    video = torch.where(draws.flip_w, video.flip(-1), video)
    return video.float() * draws.scale.float() + draws.noise.float()


def augment_draws(video: torch.Tensor, generator: torch.Generator | None = None,
                  noise_std: float = 0.05) -> AugmentDraws:
    """Draws for one view: fair coins for the flips, the scale uniform in
    [0.9, 1.1), noise_std times a standard normal in the volume's dtype."""
    kw = dict(generator=generator, device=video.device)
    flips = torch.rand(2, **kw) < 0.5
    scale = 1.0 + 0.1 * (2.0 * torch.rand((), **kw) - 1.0)
    noise = (noise_std * torch.randn(video.shape, **kw)).to(video.dtype)
    return AugmentDraws(flips[0], flips[1], scale, noise)


def augment_volume(video: torch.Tensor, generator: torch.Generator | None = None,
                   noise_std: float = 0.05) -> torch.Tensor:
    return augment_volume_from(video, augment_draws(video, generator, noise_std))


def simclr_ssl_loss(encode_fn: Callable[[torch.Tensor], torch.Tensor], video: torch.Tensor,
                    views: tuple[AugmentDraws, AugmentDraws],
                    temperature: float = 0.1, mesh=None, axis: str = "data") -> torch.Tensor:
    """Two augmented views -> encoder -> NT-Xent.  With ``mesh`` the video
    and the views' noise are this rank's rows; the embeddings are gathered
    over ``axis`` and the loss is the global batch's."""
    z1 = encode_fn(augment_volume_from(video, views[0]))
    z2 = encode_fn(augment_volume_from(video, views[1]))
    if mesh is not None:
        from ctpa_torch.comms.collectives import all_gather_batch

        z1, z2 = all_gather_batch(z1, mesh, axis), all_gather_batch(z2, mesh, axis)
    return nt_xent_loss(z1, z2, temperature)
