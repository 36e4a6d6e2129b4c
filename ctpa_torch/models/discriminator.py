"""2-D convolutional discriminator and perceptual feature net of the CTViT
generative path (port of ``ctpa/models/discriminator.py``).

ctpa's modules take (b, h, w, c) slices and convolve in flax's NHWC; the
port's take (b, c, h, w) and convolve with ``F.conv2d`` (ctpa computes them
in XLA, outside any Pallas kernel).  Parameters keep ctpa's names: flax's
automatic ``Conv_i``, ``DiscriminatorBlock_i`` and ``Dense_i``, and the
perceptual net's ``conv_{i}{a,b,c}``; a conv's ``weight`` is (out, in, kh, kw)
(``convert.py`` permutes flax's (kh, kw, in, out)).  The discriminator
flattens its last feature map in ctpa's (h, w, c) order before ``Dense_0``,
so a converted ``Dense_0`` reads the same features.

Neither module has a compute dtype of its own: each convolution and dense
layer computes in its parameters' dtype, as flax promotes a bf16 input
against fp32 parameters.  ``PerceptualNet.vgg16()`` takes a torchvision
``vgg16().features`` state dict through ``data/hf_import.py:
import_vgg_features`` and ``convert.load_flax_params``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ctpa_torch.models.layers import Dense, compute_dtype


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """flax's SAME padding (low, high) of one axis."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """flax ``nn.Conv`` with SAME padding and a bias, on (b, c, h, w)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, device=None,
                 dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel, **fk))
        self.bias = nn.Parameter(torch.zeros(cout, **fk))

    def forward(self, x):
        k, s = self.weight.shape[-1], self.stride
        (ht, hb), (wl, wr) = (_same_pads(n, k, s) for n in x.shape[-2:])
        dt = compute_dtype(self, self.weight)
        x = F.pad(x.to(dt), (wl, wr, ht, hb))
        return F.conv2d(x, self.weight.to(dt), self.bias.to(dt), stride=s)


class DiscriminatorBlock(nn.Module):
    """A 1x1 stride-2 residual conv beside two 3x3 convs with leaky_relu(0.1)
    and a 2x2 average pool; the sum over sqrt(2)."""

    def __init__(self, cin: int, filters: int, downsample: bool = True, device=None,
                 dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.downsample = downsample
        self.Conv_0 = Conv2d(cin, filters, 1, stride=2 if downsample else 1, **fk)
        self.Conv_1 = Conv2d(cin, filters, 3, **fk)
        self.Conv_2 = Conv2d(filters, filters, 3, **fk)

    def forward(self, x):
        res = self.Conv_0(x)
        x = F.leaky_relu(self.Conv_1(x), 0.1)
        x = F.leaky_relu(self.Conv_2(x), 0.1)
        if self.downsample:
            x = F.avg_pool2d(x, 2, 2)
        return (x + res) / math.sqrt(2.0)


class Discriminator(nn.Module):
    """Patch-style conv discriminator over 2-D slices (b, channels, image_size,
    image_size) -> (b,) logits.  ``image_size`` sizes ``Dense_0`` (flax infers
    it at init); 480 is the shipped CT slice."""

    def __init__(self, base_dim: int = 16, max_dim: int = 256, num_layers: int = 4,
                 channels: int = 1, image_size: int = 480, device="cuda", dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        dim = base_dim
        self.Conv_0 = Conv2d(channels, dim, 3, **fk)
        size = image_size
        for i in range(num_layers):
            out = min(dim * 2, max_dim)
            setattr(self, f"DiscriminatorBlock_{i}", DiscriminatorBlock(dim, out, **fk))
            dim, size = out, size // 2
        self.num_layers = num_layers
        self.Conv_1 = Conv2d(dim, dim, 3, **fk)
        self.Dense_0 = Dense(size * size * dim, dim, **fk)
        self.Dense_1 = Dense(dim, 1, **fk)

    def forward(self, x):
        x = self.Conv_0(x)
        for i in range(self.num_layers):
            x = getattr(self, f"DiscriminatorBlock_{i}")(x)
        x = F.leaky_relu(self.Conv_1(x), 0.1)
        # ctpa flattens NHWC: the features in (h, w, c) order
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.leaky_relu(self.Dense_0(x), 0.1)
        return self.Dense_1(x)[:, 0]


class PerceptualNet(nn.Module):
    """Conv feature pyramid for the perceptual distance: per stage
    ``convs_per_stage`` 3x3 SAME convs with relu, a 2x2 max pool between
    stages.  Returns each stage's map (b, c, h, w).  ``vgg16()`` is
    torchvision's VGG16 geometry (64/128/256/512/512, 2/2/3/3/3 convs)."""

    def __init__(self, stages: tuple[int, ...] = (64, 128, 256), channels_in: int = 3,
                 convs_per_stage: tuple[int, ...] | None = None, device="cuda", dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.layout = []
        cin = channels_in
        for i, (ch, n_convs) in enumerate(zip(stages, convs_per_stage or (2,) * len(stages))):
            names = [f"conv_{i}{'abcdef'[j]}" for j in range(n_convs)]
            for name in names:
                setattr(self, name, Conv2d(cin, ch, 3, **fk))
                cin = ch
            self.layout.append(names)

    @classmethod
    def vgg16(cls, device="cuda", dtype=None) -> "PerceptualNet":
        return cls(stages=(64, 128, 256, 512, 512), convs_per_stage=(2, 2, 3, 3, 3),
                   device=device, dtype=dtype)

    def forward(self, x) -> list[torch.Tensor]:
        feats = []
        for i, names in enumerate(self.layout):
            if i:
                x = F.max_pool2d(x, 2, 2)
            for name in names:
                x = F.relu(getattr(self, name)(x))
            feats.append(x)
        return feats


def perceptual_loss(net: PerceptualNet, real: torch.Tensor, fake: torch.Tensor,
                    final_only: bool = False) -> torch.Tensor:
    """Perceptual distance of (b, c, h, w) slices, one channel repeated to
    three: the MSE of the last stage's features with ``final_only``, else
    the mean of every stage's MSE."""

    def prep(x):
        return x.repeat(1, 3, 1, 1) if x.shape[1] == 1 else x

    fr, ff = net(prep(real)), net(prep(fake))
    if final_only:
        return torch.mean((fr[-1] - ff[-1]) ** 2)
    return sum(torch.mean((a - b) ** 2) for a, b in zip(fr, ff)) / len(fr)
