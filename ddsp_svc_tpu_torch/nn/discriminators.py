"""HiFi-GAN discriminators and the GAN losses.

Counterpart of `ddsp_svc_tpu/nn/discriminators.py`: the multi-period
discriminator (periods 2, 3, 5, 7, 11; strided 2-D convs over the audio
folded into (frames, period)), the multi-scale discriminator (three scales,
mean-pool downsampling) and the feature-matching and LSGAN losses. Convs
are plain, with no weight or spectral norm, as in JAX; they are dense
convs that JAX left to XLA, so they run on cuDNN. Module names follow the
reference's (`discriminators.{i}.convs.{j}`, `discriminators.{i}.conv_post`).

Layouts are torch's: a feature map of DiscriminatorP is (B, C, F, P), of
DiscriminatorS (B, C, T); JAX's are channel-last. The scores are (B, n) in
the same order on both sides.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.1
PERIODS = (2, 3, 5, 7, 11)
# DiscriminatorS: (out channels, kernel, stride, groups, padding)
SCALE_SPECS = ((128, 15, 1, 1, 7), (128, 41, 2, 4, 20),
               (256, 41, 2, 16, 20), (512, 41, 4, 16, 20),
               (1024, 41, 4, 16, 20), (1024, 41, 1, 16, 20),
               (1024, 5, 1, 1, 2))


class DiscriminatorP(nn.Module):
    """Period discriminator: reflect-pad the audio to a multiple of the
    period, fold it to (B, 1, T/p, p), four strided (5, 1) convs of 32,
    128, 512 and 1024 channels, a (5, 1) conv of 1024, a (3, 1) post conv."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = (kernel_size - 1) // 2
        chans = (1, 32, 128, 512, 1024)
        convs = [nn.Conv2d(c_in, c_out, (kernel_size, 1), (stride, 1),
                           padding=(pad, 0))
                 for c_in, c_out in zip(chans[:-1], chans[1:])]
        convs.append(nn.Conv2d(1024, 1024, (kernel_size, 1), 1,
                               padding=(2, 0)))
        self.convs = nn.ModuleList(convs)
        self.conv_post = nn.Conv2d(1024, 1, (3, 1), 1, padding=(1, 0))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x (B, T) -> (scores (B, n), feature maps)."""
        b, t = x.shape
        if t % self.period:
            pad = self.period - t % self.period
            x = F.pad(x[:, None], (0, pad), mode="reflect")[:, 0]
            t += pad
        x = x.reshape(b, 1, t // self.period, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class DiscriminatorS(nn.Module):
    """Scale discriminator: the grouped strided 1-D convs of SCALE_SPECS,
    then a post conv of 3."""

    def __init__(self):
        super().__init__()
        convs, c_in = [], 1
        for c_out, k, s, g, p in SCALE_SPECS:
            convs.append(nn.Conv1d(c_in, c_out, k, s, groups=g, padding=p))
            c_in = c_out
        self.convs = nn.ModuleList(convs)
        self.conv_post = nn.Conv1d(c_in, 1, 3, 1, padding=1)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x (B, T) -> (scores (B, n), feature maps)."""
        x = x[:, None]
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over windows of 4 at stride 2 after 2 zeros on each side (the
    zeros count): (B, T) -> (B, T // 2 + 1)."""
    return F.avg_pool1d(x[:, None], 4, 2, padding=2,
                        count_include_pad=True)[:, 0]


class _Multi(nn.Module):
    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """(real scores, generated scores, real feature maps, generated
        feature maps), one entry per sub-discriminator."""
        rs, fr = self.score(y)
        gs, fg = self.score(y_hat)
        return rs, gs, fr, fg


class MultiPeriodDiscriminator(_Multi):
    def __init__(self, periods: Sequence[int] = PERIODS):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorP(p)
                                            for p in periods)

    def score(self, x: torch.Tensor):
        """Each period's (scores, feature maps) of x (B, T), as two lists."""
        outs = [d(x) for d in self.discriminators]
        return [s for s, _ in outs], [f for _, f in outs]


class MultiScaleDiscriminator(_Multi):
    def __init__(self):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorS()
                                            for _ in range(3))

    def score(self, x: torch.Tensor):
        """Each scale's (scores, feature maps) of x (B, T), the audio
        mean-pooled before scales 1 and 2, as two lists."""
        scores, fmaps = [], []
        for i, d in enumerate(self.discriminators):
            if i:
                x = _avg_pool(x)
            s, f = d(x)
            scores.append(s)
            fmaps.append(f)
        return scores, fmaps


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """Feature-matching L1, summed over every map, times 2."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + (rl - gl).abs().mean()
    return loss * 2.0


def discriminator_loss(disc_real, disc_gen):
    """LSGAN: sum of mean (1 - real)^2 + mean gen^2; (loss, real terms,
    generated terms)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real, disc_gen):
        r = ((1.0 - dr) ** 2).mean()
        g = (dg ** 2).mean()
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    """LSGAN: sum of mean (1 - gen)^2; (loss, terms)."""
    gen_losses = [((1.0 - dg) ** 2).mean() for dg in disc_outputs]
    return sum(gen_losses), gen_losses
