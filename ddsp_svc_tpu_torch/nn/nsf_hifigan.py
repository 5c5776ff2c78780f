"""NSF-HiFiGAN generator (the enhancer), fp32.

Counterpart of `ddsp_svc_tpu/nn/nsf_hifigan.py`: the SineGen harmonic
source (9 sine channels, amplitude 0.1) merged by Linear(9 -> 1) + tanh,
then conv_pre k7 -> per stage [leaky(0.1) -> ConvTranspose upsample ->
+ f0-source injection conv -> mean of 3 ResBlock1] -> leaky(0.01) ->
conv_post k7 -> tanh. Module names follow the reference state dict
(`ups.{i}`, `noise_convs.{i}`, `resblocks.{n}.convs1.{m}`,
`m_source.l_linear`), with weight norm folded into plain weights.

Activations are channel-first inside; the public forward keeps the JAX
package's (B, F, num_mels) mel layout. The narrow stages (C <= 64) run
their injection conv and resblock trio through the hand-written kernel
(`ops.kernels.fused_resblocks_inject`); the wide stages (C = 256, 128)
stay on F.conv1d, as the JAX package left them to XLA.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels import (TRIO_CHANNELS, TRIO_KERNEL_SIZES,
                           fused_resblocks_inject, harmonic_source,
                           noise_conv_cf, resblock1_cf)
from ..ops.phase import _cumsum_mod1_compensated, _wrap

LRELU_SLOPE = 0.1


def _source_phase(f0_frames: torch.Tensor, upp: int, sr: int,
                  rand_ini: torch.Tensor, harmonic_num: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame-start rotations and per-sample rotation (SineGen phase
    bookkeeping). rand_ini is added to frame 0's per-sample rad before the
    cumulative sum, as the reference does, so every later frame inherits a
    wrapped offset of upp * rand_ini. Returns (start, rad), each (B, F, H)."""
    k = torch.arange(1, harmonic_num + 2, dtype=f0_frames.dtype,
                     device=f0_frames.device)
    rad = _wrap(f0_frames[..., None] * k / sr)
    rad = torch.cat([rad[:, :1] + rand_ini[:, None, :], rad[:, 1:]], dim=1)
    d = _wrap(rad * upp)
    end = _cumsum_mod1_compensated(d, dim=1)
    return _wrap(end - d), rad


def harmonic_source_fused(f0_frames: torch.Tensor, upp: int, sr: int,
                          rand_ini: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor, harmonic_num: int = 8,
                          sine_amp: float = 0.1) -> torch.Tensor:
    """Sine source + SourceModuleHnNSF merge, (B, F) f0 -> (B, F*upp, 1).
    The frame-rate phase scan stays plain torch; the per-sample part is
    the harmonic_source kernel on the card."""
    start, rad = _source_phase(f0_frames, upp, sr, rand_ini, harmonic_num)
    return harmonic_source(start.contiguous(), rad.contiguous(), w, b, upp,
                           sine_amp)[..., None]


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = tuple(dilation)
        k = kernel_size
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, k, dilation=d,
                      padding=(k * d - d) // 2) for d in self.dilation)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, k, padding=(k - 1) // 2)
            for _ in self.dilation)

    def stacked(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Weights (n_dil, 2, C, C, k) and biases (n_dil, 2, C)."""
        w = torch.stack([torch.stack([c1.weight, c2.weight])
                         for c1, c2 in zip(self.convs1, self.convs2)])
        b = torch.stack([torch.stack([c1.bias, c2.bias])
                         for c1, c2 in zip(self.convs1, self.convs2)])
        return w, b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, T) channel-first."""
        pairs = list(zip(self.convs1, self.convs2))
        return resblock1_cf(x, [(c1.weight, c2.weight) for c1, c2 in pairs],
                            [(c1.bias, c2.bias) for c1, c2 in pairs],
                            self.kernel_size, self.dilation)


class SourceModule(nn.Module):
    """Holds the Linear(9 -> 1) merge of SourceModuleHnNSF."""

    def __init__(self, harmonic_num: int = 8):
        super().__init__()
        self.l_linear = nn.Linear(harmonic_num + 1, 1)


class Generator(nn.Module):
    def __init__(self, sampling_rate: int, num_mels: int,
                 upsample_rates: Sequence[int],
                 upsample_kernel_sizes: Sequence[int],
                 upsample_initial_channel: int,
                 resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]]):
        super().__init__()
        self.sampling_rate = sampling_rate
        self.upsample_rates = tuple(upsample_rates)
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilation_sizes = tuple(
            tuple(d) for d in resblock_dilation_sizes)
        self.m_source = SourceModule()
        self.conv_pre = nn.Conv1d(num_mels, upsample_initial_channel, 7,
                                  padding=3)
        self.ups = nn.ModuleList()
        self.noise_convs = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        n_up = len(self.upsample_rates)
        for i, (u, k) in enumerate(zip(self.upsample_rates,
                                       upsample_kernel_sizes)):
            c_in = upsample_initial_channel // (2 ** i)
            ch = c_in // 2
            self.ups.append(nn.ConvTranspose1d(c_in, ch, k, u,
                                               padding=(k - u) // 2))
            if i + 1 < n_up:
                s = math.prod(self.upsample_rates[i + 1:])
                self.noise_convs.append(nn.Conv1d(1, ch, 2 * s, stride=s,
                                                  padding=s // 2))
            else:
                self.noise_convs.append(nn.Conv1d(1, ch, 1))
            for rk, rd in zip(self.resblock_kernel_sizes,
                              self.resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(ch, rk, rd))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def _use_fused(self, ch: int) -> bool:
        """The JAX package's gate for its fp32 trio kernel (C <= 64, three
        resblocks sharing one dilation schedule), narrowed to the widths the
        kernel instantiates."""
        return (ch in TRIO_CHANNELS
                and self.resblock_kernel_sizes == TRIO_KERNEL_SIZES
                and len(set(self.resblock_dilation_sizes)) == 1)

    def forward(self, mel: torch.Tensor, f0_frames: torch.Tensor,
                rand_ini: torch.Tensor) -> torch.Tensor:
        """mel (B, F, num_mels); f0_frames (B, F); rand_ini (B, 9).
        Returns (B, F * prod(upsample_rates))."""
        upp = math.prod(self.upsample_rates)
        lin = self.m_source.l_linear
        har = harmonic_source_fused(f0_frames, upp, self.sampling_rate,
                                    rand_ini, lin.weight[0], lin.bias)
        har_cf = har.transpose(1, 2)
        x = self.conv_pre(mel.transpose(1, 2))
        n_k = len(self.resblock_kernel_sizes)
        n_up = len(self.upsample_rates)
        for i in range(n_up):
            s = math.prod(self.upsample_rates[i + 1:]) if i + 1 < n_up else 1
            x = self.ups[i](F.leaky_relu(x, LRELU_SLOPE))
            nc = self.noise_convs[i]
            rbs = self.resblocks[i * n_k:(i + 1) * n_k]
            if self._use_fused(x.shape[1]):
                stacks = [rb.stacked() for rb in rbs]
                x = fused_resblocks_inject(
                    x.transpose(1, 2), har, nc.weight, nc.bias,
                    [w for w, _ in stacks], [b for _, b in stacks], s,
                    self.resblock_dilation_sizes[0],
                ).transpose(1, 2)
            else:
                x = x + noise_conv_cf(har_cf, nc.weight, nc.bias, s,
                                      x.shape[-1])
                x = sum(rb(x) for rb in rbs) / n_k
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x)[:, 0, :]


def generator_from_h(h: dict) -> Generator:
    return Generator(
        sampling_rate=h["sampling_rate"],
        num_mels=h["num_mels"],
        upsample_rates=h["upsample_rates"],
        upsample_kernel_sizes=h["upsample_kernel_sizes"],
        upsample_initial_channel=h["upsample_initial_channel"],
        resblock_kernel_sizes=h["resblock_kernel_sizes"],
        resblock_dilation_sizes=h["resblock_dilation_sizes"],
    )

