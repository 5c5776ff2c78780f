"""Excitation generators: the combtooth sinc comb, Nyquist masking of
harmonic amplitudes, and the additive oscillator bank (plain version; the
card runs `ops/kernels.py::oscillator_bank`)."""
from __future__ import annotations

import numpy as np
import torch

from .interp import upsample_frames


def combtooth(rot: torch.Tensor, f0: torch.Tensor, sr: float,
              zero_unvoiced: bool = True) -> torch.Tensor:
    """(B, T), (B, T) -> (B, T): sinc(sr * rot / (f0 + 1e-3)), zeroed where
    f0 <= 0 when zero_unvoiced. The sine argument is wrapped to [-pi, pi]
    (x - 2*round(x/2) is exact to ulp(x))."""
    x = sr * rot / (f0 + 1e-3)
    xw = x - 2.0 * torch.round(0.5 * x)
    tooth = torch.where(x.abs() < 1e-6, torch.ones_like(x),
                        torch.sin(np.pi * xw) / (np.pi * x))
    if zero_unvoiced:
        tooth = torch.where(f0 <= 0.0, torch.zeros_like(tooth), tooth)
    return tooth


def remove_above_fmax(amplitudes: torch.Tensor, pitch: torch.Tensor,
                      fmax: float, level_start: int = 1) -> torch.Tensor:
    """Zero harmonic amplitudes above fmax, with the reference's 1e-7 floor.
    amplitudes :: (B, Frame, n_harm); pitch :: (B, Frame, 1)."""
    n_harm = amplitudes.shape[-1]
    levels = torch.arange(level_start, n_harm + level_start,
                          dtype=pitch.dtype, device=pitch.device)
    aa = (pitch * levels < fmax).to(amplitudes.dtype) + 1e-7
    return amplitudes * aa


def oscillator_bank(phase: torch.Tensor, amplitudes_frames: torch.Tensor,
                    block_size: int, harmonic_chunk: int = 32) -> torch.Tensor:
    """Additive harmonic synthesis, sum_k up(amp_k) * sin((k+1) * phase).
    phase (B, T) [rad]; amplitudes_frames (B, F, n_harm), upsampled linearly
    (last frame repeated) to T = F * block_size. Harmonics are taken
    `harmonic_chunk` at a time, so no (B, T, n_harm) tensor exists. The sine
    argument is wrapped to [-pi, pi] as the TPU kernel wraps it
    (`pallas_kernels.py::_osc_kernel`); the JAX package's XLA version does
    not wrap. Differentiable by autograd. Returns (B, T)."""
    n_harm = amplitudes_frames.shape[-1]
    out = torch.zeros_like(phase)
    for k0 in range(0, n_harm, harmonic_chunk):
        amp = upsample_frames(amplitudes_frames[..., k0:k0 + harmonic_chunk],
                              block_size)
        levels = torch.arange(k0 + 1, k0 + amp.shape[-1] + 1,
                              dtype=phase.dtype, device=phase.device)
        y = phase[..., None] * levels
        y = y - (2.0 * np.pi) * torch.round(y * (0.5 / np.pi))
        out = out + (amp * torch.sin(y)).sum(-1)
    return out
