"""Excitation generators: the combtooth sinc comb and Nyquist masking of
harmonic amplitudes."""
from __future__ import annotations

import numpy as np
import torch


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
