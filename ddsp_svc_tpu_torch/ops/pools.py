"""NaN-masked 1-D pooling, used to smooth CREPE's f0 and periodicity.

Counterpart of `ddsp_svc_tpu/ops/pools.py`: reflect-pad ((k-1)//2, k//2),
then over each stride-1 window either the mean of its non-NaN entries
(count clamped to >= 1) or its (k-1)//2-th order statistic.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _windows(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """(B, T) -> (B, T, k): reflect-padded stride-1 windows."""
    xp = F.pad(x[:, None, :], ((kernel_size - 1) // 2, kernel_size // 2),
               mode="reflect")[:, 0, :]
    return xp.unfold(-1, kernel_size, 1)


def masked_avg_pool_1d(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """(B, T) -> (B, T); NaNs excluded from each window's average."""
    win = _windows(x, kernel_size)
    mask = ~torch.isnan(win)
    summed = torch.where(mask, win, torch.zeros_like(win)).sum(dim=-1)
    count = mask.to(x.dtype).sum(dim=-1).clamp(min=1.0)
    return summed / count


def median_pool_1d(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """(B, T) -> (B, T); the sliding (k-1)//2-th order statistic."""
    win = torch.sort(_windows(x, kernel_size), dim=-1).values
    return win[..., (kernel_size - 1) // 2]
