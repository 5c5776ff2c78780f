"""Frame-rate -> sample-rate linear upsampling (the reference's
align_corners upsampler: last frame repeated, last sample dropped), and the
nearest alignment of encoder frames to synth frames."""
from __future__ import annotations

import numpy as np
import torch


def upsample_frames(signal: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, Frame, Feat) -> (B, Frame*factor, Feat): output sample (f, s) is
    a[f] + (a[f+1] - a[f]) * s / factor with the last frame repeated."""
    b, n_frames, feat = signal.shape
    nxt = torch.cat([signal[:, 1:], signal[:, -1:]], dim=1)
    slope = nxt - signal
    w = torch.arange(factor, dtype=torch.float64, device=signal.device)
    w = (w / factor).to(signal.dtype)
    out = signal[:, :, None, :] + slope[:, :, None, :] * w[None, None, :, None]
    return out.reshape(b, n_frames * factor, feat)


def nearest_indices(n_frames: int, ratio: float, n_units: int) -> np.ndarray:
    """The encoder frame of each of n_frames synth frames: round(ratio i)
    (half to even, in float64 on the host), clipped to [0, n_units)."""
    return np.clip(np.round(ratio * np.arange(n_frames)).astype(np.int64),
                   0, n_units - 1)


def nearest_align(units: torch.Tensor, n_frames: int, ratio: float
                  ) -> torch.Tensor:
    """Nearest-neighbour alignment of encoder frames to synth frames:
    (B, RawFrame, Feat) -> (B, n_frames, Feat) (nearest_indices)."""
    idx = nearest_indices(n_frames, ratio, units.shape[1])
    return units[:, torch.as_tensor(idx, device=units.device), :]
