"""Length masks for bucket-padded inputs. `valid_frames` is an int, a 0-d
tensor (one length for the whole batch) or a (B,) tensor (one per item)."""
from __future__ import annotations

import numbers

import torch


def _as_col(valid_frames, device) -> torch.Tensor:
    """valid_frames as a (B?, 1) tensor on `device`. An int is filled on the
    device (no host-to-device copy, which a captured CUDA graph forbids)."""
    if isinstance(valid_frames, numbers.Integral):
        return torch.full((1, 1), int(valid_frames), device=device)
    return torch.as_tensor(valid_frames, device=device).reshape(-1, 1)


def frame_mask(t: int, valid_frames, dtype=None, device=None) -> torch.Tensor:
    """0/1 mask of valid positions: (1, t) for a scalar, (B, t) for a
    (B,) vector."""
    m = torch.arange(t, device=device)[None, :] < _as_col(valid_frames, device)
    return m if dtype is None else m.to(dtype)


def valid_col(valid_frames, dtype=None, device=None) -> torch.Tensor:
    """valid_frames as a (B?, 1) column (scalar -> (1, 1))."""
    col = _as_col(valid_frames, device)
    return col if dtype is None else col.to(dtype)
