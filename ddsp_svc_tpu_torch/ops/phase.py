"""Phase accumulation in double-single (hi, lo) fp32 arithmetic.

Frame-rate phase is a prefix sum modulo 1. The reference takes it in fp64;
here, as in `ddsp_svc_tpu/ops/phase.py`, it is a compensated two-float scan
whose carries are exact to ~2^-45, built from error-free TwoSum/TwoProduct
steps. Those steps rely on every operation rounding on its own: eager
PyTorch elementwise ops do so on the CPU and on CUDA. Never wrap these
functions in torch.compile, which may fuse them into FMAs.

The scan is a Hillis-Steele inclusive scan: log2(n) vectorized combine
steps, so a frame-rate scan costs about ten elementwise passes on the card
rather than one launch per frame.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """x - round(x): wrap to (-0.5, 0.5] (round is ties-to-even)."""
    return x - torch.round(x)


def _two_sum(a, b):
    """Knuth TwoSum: s + err == a + b exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _fast_two_sum(a, b):
    """Dekker FastTwoSum (|a| >= |b| roughly)."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    """Dekker split with factor 2^12 + 1: a == hi + lo, 12 mantissa bits
    each."""
    c = a * 4097.0
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """Dekker TwoProduct: p + err == a * b exactly (no FMA needed)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _div_ds(hi, lo, d: float):
    """Double-single (hi + lo) / scalar d -> double-single quotient."""
    q1 = hi / d
    p, pe = _two_prod(q1, torch.full_like(q1, d))
    q2 = ((hi - p) - pe + lo) / d
    return _fast_two_sum(q1, q2)


def _combine(a_hi, a_lo, b_hi, b_lo):
    s, e = _two_sum(a_hi, b_hi)
    s = _wrap(s)
    lo = a_lo + b_lo + e
    hi, lo = _fast_two_sum(s, lo)
    return _wrap(hi), lo


def _cumsum_mod1_compensated(x: torch.Tensor, dim: int = -1,
                             x_lo: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Inclusive prefix sum modulo 1 in double-single arithmetic; x_lo are
    optional low words of double-single inputs. Returns wrapped fp32."""
    hi = _wrap(x)
    lo = torch.zeros_like(hi) if x_lo is None else x_lo
    n = hi.shape[dim]
    s = 1
    while s < n:
        c_hi, c_lo = _combine(hi.narrow(dim, 0, n - s), lo.narrow(dim, 0, n - s),
                              hi.narrow(dim, s, n - s), lo.narrow(dim, s, n - s))
        hi = torch.cat([hi.narrow(dim, 0, s), c_hi], dim)
        lo = torch.cat([lo.narrow(dim, 0, s), c_lo], dim)
        s *= 2
    return _wrap(hi + lo)


def frame_totals(a: torch.Tensor, nxt: torch.Tensor, block: int, sr: int):
    """Each frame's rotation total (block a + (block - 1) / 2 (nxt - a)) / sr
    [turns] of f0 lerped from a to nxt over the frame, as an exact
    double-single pair (hi, lo)."""
    t1_hi, t1_lo = _two_prod(torch.full_like(a, float(block)), a)
    sl_hi, sl_lo = _two_sum(nxt, -a)
    half = float(np.float32((block - 1) / 2.0))
    t2_hi, t2_lo = _two_prod(sl_hi, torch.full_like(a, half))
    t2_lo = t2_lo + sl_lo * half
    s_hi, e1 = _two_sum(t1_hi, t2_hi)
    s_lo = t1_lo + t2_lo + e1
    s_hi, s_lo = _fast_two_sum(s_hi, s_lo)
    return _div_ds(s_hi, s_lo, float(np.float32(sr)))


def frame_inner(a: torch.Tensor, slope: torch.Tensor, block: int,
                sr: int) -> torch.Tensor:
    """The inclusive rotation within a frame, ((s + 1) a + s (s + 1) /
    (2 block) slope) / sr for s < block, in the closed form of the lerped
    f0's prefix sum: (...,) -> (..., block), not wrapped."""
    s = torch.arange(block, dtype=a.dtype, device=a.device)
    tri = (s * (s + 1.0)) * float(np.float32(0.5 / block))
    return ((s + 1.0) * a[..., None] + tri * slope[..., None]) / sr


def frame_carry(f0_frames: torch.Tensor, block: int, sr: int
                ) -> torch.Tensor:
    """The wrapped rotation before each frame's first sample: the exclusive
    prefix sum of the frame totals (the next frame's f0 lerped), as the
    compensated scan gives it. (B, F) [Hz] -> (B, F) [turns]. A time
    shard's window starts its phase at this (`parallel/timeparallel.py`)."""
    a = f0_frames
    nxt = torch.cat([a[:, 1:], a[:, -1:]], dim=1)
    s_hi, s_lo = frame_totals(a, nxt, block, sr)
    # exclusive prefix via zero-prepend
    zeros = torch.zeros_like(s_hi[:, :1])
    shifted_hi = torch.cat([zeros, s_hi[:, :-1]], dim=1)
    shifted_lo = torch.cat([zeros, s_lo[:, :-1]], dim=1)
    return _cumsum_mod1_compensated(shifted_hi, dim=1, x_lo=shifted_lo)


def f0_to_rot_upsampled(f0_frames: torch.Tensor, block: int, sr: int,
                        initial_phase: Optional[torch.Tensor] = None,
                        carry: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Wrapped rotations (-0.5, 0.5] of the linearly upsampled f0.

    (B, F) [Hz] -> (B, F*block). Within a frame the prefix sum of the
    upsampled f0 is an arithmetic series with a closed form; only the
    per-frame totals go through the compensated scan, as exact double-single
    pairs. carry: (B, F) [turns], each frame's rotation before its first
    sample taken from a longer sequence's `frame_carry` (a time shard's
    window of it), in place of these frames' own prefix sums.
    """
    a = f0_frames
    nxt = torch.cat([a[:, 1:], a[:, -1:]], dim=1)
    if carry is None:
        carry = frame_carry(a, block, sr)
    inner = frame_inner(a, nxt - a, block, sr)
    rot = _wrap(_wrap(inner) + carry[..., None])
    if initial_phase is not None:
        rot = _wrap(rot + initial_phase[..., None, None].to(rot.dtype)
                    / (2.0 * np.pi))
    b, f = a.shape
    return rot.reshape(b, f * block)
