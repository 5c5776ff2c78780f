"""WORLD-family F0 estimators: DIO (+ StoneMask refinement) and Harvest.

A copy of `ddsp_svc_tpu/data/world_f0.py` (host numpy; the port imports
nothing of the JAX package), held bit for bit to the original by
tests/test_torch_features.py. Parity target of both: the reference's pyworld
usage, `dio` = pw.dio + pw.stonemask, `harvest` = pw.harvest, as
re-implementations of the published algorithm structure (Morise's DIO /
StoneMask / Harvest):

- DIO: band-split the signal into per-octave-fraction lowpass channels so
  each channel isolates the fundamental for f0 in (fc/2, fc]; estimate four
  event-interval series per channel (rising/falling zero crossings, peaks,
  dips); pick the single most *stable* channel estimate per frame; fix the
  contour (jump + short-run removal); refine voiced frames with StoneMask.
- StoneMask: per-frame instantaneous-frequency refinement at the first few
  harmonics of the current estimate, amplitude-weighted, iterated.
- Harvest: many candidates per frame from a fine bandpass channel grid,
  each refined and scored by harmonic-IF consistency; the best per frame,
  then contour fixing (jumps, short runs, short gaps, median smoothing).

Event analysis runs on an FFT-resampled copy at <= 8 kHz, refinement at
<= 16 kHz. This is host work on every machine: it is timed apart from the
device stages.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["dio", "harvest", "stonemask"]


# --------------------------------------------------------------------------
# shared machinery
# --------------------------------------------------------------------------


def _next_fast_len(n: int) -> int:
    """Smallest 5-smooth integer >= n (pocketfft is dramatically slower on
    lengths with large prime factors — a 1.5M-sample file with a factor of
    211 cost ~2.5 s per transform)."""
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1:
            return n
        n += 1


def _fft_resample(x: np.ndarray, sr: float, target_sr: float) -> Tuple[np.ndarray, float]:
    """Band-limited resample via spectrum truncation. Returns (y, actual_sr);
    actual_sr is exact for the produced length (no cumulative drift). The
    transform runs zero-padded to a fast length; the padding only perturbs
    the last ~1/(bandwidth) seconds of the tail, far below the trackers'
    own noise floor."""
    if target_sr >= sr:
        return x.astype(np.float64, copy=False), float(sr)
    n = len(x)
    nf = _next_fast_len(n)
    n2f = _next_fast_len(max(16, int(round(nf * target_sr / sr))))
    spec = np.fft.rfft(x, nf)
    k2 = n2f // 2 + 1
    spec2 = spec[:k2] * (n2f / nf)
    y = np.fft.irfft(spec2, n2f)
    actual_sr = float(sr) * n2f / nf
    keep = min(len(y), int(math.ceil(n * actual_sr / sr)) + 1)
    return y[:keep], actual_sr


def _nuttall(n: int) -> np.ndarray:
    t = np.arange(n) / max(n - 1, 1)
    return (
        0.355768
        - 0.487396 * np.cos(2 * np.pi * t)
        + 0.144232 * np.cos(4 * np.pi * t)
        - 0.012604 * np.cos(6 * np.pi * t)
    )


def _fir_lowpass(sr: float, cutoff: float, periods: float = 3.0) -> np.ndarray:
    """Nuttall-windowed sinc lowpass, ~`periods` periods of `cutoff` per
    side. Time-LIMITED on purpose: a brickwall frequency response rings a
    tone's energy far into adjacent digital silence, which event-interval
    analysis then reads as a pitch (caught by
    tests/test_features.py::test_f0_silence_is_unvoiced_and_uv_interp)."""
    half = max(4, int(round(periods * sr / cutoff)))
    t = (np.arange(2 * half + 1) - half) / sr
    h = 2 * cutoff / sr * np.sinc(2 * cutoff * t)
    h = h * _nuttall(len(h))
    return h / h.sum()


def _fir_bandpass(sr: float, f_lo: float, f_hi: float) -> np.ndarray:
    """Windowed-sinc bandpass (difference of two matched-length lowpasses)."""
    half = max(4, int(round(2.0 * sr / f_lo)))
    t = (np.arange(2 * half + 1) - half) / sr
    w = _nuttall(len(t))
    lp_hi = 2 * f_hi / sr * np.sinc(2 * f_hi * t) * w
    lp_lo = 2 * f_lo / sr * np.sinc(2 * f_lo * t) * w
    return lp_hi - lp_lo


def _channel_filter_bank(x: np.ndarray, firs: List[np.ndarray]) -> List[np.ndarray]:
    """Zero-phase filter a signal with several FIRs from ONE forward FFT
    (padded to full linear convolution so nothing wraps around)."""
    pad = max(len(h) // 2 for h in firs)
    n = _next_fast_len(len(x) + 2 * pad)
    spec = np.fft.rfft(x, n)
    out = []
    for h in firs:
        c = len(h) // 2
        hh = np.zeros(n)
        hh[: len(h) - c] = h[c:]
        hh[n - c :] = h[:c]  # center the FIR at sample 0 => zero phase
        out.append(np.fft.irfft(spec * np.fft.rfft(hh), n)[: len(x)])
    return out


def _band_amplitude_at(y: np.ndarray, frame_pos: np.ndarray, halfwin: int) -> np.ndarray:
    """Local mean |y| around each frame position (cumsum; O(T))."""
    a = np.abs(y)
    cs = np.concatenate([[0.0], np.cumsum(a)])
    c = np.clip(np.round(frame_pos).astype(np.int64), 0, len(y) - 1)
    lo = np.maximum(c - halfwin, 0)
    hi = np.minimum(c + halfwin + 1, len(y))
    return (cs[hi] - cs[lo]) / np.maximum(hi - lo, 1)


def _event_times(y: np.ndarray) -> np.ndarray:
    """Sub-sample times (in samples) of negative→positive zero crossings."""
    neg = y < 0
    i = np.flatnonzero(neg[:-1] & ~neg[1:])
    if len(i) == 0:
        return np.empty(0)
    denom = y[i + 1] - y[i]
    frac = np.where(np.abs(denom) > 1e-30, -y[i] / denom, 0.5)
    return i + frac


def _interval_track(
    times: np.ndarray, sr: float, frame_pos: np.ndarray
) -> np.ndarray:
    """Event times -> f0 estimate at each frame position (0 where the frame
    lies outside the covered span or no two events exist)."""
    if len(times) < 2:
        return np.zeros(len(frame_pos))
    f = sr / np.diff(times)
    mid = 0.5 * (times[1:] + times[:-1])
    est = np.interp(frame_pos, mid, f)
    est[(frame_pos < mid[0]) | (frame_pos > mid[-1])] = 0.0
    return est


def _four_event_tracks(
    y: np.ndarray, sr: float, frame_pos: np.ndarray
) -> np.ndarray:
    """(n_frames, 4): rising ZC / falling ZC / peak / dip interval tracks."""
    dy = np.diff(y)
    tracks = [
        _interval_track(_event_times(y), sr, frame_pos),
        _interval_track(_event_times(-y), sr, frame_pos),
        _interval_track(_event_times(-dy), sr, frame_pos),  # peaks
        _interval_track(_event_times(dy), sr, frame_pos),  # dips
    ]
    return np.stack(tracks, axis=1)


def _candidate_from_tracks(
    tracks: np.ndarray, lo: float, hi: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Mean-of-four candidate + relative spread, masked to (lo, hi]."""
    valid = np.all(tracks > 0, axis=1)
    mean = np.where(valid, tracks.mean(axis=1), 0.0)
    in_range = (mean > lo) & (mean <= hi)
    ok = valid & in_range
    spread = np.where(
        ok, np.sqrt(np.maximum(tracks.var(axis=1), 0.0)) / np.maximum(mean, 1e-9), np.inf
    )
    return np.where(ok, mean, 0.0), spread


def _frame_positions(n_frames: int, hop_samples_orig: float, ratio: float) -> np.ndarray:
    """Frame centers (reference grid: n*hop at the original rate) mapped into
    a resampled signal's sample coordinates."""
    return np.arange(n_frames) * hop_samples_orig * ratio


def _remove_short_runs(f0: np.ndarray, min_run: int) -> np.ndarray:
    v = f0 > 0
    out = f0.copy()
    n = len(f0)
    i = 0
    while i < n:
        if v[i]:
            j = i
            while j < n and v[j]:
                j += 1
            if j - i < min_run:
                out[i:j] = 0.0
            i = j
        else:
            i += 1
    return out


def _kill_jumps(f0: np.ndarray, allowed: float) -> np.ndarray:
    """Zero frames that disagree with BOTH neighbors by more than `allowed`
    relative change (WORLD FixStep1/3 spirit, symmetric)."""
    v = f0 > 0
    prev = np.roll(f0, 1)
    nxt = np.roll(f0, -1)
    prev[0] = 0.0
    nxt[-1] = 0.0
    ok_prev = (prev > 0) & (np.abs(f0 - prev) < allowed * np.maximum(f0, 1e-9))
    ok_next = (nxt > 0) & (np.abs(f0 - nxt) < allowed * np.maximum(f0, 1e-9))
    lone = v & ~(np.roll(v, 1) | np.roll(v, -1))
    keep = v & (ok_prev | ok_next | lone)
    return np.where(keep, f0, 0.0)


# --------------------------------------------------------------------------
# instantaneous-frequency refinement (StoneMask core, shared with Harvest)
# --------------------------------------------------------------------------


def _refine_if(
    x: np.ndarray,
    sr: float,
    centers: np.ndarray,
    f0: np.ndarray,
    f0_floor: float,
    max_harmonics: int = 6,
    return_score: bool = False,
    chunk: int = 2048,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """One amplitude-weighted harmonic-IF refinement pass.

    centers :: frame centers in samples of `x`; f0 :: current estimates
    (0 = unvoiced, left untouched). Windows span 3 periods of the current
    estimate (hann); IF per harmonic k comes from the phase advance of the
    one-sample-shifted windowed DFT; refined f0 = Σ|X_k| (IF_k/k) / Σ|X_k|.
    With return_score: per-frame candidate score in [0, 1], the product of
    four calibrated terms (statistics measured on synthetic golden signals
    AND real 48 kHz voice, true-f vs 2f vs f/2 vs noise — see git history):
      agree      amplitude-weighted Gaussian agreement of IF_k/k with the
                 refined value (noise ⇒ harmonics disagree);
      pen_half   energy at HALF-harmonics (0.5f, 1.5f, 2.5f) relative to the
                 harmonics — an octave-too-HIGH candidate has perfectly
                 consistent harmonics, but the true odd harmonics land on
                 its half-harmonics (true r≈0.2-0.7, 2f candidates ≥2);
      pen_odd    odd-harmonic amplitude fraction — an octave-too-LOW
                 candidate sees only its even harmonics (true ≈0.6,
                 f/2 candidates ≈0.02);
      pen_energy fraction of window energy captured by the harmonics
                 (voiced ≈1.3-1.8, breath noise ≈0.1)."""
    n_frames = len(f0)
    out = f0.astype(np.float64).copy()
    score = np.zeros(n_frames) if return_score else None
    voiced_idx = np.flatnonzero(f0 > 0)
    if len(voiced_idx) == 0:
        return out, score

    # inner math in float32/complex64: the IF comes from a one-sample phase
    # difference, where float32 costs ~1e-3 Hz — far below the tracker's
    # own variance — and halves the DFT bank's wall time.
    l_max = int(math.ceil(3.0 * sr / max(f0_floor, 1e-3))) | 1
    half = l_max // 2
    xp = np.pad(x.astype(np.float32, copy=False), (half + 1, half + 2))
    rel = np.arange(l_max, dtype=np.float32) - half

    for s in range(0, len(voiced_idx), chunk):
        idx = voiced_idx[s : s + chunk]
        fz = out[idx].astype(np.float32)  # (C,)
        c = np.round(centers[idx]).astype(np.int64)
        g = c[:, None] + (np.arange(l_max) - half)[None, :] + half + 1  # into xp
        seg = xp[g]  # (C, L)
        seg1 = xp[g + 1]  # one-sample shift
        # per-frame 3-period hann (zero outside ±1.5 periods)
        u = rel[None, :] * (fz[:, None] / np.float32(sr)) / np.float32(1.5)
        w = np.where(np.abs(u) <= 1.0, 0.5 + 0.5 * np.cos(np.pi * u), 0.0).astype(np.float32)
        xw = seg * w
        xw1 = seg1 * w
        kmax = max_harmonics
        ks = np.arange(1, kmax + 1)
        # harmonics above (a conservative) Nyquist get zero weight
        k_ok = (ks[None, :] * fz[:, None]) < (0.47 * sr)
        # DFT at harmonics k*f via the recurrence e^{-i k w n} = (e^{-i w n})^k
        # — ONE cos/sin build of the fundamental phasor, then K-1 complex
        # multiplies, instead of a (C, L, K) trig basis (3-4x faster).
        theta1 = (np.float32(-2 * np.pi) / np.float32(sr)) * (fz[:, None] * rel[None, :])
        z = np.cos(theta1) + 1j * np.sin(theta1)  # (C, L) complex64
        cur1 = xw.astype(np.complex64)
        cur2 = xw1.astype(np.complex64)
        X1 = np.empty((len(fz), kmax), np.complex64)
        X2 = np.empty((len(fz), kmax), np.complex64)
        for k in range(kmax):
            cur1 = cur1 * z
            cur2 = cur2 * z
            X1[:, k] = cur1.sum(axis=1)
            X2[:, k] = cur2.sum(axis=1)
        if_k = np.angle(X2 * np.conj(X1)) * sr / (2 * np.pi)  # (C, K)
        est_k = if_k / ks[None, :]
        amp = np.abs(X1) * k_ok
        wsum = amp.sum(axis=1)
        refined = np.where(wsum > 1e-12, (amp * est_k).sum(axis=1) / np.maximum(wsum, 1e-12), fz)
        bad = ~np.isfinite(refined) | (refined < 0.5 * fz) | (refined > 2.0 * fz)
        refined = np.where(bad, fz, refined)
        out[idx] = refined
        if return_score:
            dev = np.abs(est_k - refined[:, None]) / np.maximum(refined[:, None], 1e-9)
            agree_k = np.exp(-((dev / 0.05) ** 2))
            agree = np.where(
                wsum > 1e-12, (amp * agree_k).sum(axis=1) / np.maximum(wsum, 1e-12), 0.0
            )
            n_used = np.maximum(k_ok.sum(axis=1), 1)
            hks = np.arange(3) + 0.5  # half-harmonics of the candidate
            h_ok = (hks[None, :] * fz[:, None]) < (0.47 * sr)
            zh = np.cos(0.5 * theta1) + 1j * np.sin(0.5 * theta1)
            cur_h = xw.astype(np.complex64) * zh
            amp_h = np.empty((len(fz), 3), np.float32)
            for k in range(3):  # 0.5f, 1.5f, 2.5f via full-harmonic steps
                amp_h[:, k] = np.abs(cur_h.sum(axis=1))
                if k < 2:
                    cur_h = cur_h * z
            amp_h = amp_h * h_ok
            r_half = (
                amp_h.sum(axis=1) / np.maximum(h_ok.sum(axis=1), 1)
            ) / np.maximum(wsum / n_used, 1e-12)
            pen_half = np.exp(-np.maximum(0.0, r_half - 0.7))
            odd_frac = amp[:, 0::2].sum(axis=1) / np.maximum(wsum, 1e-12)
            pen_odd = np.minimum(1.0, odd_frac / 0.4)
            w2 = (w ** 2).sum(axis=1)
            energy = (xw ** 2).sum(axis=1)
            hf = (amp ** 2).sum(axis=1) * 2.0 / np.maximum(w2 * energy, 1e-20)
            pen_energy = hf / (hf + 0.3)
            sc = agree * pen_half * pen_odd * pen_energy
            score[idx] = np.where(bad, 0.0, sc)
    return out, score


def stonemask(
    x: np.ndarray,
    sr: float,
    f0: np.ndarray,
    hop_size: float,
    f0_floor: float = 65.0,
    iterations: int = 2,
) -> np.ndarray:
    """Refine a frame-rate f0 track against the waveform (pyworld.stonemask
    counterpart — vocoder.py:74). Frames with f0==0 stay unvoiced."""
    y, sr_r = _fft_resample(np.asarray(x, np.float64), sr, 16000.0)
    centers = _frame_positions(len(f0), hop_size, sr_r / sr)
    out = np.asarray(f0, np.float64).copy()
    for _ in range(iterations):
        out, _ = _refine_if(y, sr_r, centers, out, f0_floor)
    return out.astype(np.float32)


# --------------------------------------------------------------------------
# DIO
# --------------------------------------------------------------------------


def dio(
    x: np.ndarray,
    sr: float,
    hop_size: float,
    f0_floor: float = 65.0,
    f0_ceil: float = 800.0,
    channels_in_octave: float = 2.0,
    spread_threshold: float = 0.12,
    allowed_jump: float = 0.18,
    with_stonemask: bool = True,
) -> np.ndarray:
    """DIO + (by default) StoneMask. x :: (T,) -> (T//hop + 1,) f0 [Hz].

    channels_in_octave=2.0 matches the reference call
    (the reference's ddsp/vocoder.py:72-73).

    Note: the coarse DIO track is clipped to f0_ceil, but StoneMask's
    instantaneous-frequency refinement may then drift slightly above it
    (bounded at 2x the coarse estimate by _refine_if). pyworld's
    dio+stonemask chain — what the reference actually runs — overshoots the
    same way, so the overshoot is kept for parity; consumers that need a
    hard f0 <= f0_ceil must clip downstream (uv_interp only clamps the
    floor)."""
    x = np.asarray(x, np.float64)
    n_frames = int(len(x) // hop_size) + 1
    if len(x) < 16 or not np.any(np.abs(x) > 1e-8):
        return np.zeros(n_frames, np.float32)

    y, sr_d = _fft_resample(x, sr, 8000.0)
    frame_pos = _frame_positions(n_frames, hop_size, sr_d / sr)

    n_oct = math.log2(f0_ceil / f0_floor)
    n_ch = int(math.ceil(n_oct * channels_in_octave)) + 1
    # channel fc list: each covers f0 ∈ (fc/2, fc]
    fcs = [f0_floor * 2.0 ** ((i + 1) / channels_in_octave) for i in range(n_ch)]
    fcs = [min(fc, f0_ceil * 1.1) for fc in fcs]
    filtered = _channel_filter_bank(y, [_fir_lowpass(sr_d, fc) for fc in fcs])

    # digital-silence guard: FFT roundoff leaves ~1e-12-level noise in the
    # filtered bands whose zero crossings would otherwise form "stable"
    # intervals; a band 1000x below the signal's RMS cannot be the
    # fundamental.
    amp_floor = 1e-3 * float(np.sqrt(np.mean(y**2)) + 1e-30)
    best_f0 = np.zeros(n_frames)
    best_spread = np.full(n_frames, np.inf)
    for fc, yf in zip(fcs, filtered):
        tracks = _four_event_tracks(yf, sr_d, frame_pos)
        lo = max(fc / 2.0, f0_floor * 0.98)
        hi = min(fc, f0_ceil * 1.02)
        cand, spread = _candidate_from_tracks(tracks, lo, hi)
        amp = _band_amplitude_at(yf, frame_pos, int(sr_d / fc))
        spread = np.where(amp > amp_floor, spread, np.inf)
        cand = np.where(amp > amp_floor, cand, 0.0)
        take = spread < best_spread
        best_f0 = np.where(take, cand, best_f0)
        best_spread = np.where(take, spread, best_spread)

    f0 = np.where(best_spread < spread_threshold, best_f0, 0.0)
    f0 = np.clip(f0, 0.0, f0_ceil)
    f0[f0 < f0_floor] = 0.0

    f0 = _kill_jumps(f0, allowed_jump)
    min_run = max(3, int(round(0.03 * sr / hop_size)))
    f0 = _remove_short_runs(f0, min_run)

    if with_stonemask:
        f0 = stonemask(x, sr, f0, hop_size, f0_floor)
    return np.asarray(f0, np.float32)


# --------------------------------------------------------------------------
# Harvest
# --------------------------------------------------------------------------


def _greedy_dedupe(
    cands: np.ndarray, spreads: np.ndarray, max_candidates: int
) -> np.ndarray:
    """Per-frame greedy candidate dedupe, vectorized over frames.

    For each frame: walk candidates in ascending-spread order, keep each one
    whose log2 distance to every already-kept pick exceeds 0.04 (>3%), stop
    at max_candidates. Equivalent to the per-frame Python loop (invalid
    candidates — f<=0 / inf spread — sort to the tail, so skipping them
    equals the loop's break) but runs as ~n_channels vector passes instead
    of one Python iteration per frame: this was the only non-vectorized hot
    spot in hours-scale preprocessing.
    """
    n_frames = cands.shape[0]
    order = np.argsort(spreads, axis=1)
    rows = np.arange(n_frames)
    f_sorted = cands[rows[:, None], order]
    sp_sorted = spreads[rows[:, None], order]
    valid = (f_sorted > 0) & np.isfinite(sp_sorted)
    logf = np.where(f_sorted > 0, np.log2(np.maximum(f_sorted, 1e-12)), 0.0)

    kept = np.zeros((n_frames, max_candidates))
    logk = np.zeros((n_frames, max_candidates))
    count = np.zeros(n_frames, dtype=np.int64)
    for j in range(f_sorted.shape[1]):
        lj = logf[:, j]
        ok = valid[:, j] & (count < max_candidates)
        for p in range(max_candidates):
            ok &= (count <= p) | (np.abs(lj - logk[:, p]) > 0.04)
        idx = np.where(ok)[0]
        kept[idx, count[idx]] = f_sorted[idx, j]
        logk[idx, count[idx]] = lj[idx]
        count[idx] += 1
    return kept


def harvest(
    x: np.ndarray,
    sr: float,
    hop_size: float,
    f0_floor: float = 65.0,
    f0_ceil: float = 800.0,
    channels_in_octave: float = 12.0,
    max_candidates: int = 6,
    score_threshold: float = 0.45,
    allowed_jump: float = 0.18,
) -> np.ndarray:
    """Harvest-style dense-candidate tracker. x :: (T,) -> (T//hop + 1,) [Hz].

    Counterpart of pyworld.harvest (the reference's ddsp/vocoder.py:78-85):
    candidates from a fine bandpass grid, each refined and scored by
    harmonic-IF consistency against the (≤16 kHz) waveform, best score wins,
    then contour fixing with short-gap interpolation (Harvest's contours are
    deliberately more continuous than DIO's)."""
    x = np.asarray(x, np.float64)
    n_frames = int(len(x) // hop_size) + 1
    if len(x) < 16 or not np.any(np.abs(x) > 1e-8):
        return np.zeros(n_frames, np.float32)

    y, sr_d = _fft_resample(x, sr, 8000.0)
    frame_pos = _frame_positions(n_frames, hop_size, sr_d / sr)

    n_oct = math.log2(f0_ceil / f0_floor)
    n_ch = int(math.ceil(n_oct * channels_in_octave)) + 1
    fcs = [f0_floor * 2.0 ** (i / channels_in_octave) for i in range(n_ch)]
    filtered = _channel_filter_bank(
        y, [_fir_bandpass(sr_d, fc / 1.68, fc * 1.68) for fc in fcs]
    )

    # ---- candidate generation (loose gating; scoring decides later) ----
    amp_floor = 1e-3 * float(np.sqrt(np.mean(y**2)) + 1e-30)
    cands = np.zeros((n_frames, len(fcs)))
    spreads = np.full((n_frames, len(fcs)), np.inf)
    for ci, (fc, yf) in enumerate(zip(fcs, filtered)):
        tracks = _four_event_tracks(yf, sr_d, frame_pos)
        cand, spread = _candidate_from_tracks(
            tracks, max(fc / 1.5, f0_floor * 0.9), min(fc * 1.5, f0_ceil * 1.05)
        )
        amp = _band_amplitude_at(yf, frame_pos, int(sr_d / fc))
        loose = (spread < 0.35) & (amp > amp_floor)
        cands[:, ci] = np.where(loose, cand, 0.0)
        spreads[:, ci] = np.where(loose, spread, np.inf)

    # dedupe per frame: sort by spread, greedily keep candidates >3% apart
    kept = _greedy_dedupe(cands, spreads, max_candidates)

    # ---- refine + score every candidate column against the waveform ----
    yr, sr_r = _fft_resample(x, sr, 16000.0)
    centers = _frame_positions(n_frames, hop_size, sr_r / sr)
    refined = np.zeros_like(kept)
    scores = np.zeros_like(kept)
    for j in range(max_candidates):
        col = kept[:, j]
        if not np.any(col > 0):
            continue
        r, s = _refine_if(yr, sr_r, centers, col, f0_floor, return_score=True)
        refined[:, j] = r
        scores[:, j] = s if s is not None else 0.0
    scores = np.where(
        (refined >= f0_floor) & (refined <= f0_ceil), scores, 0.0
    )

    best = np.argmax(scores, axis=1)
    rows = np.arange(n_frames)
    f0 = np.where(scores[rows, best] > score_threshold, refined[rows, best], 0.0)

    # ---- contour fixing ----
    f0 = _kill_jumps(f0, allowed_jump)
    min_run = max(3, int(round(0.03 * sr / hop_size)))
    f0 = _remove_short_runs(f0, min_run)
    f0 = _fill_short_gaps(f0, max_gap=max(2, int(round(0.02 * sr / hop_size))))
    f0 = _median3_voiced(f0)
    return np.asarray(f0, np.float32)


def _fill_short_gaps(f0: np.ndarray, max_gap: int) -> np.ndarray:
    """Linear-interpolate unvoiced gaps of <= max_gap frames BETWEEN voiced
    neighbors (Harvest emits continuous contours through brief dropouts)."""
    out = f0.copy()
    v = np.flatnonzero(f0 > 0)
    if len(v) < 2:
        return out
    for a, b in zip(v[:-1], v[1:]):
        gap = b - a - 1
        if 0 < gap <= max_gap:
            out[a + 1 : b] = np.interp(np.arange(a + 1, b), [a, b], [f0[a], f0[b]])
    return out


def _median3_voiced(f0: np.ndarray) -> np.ndarray:
    """3-point median smoothing applied only where all three frames are
    voiced (never creates or destroys voicing)."""
    if len(f0) < 3:
        return f0
    stack = np.stack([f0[:-2], f0[1:-1], f0[2:]])
    med = np.median(stack, axis=0)
    inner = np.all(stack > 0, axis=0)
    out = f0.copy()
    out[1:-1] = np.where(inner, med, f0[1:-1])
    return out
