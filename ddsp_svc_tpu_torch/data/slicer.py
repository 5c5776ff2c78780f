"""RMS-threshold silence slicer.

A numpy copy of `ddsp_svc_tpu/data/slicer.py` (the port imports nothing of
the JAX package). Parity with the reference DDSP-SVC slicer.py: detect
silent regions via
frame RMS (20 ms hop, window = min(min_interval, 4*hop)), keep at most
`max_sil_kept` frames of silence around cuts, slice at minimum-RMS
positions, and return `{idx: {"slice": bool, "split_time": "start,end"}}`
in samples. Used by offline inference to split long inputs into voiced
segments (main.py:34-47,143).

The RMS framing matches librosa.feature.rms(center=True, pad_mode='constant').
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def frame_rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """librosa.feature.rms parity: zero-pad frame_length//2 both sides,
    centered frames, sqrt(mean(x^2))."""
    y = np.pad(y, (frame_length // 2, frame_length // 2))
    n = 1 + (len(y) - frame_length) // hop_length
    idx = np.arange(n)[:, None] * hop_length + np.arange(frame_length)[None, :]
    frames = y[idx]
    return np.sqrt(np.mean(frames.astype(np.float64) ** 2, axis=1))


class Slicer:
    def __init__(
        self,
        sr: int,
        threshold: float = -40.0,
        min_length: int = 5000,
        min_interval: int = 300,
        hop_size: int = 20,
        max_sil_kept: int = 5000,
    ):
        if not min_length >= min_interval >= hop_size:
            raise ValueError("min_length >= min_interval >= hop_size required")
        if not max_sil_kept >= hop_size:
            raise ValueError("max_sil_kept >= hop_size required")
        min_interval_samp = sr * min_interval / 1000
        self.threshold = 10 ** (threshold / 20.0)
        self.hop_size = round(sr * hop_size / 1000)
        self.win_size = min(round(min_interval_samp), 4 * self.hop_size)
        self.min_length = round(sr * min_length / 1000 / self.hop_size)
        self.min_interval = round(min_interval_samp / self.hop_size)
        self.max_sil_kept = round(sr * max_sil_kept / 1000 / self.hop_size)

    @staticmethod
    def _quietest(rms: np.ndarray, lo: int, hi: int) -> int:
        """Quietest frame of rms[lo..hi] (inclusive; clipped at the end)."""
        return lo + int(rms[lo: hi + 1].argmin())

    def _cut_points(self, rms: np.ndarray, run_start: int, run_end: int,
                    keep: int) -> Tuple[Tuple[int, int], int]:
        """Cut tag (frame range to discard) for one silence run, plus the
        start of the next voiced clip.

        A run of `dur` quiet frames keeps at most `keep` frames of silence on
        each side of the cut; the cut points are the quietest frames of the
        allowed windows (three regimes: whole run removable, windows
        overlapping, windows disjoint).
        """
        def quietest(lo: int, hi: int) -> int:
            return self._quietest(rms, lo, hi)

        dur = run_end - run_start
        leading = run_start == 0
        if dur <= keep:
            cut = quietest(run_start, run_end)
            tag = (0, cut) if leading else (cut, cut)
            return tag, cut
        left = quietest(run_start, run_start + keep)
        right = quietest(run_end - keep, run_end)
        if leading:
            return (0, right), right
        if dur <= 2 * keep:  # windows overlap: also consider their overlap
            mid = quietest(run_end - keep, run_start + keep)
            return (min(left, mid), max(right, mid)), max(right, mid)
        return (left, right), right

    def _detect_cuts(self, rms: np.ndarray) -> List[Tuple[int, int]]:
        """Silence runs -> cut tags [(start_frame, end_frame)] to remove."""
        total = len(rms)
        quiet = rms < self.threshold
        edges = np.diff(np.concatenate(([False], quiet, [False])).astype(np.int8))
        run_starts = np.flatnonzero(edges == 1)
        run_ends = np.flatnonzero(edges == -1)  # exclusive: first loud frame

        tags: List[Tuple[int, int]] = []
        clip_start = 0
        for s, e in zip(run_starts, run_ends):
            if e >= total:
                # trailing silence: cut to the end if long enough
                if total - s >= self.min_interval:
                    end = min(total, s + self.max_sil_kept)
                    tags.append((self._quietest(rms, s, end), total + 1))
                break
            long_leading = s == 0 and e > self.max_sil_kept
            splittable = (
                e - s >= self.min_interval
                and e - clip_start >= self.min_length
            )
            if not (long_leading or splittable):
                continue
            tag, clip_start = self._cut_points(rms, s, e, self.max_sil_kept)
            tags.append(tag)
        return tags

    def slice(self, waveform: np.ndarray) -> Dict[str, dict]:
        samples = waveform.mean(axis=0) if waveform.ndim > 1 else waveform
        # (reference quirk kept: min_length is in frames but compared against
        # the sample count — only ultra-short inputs take this early return)
        if samples.shape[0] <= self.min_length:
            return {"0": {"slice": False, "split_time": f"0,{len(waveform)}"}}
        rms = frame_rms(samples, self.win_size, self.hop_size)
        cuts = self._detect_cuts(rms)
        if not cuts:
            return {"0": {"slice": False, "split_time": f"0,{len(waveform)}"}}

        # assemble alternating voiced / silence chunks in sample space;
        # chunk ends are clipped to the waveform, starts are not (reference
        # contract: consumers compare start==end to drop empty chunks)
        t_end = len(waveform)
        hop = self.hop_size
        chunks: List[dict] = []

        def emit(is_silence: bool, a: int, b: int) -> None:
            chunks.append({"slice": is_silence, "split_time": f"{a},{b}"})

        if cuts[0][0] > 0:
            emit(False, 0, min(t_end, cuts[0][0] * hop))
        for j, (a, b) in enumerate(cuts):
            if j:
                emit(False, cuts[j - 1][1] * hop, min(t_end, a * hop))
            emit(True, a * hop, min(t_end, b * hop))
        if cuts[-1][1] * hop < t_end:
            emit(False, cuts[-1][1] * hop, t_end)
        return {str(i): c for i, c in enumerate(chunks)}


def cut(audio_path: str, db_thresh: float = -30, min_len: int = 5000):
    """Slice a wav file by silence (slicer.py:114-122 parity).
    Returns the chunk dict at native sample rate."""
    from .wavio import load_audio

    audio, sr = load_audio(audio_path, sr=None)
    slicer = Slicer(sr=sr, threshold=db_thresh, min_length=min_len)
    return slicer.slice(audio)


def chunks2audio(audio_path: str, chunks: Dict[str, dict]):
    """Materialize (is_silence, samples) segments from a chunk dict
    (slicer.py:125-136 parity)."""
    from .wavio import load_audio

    chunks = dict(chunks)
    audio, sr = load_audio(audio_path, sr=None, mono=True)
    result = []
    for v in chunks.values():
        tag = v["split_time"].split(",")
        if tag[0] != tag[1]:
            result.append((v["slice"], audio[int(tag[0]): int(tag[1])]))
    return result, sr


def split_segments(audio: np.ndarray, sr: int, hop_size: int, db_thresh: float = -60.0):
    """Silence-split a waveform into (start_frame, chunk) segments
    (main.py:34-47 parity: frame-aligned starts)."""
    slicer = Slicer(sr=sr, threshold=db_thresh)
    chunks = slicer.slice(audio)
    result = []
    for v in chunks.values():
        tag = v["split_time"].split(",")
        if tag[0] != tag[1]:
            start, end = int(tag[0]), int(tag[1])
            if not v["slice"]:
                start_frame = start // hop_size
                result.append((start_frame, audio[start_frame * hop_size : end]))
    return result
