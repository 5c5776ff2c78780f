"""Feature extraction: f0, volume and acoustic units.

Counterpart of `ddsp_svc_tpu/data/features.py`:
  - F0Extractor in the reference's four families, one frame contract for
    all (n_frames = len//hop + 1, `silence_front` skipping, `uv_interp`
    filling unvoiced frames, clamped to f0_min):
      'parselmouth': Praat-style autocorrelation candidates on the device
        (`autocorr_candidates`), the best path through them host numpy
        (`_viterbi_track`);
      'dio' / 'harvest': WORLD-family trackers, host numpy (`world_f0.py`);
      'crepe': the CREPE network on the device, median pool 4 of the
        periodicity, periodicity < 0.05 -> unvoiced, NaN-masked average
        pool 4, the 5 ms grid resampled nearest onto the hop grid.
    The default backend is the port's torch one; 'native' and 'auto' run
    the parselmouth family on the C++ NCCF host library (`native/`, built
    at first use), as the JAX package's do. Unlike JAX, 'auto' never falls
    back to the device tracker: it raises when the library cannot be built.
  - VolumeExtractor: frame RMS.
  - UnitsEncoder: resample to the encoder's rate -> HuBERT -> nearest
    alignment onto the synth hop; weights from a torch checkpoint, the JAX
    package's flax variables (`.ckpt` / `.msgpack`) or a seed.
The torch families and the units encoder run on CUDA unless the caller
passes device="cpu".
"""
from __future__ import annotations

import math
import pickle
import warnings
from typing import Optional

import numpy as np
import torch

from ..nn.crepe import CrepeExtractor
from ..nn.hubert import HubertSoft, init_hubert_, load_hubert_state_dict
from ..ops.interp import nearest_align
from ..ops.pools import masked_avg_pool_1d, median_pool_1d
from ..ops.resample import resample
from ..ops.spectral import next_pow2
from ..ops.volume import extract_volume_np
from ..ops.windows import hann_window_symmetric
from ..utils.convert import jax_hubert_to_torch
from ..utils.device import resolve_device
from ..utils.flax_msgpack import read_msgpack
from .. import native
from . import world_f0

F0_FAMILIES = ("parselmouth", "dio", "harvest", "crepe")
F0_BACKENDS = ("torch", "native", "auto")


def autocorr_candidates(frames: torch.Tensor, sr: int, f0_min: float,
                        f0_max: float, top_k: int = 4):
    """Per-frame pitch candidates: local maxima of the normalised
    autocorrelation (window-compensated, Praat's octave cost), parabolic lag
    refinement. frames (N, W) -> (freqs (N, K) [Hz], strengths (N, K) in
    [0, 1]). The K best peaks are taken by a stable descending sort, so ties
    (frames with fewer than K peaks tie at -inf) go to the lower lag, as
    jax.lax.top_k orders them."""
    win = frames.shape[-1]
    frames = frames - frames.mean(dim=-1, keepdim=True)
    w = hann_window_symmetric(win, dtype=frames.dtype, device=frames.device)
    fft_size = next_pow2(2 * win)
    spec = torch.fft.rfft(frames * w, fft_size)
    power = spec.real * spec.real + spec.imag * spec.imag
    r = torch.fft.irfft(torch.complex(power, torch.zeros_like(power)),
                        fft_size)[..., :win]
    rw = torch.fft.irfft(torch.fft.rfft(w, fft_size).abs() ** 2,
                         fft_size)[:win]
    rn = (r / (r[..., :1] + 1e-12)) * (rw[0] / (rw + 1e-12))

    lag_min = max(2, int(math.floor(sr / f0_max)))
    lag_max = min(win - 2, int(math.ceil(sr / f0_min)))
    lags = torch.arange(win, device=frames.device)
    valid = (lags >= lag_min) & (lags <= lag_max)
    is_peak = (rn > torch.roll(rn, 1, dims=-1)) & (rn >= torch.roll(rn, -1, dims=-1))
    octave_pen = 0.01 * torch.log2(lags.clamp(min=1).to(frames.dtype)
                                   * (f0_min / sr))
    rn_masked = torch.where(valid[None, :] & is_peak, rn - octave_pen[None, :],
                            torch.full_like(rn, -math.inf))
    strengths, peaks = torch.sort(rn_masked, dim=-1, descending=True,
                                  stable=True)
    strengths, peaks = strengths[:, :top_k], peaks[:, :top_k]

    p0 = torch.gather(rn, -1, (peaks - 1).clamp(min=0))
    p1 = torch.gather(rn, -1, peaks)
    p2 = torch.gather(rn, -1, (peaks + 1).clamp(max=win - 1))
    denom = p0 - 2 * p1 + p2
    delta = torch.where(denom.abs() > 1e-12, 0.5 * (p0 - p2) / denom,
                        torch.zeros_like(denom)).clamp(-0.5, 0.5)
    freqs = sr / (peaks.to(frames.dtype) + delta).clamp(min=1.0)
    silent = (r[..., :1] / win) < 1e-8
    strengths = torch.where(torch.isfinite(strengths) & ~silent,
                            strengths.clamp(0.0, 1.0),
                            torch.zeros_like(strengths))
    return freqs, strengths


def _viterbi_track(
    freqs: np.ndarray,
    strengths: np.ndarray,
    voicing_threshold: float = 0.45,
    octave_jump_cost: float = 0.35,
    voiced_unvoiced_cost: float = 0.14,
) -> np.ndarray:
    """Praat-style best-path search over per-frame candidates + an unvoiced
    state. Maximizes sum(strength) - transition costs. Returns f0 (N,)
    with 0 for unvoiced frames."""
    n, k = freqs.shape
    # state k == unvoiced, with constant pseudo-strength
    cand_f = np.concatenate([freqs, np.zeros((n, 1))], axis=1)
    cand_s = np.concatenate(
        [strengths, np.full((n, 1), voicing_threshold)], axis=1
    )
    ks = k + 1
    logf = np.where(cand_f > 0, np.log2(np.maximum(cand_f, 1e-6)), 0.0)

    score = cand_s[0].copy()
    ptr = np.zeros((n, ks), dtype=np.int32)
    for t in range(1, n):
        # transition cost matrix (prev ks) x (cur ks)
        prev_v = cand_f[t - 1] > 0
        cur_v = cand_f[t] > 0
        jump = np.abs(logf[t - 1][:, None] - logf[t][None, :])
        cost = np.where(
            prev_v[:, None] & cur_v[None, :],
            octave_jump_cost * jump,
            np.where(prev_v[:, None] == cur_v[None, :], 0.0, voiced_unvoiced_cost),
        )
        total = score[:, None] - cost
        ptr[t] = np.argmax(total, axis=0)
        score = total[ptr[t], np.arange(ks)] + cand_s[t]

    path = np.zeros(n, dtype=np.int32)
    path[-1] = int(np.argmax(score))
    for t in range(n - 2, -1, -1):
        path[t] = ptr[t + 1][path[t + 1]]
    return cand_f[np.arange(n), path].astype(np.float32)


@torch.no_grad()
def autocorr_f0(audio: np.ndarray, sr: int, hop: float, f0_min: float,
                f0_max: float, win: int, device) -> np.ndarray:
    """The 'parselmouth' family: (T,) -> (T//hop + 1,) [Hz]. Windows of
    `win` samples centred on round(n hop) (fractional hops taken), framed
    and analysed on the device, tracked on the host."""
    n_frames = int(len(audio) // hop) + 1
    half = win // 2
    x = torch.as_tensor(np.pad(audio, (half, half + win)), device=device)
    pos = torch.as_tensor(np.round(np.arange(n_frames) * hop).astype(np.int64),
                          device=device)
    idx = (pos[:, None] + torch.arange(win, device=device)[None, :]).clamp(
        max=x.shape[0] - 1)
    freqs, strengths = autocorr_candidates(x[idx], sr, float(f0_min),
                                           float(f0_max))
    return _viterbi_track(freqs.cpu().numpy(), strengths.cpu().numpy())


class F0Extractor:
    def __init__(self, f0_extractor: str, sample_rate: int = 44100,
                 hop_size: float = 512, f0_min: float = 65,
                 f0_max: float = 800, backend: str = "torch", device=None):
        """backend selects the parselmouth family's implementation:
        'torch' (candidates on the device, the path search on the host),
        'native' (the C++ NCCF host library, `native/`, built at first use:
        the CPU fast path for preprocessing) or 'auto'. In the JAX package
        'auto' means native if it builds, else the device tracker; here it
        means native and raises when the library cannot be built or loaded,
        so a missing compiler never changes the f0 quietly. The backend does
        not apply to dio, harvest and crepe. device: where the torch
        families (parselmouth on 'torch', crepe) run; the others run on the
        host."""
        if f0_extractor not in F0_FAMILIES:
            raise ValueError(f" [x] Unknown f0 extractor: {f0_extractor}")
        if backend not in F0_BACKENDS:
            raise ValueError(f" [x] Unknown f0 backend: {backend}")
        self.f0_extractor = f0_extractor
        self.native = backend != "torch" and f0_extractor == "parselmouth"
        self.sample_rate = sample_rate
        self.hop_size = hop_size
        self.f0_min = f0_min
        self.f0_max = f0_max
        on_device = f0_extractor == "crepe" or (
            f0_extractor == "parselmouth" and not self.native)
        self.device = resolve_device(device) if on_device else None
        # analysis window: ~3 periods of f0_min (Praat AC convention)
        self.win = next_pow2(int(3 * sample_rate / f0_min))
        self._crepe = None

    def extract(self, audio: np.ndarray, uv_interp: bool = False,
                silence_front: float = 0) -> np.ndarray:
        """(T,) -> (T//hop + 1,) f0 [Hz]; 0 = unvoiced."""
        audio = np.asarray(audio, dtype=np.float32)
        n_frames = int(len(audio) // self.hop_size) + 1
        start_frame = int(silence_front * self.sample_rate / self.hop_size)
        real_silence_front = start_frame * self.hop_size / self.sample_rate
        audio_trim = audio[int(np.round(real_silence_front * self.sample_rate)):]

        if self.f0_extractor == "crepe":
            f0 = self._extract_crepe(audio_trim, n_frames - start_frame)
        elif self.f0_extractor in ("dio", "harvest"):
            f0 = getattr(world_f0, self.f0_extractor)(
                audio_trim, self.sample_rate, self.hop_size, self.f0_min,
                self.f0_max)
        elif self.native:
            f0 = native.extract_f0_native(
                audio_trim, self.sample_rate, self.hop_size, self.f0_min,
                self.f0_max, self.win)
        else:
            f0 = autocorr_f0(audio_trim, self.sample_rate, self.hop_size,
                             self.f0_min, self.f0_max, self.win, self.device)

        f0 = np.pad(f0.astype(np.float32), (start_frame, 0))
        if len(f0) < n_frames:
            f0 = np.pad(f0, (0, n_frames - len(f0)))
        f0 = f0[:n_frames]

        if uv_interp:
            uv = f0 == 0
            if (~uv).any():
                f0[uv] = np.interp(np.where(uv)[0], np.where(~uv)[0], f0[~uv])
            f0[f0 < self.f0_min] = self.f0_min
        return f0

    def _extract_crepe(self, audio: np.ndarray, n_frames: int) -> np.ndarray:
        if self._crepe is None:
            self._crepe = CrepeExtractor(self.f0_min, self.f0_max,
                                         device=self.device)
        wav16k = resample(torch.as_tensor(audio, device=self.device)[None],
                          self.sample_rate, 16000)[0]
        f0_5ms, pd = self._crepe.predict(wav16k)
        pd = median_pool_1d(torch.from_numpy(pd)[None], 4)[0].numpy()
        f0_5ms = np.where(pd < 0.05, np.nan, f0_5ms)
        f0_5ms = masked_avg_pool_1d(torch.from_numpy(f0_5ms)[None], 4)[0].numpy()
        f0_5ms = np.nan_to_num(f0_5ms)
        # nearest resample from the 5 ms grid onto the hop grid
        idx = np.minimum(
            np.round(np.arange(n_frames) * self.hop_size / self.sample_rate
                     / 0.005).astype(int),
            len(f0_5ms) - 1,
        )
        return f0_5ms[idx]


class VolumeExtractor:
    def __init__(self, hop_size: float = 512):
        self.hop_size = hop_size

    def extract(self, audio: np.ndarray) -> np.ndarray:
        return extract_volume_np(np.asarray(audio, dtype=np.float32),
                                 self.hop_size)


class UnitsEncoder:
    """Audio -> units aligned to the synthesizer's frame grid. encoder: one
    of `nn.hubert.VARIANTS`; encoder_ckpt: a torch checkpoint (the bshall
    HuBERT-soft layout or fairseq's), the JAX package's flax HuBERT
    variables serialized with msgpack (`.ckpt` or `.msgpack`), or None for
    weights from `seed`.
    The checkpoint is read with torch.load(weights_only=True); a file that
    pickles other objects beside its tensors (fairseq saves its run
    configuration so) is refused unless trust_pickle is set, because a full
    unpickle runs whatever code the file names."""

    def __init__(self, encoder: str, encoder_ckpt: Optional[str],
                 encoder_sample_rate: int = 16000, encoder_hop_size: int = 320,
                 device=None, seed: int = 0, trust_pickle: bool = False):
        self.device = resolve_device(device)
        self.encoder = encoder
        self.encoder_sample_rate = encoder_sample_rate
        self.encoder_hop_size = encoder_hop_size
        self.model = HubertSoft.variant(encoder)
        if encoder_ckpt:
            load_hubert_state_dict(self.model,
                                   self._load_ckpt(encoder_ckpt, trust_pickle))
        else:
            warnings.warn(
                f" [!] no checkpoint for units encoder '{encoder}': using "
                "RANDOM weights. Unit embeddings will be garbage; set "
                "data.encoder_ckpt for real conversions (random weights are "
                "only meant for tests and benchmarks).",
                RuntimeWarning, stacklevel=2)
            init_hubert_(self.model, torch.Generator().manual_seed(seed))
        self.model = self.model.to(self.device).eval()

    @staticmethod
    def _load_ckpt(path: str, trust_pickle: bool = False):
        if path.endswith((".ckpt", ".msgpack")):
            # the JAX package's flax variables ({'params': ...}), read by
            # the port's own msgpack reader
            return jax_hubert_to_torch(read_msgpack(path))
        try:
            return torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError as e:
            if not trust_pickle:
                raise ValueError(
                    f"{path} pickles objects beside its tensors (fairseq "
                    "saves its run configuration so); loading it in full runs "
                    "the code it names. If you trust the file, set "
                    "data.encoder_trust_pickle (UnitsEncoder(trust_pickle="
                    "True)), or save its state dict alone") from e
        warnings.warn(f"unpickling {path} in full (trust_pickle is set)",
                      RuntimeWarning, stacklevel=3)
        return torch.load(path, map_location="cpu", weights_only=False)

    @torch.no_grad()
    def encode(self, audio: np.ndarray, sample_rate: int, hop_size: float
               ) -> np.ndarray:
        """(B, T) at sample_rate -> (B, T//hop + 1, C) units."""
        n_frames = int(audio.shape[-1] // hop_size) + 1
        ratio = (hop_size / sample_rate) / (
            self.encoder_hop_size / self.encoder_sample_rate)
        x = torch.as_tensor(np.asarray(audio, np.float32), device=self.device)
        if sample_rate != self.encoder_sample_rate:
            x = resample(x, int(sample_rate), self.encoder_sample_rate)
        units = nearest_align(self.model(x), n_frames, float(ratio))
        return units.cpu().numpy()
