"""NSF-HiFiGAN enhancer front end.

Counterpart of `ddsp_svc_tpu/infer/enhancer.py` (`NsfHifiGAN`,
`Enhancer.enhance`): the f0 re-grid onto the enhancer's frame grid, the
log-mel frontend and the generator forward. Adaptive key (which needs the
resampler) and checkpoint loading are not ported yet and raise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..nn.layers import lecun_init_
from ..nn.nsf_hifigan import generator_from_h
from ..ops.spectral import log_mel_spectrogram
from ..utils.device import resolve_device


class NsfHifiGAN:
    """Generator + its config dict `h`. model_path=None draws the weights
    from `seed`."""

    def __init__(self, model_path: Optional[str], h: Optional[dict] = None,
                 seed: int = 0, device=None):
        if model_path is not None:
            raise NotImplementedError(
                "loading NSF-HiFiGAN checkpoints is not ported yet")
        if h is None:
            raise ValueError("h (the generator config) is required")
        self.device = resolve_device(device)
        self.h = h
        self.model = generator_from_h(h)
        lecun_init_(self.model, torch.Generator().manual_seed(seed))
        self.model = self.model.to(self.device).eval()

    @property
    def sample_rate(self) -> int:
        return int(self.h["sampling_rate"])

    @property
    def hop_size(self) -> int:
        return int(self.h["hop_size"])

    @torch.no_grad()
    def __call__(self, audio: torch.Tensor, f0_frames: torch.Tensor,
                 rand_ini: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, int]:
        """audio (B, T), f0_frames (B, F) on the enhancer's device.
        rand_ini (B, 9): the SineGen initial rotations (column 0 is 0);
        drawn from `generator` when given, zeros otherwise."""
        h = self.h
        b = audio.shape[0]
        if rand_ini is None:
            rand_ini = torch.zeros((b, 9), device=audio.device)
            if generator is not None:
                rand_ini[:, 1:] = torch.rand((b, 8), generator=generator,
                                             device=audio.device)
        mel = log_mel_spectrogram(
            audio, h["sampling_rate"], h["n_fft"], h["hop_size"],
            h["win_size"], h["num_mels"], h["fmin"], h["fmax"],
        ).transpose(1, 2)
        out = self.model(mel, f0_frames[:, :mel.shape[1]], rand_ini)
        return out, self.sample_rate


class Enhancer:
    def __init__(self, enhancer_type: str, enhancer_ckpt: Optional[str],
                 h: Optional[dict] = None, seed: int = 0, device=None):
        if enhancer_type != "nsf-hifigan":
            raise ValueError(f" [x] Unknown enhancer: {enhancer_type}")
        self.enhancer = NsfHifiGAN(enhancer_ckpt, h=h, seed=seed,
                                   device=device)
        self.enhancer_sample_rate = self.enhancer.sample_rate
        self.enhancer_hop_size = self.enhancer.hop_size

    def enhance(self, audio: torch.Tensor, sample_rate: int, f0: np.ndarray,
                hop_size: int, adaptive_key=0, silence_front: float = 0,
                rand_ini: Optional[np.ndarray] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, int]:
        """audio (1, T) tensor at `sample_rate`; f0 (1, n_frames, 1) numpy
        on the `hop_size` grid. Returns ((1, T') tensor, enhancer rate)."""
        start_frame = int(silence_front * sample_rate / hop_size)
        real_silence_front = start_frame * hop_size / sample_rate
        audio = audio[:, int(np.round(real_silence_front * sample_rate)):]
        f0 = f0[:, start_frame:, :]

        if adaptive_key == "auto":
            adaptive_key = 12.0 * np.log2(float(np.max(f0)) / 760.0)
            adaptive_key = max(0, np.ceil(adaptive_key))
        adaptive_key = float(adaptive_key)
        adaptive_factor = 2.0 ** (-adaptive_key / 12.0)
        adaptive_sample_rate = 100 * int(
            np.round(self.enhancer_sample_rate / adaptive_factor / 100))
        real_factor = self.enhancer_sample_rate / adaptive_sample_rate
        if adaptive_key != 0 or sample_rate != adaptive_sample_rate:
            raise NotImplementedError(
                "resampling (adaptive key, or an input rate other than the "
                "enhancer's) is not ported yet")

        n_frames = int(audio.shape[-1] // self.enhancer_hop_size + 1)
        f0_np = np.asarray(f0)[0, :, 0] * real_factor
        time_org = (hop_size / sample_rate) * np.arange(len(f0_np)) / real_factor
        time_frame = (self.enhancer_hop_size / self.enhancer_sample_rate
                      ) * np.arange(n_frames)
        f0_res = np.interp(time_frame, time_org, f0_np, left=f0_np[0],
                           right=f0_np[-1])[None, :].astype(np.float32)

        dev = self.enhancer.device
        ri = None if rand_ini is None else torch.as_tensor(
            np.asarray(rand_ini, np.float32), device=dev)
        enhanced, enhancer_sr = self.enhancer(
            audio.to(dev), torch.as_tensor(f0_res, device=dev), rand_ini=ri,
            generator=generator)
        if start_frame > 0:
            pad = int(np.round(enhancer_sr * real_silence_front))
            enhanced = torch.nn.functional.pad(enhanced, (pad, 0))
        return enhanced, enhancer_sr
