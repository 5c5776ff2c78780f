"""NSF-HiFiGAN enhancer front end.

Counterpart of `ddsp_svc_tpu/infer/enhancer.py` (`NsfHifiGAN`, `Enhancer`):
the adaptive key (`'auto'` derives it from max f0 against 760 Hz; the
adaptive rate is rounded to 100 Hz), windowed-sinc resampling into the
enhancer's rate and back, the f0 re-grid onto the enhancer's frame grid,
the log-mel frontend, the generator forward (fp32, or staged bf16 with
`bf16_min_channels`) and the silence-front padding;
`enhance_batch` runs mixed-length segments as one masked batch. Weights come
from a reference checkpoint (a generator state dict beside its config.json,
as the port's GAN export writes it), the JAX package's flax msgpack, or a
seed.
"""
from __future__ import annotations

import json
import math
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.layers import lecun_init_
from ..nn.nsf_hifigan import generator_from_h
from ..ops.resample import resample, resampled_length
from ..ops.spectral import log_mel_spectrogram, mel_reflect_pad
from ..utils.convert import jax_nsf_to_torch
from ..utils.device import resolve_device
from ..utils.flax_msgpack import read_msgpack


def _fold_weight_norm(sd, name: str) -> torch.Tensor:
    """The plain weight `name` of a reference state dict: as stored, or
    folded from torch weight_norm(dim=0) as w = g v / (||v|| + 1e-12), the
    norm over every axis but 0 (for a ConvTranspose1d weight (in, out, k)
    that is per input channel), as the JAX package's converter does."""
    if name in sd:
        return sd[name]
    prefix = name[:-len("weight")]
    g, v = sd[prefix + "weight_g"], sd[prefix + "weight_v"]
    norm = torch.sqrt((v ** 2).sum(dim=tuple(range(1, v.ndim)), keepdim=True))
    return v * (g / (norm + 1e-12))


class NsfHifiGAN:
    """Generator + its config dict `h`. model_path: a reference checkpoint
    (a torch file holding the generator's state dict, under a 'generator'
    key or bare, weight norm folded on load) or the JAX package's flax
    msgpack (`.ckpt` / `.msgpack`, {'params': ...}), with config.json
    beside it; None draws the weights from `seed`. generator_overrides: the
    Generator's forms (fused_resblocks, fused_inject, fused_stage).
    dtype / bf16_min_channels: the Generator's compute dtype and staged
    bf16 threshold (0 = off); the parameters stay fp32. mesh (a
    `parallel.Mesh`; device: its device): each call's mel frames sharded
    over `mesh_axis` (`parallel.make_time_parallel_enhancer`), every rank
    called with the same inputs and returning the whole output."""

    def __init__(self, model_path: Optional[str], h: Optional[dict] = None,
                 seed: int = 0, device=None,
                 generator_overrides: Optional[dict] = None, dtype=None,
                 bf16_min_channels: int = 0, mesh=None,
                 mesh_axis: str = "data"):
        self.device = resolve_device(device)
        if model_path is not None:
            with open(os.path.join(os.path.dirname(model_path),
                                   "config.json")) as f:
                h = json.load(f)
        if h is None:
            raise ValueError("h (the generator config) is required")
        self.h = h
        self.model = generator_from_h(
            h, dtype=dtype, bf16_min_channels=bf16_min_channels,
            **(generator_overrides or {}))
        if model_path is None:
            lecun_init_(self.model, torch.Generator().manual_seed(seed))
        elif model_path.endswith((".ckpt", ".msgpack")):
            # the JAX package's flax checkpoint ({"params": ...}, written by
            # its GAN fine-tuning export)
            params = read_msgpack(model_path)["params"]
            self.model.load_state_dict(jax_nsf_to_torch(params, h))
        else:
            cp = torch.load(model_path, map_location="cpu", weights_only=True)
            sd = cp["generator"] if "generator" in cp else cp
            self.model.load_state_dict(
                {k: _fold_weight_norm(sd, k) for k in self.model.state_dict()})
        self.model = self.model.to(self.device).eval()
        self._time_parallel = None
        if mesh is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"the mesh is on {mesh.device}, the "
                                 f"enhancer on {self.device}")
            from ..parallel.timeparallel import make_time_parallel_enhancer

            self._time_parallel = make_time_parallel_enhancer(
                self, mesh, axis=mesh_axis)

    @property
    def sample_rate(self) -> int:
        return int(self.h["sampling_rate"])

    @property
    def hop_size(self) -> int:
        return int(self.h["hop_size"])

    def _mel(self, audio: torch.Tensor, pre_padded: bool = False):
        h, g = self.h, self.model
        # JAX asks for its DFT route under bf16, which it takes on the TPU:
        # on the card that is the dft_magnitude kernel
        return log_mel_spectrogram(
            audio, h["sampling_rate"], h["n_fft"], h["hop_size"],
            h["win_size"], h["num_mels"], h["fmin"], h["fmax"],
            mxu_bf16=bool(g.bf16_min_channels) or g.dtype == torch.bfloat16,
            pre_padded=pre_padded).transpose(1, 2)

    @torch.no_grad()
    def _forward_batch(self, audio_prepadded: torch.Tensor,
                       f0_frames: torch.Tensor, rand_ini: torch.Tensor,
                       valid_frames: torch.Tensor) -> torch.Tensor:
        """Mixed-length batch forward: each row of `audio_prepadded` carries
        its item's own reflect padding, so the mel frames below each valid
        count match an exact-length forward; the generator masks everything
        past `valid_frames` (per item) to exact zeros."""
        mel = self._mel(audio_prepadded, pre_padded=True)
        return self.model(mel, f0_frames[:, :mel.shape[1]], rand_ini,
                          valid_frames=valid_frames)

    @torch.no_grad()
    def __call__(self, audio: torch.Tensor, f0_frames: torch.Tensor,
                 rand_ini: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, int]:
        """audio (B, T), f0_frames (B, F) on the enhancer's device.
        rand_ini (B, 9): the SineGen initial rotations (column 0 is 0);
        drawn from `generator` when given, zeros otherwise."""
        if rand_ini is None:
            rand_ini = self.draw_rand_ini(audio.shape[0], generator,
                                          audio.device)
        if self._time_parallel is not None:
            return (self._time_parallel(audio, f0_frames, rand_ini),
                    self.sample_rate)
        mel = self._mel(audio)
        out = self.model(mel, f0_frames[:, :mel.shape[1]], rand_ini)
        return out, self.sample_rate


    @staticmethod
    def draw_rand_ini(b: int, generator: Optional[torch.Generator], device
                      ) -> torch.Tensor:
        """SineGen's initial rotations (B, 9): column 0 zero, the others
        uniform from `generator` (all zeros without one)."""
        rand_ini = torch.zeros((b, 9), device=device)
        if generator is not None:
            rand_ini[:, 1:] = torch.rand((b, 8), generator=generator,
                                         device=device)
        return rand_ini


class EnhancePlan(NamedTuple):
    """The host side of one `Enhancer.enhance` call: the rates, the
    silence-front cut and pad in samples, and the f0 on the enhancer's
    frame grid (1, frames) fp32."""
    sample_rate: int
    adaptive_sample_rate: int
    cut: int
    pad: int
    f0_res: np.ndarray


class Enhancer:
    def __init__(self, enhancer_type: str, enhancer_ckpt: Optional[str],
                 h: Optional[dict] = None, seed: int = 0, device=None,
                 generator_overrides: Optional[dict] = None,
                 bf16_min_channels: int = 0, mesh=None,
                 mesh_axis: str = "data"):
        """mesh: `enhance`'s generator forward time-sharded over
        `mesh_axis` (NsfHifiGAN's mesh); `enhance_batch` stays unsharded."""
        if enhancer_type != "nsf-hifigan":
            raise ValueError(f" [x] Unknown enhancer: {enhancer_type}")
        self.enhancer = NsfHifiGAN(enhancer_ckpt, h=h, seed=seed,
                                   device=device,
                                   generator_overrides=generator_overrides,
                                   bf16_min_channels=bf16_min_channels,
                                   mesh=mesh, mesh_axis=mesh_axis)
        self.enhancer_sample_rate = self.enhancer.sample_rate
        self.enhancer_hop_size = self.enhancer.hop_size

    def _adaptive_rate(self, adaptive_key) -> Tuple[int, float]:
        """(adaptive sample rate rounded to 100 Hz, enhancer rate / it)."""
        factor = 2.0 ** (-float(adaptive_key) / 12.0)
        rate = 100 * int(np.round(self.enhancer_sample_rate / factor / 100))
        return rate, self.enhancer_sample_rate / rate

    def _regrid_f0(self, f0: np.ndarray, sample_rate: int, hop_size: int,
                   real_factor: float, n_frames: int) -> np.ndarray:
        """f0 (frames,) on the hop_size grid -> n_frames on the enhancer's
        grid, scaled to the adaptive rate, edges held."""
        f0 = np.asarray(f0, np.float32).reshape(-1) * real_factor
        time_org = (hop_size / sample_rate) * np.arange(len(f0)) / real_factor
        time_frame = (self.enhancer_hop_size / self.enhancer_sample_rate
                      ) * np.arange(n_frames)
        return np.interp(time_frame, time_org, f0, left=f0[0], right=f0[-1])

    def plan(self, n_samples: int, sample_rate: int, f0: np.ndarray,
             hop_size: int, adaptive_key=0, silence_front: float = 0
             ) -> EnhancePlan:
        """The host side of `enhance` for n_samples of audio: the
        silence-front frames skipped, the adaptive rate (a numeric key, or
        'auto' from max f0 against 760 Hz) and the f0 re-grid."""
        start_frame = int(silence_front * sample_rate / hop_size)
        real_silence_front = start_frame * hop_size / sample_rate
        cut = int(np.round(real_silence_front * sample_rate))
        f0 = f0[:, start_frame:, :]
        if adaptive_key == "auto":
            adaptive_key = 12.0 * np.log2(float(np.max(f0)) / 760.0)
            adaptive_key = max(0, np.ceil(adaptive_key))
        adaptive_sample_rate, real_factor = self._adaptive_rate(adaptive_key)
        n_res = resampled_length(n_samples - cut, sample_rate,
                                 adaptive_sample_rate)
        n_frames = int(n_res // self.enhancer_hop_size + 1)
        f0_res = self._regrid_f0(f0, sample_rate, hop_size, real_factor,
                                 n_frames)[None, :].astype(np.float32)
        pad = (int(np.round(self.enhancer_sample_rate * real_silence_front))
               if start_frame > 0 else 0)
        return EnhancePlan(sample_rate, adaptive_sample_rate, cut, pad, f0_res)

    def apply(self, audio: torch.Tensor, plan: EnhancePlan,
              f0_res: torch.Tensor, rand_ini: torch.Tensor) -> torch.Tensor:
        """The device side of `enhance`: audio (1, T) cut, resampled to the
        adaptive rate, through the generator with f0_res (1, frames) and
        rand_ini (1, 9) on the enhancer's device, back to the enhancer's
        rate and padded. No host work: a CUDA graph can capture it."""
        audio = audio[:, plan.cut:]
        audio_res = resample(audio.to(self.enhancer.device), plan.sample_rate,
                             plan.adaptive_sample_rate)
        enhanced, enhancer_sr = self.enhancer(audio_res, f0_res,
                                              rand_ini=rand_ini)
        enhanced = resample(enhanced, plan.adaptive_sample_rate, enhancer_sr)
        if plan.pad:
            enhanced = F.pad(enhanced, (plan.pad, 0))
        return enhanced

    def enhance(self, audio: torch.Tensor, sample_rate: int, f0: np.ndarray,
                hop_size: int, adaptive_key=0, silence_front: float = 0,
                rand_ini: Optional[np.ndarray] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, int]:
        """audio (1, T) tensor at `sample_rate`; f0 (1, n_frames, 1) numpy
        on the `hop_size` grid. rand_ini (1, 9), else drawn from
        `generator` (zeros without one). Returns ((1, T') tensor, enhancer
        rate)."""
        plan = self.plan(audio.shape[-1], sample_rate, f0, hop_size,
                         adaptive_key, silence_front)
        dev = self.enhancer.device
        ri = (self.enhancer.draw_rand_ini(1, generator, dev)
              if rand_ini is None else
              torch.as_tensor(np.asarray(rand_ini, np.float32), device=dev))
        return (self.apply(audio, plan, torch.as_tensor(plan.f0_res,
                                                        device=dev), ri),
                self.enhancer_sample_rate)

    def enhance_batch(self, audios: Sequence, sample_rate: int,
                      f0s: Sequence[np.ndarray], hop_size: int,
                      adaptive_key: float = 0,
                      rand_ini: Optional[np.ndarray] = None, pad_to: int = 0
                      ) -> Tuple[List[torch.Tensor], int]:
        """`enhance` of mixed-length segments in one masked batch, at ONE
        resolved adaptive key. audios: (T_i,) or (1, T_i) arrays or
        tensors (a tensor on the enhancer's device stays there); f0s:
        (F_i,) or (1, F_i, 1) arrays on the hop_size grid; rand_ini (B, 9).
        The resampler zero-pads as each exact-length call does, the mel sees
        each item's own reflect padding and the generator masks each item's
        valid frames, so each segment equals its own `enhance` output.
        pad_to: pad the batch's time axis to at least this many samples (one
        shape for every chunk of a bucket). Returns ([(1, T_out_i)], sr)."""
        if adaptive_key == "auto":
            raise ValueError("resolve 'auto' per item before batching")
        adaptive_sample_rate, real_factor = self._adaptive_rate(adaptive_key)
        h = self.enhancer.h
        dev = self.enhancer.device
        b = len(audios)
        flat = [torch.as_tensor(a, dtype=torch.float32, device=dev).reshape(-1)
                for a in audios]
        lens = [a.numel() for a in flat]
        batch = torch.zeros((b, max(max(lens), int(pad_to))), device=dev)
        for i, a in enumerate(flat):
            batch[i, :lens[i]] = a
        res = resample(batch, sample_rate, adaptive_sample_rate)
        res_lens = [math.ceil(adaptive_sample_rate * n / sample_rate)
                    for n in lens]

        ehop, win, n_fft = self.enhancer_hop_size, int(h["win_size"]), \
            int(h["n_fft"])
        pad_l = (win - ehop) // 2
        pad_r = max((win - ehop + 1) // 2, ehop)
        n_mel = [(n + pad_l + pad_r - n_fft) // ehop + 1 for n in res_lens]
        # the f0 grid spans the whole (pad_to-widened) batch's mel frames
        f_max = (res.shape[-1] + pad_l + pad_r - n_fft) // ehop + 1
        f0_res = np.zeros((b, f_max), np.float32)
        for i, f0 in enumerate(f0s):
            n_i = int(res.shape[-1] // ehop + 1)
            vals = self._regrid_f0(f0, sample_rate, hop_size, real_factor,
                                   max(n_i, n_mel[i]))
            f0_res[i, :n_mel[i]] = vals[:n_mel[i]]
            f0_res[i, n_mel[i]:] = vals[n_mel[i] - 1]

        # per-item reflect padding for the mel frontend
        buf = torch.zeros((b, pad_l + res.shape[-1] + pad_r), device=dev)
        for i in range(b):
            padded = mel_reflect_pad(res[i:i + 1, :res_lens[i]], win, ehop)
            buf[i, :padded.shape[-1]] = padded[0]
        if rand_ini is None:
            rand_ini = np.zeros((b, 9), np.float32)
        out = self.enhancer._forward_batch(
            buf, torch.as_tensor(f0_res, device=dev),
            torch.as_tensor(np.asarray(rand_ini, np.float32), device=dev),
            torch.as_tensor(n_mel, dtype=torch.int32, device=dev))
        upp = out.shape[-1] // f_max
        enhancer_sr = self.enhancer_sample_rate
        out_res = resample(out, adaptive_sample_rate, enhancer_sr)
        results = [out_res[i:i + 1, :math.ceil(
            enhancer_sr * n_mel[i] * upp / adaptive_sample_rate)]
            for i in range(b)]
        return results, enhancer_sr
