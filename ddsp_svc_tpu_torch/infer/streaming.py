"""Real-time streaming voice conversion with SOLA splicing.

Counterpart of `ddsp_svc_tpu/infer/streaming.py` (the reference GUI's
engine without its front end; `python -m ddsp_svc_tpu_torch.stream` drives
it from a wav file or a sound card):

  - SvcCore: the model, the units encoder and the enhancer, and one
    whole-window conversion (f0 with silence_front skipping, the volume
    threshold mask, units, the bucketed synth, the enhancer); with
    fused_window=True the window's device work is one program
    (`infer/window_graph.py`: on the card one CUDA graph per window shape);
  - StreamingSession: the sliding input window of `input_frames` samples,
    one window converted per block, the new chunk aligned against the
    carried `sola_buffer` (normalised cross-correlation argmax) and spliced
    with a sin^2 crossfade or the phase vocoder; `pipeline_depth` blocks of
    the device's work in flight;
  - phase_vocoder: the rFFT magnitude/phase interpolation splice.

The latency accounting (block, crossfade, SOLA search and last-delay
frames, safe_prefix_pad_length) is the reference GUI's. The window runs on
the model's device; f0, volume and the SOLA search run on the host.
"""
from __future__ import annotations

import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data.features import F0Extractor, UnitsEncoder, VolumeExtractor
from ..models.factory import load_model, make_bucketed_synth
from ..ops.resample import resample
from ..utils.device import resolve_device
from .enhancer import Enhancer
from .offline import response_mask
from .window_graph import WindowProgram, draw_noise, pad_to_bucket, plan_key


def phase_vocoder(a: torch.Tensor, b: torch.Tensor, fade_out: torch.Tensor,
                  fade_in: torch.Tensor) -> torch.Tensor:
    """Phase-coherent crossfade of two equal-length windows a -> b."""
    fa = torch.fft.rfft(a)
    fb = torch.fft.rfft(b)
    absab = torch.abs(fa) + torch.abs(fb)
    n = a.shape[0]
    scale = torch.full_like(absab, 2.0)
    scale[0] = 1.0
    if n % 2 == 0:
        scale[-1] = 1.0
    absab = absab * scale
    # + 0 turns the FFT's signed zeros into +0: an all-zero window (the
    # first block's empty SOLA buffer) then has phase 0, not pi, as JAX's
    # FFT gives it
    phia = torch.angle(fa + 0)
    deltaphase = torch.angle(fb + 0) - phia
    deltaphase = deltaphase - 2 * np.pi * torch.floor(
        deltaphase / (2 * np.pi) + 0.5)
    w = 2 * np.pi * torch.arange(n // 2 + 1, device=a.device) + deltaphase
    t = torch.arange(n, device=a.device)[:, None] / n
    return (a * fade_out ** 2 + b * fade_in ** 2
            + torch.sum(absab * torch.cos(w * t + phia), -1)
            * fade_out * fade_in / n)


def sola_shift(temp_wav: np.ndarray, sola_buffer: np.ndarray,
               search_frames: int) -> int:
    """The shift in [0, search_frames] that best aligns temp_wav with the
    carried sola_buffer: the argmax of their normalised cross-correlation."""
    cf = len(sola_buffer)
    nom = np.correlate(temp_wav[: cf + search_frames], sola_buffer, "valid")
    energy = np.convolve(temp_wav[: cf + search_frames] ** 2, np.ones(cf),
                         "valid")
    return int(np.argmax(nom / np.sqrt(energy + 1e-8)))


class SvcCore:
    """Whole-window conversion with a model, its units encoder and its
    enhancer, on `device` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, model_path: str, device=None, mesh=None,
                 mesh_axis: str = "data", fused_window: bool = False):
        """model_path: a checkpoint with its config.yaml beside it
        (`load_model`). The enhancer is built from the config's
        `enhancer.ckpt` and `enhancer.bf16_min_channels`; a missing
        enhancer checkpoint warns and the core converts without it, as the
        JAX package does. mesh (a `parallel.Mesh`; device: its device):
        each window's synth and enhancer run time-sharded over `mesh_axis`
        (`make_bucketed_synth(mesh=)`, `Enhancer(mesh=)`), every rank
        converting the same window and returning the whole output.
        fused_window: the window's device work as one program per window
        shape (`infer/window_graph.py`; on CUDA one captured graph per
        shape, replayed), where the enhancer is off or its adaptive key is
        numeric; it equals the default window. It excludes a mesh, as in
        the JAX package (whose core drops fused_window there quietly; this
        one raises)."""
        if fused_window and mesh is not None:
            raise ValueError(
                "SvcCore: fused_window and mesh are exclusive (the fused "
                "window is one program on one device; a mesh shards the "
                "synth and the enhancer instead)")
        self.fused_window = bool(fused_window)
        self._windows: Dict = {}
        self.device = resolve_device(device)
        self.mesh, self.mesh_axis = mesh, mesh_axis
        self.model, self.args = load_model(model_path, device=self.device)
        data = self.args.data
        self.units_encoder = UnitsEncoder(
            data.encoder, data.encoder_ckpt, data.encoder_sample_rate,
            data.encoder_hop_size, device=self.device,
            trust_pickle=bool(data.encoder_trust_pickle))
        self.enhancer: Optional[Enhancer] = None
        enh = self.args.enhancer
        if enh and enh.ckpt:
            try:
                self.enhancer = Enhancer(
                    enh.type, enh.ckpt, device=self.device,
                    bf16_min_channels=int(enh.bf16_min_channels or 0),
                    mesh=mesh, mesh_axis=mesh_axis)
            except FileNotFoundError:
                warnings.warn(
                    f" [!] enhancer checkpoint not found: {enh.ckpt} - "
                    "continuing with the raw DDSP output (no enhancement). "
                    "Fix enhancer.ckpt in the model's config.yaml for "
                    "production conversions.", RuntimeWarning, stacklevel=2)
        self._step = 0
        self._synth_cache: Dict = {}
        self._f0_cache: Dict = {}

    def _synth(self, spk_mix_dict):
        """The bucketed synth of one speaker mix, made once. The window is
        padded to its bucket (max(32, next_pow2(n)) frames) with its true
        length passed as valid_frames, so it equals the window converted at
        its own length, as the reference GUI converts it. (The JAX
        package's streaming synth pads without masking: its window then
        depends on the pad frames.)"""
        key = tuple(sorted(spk_mix_dict.items())) if spk_mix_dict else None
        if key not in self._synth_cache:
            self._synth_cache[key] = make_bucketed_synth(
                self.model, spk_mix_dict=spk_mix_dict, mesh=self.mesh,
                mesh_axis=self.mesh_axis)
        return self._synth_cache[key]

    def _f0_extractor(self, *key) -> F0Extractor:
        """One extractor per (family, rate, hop, f0 range): CREPE's weights
        are made once, not once a window."""
        if key not in self._f0_cache:
            self._f0_cache[key] = F0Extractor(*key, device=self.device)
        return self._f0_cache[key]

    @torch.no_grad()
    def infer(
        self,
        audio: np.ndarray,
        sample_rate: int,
        spk_id: int = 1,
        threshold_db: float = -45,
        pitch_adjust: float = 0,
        use_spk_mix: bool = False,
        spk_mix_dict: Optional[Dict[int, float]] = None,
        use_enhancer: bool = True,
        enhancer_adaptive_key="auto",
        pitch_extractor_type: str = "dio",
        f0_min: float = 50,
        f0_max: float = 1100,
        safe_prefix_pad_length: float = 0,
        materialize: bool = True,
        noise_hook: Optional[Callable[[int, tuple], np.ndarray]] = None,
        enhancer_rand_hook: Optional[Callable[[int], np.ndarray]] = None,
        walls: Optional[Dict[str, float]] = None,
    ):
        """Convert one window (T,) at sample_rate. Returns (audio, rate):
        numpy (T',), or with materialize=False the device tensor, left
        for the caller to collect (no host sync here).

        The calls are counted from 1. noise_hook(step, (1, samples)) and
        enhancer_rand_hook(step) -> (1, 9) optionally inject the window's
        noise excitation and SineGen initial rotations; otherwise both are
        drawn from a torch.Generator seeded with the step. walls, when
        given, accumulates each stage's host-clock seconds (the device
        synchronised at each stage's end): 'f0 + volume', 'units', 'synth',
        'enhance'; with the fused window 'f0 + volume' and 'window'."""
        t_stage = time.perf_counter()

        def stage_done(name: str) -> None:
            nonlocal t_stage
            if walls is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                now = time.perf_counter()
                walls[name] = walls.get(name, 0.0) + now - t_stage
                t_stage = now

        n_spk = self.model.unit2ctrl.spk_embed.num_embeddings
        ids = ([int(k) for k in spk_mix_dict] if use_spk_mix and spk_mix_dict
               else [int(spk_id)])
        if not all(1 <= k <= n_spk for k in ids):
            # an out-of-range embedding lookup would fail on the device
            raise ValueError(f" [x] speaker ids {ids} out of range "
                             f"[1, {n_spk}]")
        data = self.args.data
        block, model_sr = int(data.block_size), int(data.sampling_rate)
        hop_size = block * sample_rate / model_sr
        silence_front = (safe_prefix_pad_length - 0.03
                         if safe_prefix_pad_length > 0.03 else 0)
        ext = self._f0_extractor(pitch_extractor_type, sample_rate, hop_size,
                                 f0_min, f0_max)
        f0 = ext.extract(audio, uv_interp=True, silence_front=silence_front)
        f0 = f0[None, :, None] * 2 ** (float(pitch_adjust) / 12)
        volume = VolumeExtractor(hop_size).extract(audio)
        mask = response_mask(volume, threshold_db, block)
        stage_done("f0 + volume")

        self._step += 1
        step = self._step
        generator = torch.Generator(device=self.device).manual_seed(step)
        enh_on = use_enhancer and self.enhancer is not None
        if self.fused_window and not (enh_on
                                      and enhancer_adaptive_key == "auto"):
            out, out_sr = self._infer_fused(
                audio, sample_rate, f0, volume, mask, spk_id,
                spk_mix_dict if use_spk_mix else None, enh_on,
                enhancer_adaptive_key, silence_front, step, generator,
                noise_hook, enhancer_rand_hook)
            stage_done("window")
            if not materialize:
                return out[0], out_sr
            return out[0].cpu().numpy(), out_sr
        units = self.units_encoder.encode(audio[None, :], sample_rate,
                                          hop_size)
        stage_done("units")
        noise = None
        if noise_hook is not None:
            noise = np.asarray(noise_hook(step, (1, units.shape[1] * block)),
                               np.float32)
        synth = self._synth(spk_mix_dict if use_spk_mix else None)
        out = synth(units, f0.astype(np.float32),
                    volume[None, :].astype(np.float32),
                    np.asarray([[int(spk_id)]], dtype=np.int64), noise=noise,
                    generator=generator)
        out = out * torch.as_tensor(mask[:, :out.shape[-1]],
                                    device=self.device)
        stage_done("synth")
        out_sr = model_sr
        if enh_on:
            rand_ini = (None if enhancer_rand_hook is None
                        else enhancer_rand_hook(step))
            out, out_sr = self.enhancer.enhance(
                out, model_sr, f0, block, adaptive_key=enhancer_adaptive_key,
                silence_front=silence_front, rand_ini=rand_ini,
                generator=generator)
            stage_done("enhance")
        if not materialize:
            return out[0], out_sr
        return out[0].cpu().numpy(), out_sr

    def _infer_fused(self, audio, sample_rate, f0, volume, mask, spk_id,
                     spk_mix_dict, enh_on, adaptive_key, silence_front,
                     step, generator, noise_hook, enhancer_rand_hook):
        """The window through its WindowProgram: the host inputs made here,
        the noise and SineGen's rotations drawn from the step's generator
        in the default window's order (or taken from the hooks)."""
        data = self.args.data
        block, model_sr = int(data.block_size), int(data.sampling_rate)
        n = f0.shape[1]
        plan = None
        if enh_on:
            plan = self.enhancer.plan(n * block, model_sr, f0, block,
                                      adaptive_key, silence_front)
        mix = tuple(sorted(spk_mix_dict.items())) if spk_mix_dict else None
        key = (int(sample_rate), mix, plan_key(plan), len(audio))
        if key not in self._windows:
            self._windows[key] = WindowProgram(self, sample_rate, spk_mix_dict,
                                               plan, len(audio))
        prog = self._windows[key]
        f0_p, vol_p = pad_to_bucket(f0, volume, prog.bucket)
        if noise_hook is not None:
            noise = np.pad(np.asarray(noise_hook(step, (1, n * block)),
                                      np.float32),
                           ((0, 0), (0, (prog.bucket - n) * block)))
        else:
            noise = draw_noise((1, prog.bucket * block), generator,
                               self.device)
        f0_res = rand_ini = None
        if plan is not None:
            f0_res = plan.f0_res
            rand_ini = (self.enhancer.enhancer.draw_rand_ini(1, generator,
                                                             self.device)
                        if enhancer_rand_hook is None else
                        np.asarray(enhancer_rand_hook(step), np.float32))
        out = prog(audio=np.asarray(audio, np.float32)[None, :], f0=f0_p,
                   volume=vol_p, mask=mask[:, :n * block],
                   spk_id=np.asarray([[int(spk_id)]], dtype=np.int64),
                   noise=noise, f0_res=f0_res, rand_ini=rand_ini)
        return out, (self.enhancer.enhancer_sample_rate if plan is not None
                     else model_sr)


class StreamingSession:
    """Block-by-block streaming engine with carried SOLA state. `core` is a
    SvcCore, or any object with its `infer(audio, sample_rate, **kw) ->
    (audio, rate)`; the phase vocoder runs on `core.device` if it has one,
    else on the CPU."""

    def __init__(
        self,
        core,
        samplerate: int = 44100,
        block_time: float = 0.3,
        crossfade_time: float = 0.04,
        buffer_num: int = 2,
        use_phase_vocoder: bool = False,
        pipeline_depth: int = 0,
        **infer_kwargs,
    ):
        """pipeline_depth = N > 0 keeps N windows in flight: each
        process_block submits window k without collecting it (on CUDA the
        device works on it while the host extracts the next block's f0 and
        volume) and splices window k - N, whose result is ready by then.
        The SOLA splice needs only the previous output's tail, so the
        output equals the sequential engine's, N blocks later (zeros while
        priming); flush() returns the windows still in flight."""
        self.core = core
        self.device = getattr(core, "device", torch.device("cpu"))
        self.samplerate = samplerate
        self.use_phase_vocoder = use_phase_vocoder
        self.pipeline_depth = int(pipeline_depth)
        self._pending: list = []
        self.infer_kwargs = infer_kwargs

        # the reference GUI's latency accounting
        self.block_frame = int(block_time * samplerate)
        self.crossfade_frame = int(crossfade_time * samplerate)
        self.sola_search_frame = int(0.01 * samplerate)
        self.last_delay_frame = int(0.02 * samplerate)
        self.input_frames = max(
            self.block_frame + self.crossfade_frame + self.sola_search_frame
            + 2 * self.last_delay_frame,
            (1 + buffer_num) * self.block_frame,
        )
        self.safe_prefix_pad_length = (
            block_time * buffer_num - crossfade_time - 0.01 - 0.02)

        self.input_wav = np.zeros(self.input_frames, dtype=np.float32)
        self.sola_buffer = np.zeros(self.crossfade_frame, dtype=np.float32)
        self.shifts: list = []  # each splice's SOLA shift, in order
        fade = np.sin(
            np.pi * np.arange(0, 1, 1 / self.crossfade_frame) / 2) ** 2
        self.fade_in_window = fade.astype(np.float32)
        self.fade_out_window = (1.0 - fade).astype(np.float32)

    def process_block(self, block: np.ndarray) -> np.ndarray:
        """Feed one input block of `block_frame` samples; returns an output
        block of `block_frame` samples (pipeline_depth blocks late)."""
        if block.shape[-1] != self.block_frame:
            raise ValueError(f"block of {block.shape[-1]} samples, expected "
                             f"{self.block_frame}")
        self.input_wav = np.roll(self.input_wav, -self.block_frame)
        self.input_wav[-self.block_frame:] = block

        res = self.core.infer(
            self.input_wav, self.samplerate,
            safe_prefix_pad_length=self.safe_prefix_pad_length,
            materialize=self.pipeline_depth == 0, **self.infer_kwargs)
        if self.pipeline_depth > 0:
            self._pending.append(res)
            if len(self._pending) <= self.pipeline_depth:
                return np.zeros(self.block_frame, dtype=np.float32)
            res = self._pending.pop(0)
        return self._splice(*res)

    def flush(self) -> list:
        """Splice the windows still in flight (end of stream); returns the
        remaining output blocks in order."""
        outs = [self._splice(*res) for res in self._pending]
        self._pending = []
        return outs

    def _splice(self, audio, model_sr) -> np.ndarray:
        audio = torch.as_tensor(audio)  # a device result is collected here
        if model_sr != self.samplerate:
            audio = resample(audio[None], model_sr, self.samplerate)[0]
        audio = audio.cpu().numpy()

        tail = (self.block_frame + self.crossfade_frame
                + self.sola_search_frame + self.last_delay_frame)
        temp_wav = audio[-tail: -self.last_delay_frame].copy()
        shift = sola_shift(temp_wav, self.sola_buffer, self.sola_search_frame)
        self.shifts.append(shift)
        temp_wav = temp_wav[shift: shift + self.block_frame
                            + self.crossfade_frame]

        cf = self.crossfade_frame
        if self.use_phase_vocoder:
            a, b, fo, fi = (torch.as_tensor(x, device=self.device) for x in (
                self.sola_buffer, temp_wav[:cf], self.fade_out_window,
                self.fade_in_window))
            temp_wav[:cf] = phase_vocoder(a, b, fo, fi).cpu().numpy()
        else:
            temp_wav[:cf] = (temp_wav[:cf] * self.fade_in_window
                             + self.sola_buffer * self.fade_out_window)
        self.sola_buffer = temp_wav[-cf:].copy()
        return temp_wav[:-cf]
