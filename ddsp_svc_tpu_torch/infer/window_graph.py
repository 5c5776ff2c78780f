"""SvcCore's window as one program: `SvcCore(fused_window=True)`.

Counterpart of `ddsp_svc_tpu/infer/streaming.py::SvcCore._window_fn` and
`_infer_fused`, JAX's one jitted program per window shape for local
single-device deployments. The window's device work, in the default
window's order: resample to the encoder's rate, the units encoder
(HuBERT), the nearest alignment, the bucketed masked synth, the response
mask and, with a numeric adaptive key, the enhancer at static rates
(`Enhancer.apply`). With 'auto' the rates follow each window's f0, so
SvcCore takes its default window there, as JAX does.

On the card the program is one CUDA graph per key (sample rate, speaker
mix, enhancer plan, window length), captured at the key's first window
and replayed for every later one. Everything that changes from window to
window is made on the host or drawn eagerly, then copied into the
graph's static input buffers: the f0 and the volume (padded to the
bucket as the bucketed synth pads them), the response mask, the
enhancer's f0 regrid, the synth noise and SineGen's initial rotations
(from the step's generator, in the default window's order, or from the
hooks), so a replay gives the default window's numbers. The alignment's
indices depend only on the window's length and are made once per key.
Before the capture the program runs twice on a side stream, which fills
every cache a capture cannot (cuDNN's and cuFFT's plans, the Bluestein
tables, the conv core's fragment index, the windows, the resampler's and
the mel's banks); the capture itself meets no host-to-device copy and no
read of a device value. The kernels' launches are recorded at the capture
(`kernels.captured_launches`) and counted at each replay
(`kernels.add_launches`). A capture that fails raises: nothing falls back
to the eager window on the card. On the CPU (device="cpu") the same
function runs eagerly.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.factory import bucket_frames
from ..ops import kernels
from ..ops.interp import nearest_indices
from ..ops.resample import resample, resampled_length
from .enhancer import EnhancePlan

INPUTS = ("audio", "f0", "volume", "mask", "spk_id", "noise", "f0_res",
          "rand_ini")


def plan_key(plan: Optional[EnhancePlan]):
    """The static part of an enhancer plan (None: no enhancer)."""
    if plan is None:
        return None
    return (plan.sample_rate, plan.adaptive_sample_rate, plan.cut, plan.pad,
            plan.f0_res.shape[-1])


class WindowProgram:
    """One key's window: __call__(**inputs) converts a window whose host
    inputs are numpy arrays (INPUTS: audio (1, T) at sample_rate; f0 (1,
    bucket, 1) and volume (1, bucket) padded as the bucketed synth pads
    them; mask (1, frames * block); spk_id (1, 1) int64; and device
    tensors noise (1, bucket * block), f0_res (1, F_enh), rand_ini (1, 9),
    the last two None without an enhancer). Returns the (1, T') output, a
    tensor of its own."""

    def __init__(self, core, sample_rate: int, spk_mix_dict,
                 plan: Optional[EnhancePlan], n_samples: int):
        self.core, self.plan = core, plan
        self.device = core.device
        self.spk_mix_dict = spk_mix_dict
        self.sample_rate = int(sample_rate)
        data = core.args.data
        self.block = int(data.block_size)
        hop_size = self.block * sample_rate / int(data.sampling_rate)
        self.n_frames = int(n_samples // hop_size) + 1
        self.bucket = bucket_frames(self.n_frames)
        self.valid = self.n_frames if self.bucket > self.n_frames else None
        enc = core.units_encoder
        self.enc_rate = int(enc.encoder_sample_rate)
        ratio = (hop_size / sample_rate) / (enc.encoder_hop_size
                                            / enc.encoder_sample_rate)
        n_units = enc.model.frames(resampled_length(n_samples, sample_rate,
                                                    self.enc_rate))
        self.idx = torch.as_tensor(
            nearest_indices(self.n_frames, ratio, n_units), device=self.device)
        self.graph = None
        self.static: Dict[str, torch.Tensor] = {}
        self.out: Optional[torch.Tensor] = None
        self.launches: dict = {}
        self.capture_s = 0.0

    def forward(self, audio, f0, volume, mask, spk_id, noise, f0_res,
                rand_ini) -> torch.Tensor:
        """The window's device work on device tensors (no host work)."""
        core = self.core
        x = audio
        if self.sample_rate != self.enc_rate:
            x = resample(x, self.sample_rate, self.enc_rate)
        units = core.units_encoder.model(x)[:, self.idx, :]
        units = F.pad(units, (0, 0, 0, self.bucket - self.n_frames))
        signal, _, _ = core.model(units, f0, volume, spk_id,
                                  spk_mix_dict=self.spk_mix_dict, infer=True,
                                  noise=noise, valid_frames=self.valid)
        out = signal[:, :self.n_frames * self.block] * mask
        if self.plan is not None:
            out = core.enhancer.apply(out, self.plan, f0_res, rand_ini)
        return out

    def _device_inputs(self, inputs: dict) -> dict:
        return {k: None if v is None else torch.as_tensor(v, device=self.device)
                for k, v in inputs.items()}

    @torch.no_grad()
    def __call__(self, **inputs) -> torch.Tensor:
        if self.device.type != "cuda":
            return self.forward(**self._device_inputs(inputs))
        if self.graph is None:
            self._capture(self._device_inputs(inputs))
        for k, v in inputs.items():
            if v is not None:
                self.static[k].copy_(torch.as_tensor(v))
        self.graph.replay()
        kernels.add_launches(self.launches)
        # the next replay overwrites the static output: a window in flight
        # (pipeline_depth > 0) keeps a copy of its own
        return self.out.clone()

    def _capture(self, inputs: dict) -> None:
        t0 = time.perf_counter()
        self.static = {k: v.clone() for k, v in inputs.items()
                       if v is not None}
        args = [self.static.get(k) for k in INPUTS]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        saved = kernels.launch_counts()
        with torch.cuda.stream(side):
            for _ in range(2):
                self.forward(*args)
        torch.cuda.current_stream(self.device).wait_stream(side)
        kernels.reset_launch_counts()
        kernels.add_launches(saved)  # warm-up runs are not the path's
        graph = torch.cuda.CUDAGraph()
        with kernels.captured_launches() as launches:
            with torch.cuda.graph(graph):
                out = self.forward(*args)
        torch.cuda.synchronize(self.device)
        self.graph, self.out, self.launches = graph, out, launches
        self.capture_s = time.perf_counter() - t0


def draw_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """The synth's uniform(-1, 1) excitation as the model draws it from
    `generator` (`models/synths.py::_uniform_noise`)."""
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=device) * 2 - 1


def pad_to_bucket(f0: np.ndarray, volume: np.ndarray, bucket: int):
    """f0 (1, n, 1) by edge replication and volume (n,) with zeros to the
    bucket, as `make_bucketed_synth` pads them: ((1, bucket, 1), (1,
    bucket)) fp32."""
    n = f0.shape[1]
    f0 = np.pad(f0.astype(np.float32), ((0, 0), (0, bucket - n), (0, 0)),
                mode="edge")
    volume = np.pad(volume[None, :].astype(np.float32),
                    ((0, 0), (0, bucket - n)))
    return f0, volume
