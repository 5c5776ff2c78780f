"""Low-latency real-time conversion on the exact incremental engine.

Counterpart of `ddsp_svc_tpu/infer/realtime.py`. The SOLA engine
(`infer/streaming.py`) recomputes a whole sliding window every block,
because the default model is acausal through its prenet GroupNorm. For a
model trained with `causal: true, frame_norm: true` this session drives the
state-carrying `IncrementalCombSubFast` instead:

  - synthesis is O(block) per block with carried state: no window is
    recomputed, nothing is spliced or crossfaded;
  - the features still come from a sliding context window, since they are
    acausal by nature (the f0 window is centred, the response mask dilates
    4 frames each way, HuBERT attends both ways). Each block takes the
    `frames_per_block` feature frames that lie `lookahead_frames` behind
    the newest audio, so every frame's f0, volume and mask window lies
    inside the buffer; only the units keep a mild window dependence.

Latency: a block plus lookahead_frames + 2 synthesis frames (at 44.1 kHz,
hop 512 and lookahead 4, a block + ~70 ms), with no buffer_num margin and
no crossfade or SOLA search tail. The enhancer is not on this path: it is
a windowed, acausal vocoder (use the SOLA engine for it).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.features import F0Extractor, UnitsEncoder, VolumeExtractor
from ..models.factory import load_model
from ..models.incremental import IncrementalCombSubFast
from ..utils.device import resolve_device
from .offline import response_frame_mask


class IncrementalSession:
    """Block-by-block conversion over a causal + frame_norm CombSubFast.

    Feed `process_block` blocks of frames_per_block * block_size samples at
    the model's rate; each call returns as many samples, lookahead_frames
    + 2 frames behind the input. The model and the units encoder run on
    the model's device; f0 and volume on the host."""

    def __init__(
        self,
        model,
        units_encoder: UnitsEncoder,
        spk_id: int = 1,
        frames_per_block: int = 26,
        context_time: float = 1.0,
        pitch_adjust: float = 0.0,
        threshold_db: float = -45.0,
        f0_extractor: str = "dio",
        f0_min: float = 65,
        f0_max: float = 800,
        lookahead_frames: Optional[int] = None,
        seed: int = 0,
        record: bool = False,
    ):
        """seed: the noise excitation's numpy generator (the JAX session's
        bits). record: keep each block's features, noise and mask in
        `recorded` (to replay them through the engine)."""
        self.engine = IncrementalCombSubFast(model)
        hop, sr = self.engine.bs, self.engine.sr
        self.hop, self.sr = hop, sr
        self.units_encoder = units_encoder
        self.f0_ext = F0Extractor(f0_extractor, sr, hop, f0_min, f0_max,
                                  device=self.engine.device)
        self.vol_ext = VolumeExtractor(hop)
        self.pitch_factor = 2.0 ** (float(pitch_adjust) / 12.0)
        self.threshold_db = float(threshold_db)

        if lookahead_frames is None:
            # cover the centred f0 window and the 4-frame mask dilation
            lookahead_frames = max(4, -(-self.f0_ext.win // (2 * hop)) + 1)
        self.lookahead_frames = int(lookahead_frames)
        self.frames_per_block = int(frames_per_block)
        self.block_samples = self.frames_per_block * hop

        self.ctx_frames = max(
            int(round(context_time * sr / hop)),
            self.frames_per_block + self.lookahead_frames + 4)
        self.window = np.zeros(self.ctx_frames * hop, dtype=np.float32)

        self.state = self.engine.init_state(np.asarray([[int(spk_id)]]),
                                            batch=1)
        self._rng = np.random.default_rng(seed)
        # mask values of output frames -2 and -1 (the engine's pipeline)
        self._mask_queue = [0.0, 0.0]
        self.record = record
        self.recorded = {"units": [], "f0": [], "volume": [], "noise": [],
                         "mask": []}

    @classmethod
    def from_checkpoint(cls, model_path: str, device=None, **kwargs
                        ) -> "IncrementalSession":
        """A session over the checkpoint at model_path (config.yaml beside
        it) and its config's units encoder, on `device` (CUDA unless the
        caller asks for the CPU)."""
        device = resolve_device(device)
        model, args = load_model(model_path, device=device)
        data = args.data
        enc = UnitsEncoder(data.encoder, data.encoder_ckpt,
                           data.encoder_sample_rate, data.encoder_hop_size,
                           device=device,
                           trust_pickle=bool(data.encoder_trust_pickle))
        return cls(model, enc, **kwargs)

    def _window_features(self):
        """f0, volume, units and the dilated mask over the context window."""
        f0 = self.f0_ext.extract(self.window, uv_interp=True)
        volume = self.vol_ext.extract(self.window)
        units = self.units_encoder.encode(self.window[None], self.sr, self.hop)
        mask = response_frame_mask(volume, self.threshold_db)
        return units[0], f0, volume, mask

    def _mask_samples(self, mvals: np.ndarray) -> np.ndarray:
        """Frame mask values (n + 1,) lerped to n hops of samples."""
        frac = np.arange(self.hop, dtype=np.float32) / self.hop
        return (mvals[:-1, None] * (1 - frac)
                + mvals[1:, None] * frac).reshape(-1)

    def process_block(self, block: np.ndarray) -> np.ndarray:
        """Feed block_samples input samples; returns block_samples of
        converted audio (lookahead_frames + 2 frames of delay)."""
        if block.shape[-1] != self.block_samples:
            raise ValueError(f"block of {block.shape[-1]} samples, expected "
                             f"{self.block_samples}")
        self.window = np.roll(self.window, -self.block_samples)
        self.window[-self.block_samples:] = block

        units, f0, volume, mask = self._window_features()
        # the oldest feature frame fed this block, in window frames
        start = self.ctx_frames - self.lookahead_frames - self.frames_per_block
        sl = slice(start, start + self.frames_per_block)
        u = units[None, sl, :]
        f = (f0[sl] * self.pitch_factor)[None, :].astype(np.float32)
        v = volume[sl][None, :].astype(np.float32)
        noise = self._rng.uniform(
            -1.0, 1.0, size=(1, self.block_samples)).astype(np.float32)
        if self.record:
            for key, val in (("units", u), ("f0", f), ("volume", v),
                             ("noise", noise)):
                self.recorded[key].append(val)

        audio, self.state = self.engine.process(self.state, u, f, v, noise)
        audio = audio.cpu().numpy()[0]

        # the response mask, 2 frames late as the engine's output
        self._mask_queue.extend(mask[sl])
        mvals = np.asarray(self._mask_queue[: self.frames_per_block + 1])
        self._mask_queue = self._mask_queue[self.frames_per_block:]
        mask_up = self._mask_samples(mvals)
        if self.record:
            self.recorded["mask"].append(mask_up)
        return audio * mask_up

    def flush(self) -> np.ndarray:
        """Drain the engine's 2-frame pipeline at the end of the stream."""
        tail, self.state = self.engine.flush(self.state)
        tail = tail.cpu().numpy()[0]
        mvals = np.asarray(self._mask_queue[:3])
        if len(mvals) < 3:
            mvals = np.pad(mvals, (0, 3 - len(mvals)), mode="edge")
        return tail * self._mask_samples(mvals)[: tail.shape[-1]]
