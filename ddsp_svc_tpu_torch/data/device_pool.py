"""The training set in device memory (train.data_on_device): every long
enough file's features concatenated frame-aligned on the device, crops
gathered there by index.

Counterpart of `ddsp_svc_tpu/data/device_pool.py`, with its layout:
  units  :: (F_total * (1 + n_aunit), C)  the dataset's cache dtype
            (float16 under train.cache_fp16), one block per unit variant
  f0     :: (F_total,)                     float32
  volume :: (F_total,)                     float32
  audio  :: (F_total * block,)             the dataset's cache dtype
and host tables of each file's base offsets. `sample` picks a batch's
crops on the host with the JAX pool's draws (the same `random.Random`
calls, skip rule and offsets, so one seed gives the same index arrays bit
for bit); only those (B,) index arrays cross to the device. `gather_batch`
is plain tensor indexing with no host read, so it runs inside a captured
CUDA graph. The GAN's clip pool (`train/gan_solver.py::ClipPool`) follows
the same pattern.
"""
from __future__ import annotations

import random
from typing import Dict

import numpy as np
import torch


class DevicePool:
    """Built from an AudioDataset loaded with its whole cache
    (train.cache_all_data)."""

    def __init__(self, dataset, block_size: int, device):
        self.block = int(block_size)
        self.crop_frames = int(
            dataset.waveform_sec * dataset.sample_rate / dataset.hop_size)
        self.n_aunit = dataset.n_aunit
        min_sec = dataset.waveform_sec + 0.1

        names, feat_base, unit_base, n_frames, spk = [], [], [], [], []
        units_parts, f0_parts, vol_parts, audio_parts = [], [], [], []
        f_total = u_total = 0
        for rel in dataset.paths:
            buf = dataset.data_buffer[rel]
            if buf["duration"] < min_sec:
                continue  # the skip rule of AudioDataset.get_item
            if "units" not in buf:
                raise ValueError("DevicePool needs the dataset's whole cache "
                                 "(train.cache_all_data: true)")
            f0 = buf["f0"][:, 0]
            vol = buf["volume"]
            variants = buf["units"]
            nf = min(len(f0), len(vol), *(len(u) for u in variants))
            audio = buf["audio"]
            nf = min(nf, len(audio) // self.block)
            if nf <= self.crop_frames:
                continue
            names.append(rel)
            feat_base.append(f_total)
            unit_base.append([u_total + i * nf for i in range(len(variants))])
            n_frames.append(nf)
            spk.append(int(buf["spk_id"][0]))
            f0_parts.append(f0[:nf].astype(np.float32))
            vol_parts.append(vol[:nf].astype(np.float32))
            audio_parts.append(audio[: nf * self.block])
            units_parts.extend(u[:nf] for u in variants)
            f_total += nf
            u_total += nf * len(variants)
        if not names:
            raise ValueError("DevicePool: no file long enough for the crop")

        self.names = names
        self.feat_base = np.asarray(feat_base, dtype=np.int32)
        self.unit_base = np.asarray(unit_base, dtype=np.int32)  # (N, 1+n_aunit)
        self.n_frames = np.asarray(n_frames, dtype=np.int32)
        self.spk = np.asarray(spk, dtype=np.int64)
        self.frame_resolution = dataset.hop_size / dataset.sample_rate
        host = {"units": np.concatenate(units_parts, axis=0),
                "f0": np.concatenate(f0_parts),
                "volume": np.concatenate(vol_parts),
                "audio": np.concatenate(audio_parts)}
        self.arrays = {k: torch.as_tensor(v, device=device)
                       for k, v in host.items()}
        self.frames = torch.arange(self.crop_frames, device=device)
        self.samples = torch.arange(self.crop_frames * self.block,
                                    device=device)

    def __len__(self) -> int:
        return len(self.names)

    def nbytes(self) -> int:
        return int(sum(a.numel() * a.element_size()
                       for a in self.arrays.values()))

    def sample(self, file_indices, rng: random.Random) -> Dict[str, np.ndarray]:
        """The crops of a batch of pool files, drawn on the host as
        AudioDataset.get_item draws them (a uniform start in seconds, a
        uniform unit variant): {feat_start (B,), unit_start (B,) int32,
        spk_id (B, 1) int64}."""
        feat_starts, unit_starts, spk = [], [], []
        for fi in file_indices:
            fi = int(fi) % len(self.names)
            max_from = (self.n_frames[fi] * self.frame_resolution
                        - self.crop_frames * self.frame_resolution - 0.1)
            idx_from = rng.uniform(0, max(max_from, 0.0))
            start = int(idx_from / self.frame_resolution)
            start = min(start, int(self.n_frames[fi]) - self.crop_frames)
            variant = rng.randint(0, self.n_aunit)
            feat_starts.append(self.feat_base[fi] + start)
            unit_starts.append(self.unit_base[fi][variant] + start)
            spk.append(self.spk[fi])
        return {
            "feat_start": np.asarray(feat_starts, dtype=np.int32),
            "unit_start": np.asarray(unit_starts, dtype=np.int32),
            "spk_id": np.asarray(spk, dtype=np.int64)[:, None],
        }

    def gather(self, idx: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """gather_batch over this pool."""
        return gather_batch(self.arrays, idx, self.frames, self.samples)


def gather_batch(arrays: Dict[str, torch.Tensor], idx: Dict[str, torch.Tensor],
                 frames: torch.Tensor, samples: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """The batch that the host loader would have built, gathered on the
    device: idx the sample() arrays as tensors on the pool's device, frames
    = arange(crop_frames) and samples = arange(crop_frames * block) there.
    audio (B, crop * block), units (B, crop, C), f0 (B, crop, 1) and volume
    (B, crop) as float32; spk_id as given."""
    feat = idx["feat_start"].long()[:, None]
    block = samples.numel() // frames.numel()
    units = arrays["units"][idx["unit_start"].long()[:, None] + frames]
    return {
        "audio": arrays["audio"][feat * block + samples].float(),
        "units": units.float(),
        "f0": arrays["f0"][feat + frames].float()[..., None],
        "volume": arrays["volume"][feat + frames].float(),
        "spk_id": idx["spk_id"],
    }
