"""Offline conversion: segmentation, the segment loop, the stitching and
the whole-file entry point.

Counterpart of `ddsp_svc_tpu/infer/offline.py`. `run_inference` converts a
wav file end to end: load the model, f0 with an MD5-keyed cache (the JAX
package's file names, so its cache is read as is), the key change, volume
and the response mask, the silence split, and per segment the units and
`convert_features`' segment loop (bucketed synth, response mask, enhancer,
silence padding and cross-fade stitching); then the wav is written.
`convert_features` runs that loop over features the caller already has.

As in the JAX package, the key change is applied once; compat_double_key
reproduces the reference's double application (main.py applies it at two
places), multiplying sequentially as it does.
"""
from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..data.features import F0Extractor, UnitsEncoder, VolumeExtractor
from ..data.slicer import Slicer
from ..data.wavio import load_audio, write_wav
from ..models.factory import load_model, make_bucketed_synth
from ..utils.device import resolve_device
from .enhancer import Enhancer


def split(audio: np.ndarray, sample_rate: int, hop_size: float,
          db_thresh: float = -40, min_len: int = 5000):
    """Silence segmentation into (start_frame, chunk) (main.py:34-47)."""
    slicer = Slicer(sr=sample_rate, threshold=db_thresh, min_length=min_len)
    chunks = slicer.slice(audio)
    result = []
    for v in chunks.values():
        tag = v["split_time"].split(",")
        if tag[0] != tag[1]:
            start_frame = int(int(tag[0]) // hop_size)
            end_frame = int(int(tag[1]) // hop_size)
            if end_frame > start_frame:
                result.append(
                    (start_frame,
                     audio[int(start_frame * hop_size): int(end_frame * hop_size)])
                )
    return result


def cross_fade(a: np.ndarray, b: np.ndarray, idx: int) -> np.ndarray:
    """Linear cross-fade concat at sample idx (main.py:50-57)."""
    result = np.zeros(idx + b.shape[0])
    fade_len = a.shape[0] - idx
    result[:idx] = a[:idx]
    k = np.linspace(0, 1.0, num=fade_len, endpoint=True)
    result[idx: a.shape[0]] = (1 - k) * a[idx:] + k * b[:fade_len]
    result[a.shape[0]:] = b[fade_len:]
    return result


def response_frame_mask(volume: np.ndarray, threshold_db: float) -> np.ndarray:
    """Volume-threshold mask with 9-frame max dilation, at frame rate."""
    mask = (volume > 10 ** (threshold_db / 20)).astype(np.float32)
    mask = np.pad(mask, (4, 4), constant_values=(mask[0], mask[-1]))
    return np.array([np.max(mask[n: n + 9]) for n in range(len(mask) - 8)])


def response_mask(volume: np.ndarray, threshold_db: float, block_size: int
                  ) -> np.ndarray:
    """response_frame_mask upsampled linearly to sample rate, (1, T)."""
    mask = response_frame_mask(volume, threshold_db)
    nxt = np.concatenate([mask[1:], mask[-1:]])
    w = (np.arange(block_size) / block_size).astype(np.float32)
    up = mask[:, None] + (nxt - mask)[:, None] * w[None, :]
    return up.reshape(1, -1).astype(np.float32)


def convert_features(
    model: nn.Module,
    segments: Sequence[Tuple[int, np.ndarray]],
    f0: np.ndarray,
    volume: np.ndarray,
    spk_id: int = 1,
    spk_mix_dict: Optional[Dict[int, float]] = None,
    enhancer: Optional[Enhancer] = None,
    enhancer_adaptive_key=0,
    threshold_db: float = -60,
    seed: int = 0,
    noise_hook: Optional[Callable[[int, tuple], np.ndarray]] = None,
    enhancer_rand_hook: Optional[Callable[[int], np.ndarray]] = None,
) -> Tuple[np.ndarray, int]:
    """Convert an utterance from its features, on the model's device, with
    any of the three synthesizers (`build_model`).

    segments: [(start_frame, units (1, n_f, n_unit))], as `split` cuts the
    input and the units encoder encodes each cut. f0 (1, F, 1) [Hz] after
    any key change and volume (1, F) cover the whole input on the model's
    frame grid. noise_hook(i, shape) and enhancer_rand_hook(i) optionally
    inject segment i's noise excitation and SineGen initial rotations;
    otherwise both are drawn from a torch.Generator seeded with `seed`.
    Returns (audio float64 (T,), sample rate).
    """
    n_spk = model.unit2ctrl.spk_embed.num_embeddings
    ids: List[int] = ([int(k) for k in spk_mix_dict] if spk_mix_dict
                      is not None else [int(spk_id)])
    bad = [k for k in ids if not 1 <= k <= n_spk]
    if bad:
        # an out-of-range embedding lookup would fail on the device
        raise ValueError(f" [x] speaker ids {bad} out of range [1, {n_spk}]")
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    synth = make_bucketed_synth(model, spk_mix_dict=spk_mix_dict)
    bs = model.block_size
    sr = model.sampling_rate
    mask = response_mask(volume[0], threshold_db, bs)
    spk_id_arr = np.asarray([[int(spk_id)]], dtype=np.int64)

    result = np.zeros(0)
    current_length = 0
    sr_o = sr
    for i, (start_frame, seg_units) in enumerate(segments):
        n_f = seg_units.shape[1]
        seg_f0 = f0[:, start_frame: start_frame + n_f, :]
        seg_volume = volume[:, start_frame: start_frame + n_f]
        seg_noise = None
        if noise_hook is not None:
            seg_noise = np.asarray(noise_hook(i, (1, n_f * bs)), np.float32)
        seg_out = synth(seg_units, seg_f0, seg_volume, spk_id_arr,
                        noise=seg_noise, generator=generator)
        seg_mask = mask[:, start_frame * bs: (start_frame + n_f) * bs]
        seg_out = seg_out * torch.as_tensor(seg_mask, device=device)
        if enhancer is not None:
            enh_rand = None
            if enhancer_rand_hook is not None:
                enh_rand = np.asarray(enhancer_rand_hook(i), np.float32)
            seg_out, sr_o = enhancer.enhance(
                seg_out, sr, seg_f0, bs, adaptive_key=enhancer_adaptive_key,
                rand_ini=enh_rand, generator=generator)
        seg_out = seg_out.cpu().numpy().astype(np.float64).reshape(-1)

        silent_length = round(start_frame * bs * sr_o / sr) - current_length
        if silent_length >= 0:
            result = np.append(result, np.zeros(silent_length))
            result = np.append(result, seg_out)
        else:
            result = cross_fade(result, seg_out, current_length + silent_length)
        current_length = current_length + silent_length + len(seg_out)
    return result, sr_o


def run_inference(
    model_path: str,
    input_path: str,
    output_path: str,
    spk_id: int = 1,
    spk_mix_dict: Optional[Dict[int, float]] = None,
    key: float = 0,
    enhance: bool = True,
    pitch_extractor: str = "crepe",
    f0_min: float = 50,
    f0_max: float = 1100,
    threshold_db: float = -60,
    enhancer_adaptive_key=0,
    sampling_rate: int = 44100,
    cache_dir: Optional[str] = None,
    compat_double_key: bool = False,
    seed: int = 0,
    noise_hook=None,
    enhancer_rand_hook=None,
    output_subtype: str = "PCM_16",
    device=None,
) -> str:
    """Convert `input_path` into `output_path` with the model at
    `model_path` (its config.yaml beside it), on `device` (CUDA unless the
    caller asks for the CPU). The enhancer is built with the config's
    `enhancer.bf16_min_channels`. noise_hook(i, (1, samples)) and
    enhancer_rand_hook(i) -> (1, 9) optionally inject segment i's noise
    excitation and SineGen initial rotations; otherwise both are drawn from
    a torch.Generator seeded with `seed`. Returns output_path."""
    device = resolve_device(device)
    model, args = load_model(model_path, device=device)

    audio, sr_i = load_audio(input_path, sr=sampling_rate, mono=True)
    hop_size = args.data.block_size * sr_i / args.data.sampling_rate

    with open(input_path, "rb") as f:
        md5_hash = hashlib.md5(f.read()).hexdigest()
    cache_dir = cache_dir or os.path.join(
        os.path.dirname(output_path) or ".", "cache")
    cache_file = os.path.join(
        cache_dir, f"{pitch_extractor}_{f0_min}_{f0_max}_{md5_hash}.npy")
    if os.path.exists(cache_file):
        print("Loading pitch curves from cache...")
        f0 = np.load(cache_file, allow_pickle=False)
    else:
        print(f"Pitch extractor type: {pitch_extractor}")
        ext = F0Extractor(pitch_extractor, sr_i, hop_size, f0_min, f0_max,
                          device=device)
        f0 = ext.extract(audio, uv_interp=True)
        os.makedirs(cache_dir, exist_ok=True)
        np.save(cache_file, f0, allow_pickle=False)
    f0 = f0[None, :, None].astype(np.float32)

    shift = np.float32(2.0 ** (float(key) / 12))
    f0 = f0 * shift
    if compat_double_key:
        f0 = f0 * shift

    volume = VolumeExtractor(hop_size).extract(audio)[None, :]
    n_spk = int(args.model.n_spk or 1)
    if spk_mix_dict is not None:
        bad = [k for k in spk_mix_dict if not 1 <= int(k) <= n_spk]
        if bad:
            raise ValueError(
                f" [x] spk_mix_dict ids {bad} out of range [1, {n_spk}]")
    elif not 1 <= int(spk_id) <= n_spk:
        raise ValueError(f" [x] spk_id {spk_id} out of range [1, {n_spk}]")
    units_encoder = UnitsEncoder(
        args.data.encoder, args.data.encoder_ckpt,
        args.data.encoder_sample_rate, args.data.encoder_hop_size,
        device=device,
        trust_pickle=bool(args.data.encoder_trust_pickle))
    enhancer = None
    if enhance:
        print("Enhancer type: " + str(args.enhancer.type))
        enhancer = Enhancer(
            args.enhancer.type, args.enhancer.ckpt, device=device,
            bf16_min_channels=int(args.enhancer.bf16_min_channels or 0))

    segments = split(audio, sr_i, hop_size)
    print(f"Cut the input audio into {len(segments)} slices")
    units = [(start, units_encoder.encode(seg[None, :], sr_i, hop_size))
             for start, seg in segments]
    result, sr_o = convert_features(
        model, units, f0, volume, spk_id=spk_id, spk_mix_dict=spk_mix_dict,
        enhancer=enhancer, enhancer_adaptive_key=enhancer_adaptive_key,
        threshold_db=threshold_db, seed=seed, noise_hook=noise_hook,
        enhancer_rand_hook=enhancer_rand_hook)
    write_wav(output_path, result.astype(np.float32), int(sr_o),
              subtype=output_subtype)
    return output_path
