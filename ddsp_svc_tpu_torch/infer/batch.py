"""Batched offline conversion: many files, segments packed into batches.

Counterpart of `ddsp_svc_tpu/infer/batch.py`. The single-file path
(`offline.run_inference`) converts segment by segment at batch 1; this
module packs segments from many files into device batches:

  1. per file (host): load, f0 (the single path's MD5 cache file names, so
     the two paths share a cache), volume, the response mask, the split;
  2. per segment (device, exact length): units, equal to the single path's
     (HuBERT's edges depend on the true length);
  3. synthesis: segments grouped by frame bucket (`bucket_frames`), in
     chunks of `batch_size`, one forward a chunk with per-item
     `valid_frames`, so each item's valid prefix equals its own exact-length
     forward; f0 padded per item by repeating its last frame;
  4. enhancement: segments grouped by (resolved adaptive key, bucket) and
     run through `Enhancer.enhance_batch` with pad_to = bucket * block;
  5. per file: cross-fade stitching and the write, as run_inference.

The JAX package pads every chunk's batch axis up to batch_size (repeating
the last row) so that XLA compiles one program per bucket. The port does
not: PyTorch compiles nothing per shape, and on the card a padded row is
pure device work. Rows are independent, so each item's output is the same
either way.

Randomness. The synth noise of segment s of file f is drawn as in JAX,
np.random.default_rng((seed, f, s)).random(shape, float32) * 2 - 1, so the
port's default excitation equals JAX's bit for bit. JAX draws the enhancer's
SineGen rotations with jax.random from (seed, s) alone; the port cannot
import JAX and draws them with np.random.default_rng((seed, s, 1)).random(
(1, 9), float32), column 0 set to 0, keeping JAX's dependence on (seed, s)
but not its numbers. noise_hook(f, s, shape) and enhancer_rand_hook(f, s)
inject both (the tests give both paths the same).
"""
from __future__ import annotations

import hashlib
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.features import F0Extractor, UnitsEncoder, VolumeExtractor
from ..data.wavio import load_audio, write_wav
from ..models.factory import bucket_frames, load_model, make_batched_synth
from ..utils.device import resolve_device
from .enhancer import Enhancer
from .offline import cross_fade, response_mask, split


def run_inference_batch(
    model_path: str,
    input_paths: List[str],
    output_dir: str,
    batch_size: int = 16,
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
    noise_hook=None,           # (file_idx, seg_idx, shape) -> np.ndarray
    enhancer_rand_hook=None,   # (file_idx, seg_idx) -> (1, 9) np.ndarray
    output_subtype: str = "PCM_16",
    device=None,
    walls: Optional[Dict[str, float]] = None,
) -> List[str]:
    """Convert many files with batched device work on `device` (CUDA unless
    the caller asks for the CPU). Returns the output paths
    (output_dir/<input stem>.wav, in input order). walls, when given, is
    filled with each stage's host-clock seconds (the device synchronised
    at each stage's end): 'load + f0 + volume', 'units', 'synth',
    'enhance', 'stitch + write'."""
    device = resolve_device(device)
    model, args = load_model(model_path, device=device)
    block = int(args.data.block_size)
    sr_model = int(args.data.sampling_rate)

    n_spk = int(args.model.n_spk or 1)
    if spk_mix_dict is not None:
        bad = [k for k in spk_mix_dict if not 1 <= int(k) <= n_spk]
        if bad:
            raise ValueError(f" [x] spk_mix ids {bad} out of range [1, {n_spk}]")
    elif not 1 <= int(spk_id) <= n_spk:
        raise ValueError(f" [x] spk_id {spk_id} out of range [1, {n_spk}]")

    units_encoder = UnitsEncoder(
        args.data.encoder, args.data.encoder_ckpt,
        args.data.encoder_sample_rate, args.data.encoder_hop_size,
        device=device, trust_pickle=bool(args.data.encoder_trust_pickle))
    enhancer = None
    if enhance:
        enhancer = Enhancer(
            args.enhancer.type, args.enhancer.ckpt, device=device,
            bf16_min_channels=int(args.enhancer.bf16_min_channels or 0))
    synth = make_batched_synth(model, spk_mix_dict=spk_mix_dict)
    # the single path's default cache: dirname(output)/cache, which for
    # output_dir/<stem>.wav is this
    cache_dir = cache_dir or os.path.join(output_dir, "cache")

    t_stage = time.perf_counter()

    def stage_done(name: str) -> None:
        nonlocal t_stage
        if walls is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            now = time.perf_counter()
            walls[name] = now - t_stage
            t_stage = now

    # ---- per-file features and segmentation (host; f0 may use the card) ----
    extractors = {}  # one per (rate, hop): CREPE's weights are made once
    files = []
    segs = []  # one record per segment, in file and segment order
    for fi, path in enumerate(input_paths):
        audio, sr_i = load_audio(path, sr=sampling_rate, mono=True)
        hop = block * sr_i / sr_model
        with open(path, "rb") as f:
            md5 = hashlib.md5(f.read()).hexdigest()
        cache_file = os.path.join(
            cache_dir, f"{pitch_extractor}_{f0_min}_{f0_max}_{md5}.npy")
        if os.path.exists(cache_file):
            f0 = np.load(cache_file, allow_pickle=False)
        else:
            ext = extractors.get((sr_i, hop))
            if ext is None:
                ext = extractors[sr_i, hop] = F0Extractor(
                    pitch_extractor, sr_i, hop, f0_min, f0_max, device=device)
            f0 = ext.extract(audio, uv_interp=True)
            os.makedirs(cache_dir, exist_ok=True)
            np.save(cache_file, f0, allow_pickle=False)
        f0 = f0[None, :, None].astype(np.float32)
        shift = np.float32(2.0 ** (float(key) / 12))
        f0 = f0 * shift
        if compat_double_key:
            f0 = f0 * shift
        volume = VolumeExtractor(hop).extract(audio)[None, :]
        segments = split(audio, sr_i, hop)
        files.append({"path": path, "sr": sr_i, "hop": hop, "f0": f0,
                      "volume": volume,
                      "mask": response_mask(volume[0], threshold_db, block)})
        for si, (start_frame, seg_audio) in enumerate(segments):
            segs.append({"file": fi, "seg": si, "start": start_frame,
                         "audio": seg_audio})
    print(f"[batch] {len(input_paths)} files -> {len(segs)} segments")
    stage_done("load + f0 + volume")

    # ---- per-segment units (exact length, as the single path) ----
    for rec in segs:
        meta = files[rec["file"]]
        units = units_encoder.encode(rec["audio"][None, :], meta["sr"],
                                     meta["hop"])
        n_f = units.shape[1]
        rec["units"] = units
        rec["n_f"] = n_f
        rec["f0"] = meta["f0"][:, rec["start"]: rec["start"] + n_f, :]
        rec["volume"] = meta["volume"][:, rec["start"]: rec["start"] + n_f]
    stage_done("units")

    # ---- batched synthesis (bucket groups, per-item valid_frames) ----
    groups = defaultdict(list)
    for rec in segs:
        groups[bucket_frames(rec["n_f"])].append(rec)
    for bucket, recs in sorted(groups.items()):
        for lo in range(0, len(recs), batch_size):
            chunk = recs[lo: lo + batch_size]
            b = len(chunk)
            n_unit = chunk[0]["units"].shape[-1]
            units_b = np.zeros((b, bucket, n_unit), np.float32)
            f0_b = np.zeros((b, bucket, 1), np.float32)
            vol_b = np.zeros((b, bucket), np.float32)
            noise_b = np.zeros((b, bucket * block), np.float32)
            valid = np.zeros((b,), np.int64)
            for j, rec in enumerate(chunk):
                n = rec["n_f"]
                units_b[j, :n] = rec["units"][0]
                f0_b[j, :n] = rec["f0"][0]
                f0_b[j, n:] = rec["f0"][0, -1]  # per-item edge padding
                vol_b[j, :n] = rec["volume"][0]
                valid[j] = n
                shape = (1, n * block)
                if noise_hook is not None:
                    nz = np.asarray(noise_hook(rec["file"], rec["seg"], shape),
                                    np.float32)
                else:
                    nz = (np.random.default_rng(
                        (seed, rec["file"], rec["seg"])
                    ).random(shape, np.float32) * 2 - 1)
                noise_b[j, : n * block] = nz[0]
            spk_b = np.full((b, 1), int(spk_id), np.int64)
            out = synth(units_b, f0_b, vol_b, spk_b, valid, noise_b)
            for j, rec in enumerate(chunk):
                lo_s, n_s = rec["start"] * block, rec["n_f"] * block
                m = files[rec["file"]]["mask"][:, lo_s: lo_s + n_s]
                rec["signal"] = out[j: j + 1, :n_s] * torch.as_tensor(
                    m, device=device)
                rec["sr_o"] = sr_model
    stage_done("synth")

    # ---- batched enhancement (grouped by resolved key and bucket) ----
    if enhancer is not None:
        egroups = defaultdict(list)
        for rec in segs:
            eak = enhancer_adaptive_key
            if eak == "auto":
                eak = 12.0 * np.log2(float(np.max(rec["f0"])) / 760.0)
                eak = max(0, np.ceil(eak))
            rec["eak"] = float(eak)
            egroups[(rec["eak"], bucket_frames(rec["n_f"]))].append(rec)
        for (eak, bucket), recs in sorted(egroups.items()):
            for lo in range(0, len(recs), batch_size):
                chunk = recs[lo: lo + batch_size]
                rand = np.concatenate([
                    np.asarray(enhancer_rand_hook(r["file"], r["seg"]),
                               np.float32)
                    if enhancer_rand_hook is not None
                    else _default_rand_ini(seed, r["seg"])
                    for r in chunk], axis=0)
                outs, sr_o = enhancer.enhance_batch(
                    [r["signal"] for r in chunk], sr_model,
                    [r["f0"] for r in chunk], block, adaptive_key=eak,
                    rand_ini=rand, pad_to=bucket * block)
                for r, o in zip(chunk, outs):
                    r["signal"] = o
                    r["sr_o"] = sr_o
    stage_done("enhance")

    # ---- per-file stitching and write (as run_inference) ----
    os.makedirs(output_dir, exist_ok=True)
    out_paths = []
    by_file = defaultdict(list)
    for rec in segs:
        by_file[rec["file"]].append(rec)
    for fi, meta in enumerate(files):
        recs = sorted(by_file[fi], key=lambda r: r["seg"])
        result = np.zeros(0)
        current_length = 0
        sr_o = recs[0]["sr_o"] if recs else sr_model
        for rec in recs:
            sr_o = rec["sr_o"]
            seg_out = rec["signal"].cpu().numpy().astype(np.float64).reshape(-1)
            silent_length = (round(rec["start"] * block * sr_o / sr_model)
                             - current_length)
            if silent_length >= 0:
                result = np.append(result, np.zeros(silent_length))
                result = np.append(result, seg_out)
            else:
                result = cross_fade(result, seg_out,
                                    current_length + silent_length)
            current_length = current_length + silent_length + len(seg_out)
        stem = os.path.splitext(os.path.basename(meta["path"]))[0]
        out_path = os.path.join(output_dir, f"{stem}.wav")
        write_wav(out_path, result.astype(np.float32), int(sr_o),
                  subtype=output_subtype)
        out_paths.append(out_path)
    stage_done("stitch + write")
    return out_paths


def _default_rand_ini(seed: int, seg: int) -> np.ndarray:
    """Segment seg's SineGen rotations (1, 9), column 0 zero: a function of
    (seed, seg) as in JAX, drawn with numpy (the numbers differ from JAX's)."""
    r = np.random.default_rng((seed, seg, 1)).random((1, 9), np.float32)
    r[:, 0] = 0.0
    return r
