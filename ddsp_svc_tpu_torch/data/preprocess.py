"""Preprocessing: raw audio -> the feature store the trainer reads.

Counterpart of `ddsp_svc_tpu/data/preprocess.py`, with its layout and file
names: walks `{path}/audio/{spk}/*.wav` and writes `units/{spk}/{name}.0.npy`,
`f0/{spk}/{name}.npy` (unvoiced frames linearly interpolated unless
use_vuv), `f0_stat/{spk}/{name}.npy` (the utterance's mean log-f0 over its
voiced frames) and `volume/{spk}/{name}.npy`; a file with no voiced frame is
moved to `skip/`. The train pass gathers each speaker's mean of those means
into `f0_stats.npy` (the validation's pitch transposition reads it).

Files run on a pool of `num_workers` threads: the wav decode, the resampler
and the native f0 overlap on the host, and the device work (HuBERT, CREPE)
runs under torch.no_grad in each thread (grad mode is per thread).
"""
from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

from .dataset import traverse_dir
from .features import F0Extractor, UnitsEncoder, VolumeExtractor
from .wavio import load_audio


def preprocess(
    path: str,
    f0_extractor: F0Extractor,
    volume_extractor: VolumeExtractor,
    units_encoder: Optional[UnitsEncoder],
    sample_rate: int,
    hop_size: int,
    gen_stats: bool = False,
    n_aunit: int = 0,
    use_vuv: bool = False,
    num_workers: int = 4,
) -> None:
    """Extract the features of every wav under `path`/audio (n_aunit is
    accepted for the JAX package's signature and unused, as there)."""
    path_srcdir = os.path.join(path, "audio")
    path_unitsdir = os.path.join(path, "units")
    path_f0dir = os.path.join(path, "f0")
    path_f0statdir = os.path.join(path, "f0_stat")
    path_f0statfile = os.path.join(path, "f0_stats")
    path_volumedir = os.path.join(path, "volume")
    path_skipdir = os.path.join(path, "skip")

    rel_wavs = traverse_dir(path_srcdir, extension="wav", is_pure=True,
                            is_ext=True)
    print(f"Preprocess the audio clips in: {path_srcdir} "
          f"({len(rel_wavs)} files)")

    def process_one(rel_wav):
        rel_bin = rel_wav[: -len(".wav")] + ".npy"
        path_srcfile = os.path.join(path_srcdir, rel_wav)
        path_f0file = os.path.join(path_f0dir, rel_bin)
        path_f0statfile_utt = os.path.join(path_f0statdir, rel_bin)
        path_volumefile = os.path.join(path_volumedir, rel_bin)
        path_unitsfile = os.path.join(path_unitsdir, rel_bin)
        path_skipfile = os.path.join(path_skipdir, rel_wav)
        for p in (path_f0file, path_f0statfile_utt, path_volumefile,
                  path_unitsfile):
            os.makedirs(os.path.dirname(p), exist_ok=True)

        audio, _ = load_audio(path_srcfile, sr=sample_rate, mono=True)
        volume = volume_extractor.extract(audio)
        if units_encoder is not None:
            units = units_encoder.encode(audio[None, :], sample_rate,
                                         hop_size)[0]
            np.save(path_unitsfile[:-4] + ".0.npy", units)

        f0 = f0_extractor.extract(audio, uv_interp=False)
        unvoiced = f0 == 0
        if (~unvoiced).sum() > 0:
            lfo_mean = np.mean(np.log(f0[~unvoiced]))
            if not use_vuv:
                f0 = f0.copy()
                f0[unvoiced] = np.interp(np.where(unvoiced)[0],
                                         np.where(~unvoiced)[0], f0[~unvoiced])
            np.save(path_f0file, f0)
            np.save(path_f0statfile_utt, lfo_mean)
            np.save(path_volumefile, volume)
        else:
            print(f"\n[Error] F0 extraction failed: {path_srcfile}")
            os.makedirs(os.path.dirname(path_skipfile), exist_ok=True)
            shutil.move(path_srcfile, os.path.dirname(path_skipfile))
            print(f"This file has been moved to {path_skipfile}")

    if num_workers > 1 and len(rel_wavs) > 1:
        with ThreadPoolExecutor(max_workers=num_workers) as ex:
            list(ex.map(process_one, rel_wavs))  # re-raises a file's error
    else:
        for rel_wav in rel_wavs:
            process_one(rel_wav)

    if gen_stats:
        stats = {}
        dir_fo_stat = Path(path_f0statdir)
        if dir_fo_stat.is_dir():
            for p_spk in dir_fo_stat.iterdir():
                vals = [np.load(p) for p in p_spk.iterdir()]
                if vals:
                    stats[str(p_spk.name)] = float(np.mean(vals))
        np.save(path_f0statfile, stats)


def preprocess_from_config(args, device=None) -> None:
    """The train pass (with f0_stats.npy), then the valid pass, with the
    config's extractors on `device` (CUDA unless the caller asks for the
    CPU). The parselmouth family runs on the native NCCF library
    (backend 'auto', which raises if the library cannot be built)."""
    d = args.data
    f0_extractor = F0Extractor(
        d.f0_extractor, d.sampling_rate, d.block_size, d.f0_min, d.f0_max,
        backend="auto", device=device)
    volume_extractor = VolumeExtractor(d.block_size)
    units_encoder = UnitsEncoder(
        d.encoder, d.encoder_ckpt, d.encoder_sample_rate, d.encoder_hop_size,
        device=device, trust_pickle=bool(d.encoder_trust_pickle))
    for data_path, gen_stats in ((d.train_path, True), (d.valid_path, False)):
        preprocess(data_path, f0_extractor, volume_extractor, units_encoder,
                   d.sampling_rate, d.block_size, gen_stats=gen_stats,
                   n_aunit=d.n_aunit or 0, use_vuv=bool(d.use_vuv))
